// Ring all-reduce SUM over d shards held on one card, for Hopper (sm_90a):
// a thread block cluster of d CTAs trades the payload around a ring
// through distributed shared memory.
//
// Replaces the TPU kernel parallel/ring.py _ring_sum_kernel of the JAX
// package (tpu_aerial_transport), driven there by _pallas_ring_allreduce:
// each of d TPU cores holds one shard's payload and passes it to its right
// neighbour by remote DMA, d - 1 hops, adding what arrives. On one H100 the
// d shards are the rows of a (d, P) float32 tensor (the port's explicit
// shard axis), and the counterpart of d cores trading payloads is a cluster
// of d CTAs trading them through each other's shared memory:
//
//   - grid: tiles x d CTAs in clusters of d (cluster dimension set at run
//     time through cudaLaunchKernelEx); a CTA's rank in its cluster is its
//     shard r, the cluster index its payload tile of RS_TILE floats;
//   - comm slots: d write-once slots of RS_TILE floats in dynamic shared
//     memory (the TPU kernel's (d, R, 128) VMEM scratch); slot 0 takes the
//     CTA's own tile;
//   - neighbour barrier: one cluster barrier after staging slot 0, so every
//     CTA's shared memory exists before any remote store (ring.py:293-301);
//   - hop s = 0 .. d-2: store slot s into slot s+1 of CTA (r+1) % d (the
//     remote copy), arrive on the cluster barrier (release), add slot s
//     (s >= 1) into the accumulator while the neighbours' stores land (the
//     TPU kernel's overlap, ring.py:315-318), wait on the barrier (acquire);
//     after the last hop add slot d-1. Write-once slots mean no slot is
//     overwritten while it is read, and no CTA touches a neighbour's shared
//     memory after its last wait, so no closing barrier is needed.
//
// Order: on shard r the sum is x_r + x_{r-1} + ... + x_{r-d+1} (indices mod
// d), added left to right in float32, the TPU kernel's order; the kernel
// only adds (nothing for an FMA to contract), so it agrees bit for bit with
// its plain version (parallel/ring.py ring_sum_shards_reference). NaN
// propagates. The ragged last tile is masked; no zero pad is needed.
//
// What bounds it: it must read the d x P input and write the d x P output
// once, 2 d P 4 bytes, and do (d - 1) d P float32 adds. At this path's
// payloads (P of a few hundred to 6,144 floats, d <= 8: at most 0.4 MB) both
// bounds are well under a microsecond, and the kernel is bound by latency:
// one launch and d - 1 cluster barriers. Hiding that (fusing the exchange
// into its producer, or a persistent kernel) is later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define RS_THREADS 256
#define RS_PER_THREAD 4
#define RS_TILE (RS_THREADS * RS_PER_THREAD)
// The portable cluster size: the most CTAs a cluster may hold without
// opting in to a non-portable size.
#define RS_MAX_SHARDS 8

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__global__ void ring_sum_kernel(const float* __restrict__ x,
                                float* __restrict__ out, int d,
                                long long P) {
  extern __shared__ float slots[];  // d x RS_TILE
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const long long tile = blockIdx.x / d;
  const int tid = threadIdx.x;
  const float* row = x + (long long)r * P;

  float acc[RS_PER_THREAD];
#pragma unroll
  for (int j = 0; j < RS_PER_THREAD; ++j) {
    const int k = tid + j * RS_THREADS;
    const long long idx = tile * RS_TILE + k;
    const float v = idx < P ? row[idx] : 0.f;
    slots[k] = v;
    acc[j] = v;
  }
  // Neighbour barrier: slot 0 staged, and every CTA of the cluster running
  // (its shared memory exists) before the first remote store.
  cluster.sync();

  float* right = cluster.map_shared_rank(slots, (r + 1) % d);
  for (int s = 0; s < d - 1; ++s) {
    const float* mine = slots + s * RS_TILE;
    float* theirs = right + (s + 1) * RS_TILE;
#pragma unroll
    for (int j = 0; j < RS_PER_THREAD; ++j) {
      const int k = tid + j * RS_THREADS;
      theirs[k] = mine[k];
    }
    cluster_arrive_release();
    if (s > 0) {
#pragma unroll
      for (int j = 0; j < RS_PER_THREAD; ++j)
        acc[j] += mine[tid + j * RS_THREADS];
    }
    cluster_wait_acquire();
  }
  if (d > 1) {
    const float* last = slots + (d - 1) * RS_TILE;
#pragma unroll
    for (int j = 0; j < RS_PER_THREAD; ++j) acc[j] += last[tid + j * RS_THREADS];
  }

  float* orow = out + (long long)r * P;
#pragma unroll
  for (int j = 0; j < RS_PER_THREAD; ++j) {
    const long long idx = tile * RS_TILE + tid + j * RS_THREADS;
    if (idx < P) orow[idx] = acc[j];
  }
}

extern "C" int ring_sum_launch(const float* x, float* out, int d, long long P,
                               int device, cudaStream_t stream) {
  if (d < 1 || d > RS_MAX_SHARDS || P < 0) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (P + RS_TILE - 1) / RS_TILE;
  if (tiles * d > 0x7fffffffLL) return (int)cudaErrorInvalidValue;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * d), 1, 1);
  cfg.blockDim = dim3(RS_THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)d * RS_TILE * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)d;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, ring_sum_kernel, x, out, d, P);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* ring_sum_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
