// Ring all-reduce SUM over d shards held on one card, for Hopper (sm_90a):
// one plain launch, each thread summing its own columns in every shard's
// ring order, with no cluster, no shared memory and no barrier.
//
// Replaces the TPU kernel parallel/ring.py _ring_sum_kernel of the JAX
// package (tpu_aerial_transport), driven there by _pallas_ring_allreduce:
// each of d TPU cores holds one shard's payload and passes it to its right
// neighbour by remote DMA, d - 1 hops, adding what arrives. On one H100 the
// d shards are the rows of one contiguous (d, P) float32 tensor (the port's
// explicit shard axis), so the DMA the hops hide has no wire to cross: the
// d values a shard receives for one column are one strided read away.
//
//   - grid: one thread per group of V columns (V = 4, one 16-byte load a
//     row, when P is a multiple of 4, both tensors are 16-byte aligned and
//     d <= RS_VEC_MAX_SHARDS; else V = 1); the ragged last block returns
//     early for the groups past P;
//   - the thread loads the d x V values of its columns once (row r is
//     contiguous, so each row's loads are coalesced across the warp) into
//     registers;
//   - for each shard r it adds them in r's ring order, x_r + x_{r-1} + ...
//     + x_{r-d+1} (indices mod d), left to right in float32, and writes
//     row r of the output.
//
// Order: the TPU kernel's order, shard by shard; the kernel only adds
// (nothing for an FMA to contract), so it agrees bit for bit with its plain
// version (parallel/ring.py ring_sum_shards_reference). NaN propagates.
//
// What bounds it: it must read the d x P input and write the d x P output
// once, 2 d P 4 bytes, and do (d - 1) d P float32 adds; at this path's
// payloads (P of a few hundred to 6,144 floats, d = 8: at most 0.4 MB) both
// are well under a microsecond. What the design does about it: it reads
// and writes exactly those bytes, and its only latency is one launch and
// one load-add-store chain a thread, with nothing to wait for between
// threads. The shard count is a template argument, so the d x V values and
// every index stay in registers; RS_MAX_SHARDS is the most it is built for
// (d x V <= 64 values a thread, far from a spill).

#include <cuda_runtime.h>

#include <stdint.h>

#define RS_THREADS 128
#define RS_MAX_SHARDS 32
// The most shards that take the 16-byte (V = 4) form.
#define RS_VEC_MAX_SHARDS 16

template <int D, int V>
__global__ void __launch_bounds__(RS_THREADS)
ring_sum_kernel(const float* __restrict__ x, float* __restrict__ out,
                long long P) {
  const long long g = (long long)blockIdx.x * RS_THREADS + threadIdx.x;
  if (g * V >= P) return;
  float v[D][V];
#pragma unroll
  for (int r = 0; r < D; ++r) {
    if constexpr (V == 4) {
      const float4 q = reinterpret_cast<const float4*>(x + r * P)[g];
      v[r][0] = q.x;
      v[r][1] = q.y;
      v[r][2] = q.z;
      v[r][3] = q.w;
    } else {
      v[r][0] = x[r * P + g];
    }
  }
#pragma unroll
  for (int r = 0; r < D; ++r) {
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = v[r][e];
#pragma unroll
    for (int s = 1; s < D; ++s) {
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] += v[(r - s + D) % D][e];
    }
    if constexpr (V == 4) {
      reinterpret_cast<float4*>(out + r * P)[g] =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      out[r * P + g] = acc[0];
    }
  }
}

// The instantiation for d shards (V = 4 when vec), or null past the cap.
template <int D>
static const void* ring_sum_fn(int d, bool vec) {
  if (d == D) {
    if constexpr (D <= RS_VEC_MAX_SHARDS) {
      if (vec) return (const void*)ring_sum_kernel<D, 4>;
    }
    return (const void*)ring_sum_kernel<D, 1>;
  }
  if constexpr (D < RS_MAX_SHARDS) return ring_sum_fn<D + 1>(d, vec);
  return nullptr;
}

static bool ring_sum_vec(const float* x, const float* out, int d,
                         long long P) {
  return d <= RS_VEC_MAX_SHARDS && P % 4 == 0 &&
         (((uintptr_t)x | (uintptr_t)out) & 15) == 0;
}

extern "C" int ring_sum_launch(const float* x, float* out, int d, long long P,
                               int device, cudaStream_t stream) {
  if (d < 1 || d > RS_MAX_SHARDS || P < 0) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const bool vec = ring_sum_vec(x, out, d, P);
  const long long groups = vec ? P / 4 : P;
  const long long blocks = (groups + RS_THREADS - 1) / RS_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&x, (void*)&out, (void*)&P};
  e = cudaLaunchKernel(ring_sum_fn<1>(d, vec), dim3((unsigned)blocks),
                       dim3(RS_THREADS), args, 0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// What the build made of the instantiation a (d, P) launch takes, for the
// report: out = {registers a thread, local (spill) bytes a thread, 16-byte
// form 0/1}. The alignment is taken as the allocator's (16 bytes).
extern "C" int ring_sum_info(int d, long long P, int device, int* out) {
  if (d < 1 || d > RS_MAX_SHARDS || P < 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const bool vec = ring_sum_vec(nullptr, nullptr, d, P);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, ring_sum_fn<1>(d, vec));
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = vec ? 1 : 0;
  return (int)cudaSuccess;
}

extern "C" const char* ring_sum_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
