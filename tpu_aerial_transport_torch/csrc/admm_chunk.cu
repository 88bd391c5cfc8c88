// Fixed-length ADMM chunk for Hopper (sm_90a): `iters` iterations of one
// small conic QP per lane, with its fused operator K2 and w2 given.
//
// Replaces the TPU kernel ops/admm_kernel.py _admm_chunk_kernel of the JAX
// package (tpu_aerial_transport), float32. Per lane:
//
//   repeat iters:  v = K2 [x; rho z - y] - w2;  x = v[:nv]
//                  Ax_rel = alpha v[nv:] + (1 - alpha) z
//                  z = Pi(Ax_rel + y / rho)      (translated box x SOC)
//                  y = y + rho (Ax_rel - z)
//
// and nothing else: the w2 build and the residuals stay outside, in plain
// tensor ops, as the JAX package leaves them to XLA. The solver's chunked
// route (ops/socp.py, socp_fused="pallas") launches it once per chunk of a
// tolerance-chunked solve, or once for a fixed-iteration solve.
//
// Unlike the TPU kernel, which keeps lanes last ((d, d, B), 128 lanes a grid
// cell, the lane count padded), this one keeps the batch first, like the
// port's whole-solve kernel: one block per lane, so a ragged lane count
// needs no padding.
//
// What bounds it: at the C-ADMM headline (2048 lanes, d = 48, 20
// iterations) one launch must read K2 (9,216 B), w2 and the per-row vectors
// and write x, y, z: 10,496 B a lane, 21.5 MB in all, against about 205
// MFLOP of float32 work, far below the H100's float32 balance point (20
// operations a byte): bound by memory bandwidth and latency. What the design
// does about that: K2 is read from device memory once per launch into shared
// memory (odd row stride, conflict-free row walks) and stays there across
// the chunk's iterations; x, y, z, w2 and the row constants live in the
// registers of the thread that owns the row. The iteration body is the one
// the whole-solve kernel runs (admm_common.cuh admm_iteration).

#include "admm_common.cuh"

static __host__ __device__ size_t chunk_smem_floats(int nv, int m) {
  const int d = nv + m;
  return (size_t)d * fs_odd(d) + 2 * (size_t)d;
}

__global__ void admm_chunk_kernel(
    const float* __restrict__ K2g, const float* __restrict__ w2g,
    const float* __restrict__ rhog, const float* __restrict__ lbg,
    const float* __restrict__ ubg, const float* __restrict__ shiftg,
    const float* __restrict__ x0g, const float* __restrict__ y0g,
    const float* __restrict__ z0g, float* __restrict__ xo,
    float* __restrict__ yo, float* __restrict__ zo, int nv, int m, int n_box,
    int iters, int has_shift, float alpha, float one_minus_alpha,
    SocDims soc) {
  extern __shared__ float smem[];
  const long long lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int d = nv + m;
  const int ld_d = fs_odd(d);

  float* sK2 = smem;                  // d x ld_d
  float* su = sK2 + d * ld_d;         // d: [x; rho z - y]
  float* szs = su + d;                // d: pre-projection

  const float* K2l = K2g + lane * d * d;
  for (int i = tid; i < d * d; i += nth) sK2[(i / d) * ld_d + i % d] = K2l[i];

  const bool is_x = tid < nv;
  const bool is_row = tid >= nv && tid < d;
  const int r = tid - nv;
  float x = 0.f, y = 0.f, z = 0.f;
  const float w = tid < d ? w2g[lane * d + tid] : 0.f;
  RowConst rc = {1.f, 0.f, 0.f, 0.f, 0, 0};
  if (is_x) {
    x = x0g[lane * nv + tid];
  } else if (is_row) {
    y = y0g[lane * m + r];
    z = z0g[lane * m + r];
    rc.rho = rhog[lane * m + r];
    if (has_shift) rc.sh = shiftg[lane * m + r];
    if (r < n_box) {
      rc.lb = lbg[lane * n_box + r];
      rc.ub = ubg[lane * n_box + r];
    } else {
      soc_block_of(r, n_box, soc, &rc.blk_off, &rc.blk_d);
    }
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it)
    admm_iteration(sK2, ld_d, su, szs, tid, nv, d, n_box, w, rc, has_shift,
                   alpha, one_minus_alpha, x, y, z);

  if (is_x) {
    xo[lane * nv + tid] = x;
  } else if (is_row) {
    yo[lane * m + r] = y;
    zo[lane * m + r] = z;
  }
}

extern "C" int admm_chunk_launch(
    const float* K2, const float* w2, const float* rho, const float* lb,
    const float* ub, const float* shift, const float* x0, const float* y0,
    const float* z0, float* xo, float* yo, float* zo, int B, int nv, int m,
    int n_box, int iters, int has_shift, float alpha, float one_minus_alpha,
    SocDims soc, int device, cudaStream_t stream) {
  if (B < 0 || iters < 0 || !soc_layout_ok(nv, m, n_box, soc))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = chunk_smem_floats(nv, m) * sizeof(float);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(admm_chunk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int d = nv + m;
  const int threads = ((d + 31) / 32) * 32;
  admm_chunk_kernel<<<B, threads, smem, stream>>>(
      K2, w2, rho, lb, ub, shift, x0, y0, z0, xo, yo, zo, nv, m, n_box, iters,
      has_shift, alpha, one_minus_alpha, soc);
  return (int)cudaGetLastError();
}

extern "C" const char* admm_chunk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
