// Whole-solve batched ADMM for Hopper (sm_90a): one small conic QP per lane.
//
// Replaces the TPU kernel ops/admm_kernel.py _fused_solve_kernel of the JAX
// package (tpu_aerial_transport), in its compiled form (exact_dot=False),
// with or without a cone shift, in both of its forms and both operator
// storage types (float32, or bfloat16 for K2, Minv, A and P: the JAX
// package's precision="bf16", ops/admm_kernel.py:541-546 and :574-579):
//
// - fixed-iteration (fused_solve_kernel): per lane
//     wq = Minv q,  w2 = [wq; A wq]
//     repeat iters:  v = K2 [x; rho z - y] - w2;  x = v[:nv]
//                    Ax_rel = alpha v[nv:] + (1 - alpha) z
//                    z = Pi(Ax_rel + y / rho)      (translated box x SOC)
//                    y = y + rho (Ax_rel - z)
//     prim = max|A x - z|,  dual = max|P x + q + A^T y|
// - early exit (fused_solve_early_kernel, check_every > 0 and tol > 0): the
//   iterations run in chunks of check_every. The lane stops as soon as
//   (prim > tol) | (dual > tol) is false at a chunk boundary -- the first
//   test comes before any iteration, and a NaN residual compares false, so
//   a non-finite lane stops too -- or after iters // check_every chunks,
//   followed by one remainder chunk of iters % check_every if the lane is
//   still above tol. An optional gate (active[lane] > 0) switches a lane
//   off from the start: it runs 0 iterations and passes its warm start
//   through. eff[lane] = chunks run x check_every (+ the remainder if it
//   ran). Exit residuals are written for every lane, gated-off ones
//   included.
//
// bf16 storage (fused_solve_bf16_kernel, fused_solve_early_bf16_kernel): the
// four operators arrive rounded to bfloat16 and are converted to float32
// exactly (__bfloat162float) while they are staged into shared memory, so
// every use -- the w2 build (Minv, A), the iterations (K2) and the residuals
// (A, P) -- reads the rounded operators in float32, as the JAX kernel
// upcasts before every contraction (ops/admm_kernel.py:361-364). Vectors,
// the (x, y, z) carry and all sums stay float32. Only the staging differs.
//
// Cone layout [box (n_box) | SOC blocks (soc.d[0..n))]; Pi clips the box rows
// and applies the closed-form SOC projection (keep inside, zero in the polar
// cone, radial shrink otherwise, with the nrm > 0 guard) to each block, all
// after adding `shift` and before subtracting it again (has_shift = 0 adds
// nothing).
//
// What bounds it: at the C-ADMM headline (2048 lanes, nv = 16, m = 32,
// n_box = 24, d = 48, 20 iterations) one launch must read 14,472 B a lane,
// 29.6 MB in all, against about 214 MFLOP of float32 work: about 0.007
// operations a byte, far below the H100's float32 balance point (67 TFLOP/s
// over 3.35 TB/s, 20 operations a byte), so it is bound by memory bandwidth
// and by latency. The early-exit form does less work on the same bytes (a
// converged lane stops), and a gated-off lane needs neither K2 nor Minv, so
// its bound is lower still and still set by bytes. bf16 storage halves the
// operator bytes (7,816 B a lane at the headline instead of 14,472 B). What
// the design does
// about that: each lane's operators (K2, Minv, A, P) are read from device
// memory once per solve into shared memory and stay there across all
// iterations, instead of once per iteration; a gated-off lane skips K2 and
// Minv; the per-lane vectors live in registers.
//
// Design (simple and right first): one block per lane, one thread per row of
// K2 (d rows, block rounded up to whole warps), so a lane that converges
// simply stops iterating: the stop decision is reduced over the block and
// read back from shared memory behind a barrier, so every thread of the
// block takes it together and none leaves the barriers of an iteration.
// SOC norms are summed by each row of the block in order; residuals are
// reduced with warp shuffles and one pass over the warps.

#include <cuda_bf16.h>

#include "admm_common.cuh"

static __host__ __device__ size_t fs_smem_floats(int nv, int m) {
  const int d = nv + m;
  return (size_t)d * fs_odd(d) + (size_t)(2 * nv + m) * fs_odd(nv)
         + 2 * (size_t)d + FS_RED_FLOATS;
}

// One operator entry from global memory as float32 (exact for bfloat16).
__device__ __forceinline__ float fs_load(const float* p) { return *p; }
__device__ __forceinline__ float fs_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// OP is the operators' storage type (float or __nv_bfloat16).
template <bool EARLY, typename OP>
__device__ __forceinline__ void fused_solve_lane(
    const OP* __restrict__ K2g, const OP* __restrict__ Minvg,
    const OP* __restrict__ Ag, const OP* __restrict__ Pg,
    const float* __restrict__ qg, const float* __restrict__ rhog,
    const float* __restrict__ lbg, const float* __restrict__ ubg,
    const float* __restrict__ shiftg, const float* __restrict__ x0g,
    const float* __restrict__ y0g, const float* __restrict__ z0g,
    const float* __restrict__ activeg, float* __restrict__ xo,
    float* __restrict__ yo, float* __restrict__ zo, float* __restrict__ res,
    int* __restrict__ effo, int nv, int m, int n_box, int iters,
    int check_every, float tol, int has_shift, float alpha,
    float one_minus_alpha, const SocDims& soc) {
  extern __shared__ float smem[];
  const long long lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int d = nv + m;
  const int ld_d = fs_odd(d), ld_v = fs_odd(nv);

  float* sK2 = smem;                  // d x ld_d
  float* sMinv = sK2 + d * ld_d;      // nv x ld_v
  float* sP = sMinv + nv * ld_v;      // nv x ld_v
  float* sA = sP + nv * ld_v;         // m x ld_v
  float* su = sA + m * ld_v;          // d: [x; rho z - y], then x at exit
  float* szs = su + d;                // d: q / wq staging, pre-projection
  float* sred = szs + d;              // residual reduction scratch

  // A gated-off lane iterates 0 times: it needs neither K2 nor Minv.
  const bool gate = !EARLY || activeg == nullptr || activeg[lane] > 0.f;

  // Stage this lane's operators once (coalesced global reads), as float32
  // whatever their storage type.
  if (gate) {
    const OP* K2l = K2g + lane * d * d;
    for (int i = tid; i < d * d; i += nth)
      sK2[(i / d) * ld_d + i % d] = fs_load(K2l + i);
    const OP* Minvl = Minvg + lane * nv * nv;
    for (int i = tid; i < nv * nv; i += nth)
      sMinv[(i / nv) * ld_v + i % nv] = fs_load(Minvl + i);
  }
  const OP* Pl = Pg + lane * nv * nv;
  for (int i = tid; i < nv * nv; i += nth)
    sP[(i / nv) * ld_v + i % nv] = fs_load(Pl + i);
  const OP* Al = Ag + lane * m * nv;
  for (int i = tid; i < m * nv; i += nth)
    sA[(i / nv) * ld_v + i % nv] = fs_load(Al + i);

  const bool is_x = tid < nv;
  const bool is_row = tid >= nv && tid < d;
  const int r = tid - nv;
  float x = 0.f, q = 0.f, y = 0.f, z = 0.f, w = 0.f;
  RowConst rc = {1.f, 0.f, 0.f, 0.f, 0, 0};
  if (is_x) {
    x = x0g[lane * nv + tid];
    q = qg[lane * nv + tid];
    szs[tid] = q;
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

  int eff = 0;
  if (gate) {
    // qp-build tail: w2 = [Minv q; A (Minv q)], each row keeping its own
    // entry.
    if (is_x) {
      float acc = 0.f;
      const float* row = sMinv + tid * ld_v;
      for (int j = 0; j < nv; ++j) acc += row[j] * szs[j];
      w = acc;
    }
    __syncthreads();
    if (is_x) szs[tid] = w;
    __syncthreads();
    if (is_row) {
      float acc = 0.f;
      const float* row = sA + r * ld_v;
      for (int j = 0; j < nv; ++j) acc += row[j] * szs[j];
      w = acc;
    }
    __syncthreads();

    if (!EARLY) {
      for (int it = 0; it < iters; ++it)
        admm_iteration(sK2, ld_d, su, szs, tid, nv, d, n_box, w, rc,
                       has_shift, alpha, one_minus_alpha, x, y, z);
    } else {
      // Tolerance-chunked with the lane's own freeze: the masked loop of
      // the reference (ops/admm_kernel.py:442-491) for one lane.
      const int n_full = iters / check_every;
      const int rem = iters % check_every;
      float p, du;
      block_residuals(sA, sP, ld_v, su, szs, sred, tid, nth, nv, m, x, y, z,
                      q, &p, &du);
      bool above = p > tol || du > tol;
      int chunks = 0;
      while (above && chunks < n_full) {
        for (int it = 0; it < check_every; ++it)
          admm_iteration(sK2, ld_d, su, szs, tid, nv, d, n_box, w, rc,
                         has_shift, alpha, one_minus_alpha, x, y, z);
        ++chunks;
        block_residuals(sA, sP, ld_v, su, szs, sred, tid, nth, nv, m, x, y,
                        z, q, &p, &du);
        above = p > tol || du > tol;
      }
      eff = chunks * check_every;
      if (rem > 0 && above) {
        for (int it = 0; it < rem; ++it)
          admm_iteration(sK2, ld_d, su, szs, tid, nv, d, n_box, w, rc,
                         has_shift, alpha, one_minus_alpha, x, y, z);
        eff += rem;
      }
    }
  }

  // Exit residuals: prim over the m rows, dual over the nv columns.
  float p, du;
  block_residuals(sA, sP, ld_v, su, szs, sred, tid, nth, nv, m, x, y, z, q,
                  &p, &du);
  if (tid == 0) {
    res[lane * 2] = p;
    res[lane * 2 + 1] = du;
    if (EARLY) effo[lane] = eff;
  }
  if (is_x) {
    xo[lane * nv + tid] = x;
  } else if (is_row) {
    yo[lane * m + r] = y;
    zo[lane * m + r] = z;
  }
}

#define FS_PARAMS(OP)                                                         \
  const OP *__restrict__ K2g, const OP *__restrict__ Minvg,                   \
      const OP *__restrict__ Ag, const OP *__restrict__ Pg,                   \
      const float *__restrict__ qg, const float *__restrict__ rhog,           \
      const float *__restrict__ lbg, const float *__restrict__ ubg,           \
      const float *__restrict__ shiftg, const float *__restrict__ x0g,        \
      const float *__restrict__ y0g, const float *__restrict__ z0g,           \
      const float *__restrict__ activeg, float *__restrict__ xo,              \
      float *__restrict__ yo, float *__restrict__ zo,                        \
      float *__restrict__ res,                                                \
      int *__restrict__ effo, int nv, int m, int n_box, int iters,            \
      int check_every, float tol, int has_shift, float alpha,                 \
      float one_minus_alpha, SocDims soc
#define FS_ARGS                                                             \
  K2g, Minvg, Ag, Pg, qg, rhog, lbg, ubg, shiftg, x0g, y0g, z0g, activeg, xo, \
      yo, zo, res, effo, nv, m, n_box, iters, check_every, tol, has_shift,   \
      alpha, one_minus_alpha, soc

// Four kernels with distinct names (none a substring of another), so a
// trace tells the forms and storage types apart.
__global__ void fused_solve_kernel(FS_PARAMS(float)) {
  fused_solve_lane<false, float>(FS_ARGS);
}

__global__ void fused_solve_early_kernel(FS_PARAMS(float)) {
  fused_solve_lane<true, float>(FS_ARGS);
}

__global__ void fused_solve_bf16_kernel(FS_PARAMS(__nv_bfloat16)) {
  fused_solve_lane<false, __nv_bfloat16>(FS_ARGS);
}

__global__ void fused_solve_early_bf16_kernel(FS_PARAMS(__nv_bfloat16)) {
  fused_solve_lane<true, __nv_bfloat16>(FS_ARGS);
}

// check_every > 0 selects the early-exit kernel (then tol > 0 and eff must
// be given; active may be null); bf16 != 0 says K2, Minv, A and P are
// bfloat16 (else float32). Returns a cudaError_t.
extern "C" int fused_solve_launch(
    const void* K2, const void* Minv, const void* A, const void* P,
    const float* q, const float* rho, const float* lb, const float* ub,
    const float* shift, const float* x0, const float* y0, const float* z0,
    const float* active, float* xo, float* yo, float* zo, float* res,
    int* eff, int B, int nv, int m, int n_box, int iters, int check_every,
    float tol, int has_shift, int bf16, float alpha, float one_minus_alpha,
    SocDims soc, int device, cudaStream_t stream) {
  const bool early = check_every > 0;
  if (B < 0 || iters < 0 || !soc_layout_ok(nv, m, n_box, soc) ||
      (early && (!(tol > 0.f) || eff == nullptr)) ||
      (!early && active != nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  // This library's runtime keeps its own current device: launch on the
  // tensors' device, whose stream the caller passes.
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = fs_smem_floats(nv, m) * sizeof(float);
  const void* fn =
      bf16 ? (early ? (const void*)fused_solve_early_bf16_kernel
                    : (const void*)fused_solve_bf16_kernel)
           : (early ? (const void*)fused_solve_early_kernel
                    : (const void*)fused_solve_kernel);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int d = nv + m;
  const int threads = ((d + 31) / 32) * 32;
  if (!early) {
    eff = nullptr;
    check_every = 0;
    tol = 0.f;
  }
  const __nv_bfloat16* K2h = static_cast<const __nv_bfloat16*>(K2);
  const __nv_bfloat16* Minvh = static_cast<const __nv_bfloat16*>(Minv);
  const __nv_bfloat16* Ah = static_cast<const __nv_bfloat16*>(A);
  const __nv_bfloat16* Ph = static_cast<const __nv_bfloat16*>(P);
  const float* K2f = static_cast<const float*>(K2);
  const float* Minvf = static_cast<const float*>(Minv);
  const float* Af = static_cast<const float*>(A);
  const float* Pf = static_cast<const float*>(P);
#define FS_TAIL                                                              \
  q, rho, lb, ub, shift, x0, y0, z0, active, xo, yo, zo, res, eff, nv, m,    \
      n_box, iters, check_every, tol, has_shift, alpha, one_minus_alpha, soc
  if (bf16 && early)
    fused_solve_early_bf16_kernel<<<B, threads, smem, stream>>>(
        K2h, Minvh, Ah, Ph, FS_TAIL);
  else if (bf16)
    fused_solve_bf16_kernel<<<B, threads, smem, stream>>>(K2h, Minvh, Ah, Ph,
                                                          FS_TAIL);
  else if (early)
    fused_solve_early_kernel<<<B, threads, smem, stream>>>(K2f, Minvf, Af, Pf,
                                                           FS_TAIL);
  else
    fused_solve_kernel<<<B, threads, smem, stream>>>(K2f, Minvf, Af, Pf,
                                                     FS_TAIL);
#undef FS_TAIL
  return (int)cudaGetLastError();
}

extern "C" const char* fused_solve_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
