// Whole-solve batched ADMM for Hopper (sm_90a): one small conic QP per lane.
//
// Replaces the TPU kernel ops/admm_kernel.py _fused_solve_kernel of the JAX
// package (tpu_aerial_transport), in its compiled form (exact_dot=False),
// float32, with or without a cone shift, in both of its forms:
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
// its bound is lower still and still set by bytes. What the design does
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

#include "admm_common.cuh"

static __host__ __device__ size_t fs_smem_floats(int nv, int m) {
  const int d = nv + m;
  return (size_t)d * fs_odd(d) + (size_t)(2 * nv + m) * fs_odd(nv)
         + 2 * (size_t)d + FS_RED_FLOATS;
}

template <bool EARLY>
__device__ __forceinline__ void fused_solve_lane(
    const float* __restrict__ K2g, const float* __restrict__ Minvg,
    const float* __restrict__ Ag, const float* __restrict__ Pg,
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

  // Stage this lane's operators once (coalesced global reads).
  if (gate) {
    const float* K2l = K2g + lane * d * d;
    for (int i = tid; i < d * d; i += nth)
      sK2[(i / d) * ld_d + i % d] = K2l[i];
    const float* Minvl = Minvg + lane * nv * nv;
    for (int i = tid; i < nv * nv; i += nth)
      sMinv[(i / nv) * ld_v + i % nv] = Minvl[i];
  }
  const float* Pl = Pg + lane * nv * nv;
  for (int i = tid; i < nv * nv; i += nth)
    sP[(i / nv) * ld_v + i % nv] = Pl[i];
  const float* Al = Ag + lane * m * nv;
  for (int i = tid; i < m * nv; i += nth) sA[(i / nv) * ld_v + i % nv] = Al[i];

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

#define FS_PARAMS                                                             \
  const float *__restrict__ K2g, const float *__restrict__ Minvg,             \
      const float *__restrict__ Ag, const float *__restrict__ Pg,             \
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

__global__ void fused_solve_kernel(FS_PARAMS) {
  fused_solve_lane<false>(FS_ARGS);
}

__global__ void fused_solve_early_kernel(FS_PARAMS) {
  fused_solve_lane<true>(FS_ARGS);
}

// check_every > 0 selects the early-exit kernel (then tol > 0 and eff must
// be given; active may be null). Returns a cudaError_t.
extern "C" int fused_solve_launch(
    const float* K2, const float* Minv, const float* A, const float* P,
    const float* q, const float* rho, const float* lb, const float* ub,
    const float* shift, const float* x0, const float* y0, const float* z0,
    const float* active, float* xo, float* yo, float* zo, float* res,
    int* eff, int B, int nv, int m, int n_box, int iters, int check_every,
    float tol, int has_shift, float alpha, float one_minus_alpha, SocDims soc,
    int device, cudaStream_t stream) {
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
  const void* fn = early ? (const void*)fused_solve_early_kernel
                         : (const void*)fused_solve_kernel;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int d = nv + m;
  const int threads = ((d + 31) / 32) * 32;
  if (early)
    fused_solve_early_kernel<<<B, threads, smem, stream>>>(
        K2, Minv, A, P, q, rho, lb, ub, shift, x0, y0, z0, active, xo, yo, zo,
        res, eff, nv, m, n_box, iters, check_every, tol, has_shift, alpha,
        one_minus_alpha, soc);
  else
    fused_solve_kernel<<<B, threads, smem, stream>>>(
        K2, Minv, A, P, q, rho, lb, ub, shift, x0, y0, z0, nullptr, xo, yo,
        zo, res, nullptr, nv, m, n_box, iters, 0, 0.f, has_shift, alpha,
        one_minus_alpha, soc);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_solve_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
