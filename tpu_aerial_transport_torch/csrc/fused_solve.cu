// Whole-solve batched ADMM for Hopper (sm_90a): one small conic QP per lane.
//
// Replaces the TPU kernel ops/admm_kernel.py _fused_solve_kernel of the JAX
// package (tpu_aerial_transport), in its compiled form (exact_dot=False),
// with or without a cone shift, in both of its forms and both operator
// storage types (float32, or bfloat16 for K2, Minv, A and P: the JAX
// package's precision="bf16", ops/admm_kernel.py:541-546 and :574-579):
//
// - fixed-iteration: per lane
//     wq = Minv q,  w2 = [wq; A wq]
//     repeat iters:  v = K2 [x; rho z - y] - w2;  x = v[:nv]
//                    Ax_rel = alpha v[nv:] + (1 - alpha) z
//                    z = Pi(Ax_rel + y / rho)      (translated box x SOC)
//                    y = y + rho (Ax_rel - z)
//     prim = max|A x - z|,  dual = max|P x + q + A^T y|
// - early exit (check_every > 0 and tol > 0): the iterations run in chunks
//   of check_every. The lane stops as soon as (prim > tol) | (dual > tol)
//   is false at a chunk boundary -- the first test comes before any
//   iteration, and a NaN residual compares false, so a non-finite lane
//   stops too -- or after iters // check_every chunks, followed by one
//   remainder chunk of iters % check_every if the lane is still above tol.
//   An optional gate (active[lane] > 0) switches a lane off from the start:
//   it runs 0 iterations and passes its warm start through. eff[lane] =
//   chunks run x check_every (+ the remainder if it ran). Exit residuals
//   are written for every lane, gated-off ones included.
//
// bf16 storage: the four operators arrive rounded to bfloat16 and are
// converted to float32 exactly (__bfloat162float) as they are staged, so
// every use -- the w2 build (Minv, A), the iterations (K2) and the residuals
// (A, P) -- reads the rounded operators in float32, as the JAX kernel
// upcasts before every contraction (ops/admm_kernel.py:361-364). Vectors,
// the (x, y, z) carry and all sums stay float32. Only the staging differs.
//
// Cone layout [box (n_box) | SOC blocks (soc.d[0..n))]; Pi clips the box rows
// and applies the closed-form SOC projection (keep inside, zero in the polar
// cone, radial shrink otherwise, with the nrm > 0 guard) to each block, all
// after adding `shift` and before subtracting it again (has_shift = 0 adds
// nothing). The warp body sums every K2 row in one chain, j = 0..d-1, one
// FMA a term (d <= 64); the shared-memory body (d > 64 at every shape it
// takes: 67, 72, 79, 111) sums a row in eight chains added pairwise
// (admm_common.cuh admm_iteration), which keeps its rounding within the
// kernel bar of the plain version's.
//
// What bounds it: at the C-ADMM headline (2048 lanes, nv = 16, m = 32,
// n_box = 24, d = 48, 20 iterations) one launch must read 14,472 B a lane,
// 29.6 MB in all, against about 214 MFLOP of float32 work: about 0.007
// operations a byte, far below the H100's float32 balance point (67 TFLOP/s
// over 3.35 TB/s, 20 operations a byte), so it is bound by memory bandwidth
// and by latency. The early-exit form does less work on the same bytes (a
// converged lane stops), and a gated-off lane needs neither K2 nor Minv.
// bf16 storage halves the operator bytes (7,816 B a lane at the headline).
//
// Two bodies, chosen by the wrapper from the shape (nv, m) alone:
//
// - nv <= 32 and m <= 32 (every agent QP: C-ADMM d = 48, DD and the n = 3
//   full QP d = 56): one warp per lane, WS_LANES lanes a block, no
//   block-wide barrier. Lane thread t owns constraint row t and x row t.
//   Constraint row t of K2 lives in the thread's registers (float32,
//   loaded once with 16-byte loads, 8 values a load in bf16); the x rows
//   live in the warp's shared memory with a row stride of an odd number of
//   16-byte words, so the threads' 16-byte row reads hit distinct banks.
//   Both rows run j = 0..d-1 (then 0 x 0 up to a whole 8-entry word). The
//   iterate u = [x; rho z - y] goes through a per-warp buffer behind
//   __syncwarp and is read as 16-byte broadcasts, one load serving both
//   rows' FMAs; the SOC norms gather their block's values by warp
//   shuffles, and every constraint row projects once, in one branch-free
//   pass of the warp. Residuals and the early-exit decision are warp
//   shuffles, so a converged lane's warp simply stops. A, P and K2's x rows are staged
//   with no per-element division: float32 by asynchronous 16-byte copies
//   (cp.async), all in flight at once; bfloat16 by 16-byte loads, four a
//   thread in flight, converted on the way. Minv is read from device
//   memory once, for the w2 build. Registers are capped at 128 a thread
//   (__launch_bounds__) and a lane takes 7.3 KB of shared memory at d = 48
//   and 12.1 KB at d = 56, so 16 lanes fit an SM and the headline's 2048
//   lanes are resident at once. What is left (measured on an H100): the
//   staging runs near the byte bound, and each iteration costs its serial
//   chain (d dependent FMAs, the division by rho, the projection) and the
//   shared-memory reads of the x rows and of u, 16 lanes an SM sharing one
//   shared-memory pipe; holding the x rows in registers as well would
//   need more than the 128 registers that keep 16 lanes an SM.
// - otherwise (the centralized QPs: d = 67 at the entry, 79 at n = 4, up
//   to 127; C-ADMM's full QP from n = 8): one block per lane, one thread
//   per row of K2 (d rows, rounded up to whole warps), every operator
//   staged once into shared memory with odd row strides; the stop decision
//   is reduced over the block and read back behind a barrier, so every
//   thread takes it together.
//
// The warp body's staging, broadcasts and projection live in
// warp_common.cuh, shared with the chunk kernel's warp body.

#include "warp_common.cuh"

// ---------------------------------------------------------------------------
// The shared-memory body: one block per lane (every other shape).
// ---------------------------------------------------------------------------

static __host__ __device__ size_t fs_smem_floats(int nv, int m) {
  const int d = nv + m;
  return (size_t)d * fs_odd(d) + (size_t)(2 * nv + m) * fs_odd(nv)
         + 2 * (size_t)d + FS_RED_FLOATS;
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

// ---------------------------------------------------------------------------
// The warp body: one warp per lane (nv <= 32 and m <= 32).
// ---------------------------------------------------------------------------

// acc = sum_{c < n} row[c] v[c], c ascending, one FMA a term; 16-byte
// shared reads (both arrays hold whole 16-byte words past n).
__device__ __forceinline__ float ws_dot(const float* row, const float* v,
                                        int n) {
  float acc = 0.f;
  for (int c0 = 0; c0 < n; c0 += 4) {
    const float4 a4 = *reinterpret_cast<const float4*>(row + c0);
    const float4 v4 = *reinterpret_cast<const float4*>(v + c0);
    const float av[4] = {a4.x, a4.y, a4.z, a4.w};
    const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c0 + e < n) acc = fmaf(av[e], vv[e], acc);
  }
  return acc;
}

// One ADMM iteration of the lane (admm_iteration's order of operations):
// ws_put_u, both K2 sums, ws_finish. kc is constraint row t of K2
// (registers), kx x row t (shared memory; u itself for a thread without an
// x row, whose sum is then unused). Both run j = 0..DR-1, one FMA a term;
// the entries past d are 0 x 0, which adds exactly nothing to a sum that
// starts at +0.
template <int DR>
__device__ __forceinline__ void ws_iteration(
    const float (&kc)[DR], const float* kx, float* su, int t, int nv,
    int n_box, int soc_max, int has_shift, float alpha,
    float one_minus_alpha, WsRows& s) {
  ws_put_u(su, t, nv, s);
  float acc_c = 0.f, acc_x = 0.f;
#pragma unroll
  for (int q = 0; q < DR / 4; ++q) {
    const float4 u4 = reinterpret_cast<const float4*>(su)[q];
    const float4 x4 = reinterpret_cast<const float4*>(kx)[q];
    const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
    const float xx[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_c = fmaf(kc[4 * q + e], uu[e], acc_c);
      acc_x = fmaf(xx[e], uu[e], acc_x);
    }
  }
  ws_finish(acc_c, acc_x, t, n_box, soc_max, has_shift, alpha,
            one_minus_alpha, s);
}

// The lane's residuals, prim = max_r |A x - z|_r and dual = max_c |P x + q
// + A^T y|_c, in block_residuals' order, reduced over the warp
// (NaN-propagating); every thread gets both.
__device__ __forceinline__ void ws_residuals(const float* sA,
                                             const float* sP, int ldv,
                                             float* su, float* sy, int t,
                                             int nv, int m, const WsRows& s,
                                             const float* __restrict__ ql,
                                             float* prim, float* dual) {
  __syncwarp();
  if (s.has_x) su[t] = s.x;
  if (s.has_c) sy[t] = s.y;
  __syncwarp();
  float pv = 0.f, dv = 0.f;
  if (s.has_c) pv = fabsf(ws_dot(sA + t * ldv, su, nv) - s.z);
  if (s.has_x) {
    const float px = ws_dot(sP + t * ldv, su, nv);
    float aty = 0.f;
    for (int rr = 0; rr < m; ++rr) aty += sA[rr * ldv + t] * sy[rr];
    dv = fabsf(px + ql[t] + aty);
  }
  *prim = warp_nan_max(pv);
  *dual = warp_nan_max(dv);
}

// wq = Minv q for x row t, from device memory (row t of the lane's Minv,
// j ascending); q is in su.
template <typename OP>
__device__ __forceinline__ float ws_minv_q(const OP* __restrict__ Minvl,
                                           const float* su, int nv, int t,
                                           bool vec) {
  constexpr int VW = 16 / sizeof(OP);
  const OP* row = Minvl + (size_t)t * nv;
  float acc = 0.f;
  if (vec) {
    for (int j0 = 0; j0 < nv; j0 += VW) {
      float v[VW];
      ws_load16(row + j0, v);
#pragma unroll
      for (int e = 0; e < VW; ++e) acc += v[e] * su[j0 + e];
    }
  } else {
    for (int j = 0; j < nv; ++j) acc += fs_load(row + j) * su[j];
  }
  return acc;
}

template <bool EARLY, typename OP, int DR>
__device__ __forceinline__ void warp_solve_lane(
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
    float one_minus_alpha, const SocDims& soc, int B) {
  extern __shared__ float4 ws_smem4[];
  const int t = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long lane = (long long)blockIdx.x * WS_LANES + warp;
  if (lane >= B) return;  // the whole warp: no barrier is left waiting.
  const int d = nv + m;
  const int ldv = ws_ld(nv), ldx = ws_ld(DR);
  float* sA = reinterpret_cast<float*>(ws_smem4) +
              (size_t)warp * ws_smem_floats(nv, m);
  float* sP = sA + m * ldv;
  float* sKx = sP + nv * ldv;  // K2's x rows, zero past d.
  float* su = sKx + nv * ldx;  // DR entries, zero past d.
  float* sy = su + DR;

  // A gated-off lane iterates 0 times: it needs neither K2 nor Minv.
  const bool gate = !EARLY || activeg == nullptr || activeg[lane] > 0.f;
  constexpr int VW = 16 / sizeof(OP);

  WsRows s;
  ws_load_rows(s, lane, t, nv, m, n_box, x0g, y0g, z0g, rhog, lbg, ubg,
               shiftg, has_shift, soc);
  const float* ql = qg + lane * nv;  // read where used: q is not carried.
  const int soc_max = ws_soc_max(soc);

  float kc[DR];
  const OP* K2l = K2g + lane * d * d;
  if (gate) {
    const bool vec = d % VW == 0 && ws_aligned(K2g);
    ws_load_row<DR>(kc, K2l + (size_t)(nv + t) * d, s.has_c ? d : 0, vec);
    ws_stage(sKx, ldx, K2l, nv, d, t);
    if (s.has_x)
      for (int c = d; c < DR; ++c) sKx[t * ldx + c] = 0.f;
  }
  ws_stage(sA, ldv, Ag + lane * m * nv, m, nv, t);
  ws_stage(sP, ldv, Pg + lane * nv * nv, nv, nv, t);
  for (int i = d + t; i < DR; i += 32) su[i] = 0.f;
  const float* kx = s.has_x ? sKx + t * ldx : su;
  cp_async_wait_all();
  __syncwarp();

  int eff = 0;
  if (gate) {
    // qp-build tail: w2 = [Minv q; A (Minv q)].
    if (s.has_x) su[t] = ql[t];
    __syncwarp();
    const bool mvec = nv % VW == 0 && ws_aligned(Minvg);
    if (s.has_x) s.wx = ws_minv_q(Minvg + lane * nv * nv, su, nv, t, mvec);
    __syncwarp();
    if (s.has_x) su[t] = s.wx;
    __syncwarp();
    if (s.has_c) s.wc = ws_dot(sA + t * ldv, su, nv);
    __syncwarp();

    if (!EARLY) {
      for (int it = 0; it < iters; ++it)
        ws_iteration<DR>(kc, kx, su, t, nv, n_box, soc_max, has_shift,
                         alpha, one_minus_alpha, s);
    } else {
      // Tolerance-chunked with the lane's own freeze: the masked loop of
      // the reference (ops/admm_kernel.py:442-491) for one lane.
      const int n_full = iters / check_every;
      const int rem = iters % check_every;
      float p, du;
      ws_residuals(sA, sP, ldv, su, sy, t, nv, m, s, ql, &p, &du);
      bool above = p > tol || du > tol;
      int chunks = 0;
      while (above && chunks < n_full) {
        for (int it = 0; it < check_every; ++it)
          ws_iteration<DR>(kc, kx, su, t, nv, n_box, soc_max, has_shift,
                           alpha, one_minus_alpha, s);
        ++chunks;
        ws_residuals(sA, sP, ldv, su, sy, t, nv, m, s, ql, &p, &du);
        above = p > tol || du > tol;
      }
      eff = chunks * check_every;
      if (rem > 0 && above) {
        for (int it = 0; it < rem; ++it)
          ws_iteration<DR>(kc, kx, su, t, nv, n_box, soc_max, has_shift,
                           alpha, one_minus_alpha, s);
        eff += rem;
      }
    }
  }

  // Exit residuals: prim over the m rows, dual over the nv columns.
  float p, du;
  ws_residuals(sA, sP, ldv, su, sy, t, nv, m, s, ql, &p, &du);
  if (t == 0) {
    res[lane * 2] = p;
    res[lane * 2 + 1] = du;
    if (EARLY) effo[lane] = eff;
  }
  if (s.has_x) xo[lane * nv + t] = s.x;
  if (s.has_c) {
    yo[lane * m + t] = s.y;
    zo[lane * m + t] = s.z;
  }
}

// ---------------------------------------------------------------------------
// Entry points and the launcher.
// ---------------------------------------------------------------------------

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
      float one_minus_alpha, SocDims soc, int B
#define FS_ARGS                                                             \
  K2g, Minvg, Ag, Pg, qg, rhog, lbg, ubg, shiftg, x0g, y0g, z0g, activeg, xo, \
      yo, zo, res, effo, nv, m, n_box, iters, check_every, tol, has_shift,   \
      alpha, one_minus_alpha, soc

// Eight kernels with distinct names (none a substring of another), so a
// trace tells the bodies, forms and storage types apart. The shared-memory
// body's grid is one block a lane (B unused).
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

// The warp body, with K2's rows DR = d rounded up to 8 entries long.
template <int DR>
__global__ void __launch_bounds__(WS_THREADS, WS_MIN_BLOCKS)
    warp_solve_kernel(FS_PARAMS(float)) {
  warp_solve_lane<false, float, DR>(FS_ARGS, B);
}

template <int DR>
__global__ void __launch_bounds__(WS_THREADS, WS_MIN_BLOCKS)
    warp_solve_early_kernel(FS_PARAMS(float)) {
  warp_solve_lane<true, float, DR>(FS_ARGS, B);
}

template <int DR>
__global__ void __launch_bounds__(WS_THREADS, WS_MIN_BLOCKS)
    warp_solve_bf16_kernel(FS_PARAMS(__nv_bfloat16)) {
  warp_solve_lane<false, __nv_bfloat16, DR>(FS_ARGS, B);
}

template <int DR>
__global__ void __launch_bounds__(WS_THREADS, WS_MIN_BLOCKS)
    warp_solve_early_bf16_kernel(FS_PARAMS(__nv_bfloat16)) {
  warp_solve_lane<true, __nv_bfloat16, DR>(FS_ARGS, B);
}

template <int DR>
static const void* ws_fn(bool early, bool bf16) {
  return bf16 ? (early ? (const void*)warp_solve_early_bf16_kernel<DR>
                       : (const void*)warp_solve_bf16_kernel<DR>)
              : (early ? (const void*)warp_solve_early_kernel<DR>
                       : (const void*)warp_solve_kernel<DR>);
}

// The launch of body (0: shared memory, 1: warp) for (nv, m): kernel,
// block, grid and dynamic shared memory. Null fn when the body does not
// take d.
struct FsLaunch {
  const void* fn;
  int lanes_per_block, threads;
  size_t smem;
};

static FsLaunch fs_launch_of(int body, int nv, int m, bool early, bool bf16) {
  const int d = nv + m;
  FsLaunch l = {nullptr, 1, ((d + 31) / 32) * 32,
                fs_smem_floats(nv, m) * sizeof(float)};
  if (body == 0) {
    l.fn = bf16 ? (early ? (const void*)fused_solve_early_bf16_kernel
                         : (const void*)fused_solve_bf16_kernel)
                : (early ? (const void*)fused_solve_early_kernel
                         : (const void*)fused_solve_kernel);
    return l;
  }
  if (body != 1 || nv > WS_MAX_ROWS || m > WS_MAX_ROWS) return l;
  l.lanes_per_block = WS_LANES;
  l.threads = WS_THREADS;
  l.smem = WS_LANES * ws_smem_floats(nv, m) * sizeof(float);
  switch (ws_round8(d) / 8) {
    case 1: l.fn = ws_fn<8>(early, bf16); break;
    case 2: l.fn = ws_fn<16>(early, bf16); break;
    case 3: l.fn = ws_fn<24>(early, bf16); break;
    case 4: l.fn = ws_fn<32>(early, bf16); break;
    case 5: l.fn = ws_fn<40>(early, bf16); break;
    case 6: l.fn = ws_fn<48>(early, bf16); break;
    case 7: l.fn = ws_fn<56>(early, bf16); break;
    default: l.fn = ws_fn<64>(early, bf16); break;
  }
  return l;
}

static cudaError_t fs_prepare(const FsLaunch& l) {
  if (l.smem > 48 * 1024)
    return cudaFuncSetAttribute(
        l.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
  return cudaSuccess;
}

// check_every > 0 selects the early-exit form (then tol > 0 and eff must
// be given; active may be null); bf16 != 0 says K2, Minv, A and P are
// bfloat16 (else float32); body 1 is the warp body (nv and m at most
// WS_MAX_ROWS), 0 the shared-memory body. Returns a cudaError_t.
extern "C" int fused_solve_launch(
    const void* K2, const void* Minv, const void* A, const void* P,
    const float* q, const float* rho, const float* lb, const float* ub,
    const float* shift, const float* x0, const float* y0, const float* z0,
    const float* active, float* xo, float* yo, float* zo, float* res,
    int* eff, int B, int nv, int m, int n_box, int iters, int check_every,
    float tol, int has_shift, int bf16, int body, float alpha,
    float one_minus_alpha, SocDims soc, int device, cudaStream_t stream) {
  const bool early = check_every > 0;
  if (B < 0 || iters < 0 || !soc_layout_ok(nv, m, n_box, soc) ||
      (early && (!(tol > 0.f) || eff == nullptr)) ||
      (!early && active != nullptr))
    return (int)cudaErrorInvalidValue;
  const FsLaunch l = fs_launch_of(body, nv, m, early, bf16 != 0);
  if (l.fn == nullptr) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  // This library's runtime keeps its own current device: launch on the
  // tensors' device, whose stream the caller passes.
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = fs_prepare(l);
  if (e != cudaSuccess) return (int)e;
  if (!early) {
    eff = nullptr;
    check_every = 0;
    tol = 0.f;
  }
  void* args[] = {&K2, &Minv, &A, &P, &q, &rho, &lb, &ub, &shift, &x0,
                  &y0, &z0, &active, &xo, &yo, &zo, &res, &eff, &nv, &m,
                  &n_box, &iters, &check_every, &tol, &has_shift, &alpha,
                  &one_minus_alpha, &soc, &B};
  const unsigned blocks =
      (unsigned)((B + l.lanes_per_block - 1) / l.lanes_per_block);
  e = cudaLaunchKernel(l.fn, dim3(blocks), dim3(l.threads), args, l.smem,
                       stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// What a launch of body for (nv, m) is, for the report: out = {lanes a
// block, threads a block, dynamic shared memory a block (bytes), registers
// a thread, local memory a thread (bytes: spills), resident lanes an SM}.
extern "C" int fused_solve_info(int nv, int m, int bf16, int early, int body,
                                int device, int* out) {
  const FsLaunch l = fs_launch_of(body, nv, m, early != 0, bf16 != 0);
  if (l.fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = fs_prepare(l);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, l.fn);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, l.fn,
                                                      l.threads, l.smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = l.lanes_per_block;
  out[1] = l.threads;
  out[2] = (int)l.smem;
  out[3] = attr.numRegs;
  out[4] = (int)attr.localSizeBytes;
  out[5] = blocks * l.lanes_per_block;
  return (int)cudaSuccess;
}

extern "C" const char* fused_solve_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
