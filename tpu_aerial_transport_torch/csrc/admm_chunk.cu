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
// port's whole-solve kernel, so a ragged lane count needs no padding.
//
// What bounds it: at the C-ADMM headline (2048 lanes, d = 48, 20
// iterations) one launch must read K2 (9,216 B), w2 and the per-row vectors
// and write x, y, z: 10,496 B a lane, 21.5 MB in all, against about 205
// MFLOP of float32 work, far below the H100's float32 balance point (20
// operations a byte): bound by memory bandwidth and by each lane's serial
// chain of iterations. Tensor cores do not apply: each lane is a
// matrix-vector product with its own K2 (N = 1), and the port keeps float32
// with TF32 off.
//
// Two bodies, chosen by the wrapper from the shape (nv, m) alone
// (ops/admm_kernel.py admm_chunk_geometry):
//
// - nv <= 32 and m <= 32 (every agent QP: C-ADMM d = 48, DD d = 56): one
//   warp per lane (warp_chunk_kernel<DR, XR>, DR = d rounded up to 8),
//   WS_LANES lanes a block, no block-wide barrier: the whole-solve kernel's
//   warp body (warp_common.cuh) without its A, P, Minv and residual state.
//   Thread t owns constraint row t, whose K2 row it holds in registers
//   (staged with 16-byte loads, all in flight at once), and x row t. u goes
//   through a per-warp buffer as 16-byte broadcasts; SOC norms and the
//   projection use warp shuffles, in one pass. The chunk keeps no other
//   operator, so it has registers to hold K2's x rows too. Two layouts of
//   the x rows (XR), chosen by the wrapper from nv:
//     WC_SPLIT   (nv <= 16) x row r in registers, its first DR / 2 entries
//                in thread r and the rest in thread r + 16, joined by one
//                shuffle (the sum runs in two halves, then adds them);
//     WC_SHARED  (nv > 16) x rows in the warp's shared memory, odd
//                16-byte-word stride, staged by cp.async (the whole-solve
//                warp body's layout).
//   Registers are capped at 128 a thread (__launch_bounds__), so 16 lanes
//   fit an SM. Whole x rows in every thread's registers as well as the
//   constraint row spill at that cap at DR = 48 and at DR = 56, and ran
//   slower than both layouts on an H100; WC_SPLIT does not spill at
//   DR = 48 and beats WC_SHARED there (chip_smoke.py phase 9 times both).
// - otherwise (C-ADMM's full QP at n = 8, d = 72; larger shapes): one block
//   per lane (admm_chunk_kernel), one thread per row of K2 (d rows, rounded
//   up to whole warps), in the whole-solve kernel's two layouts
//   (admm_common.cuh). From d = 65 to 128 the thread holds its K2 row in
//   registers, staged once by cp.async, and the iteration is rb_iteration:
//   u as 16-byte broadcasts from one of two buffers, one barrier, SOC norms
//   by shuffles; a budget of 136 registers keeps 5 lanes an SM up to d =
//   80. What bounds it on an H100: the chunk reads K2 once and iterates, so
//   at d = 72 a lane's chain of about 0.63 us an iteration, over the lanes
//   an SM holds, sets the time, several times the bytes it must read.
//   Other d keep K2 in shared memory (admm_iteration, two barriers).

#include "warp_common.cuh"

// ---------------------------------------------------------------------------
// The block body: one block per lane.
// ---------------------------------------------------------------------------

// One lane's shared memory in floats: the shared-row layout's K2 (odd row
// stride) and two d-vectors; the register-row layout's regions where it
// takes d (admm_common.cuh rb_smem).
static __host__ __device__ size_t chunk_smem_floats(int nv, int m) {
  const int d = nv + m;
  if (rb_takes(d)) return rb_smem(nv, m, false).total;
  return (size_t)d * fs_odd(d) + 2 * (size_t)d;
}

#define CHUNK_PARAMS                                                         \
  const float *__restrict__ K2g, const float *__restrict__ w2g,              \
      const float *__restrict__ rhog, const float *__restrict__ lbg,         \
      const float *__restrict__ ubg, const float *__restrict__ shiftg,       \
      const float *__restrict__ x0g, const float *__restrict__ y0g,          \
      const float *__restrict__ z0g, float *__restrict__ xo,                 \
      float *__restrict__ yo, float *__restrict__ zo, int nv, int m,         \
      int n_box, int iters, int has_shift, float alpha,                      \
      float one_minus_alpha, SocDims soc, int B

// The block body in the shared-row layout: K2 in shared memory, one thread
// a row (admm_common.cuh admm_iteration).
__device__ __forceinline__ void chunk_lane(CHUNK_PARAMS) {
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

// The block body in the register-row layout (rb_takes(d)): K2's rows in
// registers, one thread a row (admm_common.cuh rb_iteration).
template <int DR>
__device__ __forceinline__ void rb_chunk_lane(CHUNK_PARAMS) {
  extern __shared__ float4 rb_smem4[];
  float* smem = reinterpret_cast<float*>(rb_smem4);
  const long long lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int d = nv + m;
  const int ldd = rb_ld(d);
  const int usz = rb_ld16(DR);
  const RbSmem L = rb_smem(nv, m, false);
  float* sK2 = smem + L.k2;
  float* su = smem + L.u;  // two u buffers.
  float* szs = smem + L.zs;

  // Every entry of both u buffers is zero until written: the entries past
  // d meet zero K2 entries and must add exactly nothing.
  for (int e = tid; e < 2 * usz; e += nth) su[e] = 0.f;
  int ldk;
  const float* k2 =
      rb_stage_k2(sK2, ldd, K2g + lane * d * d, d, tid, nth, &ldk);
  RbRow s;
  rb_map(s, tid, nv, m, n_box, soc);
  rb_load_row(s, lane, nv, m, n_box, x0g, y0g, z0g, rhog, lbg, ubg, shiftg,
              has_shift);
  if (s.kind != RB_NONE) s.w = w2g[lane * d + s.i];
  int soc_max;
  const bool shfl = rb_soc_in_warps(soc, &soc_max);
  const bool warp_soc = (tid >> 5) * 32 < m - n_box;
  rb_cp_async_wait();
  __syncthreads();

  float kr[DR];
  rb_load_k2(kr, k2, ldk, s, d);
  rb_put_u(su, s);
  for (int it = 0; it < iters; ++it) {
    const int b = it & 1;
    __syncthreads();
    rb_iteration(kr, su + b * usz, su + (b ^ 1) * usz, szs, warp_soc, shfl,
                 soc_max, has_shift, alpha, one_minus_alpha, s);
  }

  if (s.kind == RB_X) {
    xo[lane * nv + s.i] = s.x;
  } else if (s.kind != RB_NONE) {
    yo[lane * m + s.r] = s.y;
    zo[lane * m + s.r] = s.z;
  }
}

// The block body's grid is one block a lane (B unused); its name is two
// overloads, one a layout. The shared-row layout has no launch bound: the
// compiler's own choice (32 registers a thread at d = 48) keeps 21 lanes an
// SM, where a 256-thread bound took 106 and 8 lanes, and ran slower on an
// H100.
__global__ void admm_chunk_kernel(CHUNK_PARAMS) {
  chunk_lane(K2g, w2g, rhog, lbg, ubg, shiftg, x0g, y0g, z0g, xo, yo, zo, nv,
             m, n_box, iters, has_shift, alpha, one_minus_alpha, soc, B);
}

// The register-row layout, DR the longest row of the instantiation, its
// register budget rb_budget's (admm_common.cuh RB_CHUNK_SHORT_REGS,
// RB_LONG_REGS).
template <int DR>
__global__ void __launch_bounds__(rb_threads(DR), rb_min_blocks(DR, false))
    admm_chunk_kernel(CHUNK_PARAMS) {
  rb_chunk_lane<DR>(K2g, w2g, rhog, lbg, ubg, shiftg, x0g, y0g, z0g, xo, yo,
                    zo, nv, m, n_box, iters, has_shift, alpha,
                    one_minus_alpha, soc, B);
}

// ---------------------------------------------------------------------------
// The warp body: one warp per lane (nv <= 32 and m <= 32).
// ---------------------------------------------------------------------------

// Layouts of K2's x rows (see the header).
#define WC_SHARED 0
#define WC_SPLIT 1
// The most x rows WC_SPLIT takes: one half row in each half-warp.
#define WC_SPLIT_MAX_NV 16

// One warp's shared memory, in floats: u (round8(d), zero past d), then
// under WC_SHARED K2's x rows (nv x ws_ld(round8(d)), zero past d).
static __host__ __device__ size_t wc_smem_floats(int nv, int m, int xr) {
  const int dr = ws_round8(nv + m);
  return (size_t)dr + (xr == WC_SHARED ? (size_t)nv * ws_ld(dr) : 0);
}

template <int DR, int XR>
__global__ void __launch_bounds__(WS_THREADS, WS_MIN_BLOCKS)
    warp_chunk_kernel(CHUNK_PARAMS) {
  extern __shared__ float4 wc_smem4[];
  const int t = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long lane = (long long)blockIdx.x * WS_LANES + warp;
  if (lane >= B) return;  // the whole warp: no barrier is left waiting.
  const int d = nv + m;
  const int ldx = ws_ld(DR);
  float* su = reinterpret_cast<float*>(wc_smem4) +
              (size_t)warp * wc_smem_floats(nv, m, XR);
  float* sKx = su + DR;  // WC_SHARED only.

  WsRows s;
  ws_load_rows(s, lane, t, nv, m, n_box, x0g, y0g, z0g, rhog, lbg, ubg,
               shiftg, has_shift, soc);
  if (s.has_x) s.wx = w2g[lane * d + t];
  if (s.has_c) s.wc = w2g[lane * d + nv + t];
  const int soc_max = ws_soc_max(soc);

  // K2's rows: constraint row t into registers; the x rows by layout.
  const float* K2l = K2g + lane * d * d;
  const bool vec = d % 4 == 0 && ws_aligned(K2g);
  float kc[DR];
  ws_load_row<DR>(kc, K2l + (size_t)(nv + t) * d, s.has_c ? d : 0, vec);
  constexpr int KX = XR == WC_SPLIT ? DR / 2 : 1;
  float kx[KX];
  const int h = t >> 4;  // WC_SPLIT: which half of x row t & 15 t holds.
  if constexpr (XR == WC_SPLIT) {
    const int r = t & 15;
    const int c0 = h * (DR / 2);
    const int n = r < nv ? min(max(d - c0, 0), DR / 2) : 0;
    ws_load_row<DR / 2>(kx, K2l + (size_t)r * d + c0, n, vec);
  } else {
    ws_stage(sKx, ldx, K2l, nv, d, t);
    if (s.has_x)
      for (int c = d; c < DR; ++c) sKx[t * ldx + c] = 0.f;
  }
  for (int i = d + t; i < DR; i += 32) su[i] = 0.f;
  const float4* kx4 =
      reinterpret_cast<const float4*>(s.has_x ? sKx + t * ldx : su);
  cp_async_wait_all();
  __syncwarp();

  const float4* su4 = reinterpret_cast<const float4*>(su);
  for (int it = 0; it < iters; ++it) {
    ws_put_u(su, t, nv, s);
    // Both sums run j ascending, one FMA a term (0 x 0 past d); under
    // WC_SPLIT the x row's two halves are summed apart and then added.
    float acc_c = 0.f, acc_x = 0.f;
#pragma unroll
    for (int q = 0; q < DR / 4; ++q) {
      const float4 u4 = su4[q];
      const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
      float xx[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (XR == WC_SHARED) {
        const float4 x4 = kx4[q];
        xx[0] = x4.x;
        xx[1] = x4.y;
        xx[2] = x4.z;
        xx[3] = x4.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc_c = fmaf(kc[4 * q + e], uu[e], acc_c);
        if constexpr (XR == WC_SHARED) acc_x = fmaf(xx[e], uu[e], acc_x);
      }
    }
    if constexpr (XR == WC_SPLIT) {
      const float4* uh = su4 + h * (DR / 8);
#pragma unroll
      for (int q = 0; q < DR / 8; ++q) {
        const float4 u4 = uh[q];
        const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc_x = fmaf(kx[4 * q + e], uu[e], acc_x);
      }
      acc_x += __shfl_xor_sync(0xffffffffu, acc_x, 16);
    }
    ws_finish(acc_c, acc_x, t, n_box, soc_max, has_shift, alpha,
              one_minus_alpha, s);
  }

  if (s.has_x) xo[lane * nv + t] = s.x;
  if (s.has_c) {
    yo[lane * m + t] = s.y;
    zo[lane * m + t] = s.z;
  }
}

// ---------------------------------------------------------------------------
// The launcher.
// ---------------------------------------------------------------------------

template <int DR>
static const void* wc_fn(int xr) {
  return xr == WC_SPLIT ? (const void*)warp_chunk_kernel<DR, WC_SPLIT>
                        : (const void*)warp_chunk_kernel<DR, WC_SHARED>;
}

// The launch of body (0: block, 1: warp with x-row layout xr) for (nv, m):
// kernel, block, grid and dynamic shared memory. Null fn when the body or
// layout does not take the shape.
struct WcLaunch {
  const void* fn;
  int lanes_per_block, threads;
  size_t smem;
};

static WcLaunch wc_launch_of(int body, int xr, int nv, int m) {
  const int d = nv + m;
  WcLaunch l = {nullptr, 1,
                rb_threads(d),
                chunk_smem_floats(nv, m) * sizeof(float)};
  if (body == 0) {
    switch (rb_takes(d) ? rb_bucket(d) : 0) {
      case 0:  // the shared-row overload: its type names no DR.
        l.fn = (const void*)static_cast<void (*)(CHUNK_PARAMS)>(
            admm_chunk_kernel);
        break;
      case 72: l.fn = (const void*)admm_chunk_kernel<72>; break;
      case 80: l.fn = (const void*)admm_chunk_kernel<80>; break;
      case 112: l.fn = (const void*)admm_chunk_kernel<112>; break;
      default: l.fn = (const void*)admm_chunk_kernel<RB_MAX_D>; break;
    }
    return l;
  }
  if (body != 1 || nv > WS_MAX_ROWS || m > WS_MAX_ROWS || xr < WC_SHARED ||
      xr > WC_SPLIT || (xr == WC_SPLIT && nv > WC_SPLIT_MAX_NV))
    return l;
  l.lanes_per_block = WS_LANES;
  l.threads = WS_THREADS;
  l.smem = WS_LANES * wc_smem_floats(nv, m, xr) * sizeof(float);
  switch (ws_round8(d) / 8) {
    case 1: l.fn = wc_fn<8>(xr); break;
    case 2: l.fn = wc_fn<16>(xr); break;
    case 3: l.fn = wc_fn<24>(xr); break;
    case 4: l.fn = wc_fn<32>(xr); break;
    case 5: l.fn = wc_fn<40>(xr); break;
    case 6: l.fn = wc_fn<48>(xr); break;
    case 7: l.fn = wc_fn<56>(xr); break;
    default: l.fn = wc_fn<64>(xr); break;
  }
  return l;
}

static cudaError_t wc_prepare(const WcLaunch& l) {
  if (l.smem > 48 * 1024)
    return cudaFuncSetAttribute(
        l.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
  return cudaSuccess;
}

// body 1 is the warp body (nv and m at most WS_MAX_ROWS) with x-row layout
// x_rows (WC_*), 0 the block body (x_rows ignored). Returns a cudaError_t.
extern "C" int admm_chunk_launch(
    const float* K2, const float* w2, const float* rho, const float* lb,
    const float* ub, const float* shift, const float* x0, const float* y0,
    const float* z0, float* xo, float* yo, float* zo, int B, int nv, int m,
    int n_box, int iters, int has_shift, int body, int x_rows, float alpha,
    float one_minus_alpha, SocDims soc, int device, cudaStream_t stream) {
  if (B < 0 || iters < 0 || !soc_layout_ok(nv, m, n_box, soc))
    return (int)cudaErrorInvalidValue;
  const WcLaunch l = wc_launch_of(body, x_rows, nv, m);
  if (l.fn == nullptr) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  // This library's runtime keeps its own current device: launch on the
  // tensors' device, whose stream the caller passes.
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = wc_prepare(l);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&K2, &w2, &rho, &lb, &ub, &shift, &x0, &y0, &z0, &xo,
                  &yo, &zo, &nv, &m, &n_box, &iters, &has_shift, &alpha,
                  &one_minus_alpha, &soc, &B};
  const unsigned blocks =
      (unsigned)((B + l.lanes_per_block - 1) / l.lanes_per_block);
  e = cudaLaunchKernel(l.fn, dim3(blocks), dim3(l.threads), args, l.smem,
                       stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// What a launch of (body, x_rows) for (nv, m) is, for the report: out =
// {lanes a block, threads a block, dynamic shared memory a block (bytes),
// registers a thread, local memory a thread (bytes: spills), resident lanes
// an SM}.
extern "C" int admm_chunk_info(int nv, int m, int body, int x_rows,
                               int device, int* out) {
  const WcLaunch l = wc_launch_of(body, x_rows, nv, m);
  if (l.fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = wc_prepare(l);
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

extern "C" const char* admm_chunk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
