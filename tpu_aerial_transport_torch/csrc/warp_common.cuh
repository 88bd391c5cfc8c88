// The warp body's pieces shared by the port's warp-per-lane kernels
// (fused_solve.cu warp_solve_*kernel, admm_chunk.cu warp_chunk_kernel): one
// warp per lane, WS_LANES lanes a block, no block-wide barrier. Lane thread t
// owns constraint row t (its y, z, rho, bounds and shift in registers) and,
// where it has one, x row t. Here: the launch constants, operator loads and
// staging (16-byte loads, cp.async), the exact division and square root, and
// the iteration's two ends around the K2 sums -- the broadcast of
// u = [x; rho z - y] through the warp's buffer, and the finish: the x
// update, over-relaxation, the SOC norms by warp shuffles, the branch-free
// translated box x SOC projection and the dual update.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "admm_common.cuh"

// One operator entry from global memory as float32 (exact for bfloat16).
__device__ __forceinline__ float fs_load(const float* p) { return *p; }
__device__ __forceinline__ float fs_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

#define WS_LANES 4
#define WS_THREADS (32 * WS_LANES)
// The most x rows and the most constraint rows the warp body takes: one of
// each a thread.
#define WS_MAX_ROWS 32
// Blocks an SM must be able to hold: caps registers at 65536 / (16 x 32) =
// 128 a thread, so 16 lanes fit an SM.
#define WS_MIN_BLOCKS (16 / WS_LANES)

static __host__ __device__ __forceinline__ int ws_round4(int k) {
  return (k + 3) & ~3;
}

// d rounded up to whole 8-entry words: the length of K2's rows in the
// warp body (registers and shared memory), zero past d.
static __host__ __device__ __forceinline__ int ws_round8(int k) {
  return (k + 7) & ~7;
}

// A shared-memory row stride for k floats: whole 16-byte words, an odd
// number of them.
static __host__ __device__ __forceinline__ int ws_ld(int k) {
  const int r = ws_round4(k);
  return ((r >> 2) & 1) ? r : r + 4;
}

// One warp's shared memory, in floats: A (m x ldv), P (nv x ldv), K2's x
// rows (nv x ld of round8(d)), u (round8(d)), y for the residuals (m).
static __host__ __device__ size_t ws_smem_floats(int nv, int m) {
  const int dr = ws_round8(nv + m);
  return (size_t)(m + nv) * ws_ld(nv) + (size_t)nv * ws_ld(dr) + dr +
         ws_round4(m);
}

// 16 bytes of operator entries from device memory as float32.
__device__ __forceinline__ void ws_load16(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void ws_load16(const __nv_bfloat16* p, float* v) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // low half first: little-endian pairs.
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

template <typename OP>
__device__ __forceinline__ bool ws_aligned(const OP* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 16 bytes from device memory into shared memory without passing through
// registers; complete after cp_async_wait_all.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy a rows x cols row-major operator block into shared memory (float32,
// row stride ld), by the warp's 32 threads, 16 bytes a copy where the rows
// are whole 16-byte words (one entry a copy otherwise). float32 goes
// asynchronously (cp.async), bfloat16 through registers, four copies a
// thread in flight. Each thread steps its (row, column) by the warp's
// stride instead of dividing per element.
template <typename OP>
__device__ __forceinline__ void ws_stage(float* __restrict__ dst, int ld,
                                         const OP* __restrict__ src,
                                         int rows, int cols, int t) {
  constexpr int VW = 16 / sizeof(OP);
  constexpr int U = 4;
  if (rows <= 0) return;
  const bool vec = cols % VW == 0 && ws_aligned(src);
  const int step = vec ? VW : 1;
  const int per_row = cols / step;
  const int n = rows * per_row;
  const int dr = 32 / per_row, dc = 32 - dr * per_row;
  int row = t / per_row, col = t - row * per_row;
  if constexpr (sizeof(OP) == 4) {
    if (vec) {
      for (int i = t; i < n; i += 32) {
        cp_async16(dst + row * ld + col * VW, src + (size_t)i * VW);
        row += dr;
        col += dc;
        if (col >= per_row) {
          col -= per_row;
          ++row;
        }
      }
      return;
    }
  }
  for (int i0 = t; i0 < n; i0 += 32 * U) {
    float v[U][VW];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + 32 * u;
      if (i < n) {
        if (vec) ws_load16(src + (size_t)i * VW, v[u]);
        else v[u][0] = fs_load(src + i);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + 32 * u >= n) break;
      float* o = dst + row * ld + col * step;
      if (vec) {
#pragma unroll
        for (int e = 0; e < VW; e += 4)
          *reinterpret_cast<float4*>(o + e) =
              make_float4(v[u][e], v[u][e + 1], v[u][e + 2], v[u][e + 3]);
      } else {
        *o = v[u][0];
      }
      row += dr;
      col += dc;
      if (col >= per_row) {
        col -= per_row;
        ++row;
      }
    }
  }
}

// One K2 row (d entries) into registers, zero past d.
template <int DR, typename OP>
__device__ __forceinline__ void ws_load_row(float (&k)[DR],
                                            const OP* __restrict__ row,
                                            int d, bool vec) {
  constexpr int VW = 16 / sizeof(OP);
  if (vec) {
#pragma unroll
    for (int q = 0; q < DR / VW; ++q) {
      float v[VW];
      if (q * VW < d) {
        ws_load16(row + q * VW, v);
      } else {
#pragma unroll
        for (int e = 0; e < VW; ++e) v[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VW; ++e) k[q * VW + e] = v[e];
    }
  } else {
#pragma unroll
    for (int j = 0; j < DR; ++j) k[j] = j < d ? fs_load(row + j) : 0.f;
  }
}

// a / b rounded as `/` rounds, for b nonzero and not NaN. A zero
// dividend takes its exact quotient (a zero with the sign of a x b)
// instead of the division's slow path, which zeros are sent down: y = 0
// on every inactive row.
__device__ __forceinline__ float ws_div(float a, float b) {
  const float q = (a == 0.f ? 1.f : a) / b;
  return a == 0.f ? __int_as_float((__float_as_int(a) ^ __float_as_int(b)) &
                                   0x80000000)
                  : q;
}

// sqrtf(x) for x >= 0 or NaN; zero takes its exact root (itself) instead of
// the square root's slow path. The branch-free projection takes a root on
// every row, and a box row's sum of squares is 0.
__device__ __forceinline__ float ws_sqrt(float x) {
  const float r = sqrtf(x == 0.f ? 1.f : x);
  return x == 0.f ? x : r;
}

// What lane thread t holds: x row t (when t < nv) and constraint row t
// (when t < m), with the constraint row's constants.
struct WsRows {
  bool has_x, has_c;
  float x, wx;             // x row.
  float y, z, wc, ax_rel;  // constraint row (ax_rel within an iteration).
  RowConst rc;
};

// The iteration's first end: this thread's entries of u = [x; rho z - y]
// into the warp's buffer, then one __syncwarp.
__device__ __forceinline__ void ws_put_u(float* su, int t, int nv,
                                         const WsRows& s) {
  if (s.has_x) su[t] = s.x;
  if (s.has_c) su[nv + t] = s.rc.rho * s.z - s.y;
  __syncwarp();
}

// The iteration's other end, given this thread's two K2 sums (acc_c of its
// constraint row, acc_x of its x row; each unused where the thread has no
// such row), in admm_iteration's order of operations. No block barrier.
// Each SOC row reads its block's head and the block's other rows by warp
// shuffles (constraint row r lives in thread r), in the order k = 1.. of
// the sum; every thread takes part in every shuffle. The shuffles also
// order this iteration's reads of u before the next iteration's writes:
// every thread's K2 sums are done before any thread passes them. The
// projection is computed without a branch (both kinds, then a select), and
// a zero dividend or radicand skips the division's and the square root's
// slow paths.
__device__ __forceinline__ void ws_finish(float acc_c, float acc_x, int t,
                                          int n_box, int soc_max,
                                          int has_shift, float alpha,
                                          float one_minus_alpha, WsRows& s) {
  if (s.has_x) s.x = acc_x - s.wx;
  float zs = 0.f;
  if (s.has_c) {
    const float v = acc_c - s.wc;
    s.ax_rel = alpha * v + one_minus_alpha * s.z;
    zs = s.ax_rel + ws_div(s.y, s.rc.rho);
    if (has_shift) zs = zs + s.rc.sh;
  }
  const RowConst& rc = s.rc;
  const float tt = __shfl_sync(0xffffffffu, zs, rc.blk_off);
  float ss = 0.f;
  for (int k = 1; k < soc_max; ++k) {
    const float vk = __shfl_sync(0xffffffffu, zs, (rc.blk_off + k) & 31);
    if (k < rc.blk_d) ss += vk * vk;
  }
  if (!s.has_c) return;
  // Both projections, without a branch: the box clip (max then min,
  // NaN-propagating) and the closed-form SOC projection; the row's kind
  // selects.
  float zb = zs < rc.lb ? rc.lb : zs;
  zb = zb > rc.ub ? rc.ub : zb;
  const float nrm = ws_sqrt(ss);
  const bool inside = nrm <= tt;
  const bool polar = nrm <= -tt;
  const float sv = 0.5f * (tt + nrm);
  const bool pos = nrm > 0.f;
  const float scale = pos ? ws_div(sv, pos ? nrm : 1.f) : 0.f;
  const float zc = t == rc.blk_off ? (inside ? tt : (polar ? 0.f : sv))
                                   : (inside ? zs
                                             : (polar ? 0.f : scale * zs));
  const float zp = t < n_box ? zb : zc;
  const float z_new = has_shift ? zp - rc.sh : zp;
  s.y = s.y + rc.rho * (s.ax_rel - z_new);
  s.z = z_new;
}

// The lane's rows and constants from device memory: x row t (t < nv),
// constraint row t (t < m) with its y, z, rho, shift and either its box
// bounds or its SOC block; the rest zero (rho 1).
__device__ __forceinline__ void ws_load_rows(
    WsRows& s, long long lane, int t, int nv, int m, int n_box,
    const float* __restrict__ x0g, const float* __restrict__ y0g,
    const float* __restrict__ z0g, const float* __restrict__ rhog,
    const float* __restrict__ lbg, const float* __restrict__ ubg,
    const float* __restrict__ shiftg, int has_shift, const SocDims& soc) {
  s.has_x = t < nv;
  s.has_c = t < m;
  s.x = s.wx = s.y = s.z = s.wc = s.ax_rel = 0.f;
  s.rc = {1.f, 0.f, 0.f, 0.f, 0, 0};
  if (s.has_x) s.x = x0g[lane * nv + t];
  if (s.has_c) {
    s.y = y0g[lane * m + t];
    s.z = z0g[lane * m + t];
    s.rc.rho = rhog[lane * m + t];
    if (has_shift) s.rc.sh = shiftg[lane * m + t];
    if (t < n_box) {
      s.rc.lb = lbg[lane * n_box + t];
      s.rc.ub = ubg[lane * n_box + t];
    } else {
      soc_block_of(t, n_box, soc, &s.rc.blk_off, &s.rc.blk_d);
    }
  }
}

// The largest SOC block: the shuffles a norm takes.
__device__ __forceinline__ int ws_soc_max(const SocDims& soc) {
  int k = 0;
  for (int b = 0; b < soc.n; ++b) k = max(k, soc.d[b]);
  return k;
}
