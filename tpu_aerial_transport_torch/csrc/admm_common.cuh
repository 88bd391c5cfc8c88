// Pieces shared by the port's batched ADMM kernels (fused_solve.cu,
// admm_chunk.cu): the cone layout passed by value, NaN-propagating maxima,
// and the one-block-a-lane bodies' iteration and residuals in their two
// layouts, chosen from d alone:
//
// - register rows (RB_MIN_D <= d <= RB_MAX_D, every shape a path runs on
//   these bodies: d = 67, 72, 79, 111): each K2 row lives in the registers
//   of the one thread that owns the row, staged once through shared memory
//   by cp.async. An iteration reads only u from shared memory, as 16-byte
//   broadcasts, from one of two buffers, so it needs one barrier; the SOC
//   rows lead the thread map, so a block of up to 32 rows lies in one warp
//   and its norm goes by shuffles. Splitting a row over 2 or 4 threads of a
//   warp (shorter chains, more warps a lane) ran slower at every shape on
//   an H100: the shuffles that join the chains cost more than they save.
// - shared rows (d <= 64 when a block body is asked for, or d > 128, where
//   K2 no longer fits a block's registers): thread i < nv owns x_i, thread
//   nv + r constraint row r, K2 is read from shared memory every iteration
//   (odd row strides, so a warp's threads walking their rows hit distinct
//   banks), two barriers an iteration.
//
// What bounds them on an H100: an iteration of a lane is a chain of
// dependent steps (the K2 row sum, y / rho, the SOC norm, its square root
// and division, the barrier) of about 0.63 us in the register-row layout
// (1.9-2.3 us in the shared-row layout, whose iteration waited on the
// shared-memory pipe: two 4-byte reads a term), far above the operations
// and bytes it needs. So a batch's time is the iterations x that chain,
// divided by the lanes an SM keeps in flight to hide it: the registers K2
// takes set those (4 lanes at d <= 80, 2 at d = 111), and at 256 lanes (about
// 2 an SM) the chain itself is the time.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FS_MAX_SOC_BLOCKS 16
#define FS_MAX_DIM 256
// Residual reduction scratch: one slot per warp for each residual, and the
// two block-wide results.
#define FS_RED_FLOATS 66
// K2 row sums: rows of up to K2_ONE_CHAIN_MAX_D terms in one chain, longer
// rows in K2_CHAINS chains (term j into chain j mod K2_CHAINS, j ascending,
// the chains added pairwise). One chain's rounding grows with its length:
// at d = 111 it is about twice the plain version's (cuBLAS) distance from
// the float64 sum, which the 1e3-boosted equality rows carry into y, and the
// early-exit decisions follow it. On an H100 at every block-body shape (d =
// 67, 72, 79, 111) one, two and four chains each missed the kernel bar
// somewhere (a 4-lane served chunk at d = 79: 2.02, 1.009 and 1.009 times
// it), eight met it everywhere (0.08 times there).
#define K2_ONE_CHAIN_MAX_D 64
#define K2_CHAINS 8

struct SocDims {
  int n;
  int d[FS_MAX_SOC_BLOCKS];
};

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float warp_nan_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

static __host__ __device__ __forceinline__ int fs_odd(int k) { return k | 1; }

// The SOC block that constraint row r (r >= n_box) belongs to.
__device__ __forceinline__ void soc_block_of(int r, int n_box,
                                             const SocDims& soc,
                                             int* blk_off, int* blk_d) {
  int off = n_box;
  for (int b = 0; b < soc.n; ++b) {
    if (r < off + soc.d[b]) {
      *blk_off = off;
      *blk_d = soc.d[b];
      return;
    }
    off += soc.d[b];
  }
}

// Per-row constants of one lane, in the registers of the owning thread.
struct RowConst {
  float rho, sh, lb, ub;
  int blk_off, blk_d;
};

// One ADMM iteration of the lane in the shared-row layout, in the
// reference's order of operations (ops/socp.py _admm_step):
//   v = K2 [x; rho z - y] - w2;  x = v[:nv]
//   Ax_rel = alpha v[nv:] + (1 - alpha) z
//   z = Pi(Ax_rel + y / rho)     (translated box x SOC, shift added first)
//   y = y + rho (Ax_rel - z)
// `w` is this thread's entry of w2. Two barriers: after the [x; rho z - y]
// write, and after the pre-projection write (an SOC block's rows read each
// other's values). Clip is max then min and the maxima propagate NaN.
__device__ __forceinline__ void admm_iteration(
    const float* __restrict__ sK2, int ld_d, float* su, float* szs, int tid,
    int nv, int d, int n_box, float w, const RowConst& rc, int has_shift,
    float alpha, float one_minus_alpha, float& x, float& y, float& z) {
  const bool is_x = tid < nv;
  const bool is_row = tid >= nv && tid < d;
  const int r = tid - nv;
  if (is_x) su[tid] = x;
  else if (is_row) su[tid] = rc.rho * z - y;
  __syncthreads();

  float ax_rel = 0.f;
  if (tid < d) {
    const float* row = sK2 + tid * ld_d;
    float acc;
    if (d <= K2_ONE_CHAIN_MAX_D) {
      acc = 0.f;
      for (int j = 0; j < d; ++j) acc += row[j] * su[j];
    } else {
      float p[K2_CHAINS];
#pragma unroll
      for (int k = 0; k < K2_CHAINS; ++k) p[k] = 0.f;
      int j = 0;
      for (; j + K2_CHAINS <= d; j += K2_CHAINS) {
#pragma unroll
        for (int k = 0; k < K2_CHAINS; ++k) p[k] += row[j + k] * su[j + k];
      }
#pragma unroll
      for (int k = 0; k < K2_CHAINS; ++k)
        if (j + k < d) p[k] += row[j + k] * su[j + k];
#pragma unroll
      for (int h = K2_CHAINS / 2; h > 0; h >>= 1) {
#pragma unroll
        for (int k = 0; k < h; ++k) p[k] += p[k + h];
      }
      acc = p[0];
    }
    const float v = acc - w;
    if (is_x) {
      x = v;
    } else {
      ax_rel = alpha * v + one_minus_alpha * z;
      float zs = ax_rel + y / rc.rho;
      if (has_shift) zs = zs + rc.sh;
      szs[r] = zs;
    }
  }
  __syncthreads();

  if (is_row) {
    const float zs = szs[r];
    float zp;
    if (r < n_box) {
      zp = zs < rc.lb ? rc.lb : zs;  // max then min, NaN-propagating.
      zp = zp > rc.ub ? rc.ub : zp;
    } else {
      const float t = szs[rc.blk_off];
      float ss = 0.f;
      for (int k = 1; k < rc.blk_d; ++k) {
        const float vk = szs[rc.blk_off + k];
        ss += vk * vk;
      }
      const float nrm = sqrtf(ss);
      const bool inside = nrm <= t;
      const bool polar = nrm <= -t;
      const float s = 0.5f * (t + nrm);
      if (r == rc.blk_off) {
        zp = inside ? t : (polar ? 0.f : s);
      } else {
        const float scale = nrm > 0.f ? s / nrm : 0.f;
        zp = inside ? zs : (polar ? 0.f : scale * zs);
      }
    }
    const float z_new = has_shift ? zp - rc.sh : zp;
    y = y + rc.rho * (ax_rel - z_new);
    z = z_new;
  }
}

// The lane's residuals prim = max_r |A x - z|_r and dual = max_c |P x + q +
// A^T y|_c, reduced over the block (NaN-propagating); every thread gets both.
// The results pass through shared memory behind a barrier, so a decision
// taken on them is the same in every thread of the block.
__device__ __forceinline__ void block_residuals(
    const float* __restrict__ sA, const float* __restrict__ sP, int ld_v,
    float* su, float* szs, float* sred, int tid, int nth, int nv, int m,
    float x, float y, float z, float q, float* prim, float* dual) {
  const bool is_x = tid < nv;
  const bool is_row = tid >= nv && tid < nv + m;
  const int r = tid - nv;
  __syncthreads();
  if (is_x) su[tid] = x;
  else if (is_row) szs[r] = y;
  __syncthreads();
  float pv = 0.f, dv = 0.f;
  if (is_row) {
    float acc = 0.f;
    const float* row = sA + r * ld_v;
    for (int c = 0; c < nv; ++c) acc += row[c] * su[c];
    pv = fabsf(acc - z);
  } else if (is_x) {
    float px = 0.f;
    const float* row = sP + tid * ld_v;
    for (int j = 0; j < nv; ++j) px += row[j] * su[j];
    float aty = 0.f;
    for (int rr = 0; rr < m; ++rr) aty += sA[rr * ld_v + tid] * szs[rr];
    dv = fabsf(px + q + aty);
  }
  pv = warp_nan_max(pv);
  dv = warp_nan_max(dv);
  const int warp = tid >> 5;
  if ((tid & 31) == 0) {
    sred[warp] = pv;
    sred[32 + warp] = dv;
  }
  __syncthreads();
  if (tid == 0) {
    float p = 0.f, du = 0.f;
    for (int k = 0; k < (nth + 31) / 32; ++k) {
      p = nan_max(p, sred[k]);
      du = nan_max(du, sred[32 + k]);
    }
    sred[64] = p;
    sred[65] = du;
  }
  __syncthreads();
  *prim = sred[64];
  *dual = sred[65];
}

// ---------------------------------------------------------------------------
// The register-row layout of the one-block-a-lane bodies (RB_MIN_D <= d <=
// RB_MAX_D). Its arithmetic is admm_iteration's and block_residuals', in the
// same order, so its results are theirs bit for bit.
// ---------------------------------------------------------------------------

#define RB_MIN_D (K2_ONE_CHAIN_MAX_D + 1)
#define RB_MAX_D 128
// The register budget a thread of the register-row instantiations (their
// __launch_bounds__, and ops/admm_kernel.py's residency, which reads these
// lines): up to d = RB_SHORT_D, 168 for the whole solve (four lanes an SM:
// the 2048-lane full QP at d = 72 ran fastest there on an H100) and 136 for
// the chunk (five lanes an SM); above, 255 for both (two lanes an SM; a
// tighter budget spilled K2 and ran slower at d = 111).
#define RB_SHORT_D 80
#define RB_SOLVE_SHORT_REGS 168
#define RB_CHUNK_SHORT_REGS 136
#define RB_LONG_REGS 255

static __host__ __device__ __forceinline__ int rb_r4(int k) {
  return (k + 3) & ~3;
}

// A shared-memory row stride of whole 16-byte words, an odd number of them.
static __host__ __device__ __forceinline__ int rb_ld16(int k) {
  const int r = rb_r4(k);
  return ((r >> 2) & 1) ? r : r + 4;
}

// An operator's row stride in shared memory: whole 16-byte words (an odd
// number) where rows of k floats can be read 16 bytes at a time, else an
// odd number of floats. Either way the threads of a warp reading their own
// rows hit distinct banks.
static __host__ __device__ __forceinline__ int rb_ld(int k) {
  return k % 4 == 0 ? rb_ld16(k) : (k | 1);
}

static __host__ __device__ __forceinline__ bool rb_takes(int d) {
  return d >= RB_MIN_D && d <= RB_MAX_D;
}

// The largest d of the instantiation that takes d: each one sums whole rows
// of its own length (a whole number of K2_CHAINS-term words), zero past d,
// with no test in the loop.
static __host__ __device__ __forceinline__ constexpr int rb_bucket(int d) {
  return d <= 72 ? 72 : d <= 80 ? 80 : d <= 112 ? 112 : RB_MAX_D;
}

static __host__ __device__ __forceinline__ constexpr int rb_threads(int d) {
  return ((d + 31) / 32) * 32;
}

static __host__ __device__ constexpr int rb_budget(int dr, bool solve) {
  return dr <= RB_SHORT_D ? (solve ? RB_SOLVE_SHORT_REGS : RB_CHUNK_SHORT_REGS)
                          : RB_LONG_REGS;
}

// The blocks an SM an instantiation's launch bound asks for, from its
// register budget a thread: 65536 / (threads x budget), at least 1.
static __host__ __device__ constexpr int rb_min_blocks(int dr, bool solve) {
  return 65536 / (rb_threads(dr) * rb_budget(dr, solve)) < 1
             ? 1
             : 65536 / (rb_threads(dr) * rb_budget(dr, solve));
}

// The shared memory of one lane, in floats, by region: K2 (d x rb_ld(d)),
// then for the whole solve Minv, P (nv x rb_ld(nv)) and A (m x rb_ld(nv)),
// two u buffers (rb_ld16(rb_bucket(d)) floats each), for the whole
// solve a d-vector (q, wq, and x and y for the residuals), the
// pre-projection values (m) and the reduction scratch. Every region starts
// on a 16-byte boundary.
struct RbSmem {
  int k2, minv, p, a, u, v, zs, red, total;
};

static __host__ __device__ RbSmem rb_smem(int nv, int m, bool solve) {
  const int d = nv + m, ldd = rb_ld(d), ldv = rb_ld(nv);
  RbSmem s;
  int o = 0;
  s.k2 = o;
  o += rb_r4(d * ldd);
  s.minv = o;
  if (solve) o += rb_r4(nv * ldv);
  s.p = o;
  if (solve) o += rb_r4(nv * ldv);
  s.a = o;
  if (solve) o += rb_r4(m * ldv);
  s.u = o;
  o += 2 * rb_ld16(rb_bucket(d));
  s.v = o;
  if (solve) o += rb_r4(d);
  s.zs = o;
  o += rb_r4(m);
  s.red = o;
  if (solve) o += rb_r4(FS_RED_FLOATS);
  s.total = o;
  return s;
}

__device__ __forceinline__ float rb_float(float v) { return v; }
__device__ __forceinline__ float rb_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ bool rb_aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Asynchronous copies from device memory into shared memory, complete
// after rb_cp_async_wait.
__device__ __forceinline__ void rb_cp_async16(float* smem, const float* g) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void rb_cp_async4(float* smem, const float* g) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void rb_cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Close the group of copies issued so far; wait until all but the last
// group closed have landed.
__device__ __forceinline__ void rb_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void rb_cp_async_wait_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copy a rows x cols row-major operator into shared memory as float32 (row
// stride ld), by the block's nth threads, each stepping its (row, column)
// by the block's stride instead of dividing per element. float32 goes by
// asynchronous copies, 16 bytes each where the rows are whole 16-byte words
// on both sides, else 4; bfloat16 by 16-byte loads (or one entry a load),
// four a thread in flight, converted on the way.
template <typename OP>
__device__ __forceinline__ void rb_stage(float* __restrict__ dst, int ld,
                                         const OP* __restrict__ src,
                                         int rows, int cols, int tid,
                                         int nth) {
  constexpr int VW = 16 / sizeof(OP);
  constexpr int U = 4;
  if (rows <= 0) return;
  const bool vec = cols % VW == 0 && ld % 4 == 0 && rb_aligned16(src);
  const int step = vec ? VW : 1;
  const int per_row = cols / step;
  const int n = rows * per_row;
  const int dr = nth / per_row, dc = nth - dr * per_row;
  int row = tid / per_row, col = tid - row * per_row;
  if constexpr (sizeof(OP) == 4) {
    for (int i = tid; i < n; i += nth) {
      if (vec) rb_cp_async16(dst + row * ld + col * VW, src + (size_t)i * VW);
      else rb_cp_async4(dst + row * ld + col, src + i);
      row += dr;
      col += dc;
      if (col >= per_row) {
        col -= per_row;
        ++row;
      }
    }
  } else {
    for (int i0 = tid; i0 < n; i0 += nth * U) {
      float v[U][VW];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + nth * u;
        if (i >= n) continue;
        if (vec) {
          const uint4 q = *reinterpret_cast<const uint4*>(src + (size_t)i * VW);
          const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {  // low half first: little-endian.
            v[u][2 * k] = __uint_as_float(w[k] << 16);
            v[u][2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
          }
        } else {
          v[u][0] = rb_float(src[i]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i0 + nth * u >= n) break;
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
}

// K2 (d x d) into shared memory; returns where row 0 landed and, in *ld, the
// row stride. Rows of whole 16-byte words go row by row (rb_stage, stride
// ldd); other float32 rows go as the lane's whole segment, 16 bytes a copy
// (the few entries before the first and after the last whole word 4
// bytes each), landing at stride d from the segment's own 16-byte
// offset; ldd x d floats hold it with that offset (ldd = d | 1 there).
template <typename OP>
__device__ __forceinline__ const float* rb_stage_k2(
    float* __restrict__ buf, int ldd, const OP* __restrict__ src, int d,
    int tid, int nth, int* ld) {
  if constexpr (sizeof(OP) == 4) {
    if (!(d % 4 == 0 && rb_aligned16(src))) {
      const int h = (int)((reinterpret_cast<uintptr_t>(src) & 15) >> 2);
      float* dst = buf + h;
      const int n = d * d;
      const int head = h ? min(4 - h, n) : 0;
      const int words = (n - head) >> 2;
      for (int i = tid; i < head; i += nth) rb_cp_async4(dst + i, src + i);
      for (int i = tid; i < words; i += nth)
        rb_cp_async16(dst + head + 4 * i, src + head + 4 * i);
      for (int i = head + 4 * words + tid; i < n; i += nth)
        rb_cp_async4(dst + i, src + i);
      *ld = d;
      return dst;
    }
  }
  rb_stage(buf, ldd, src, d, d, tid, nth);
  *ld = ldd;
  return buf;
}

// acc = sum_{c < n} row[c] v[c], c ascending, one FMA a term (a one-chain
// sum); 16 bytes a read where both rows are whole 16-byte words (vec).
__device__ __forceinline__ float rb_dot(const float* row, const float* v,
                                        int n, bool vec) {
  float acc = 0.f;
  if (vec) {
    for (int c0 = 0; c0 < n; c0 += 4) {
      const float4 a4 = *reinterpret_cast<const float4*>(row + c0);
      const float4 v4 = *reinterpret_cast<const float4*>(v + c0);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c0 + e < n) acc = fmaf(av[e], vv[e], acc);
    }
  } else {
#pragma unroll 8
    for (int c = 0; c < n; ++c) acc = fmaf(row[c], v[c], acc);
  }
  return acc;
}

// a / b rounded as `/` rounds, for b nonzero and not NaN; a zero dividend
// takes its exact quotient (a zero with the sign of a x b) instead of the
// division's slow path, which zeros are sent down: y = 0 on every inactive
// row.
__device__ __forceinline__ float rb_div(float a, float b) {
  const float q = (a == 0.f ? 1.f : a) / b;
  return a == 0.f ? __int_as_float((__float_as_int(a) ^ __float_as_int(b)) &
                                   0x80000000)
                  : q;
}

// sqrtf(x) for x >= 0 or NaN; zero takes its exact root (itself) instead
// of the square root's slow path.
__device__ __forceinline__ float rb_sqrt(float x) {
  const float r = sqrtf(x == 0.f ? 1.f : x);
  return x == 0.f ? x : r;
}

#define RB_NONE 0
#define RB_X 1
#define RB_BOX 2
#define RB_SOC 3

// One thread's row: its kind and index, its SOC block, its iterate and
// constants.
struct RbRow {
  int kind;
  int i;      // in [x rows | constraint rows]: the K2 row, u_i's place.
  int r;      // constraint row (i - nv).
  int head;   // SOC: the block's first constraint row,
  int head_lane;  // and the lane that holds it.
  int blk_d;
  float x, y, z, w, q, ax;
  float rho, sh, lb, ub;
};

// Thread g holds, in this order, the SOC rows (so a block of k <= 32 rows
// starting at a multiple of k lies inside one warp), the box rows, then the
// x rows; threads past d hold nothing.
__device__ __forceinline__ void rb_map(RbRow& s, int g, int nv, int m,
                                       int n_box, const SocDims& soc) {
  const int n_soc = m - n_box;
  s.kind = RB_NONE;
  s.i = s.r = s.head = s.head_lane = 0;
  s.blk_d = 0;
  if (g < n_soc) {
    s.kind = RB_SOC;
    s.r = n_box + g;
  } else if (g < n_soc + n_box) {
    s.kind = RB_BOX;
    s.r = g - n_soc;
  } else if (g < nv + m) {
    s.kind = RB_X;
    s.i = g - n_soc - n_box;
  }
  if (s.kind == RB_SOC || s.kind == RB_BOX) s.i = nv + s.r;
  if (s.kind == RB_SOC) {
    // soc_block_of's search with the blocks unrolled, so the cone layout
    // is read where the launch left it rather than from a local copy.
    int off = n_box;
#pragma unroll
    for (int b = 0; b < FS_MAX_SOC_BLOCKS; ++b) {
      if (b < soc.n && s.blk_d == 0 && s.r < off + soc.d[b]) {
        s.head = off;
        s.blk_d = soc.d[b];
      }
      if (b < soc.n) off += soc.d[b];
    }
    s.head_lane = (s.head - n_box) % 32;
  }
  s.x = s.y = s.z = s.w = s.q = s.ax = 0.f;
  s.rho = 1.f;
  s.sh = s.lb = s.ub = 0.f;
}

// The row's iterate and constants from device memory.
__device__ __forceinline__ void rb_load_row(
    RbRow& s, long long lane, int nv, int m, int n_box,
    const float* __restrict__ x0g, const float* __restrict__ y0g,
    const float* __restrict__ z0g, const float* __restrict__ rhog,
    const float* __restrict__ lbg, const float* __restrict__ ubg,
    const float* __restrict__ shiftg, int has_shift) {
  if (s.kind == RB_X) {
    s.x = x0g[lane * nv + s.i];
  } else if (s.kind != RB_NONE) {
    s.y = y0g[lane * m + s.r];
    s.z = z0g[lane * m + s.r];
    s.rho = rhog[lane * m + s.r];
    if (has_shift) s.sh = shiftg[lane * m + s.r];
    if (s.kind == RB_BOX) {
      s.lb = lbg[lane * n_box + s.r];
      s.ub = ubg[lane * n_box + s.r];
    }
  }
}

// K2 row i of the lane (shared memory, row 0 at sK2, stride ld) into
// registers, zero past d.
template <int KR>
__device__ __forceinline__ void rb_load_k2(float (&kr)[KR],
                                           const float* __restrict__ sK2,
                                           int ld, const RbRow& s, int d) {
  const float* row = sK2 + s.i * ld;
  const bool has = s.kind != RB_NONE;
#pragma unroll
  for (int j = 0; j < KR; ++j) kr[j] = has && j < d ? row[j] : 0.f;
}

// Whether every SOC block lies inside one warp's rows under rb_map (then the
// norms go by shuffles), and the largest block.
__device__ __forceinline__ bool rb_soc_in_warps(const SocDims& soc,
                                                int* soc_max) {
  bool ok = true;
  int g = 0, mx = 0;
#pragma unroll
  for (int b = 0; b < FS_MAX_SOC_BLOCKS; ++b) {
    if (b >= soc.n) break;
    const int k = soc.d[b];
    ok = ok && g / 32 == (g + k - 1) / 32;
    g += k;
    mx = max(mx, k);
  }
  *soc_max = mx;
  return ok;
}

// The u entry of the row into buffer un: x, or rho z - y.
__device__ __forceinline__ void rb_put_u(float* un, const RbRow& s) {
  if (s.kind == RB_NONE) return;
  un[s.i] = s.kind == RB_X ? s.x : s.rho * s.z - s.y;
}

// One ADMM iteration of the lane in the register-row layout, in
// admm_iteration's order of operations, after the barrier that completes
// buffer uc: each thread sums its K2 row from registers against u (16-byte
// reads) in K2_CHAINS chains, term j into chain j mod K2_CHAINS, added
// pairwise 8 -> 4 -> 2 -> 1 as admm_iteration adds them, then the row's
// update; an SOC row reads its block by warp shuffles (shfl) or, where a
// block crosses warps, through shared memory behind a barrier. Ends by
// writing the row's next u entry into buffer un; the next iteration's
// barrier completes it.
template <int KR>
__device__ __forceinline__ void rb_iteration(
    const float (&kr)[KR], const float* __restrict__ uc, float* un,
    float* szs, bool warp_soc, bool shfl, int soc_max, int has_shift,
    float alpha, float one_minus_alpha, RbRow& s) {
  static_assert(KR % K2_CHAINS == 0, "rows of whole K2_CHAINS-term words");
  // y / rho needs nothing of this iteration's sum: started first, its
  // latency runs under the sum's.
  const float y_rho = rb_div(s.y, s.rho);
  float p[K2_CHAINS];
#pragma unroll
  for (int l = 0; l < K2_CHAINS; ++l) p[l] = 0.f;
  const float4* u4 = reinterpret_cast<const float4*>(uc);
#pragma unroll
  for (int e4 = 0; e4 < KR / 4; ++e4) {
    const float4 v = u4[e4];
    const float uu[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int l = (4 * e4 + e) % K2_CHAINS;
      p[l] = fmaf(kr[4 * e4 + e], uu[e], p[l]);
    }
  }
#pragma unroll
  for (int h = K2_CHAINS / 2; h > 0; h >>= 1) {
#pragma unroll
    for (int l = 0; l < h; ++l) p[l] += p[l + h];
  }

  const float v = p[0] - s.w;
  float zs = 0.f;
  if (s.kind == RB_X) {
    s.x = v;
  } else if (s.kind != RB_NONE) {
    // alpha v + (1 - alpha) z with the second product fused, as the
    // compiler fuses admm_iteration's (written out: the choice would
    // otherwise follow the code around it).
    s.ax = fmaf(one_minus_alpha, s.z, alpha * v);
    zs = s.ax + y_rho;
    if (has_shift) zs = zs + s.sh;
  }

  // The SOC norm: the block's head t and sum_{k >= 1} v_k^2, k ascending.
  float t = 0.f, ss = 0.f;
  if (shfl) {
    if (warp_soc && soc_max <= 4) {
      // Blocks of up to four rows (every cone the controllers build): the
      // four shuffles at once.
      const float v1 = __shfl_sync(0xffffffffu, zs, (s.head_lane + 1) & 31);
      const float v2 = __shfl_sync(0xffffffffu, zs, (s.head_lane + 2) & 31);
      const float v3 = __shfl_sync(0xffffffffu, zs, (s.head_lane + 3) & 31);
      t = __shfl_sync(0xffffffffu, zs, s.head_lane);
      if (1 < s.blk_d) ss += v1 * v1;
      if (2 < s.blk_d) ss += v2 * v2;
      if (3 < s.blk_d) ss += v3 * v3;
    } else if (warp_soc) {
      t = __shfl_sync(0xffffffffu, zs, s.head_lane);
      for (int kk = 1; kk < soc_max; ++kk) {
        const float vk = __shfl_sync(0xffffffffu, zs, (s.head_lane + kk) & 31);
        if (kk < s.blk_d) ss += vk * vk;
      }
    }
  } else {
    if (s.kind == RB_SOC) szs[s.r] = zs;
    __syncthreads();
    if (s.kind == RB_SOC) {
      t = szs[s.head];
      for (int kk = 1; kk < s.blk_d; ++kk) {
        const float vk = szs[s.head + kk];
        ss += vk * vk;
      }
    }
  }

  if (s.kind == RB_BOX || s.kind == RB_SOC) {
    float zp;
    if (s.kind == RB_BOX) {
      zp = zs < s.lb ? s.lb : zs;  // max then min, NaN-propagating.
      zp = zp > s.ub ? s.ub : zp;
    } else {
      const float nrm = rb_sqrt(ss);
      const bool inside = nrm <= t;
      const bool polar = nrm <= -t;
      const float sv = 0.5f * (t + nrm);
      if (s.r == s.head) {
        zp = inside ? t : (polar ? 0.f : sv);
      } else {
        const float scale = nrm > 0.f ? rb_div(sv, nrm) : 0.f;
        zp = inside ? zs : (polar ? 0.f : scale * zs);
      }
    }
    const float z_new = has_shift ? zp - s.sh : zp;
    s.y = s.y + s.rho * (s.ax - z_new);
    s.z = z_new;
  }
  rb_put_u(un, s);
}

// The lane's residuals in block_residuals' order (prim over the m rows,
// dual over the nv columns, NaN-propagating maxima), each row's term by
// its thread; every thread gets both, read back behind a barrier.
__device__ __forceinline__ void rb_residuals(
    const float* __restrict__ sA, const float* __restrict__ sP, int ldv,
    float* sv, float* sred, int tid, int nth, int nv, int m,
    const RbRow& s, float* prim, float* dual) {
  __syncthreads();
  if (s.kind == RB_X) sv[s.i] = s.x;
  else if (s.kind != RB_NONE) sv[s.i] = s.y;
  __syncthreads();
  const bool vec = ldv % 4 == 0 && nv % 4 == 0;
  float pv = 0.f, dv = 0.f;
  if (s.kind == RB_BOX || s.kind == RB_SOC) {
    pv = fabsf(rb_dot(sA + s.r * ldv, sv, nv, vec) - s.z);
  } else if (s.kind == RB_X) {
    const float px = rb_dot(sP + s.i * ldv, sv, nv, vec);
    float aty = 0.f;
#pragma unroll 8
    for (int rr = 0; rr < m; ++rr) aty += sA[rr * ldv + s.i] * sv[nv + rr];
    dv = fabsf(px + s.q + aty);
  }
  pv = warp_nan_max(pv);
  dv = warp_nan_max(dv);
  const int warp = tid >> 5;
  if ((tid & 31) == 0) {
    sred[warp] = pv;
    sred[32 + warp] = dv;
  }
  __syncthreads();
  if (tid == 0) {
    float p = 0.f, du = 0.f;
    for (int w = 0; w < (nth + 31) / 32; ++w) {
      p = nan_max(p, sred[w]);
      du = nan_max(du, sred[32 + w]);
    }
    sred[64] = p;
    sred[65] = du;
  }
  __syncthreads();
  *prim = sred[64];
  *dual = sred[65];
}

// rb_residuals as a call of its own: the early-exit forms test inside their
// loop of iterations, and inlined there the test's code slows the
// iterations around it (measured on an H100).
static __device__ __noinline__ void rb_residuals_call(
    const float* __restrict__ sA, const float* __restrict__ sP, int ldv,
    float* sv, float* sred, int tid, int nth, int nv, int m,
    const RbRow& s, float* prim, float* dual) {
  rb_residuals(sA, sP, ldv, sv, sred, tid, nth, nv, m, s, prim, dual);
}

// Host-side checks shared by the launchers: the cone layout must cover the
// m rows and fit the compile-time bounds.
static inline bool soc_layout_ok(int nv, int m, int n_box,
                                 const SocDims& soc) {
  if (nv < 1 || m < 1 || nv + m > FS_MAX_DIM || soc.n < 0 ||
      soc.n > FS_MAX_SOC_BLOCKS || n_box < 0 || n_box > m)
    return false;
  int soc_rows = 0;
  for (int b = 0; b < soc.n; ++b) {
    if (soc.d[b] < 2) return false;
    soc_rows += soc.d[b];
  }
  return n_box + soc_rows == m;
}
