// Pieces shared by the port's batched ADMM kernels (fused_solve.cu,
// admm_chunk.cu): the cone layout passed by value, NaN-propagating maxima,
// one ADMM iteration of one lane, and the lane's exit residuals.
//
// Layout inside a block (one lane): thread i < nv owns x_i; thread nv + r
// owns constraint row r (its y_r, z_r, rho_r, bounds and shift live in that
// thread's registers); threads past d = nv + m only join the barriers.
// Shared-memory matrix rows use an odd stride, so the threads of a warp
// walking their rows hit distinct banks.

#pragma once

#include <cuda_runtime.h>

#define FS_MAX_SOC_BLOCKS 16
#define FS_MAX_DIM 256
// Residual reduction scratch: one slot per warp for each residual, and the
// two block-wide results.
#define FS_RED_FLOATS 66
// K2 row sums in admm_iteration: rows of up to K2_ONE_CHAIN_MAX_D terms in
// one chain, longer rows in K2_CHAINS chains (a power of two).
#define K2_ONE_CHAIN_MAX_D 80
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

// One ADMM iteration of the lane, in the reference's order of operations
// (ops/socp.py _admm_step), a long K2 row summed in K2_CHAINS chains:
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
    // A row of up to K2_ONE_CHAIN_MAX_D terms is summed in one chain of
    // FMAs, j ascending; a longer one in K2_CHAINS chains (term j into
    // chain j mod K2_CHAINS), added pairwise. One chain's rounding grows
    // with its length: at d = 111 it is about twice the plain version's
    // (cuBLAS) distance from the float64 sum, which the 1e3-boosted
    // equality rows carry into y, and the early-exit decisions follow it.
    // Eight chains bring it to the plain version's; at d <= 79 one chain
    // is within the kernel bar and faster (measured on an H100).
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
