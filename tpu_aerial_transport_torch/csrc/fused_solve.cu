// Whole-solve batched ADMM for Hopper (sm_90a): one small conic QP per lane.
//
// Replaces the TPU kernel ops/admm_kernel.py _fused_solve_kernel of the JAX
// package (tpu_aerial_transport), in its compiled form (exact_dot=False),
// fixed-iteration, float32, with or without a cone shift. Per lane:
//
//   wq = Minv q,  w2 = [wq; A wq]
//   repeat iters:  v = K2 [x; rho z - y] - w2;  x = v[:nv]
//                  Ax_rel = alpha v[nv:] + (1 - alpha) z
//                  z = Pi(Ax_rel + y / rho)      (translated box x SOC)
//                  y = y + rho (Ax_rel - z)
//   prim = max|A x - z|,  dual = max|P x + q + A^T y|
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
// and by latency. What the design does about that: each lane's operators
// (K2, Minv, A, P) are read from device memory once per solve into shared
// memory and stay there across all iterations, instead of once per
// iteration; the per-lane vectors live in registers.
//
// Design (simple and right first): one block per lane, one thread per row of
// K2 (d rows, block rounded up to whole warps). Shared-memory matrix rows use
// an odd stride, so the threads of a warp walking their rows hit distinct
// banks. Two barriers per iteration: after the [x; rho z - y] write, and
// after the pre-projection write (an SOC block's rows read each other's
// values). SOC norms are summed by each row of the block in order; residuals
// are reduced with warp shuffles and one pass over the warps. Maxima
// propagate NaN, as the reference's do.

#include <cuda_runtime.h>

#define FS_MAX_SOC_BLOCKS 16
#define FS_MAX_DIM 256

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

static __host__ __device__ int fs_odd(int k) { return k | 1; }

static __host__ __device__ size_t fs_smem_floats(int nv, int m) {
  const int d = nv + m;
  return (size_t)d * fs_odd(d) + (size_t)(2 * nv + m) * fs_odd(nv)
         + 2 * (size_t)d + 64;
}

__global__ void fused_solve_kernel(
    const float* __restrict__ K2g, const float* __restrict__ Minvg,
    const float* __restrict__ Ag, const float* __restrict__ Pg,
    const float* __restrict__ qg, const float* __restrict__ rhog,
    const float* __restrict__ lbg, const float* __restrict__ ubg,
    const float* __restrict__ shiftg, const float* __restrict__ x0g,
    const float* __restrict__ y0g, const float* __restrict__ z0g,
    float* __restrict__ xo, float* __restrict__ yo, float* __restrict__ zo,
    float* __restrict__ res, int nv, int m, int n_box, int iters,
    int has_shift, float alpha, float one_minus_alpha, SocDims soc) {
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
  float* sred = szs + d;              // 64: residual reduction scratch

  // Stage this lane's operators once (coalesced global reads).
  const float* K2l = K2g + lane * d * d;
  for (int i = tid; i < d * d; i += nth) sK2[(i / d) * ld_d + i % d] = K2l[i];
  const float* Minvl = Minvg + lane * nv * nv;
  const float* Pl = Pg + lane * nv * nv;
  for (int i = tid; i < nv * nv; i += nth) {
    sMinv[(i / nv) * ld_v + i % nv] = Minvl[i];
    sP[(i / nv) * ld_v + i % nv] = Pl[i];
  }
  const float* Al = Ag + lane * m * nv;
  for (int i = tid; i < m * nv; i += nth) sA[(i / nv) * ld_v + i % nv] = Al[i];

  // Row-owned registers: thread i < nv owns x_i; thread nv + r owns row r.
  const bool is_x = tid < nv;
  const bool is_row = tid >= nv && tid < d;
  const int r = tid - nv;
  float x = 0.f, q = 0.f, y = 0.f, z = 0.f, rho = 1.f, sh = 0.f;
  float lb = 0.f, ub = 0.f, w = 0.f;
  int blk_off = 0, blk_d = 0;
  if (is_x) {
    x = x0g[lane * nv + tid];
    q = qg[lane * nv + tid];
    szs[tid] = q;
  } else if (is_row) {
    y = y0g[lane * m + r];
    z = z0g[lane * m + r];
    rho = rhog[lane * m + r];
    if (has_shift) sh = shiftg[lane * m + r];
    if (r < n_box) {
      lb = lbg[lane * n_box + r];
      ub = ubg[lane * n_box + r];
    } else {
      int off = n_box;
      for (int b = 0; b < soc.n; ++b) {
        if (r < off + soc.d[b]) {
          blk_off = off;
          blk_d = soc.d[b];
          break;
        }
        off += soc.d[b];
      }
    }
  }
  __syncthreads();

  // qp-build tail: w2 = [Minv q; A (Minv q)], each row keeping its own entry.
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

  for (int it = 0; it < iters; ++it) {
    if (is_x) su[tid] = x;
    else if (is_row) su[tid] = rho * z - y;
    __syncthreads();

    float ax_rel = 0.f;
    if (tid < d) {
      float acc = 0.f;
      const float* row = sK2 + tid * ld_d;
      for (int j = 0; j < d; ++j) acc += row[j] * su[j];
      const float v = acc - w;
      if (is_x) {
        x = v;
      } else {
        ax_rel = alpha * v + one_minus_alpha * z;
        float zs = ax_rel + y / rho;
        if (has_shift) zs = zs + sh;
        szs[r] = zs;
      }
    }
    __syncthreads();

    if (is_row) {
      const float zs = szs[r];
      float zp;
      if (r < n_box) {
        zp = zs < lb ? lb : zs;  // max then min, NaN-propagating.
        zp = zp > ub ? ub : zp;
      } else {
        const float t = szs[blk_off];
        float ss = 0.f;
        for (int k = 1; k < blk_d; ++k) {
          const float vk = szs[blk_off + k];
          ss += vk * vk;
        }
        const float nrm = sqrtf(ss);
        const bool inside = nrm <= t;
        const bool polar = nrm <= -t;
        const float s = 0.5f * (t + nrm);
        if (r == blk_off) {
          zp = inside ? t : (polar ? 0.f : s);
        } else {
          const float scale = nrm > 0.f ? s / nrm : 0.f;
          zp = inside ? zs : (polar ? 0.f : scale * zs);
        }
      }
      const float z_new = has_shift ? zp - sh : zp;
      y = y + rho * (ax_rel - z_new);
      z = z_new;
    }
  }

  // Exit residuals: prim over the m rows, dual over the nv columns.
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
    res[lane * 2] = p;
    res[lane * 2 + 1] = du;
  }

  if (is_x) {
    xo[lane * nv + tid] = x;
  } else if (is_row) {
    yo[lane * m + r] = y;
    zo[lane * m + r] = z;
  }
}

extern "C" int fused_solve_launch(
    const float* K2, const float* Minv, const float* A, const float* P,
    const float* q, const float* rho, const float* lb, const float* ub,
    const float* shift, const float* x0, const float* y0, const float* z0,
    float* xo, float* yo, float* zo, float* res, int B, int nv, int m,
    int n_box, int iters, int has_shift, float alpha, float one_minus_alpha,
    SocDims soc, int device, cudaStream_t stream) {
  const int d = nv + m;
  if (B < 0 || nv < 1 || m < 1 || d > FS_MAX_DIM || soc.n < 0 ||
      soc.n > FS_MAX_SOC_BLOCKS || n_box < 0 || n_box > m || iters < 0)
    return (int)cudaErrorInvalidValue;
  int soc_rows = 0;
  for (int b = 0; b < soc.n; ++b) {
    if (soc.d[b] < 2) return (int)cudaErrorInvalidValue;
    soc_rows += soc.d[b];
  }
  if (n_box + soc_rows != m) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  // This library's runtime keeps its own current device: launch on the
  // tensors' device, whose stream the caller passes.
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = fs_smem_floats(nv, m) * sizeof(float);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(
        fused_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = ((d + 31) / 32) * 32;
  fused_solve_kernel<<<B, threads, smem, stream>>>(
      K2, Minv, A, P, q, rho, lb, ub, shift, x0, y0, z0, xo, yo, zo, res, nv,
      m, n_box, iters, has_shift, alpha, one_minus_alpha, soc);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_solve_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
