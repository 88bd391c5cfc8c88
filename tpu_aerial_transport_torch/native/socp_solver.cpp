// Native (C++) conic-QP solver: the float64 host oracle of ops/socp.py.
//
// A dependency-free ADMM solver for
//
//     minimize    (1/2) x^T P x + q^T x
//     subject to  A x + shift in Box(l, u) x SOC(d_1) x ... x SOC(d_k)
//
// with the SAME splitting, equality-row penalty (kEqRhoScale), over-relaxation
// and cone regimes as ops/socp.py and the whole-solve kernel
// (csrc/fused_solve.cu), so it is an independent float64 implementation of
// the same iterations: the oracle the port's tests and chip_smoke.py hold the
// float32 solves against.
//
// Dense row-major matrices; Cholesky-factored KKT; no external deps. Built as a
// shared library with g++ and bound through ctypes
// (tpu_aerial_transport_torch/native/__init__.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double kEqRhoScale = 1e3;  // ops/socp.py EQ_RHO_SCALE.

// In-place dense Cholesky (lower) of an n x n SPD matrix. Returns false if a
// non-positive pivot appears.
bool cholesky(std::vector<double>& M, int n) {
  for (int j = 0; j < n; ++j) {
    double d = M[j * n + j];
    for (int k = 0; k < j; ++k) d -= M[j * n + k] * M[j * n + k];
    if (d <= 0.0) return false;
    const double L = std::sqrt(d);
    M[j * n + j] = L;
    for (int i = j + 1; i < n; ++i) {
      double s = M[i * n + j];
      for (int k = 0; k < j; ++k) s -= M[i * n + k] * M[j * n + k];
      M[i * n + j] = s / L;
    }
  }
  // Zero the strict upper triangle for cleanliness.
  for (int i = 0; i < n; ++i)
    for (int j = i + 1; j < n; ++j) M[i * n + j] = 0.0;
  return true;
}

void chol_solve(const std::vector<double>& L, int n, std::vector<double>& b) {
  for (int i = 0; i < n; ++i) {
    double s = b[i];
    for (int k = 0; k < i; ++k) s -= L[i * n + k] * b[k];
    b[i] = s / L[i * n + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    double s = b[i];
    for (int k = i + 1; k < n; ++k) s -= L[k * n + i] * b[k];
    b[i] = s / L[i * n + i];
  }
}

// Project z (length m) onto the translated cone; identical regime logic to
// ops/socp.py project_soc / _project_cone.
void project_cone(std::vector<double>& z, const double* lb, const double* ub,
                  int n_box, const int32_t* soc_dims, int n_soc,
                  const double* shift) {
  if (shift != nullptr)
    for (size_t i = 0; i < z.size(); ++i) z[i] += shift[i];
  for (int i = 0; i < n_box; ++i) {
    if (z[i] < lb[i]) z[i] = lb[i];
    if (z[i] > ub[i]) z[i] = ub[i];
  }
  int off = n_box;
  for (int b = 0; b < n_soc; ++b) {
    const int d = soc_dims[b];
    const double t = z[off];
    double nv = 0.0;
    for (int i = 1; i < d; ++i) nv += z[off + i] * z[off + i];
    nv = std::sqrt(nv);
    if (nv <= t) {
      // inside: keep.
    } else if (nv <= -t) {
      for (int i = 0; i < d; ++i) z[off + i] = 0.0;
    } else {
      const double s = 0.5 * (t + nv);
      const double scale = (nv > 0.0) ? s / nv : 0.0;
      z[off] = s;
      for (int i = 1; i < d; ++i) z[off + i] *= scale;
    }
    off += d;
  }
  if (shift != nullptr)
    for (size_t i = 0; i < z.size(); ++i) z[i] -= shift[i];
}

}  // namespace

extern "C" {

// Solve one conic QP. Returns 0 on success, 1 on factorization failure.
// All matrices row-major double. Outputs: x (nv), y (m), z (m), and
// residuals[2] = {primal_inf, dual_inf}.
int socp_solve(const double* P, const double* q, const double* A,
               const double* lb, const double* ub, const double* shift,
               int nv, int m, int n_box, const int32_t* soc_dims, int n_soc,
               int iters, double rho, double sigma, double alpha,
               const double* x0, const double* y0, const double* z0,
               double* x_out, double* y_out, double* z_out,
               double* residuals) {
  std::vector<double> rho_vec(m, rho);
  for (int i = 0; i < n_box; ++i)
    if (ub[i] - lb[i] < 1e-9) rho_vec[i] = rho * kEqRhoScale;

  // KKT matrix M = P + sigma I + A^T diag(rho) A, factored once.
  std::vector<double> M(static_cast<size_t>(nv) * nv);
  for (int i = 0; i < nv; ++i)
    for (int j = 0; j < nv; ++j) {
      double s = P[i * nv + j] + (i == j ? sigma : 0.0);
      for (int r = 0; r < m; ++r) s += A[r * nv + i] * rho_vec[r] * A[r * nv + j];
      M[i * nv + j] = s;
    }
  if (!cholesky(M, nv)) return 1;

  std::vector<double> x(nv, 0.0), y(m, 0.0), z(m, 0.0);
  if (x0 != nullptr) std::memcpy(x.data(), x0, nv * sizeof(double));
  if (y0 != nullptr) std::memcpy(y.data(), y0, m * sizeof(double));
  if (z0 != nullptr) {
    std::memcpy(z.data(), z0, m * sizeof(double));
  } else {
    project_cone(z, lb, ub, n_box, soc_dims, n_soc, shift);
  }

  std::vector<double> rhs(nv), Ax(m), zt(m);
  for (int it = 0; it < iters; ++it) {
    // rhs = sigma x - q + A^T (rho z - y); x = M^{-1} rhs.
    for (int i = 0; i < nv; ++i) rhs[i] = sigma * x[i] - q[i];
    for (int r = 0; r < m; ++r) {
      const double w = rho_vec[r] * z[r] - y[r];
      for (int i = 0; i < nv; ++i) rhs[i] += A[r * nv + i] * w;
    }
    chol_solve(M, nv, rhs);
    x.swap(rhs);
    // Ax, over-relaxed z-update, dual update.
    for (int r = 0; r < m; ++r) {
      double s = 0.0;
      for (int i = 0; i < nv; ++i) s += A[r * nv + i] * x[i];
      Ax[r] = alpha * s + (1.0 - alpha) * z[r];
    }
    for (int r = 0; r < m; ++r) zt[r] = Ax[r] + y[r] / rho_vec[r];
    project_cone(zt, lb, ub, n_box, soc_dims, n_soc, shift);
    for (int r = 0; r < m; ++r) {
      y[r] += rho_vec[r] * (Ax[r] - zt[r]);
      z[r] = zt[r];
    }
  }

  // Residuals: prim = ||A x - z||_inf; dual = ||P x + q + A^T y||_inf.
  double prim = 0.0, dual = 0.0;
  for (int r = 0; r < m; ++r) {
    double s = 0.0;
    for (int i = 0; i < nv; ++i) s += A[r * nv + i] * x[i];
    prim = std::max(prim, std::fabs(s - z[r]));
  }
  for (int i = 0; i < nv; ++i) {
    double s = q[i];
    for (int j = 0; j < nv; ++j) s += P[i * nv + j] * x[j];
    for (int r = 0; r < m; ++r) s += A[r * nv + i] * y[r];
    dual = std::max(dual, std::fabs(s));
  }
  std::memcpy(x_out, x.data(), nv * sizeof(double));
  std::memcpy(y_out, y.data(), m * sizeof(double));
  std::memcpy(z_out, z.data(), m * sizeof(double));
  residuals[0] = prim;
  residuals[1] = dual;
  return 0;
}

// Batched entry point: nb independent problems with identical static layout
// (nv, m, cones) but distinct data (the batch axis of
// ops/socp.py solve_socp).
int socp_solve_batch(const double* P, const double* q, const double* A,
                     const double* lb, const double* ub, const double* shift,
                     int nb, int nv, int m, int n_box,
                     const int32_t* soc_dims, int n_soc,
                     int iters, double rho, double sigma, double alpha,
                     double* x_out, double* y_out, double* z_out,
                     double* residuals) {
  int rc = 0;
  for (int b = 0; b < nb; ++b) {
    rc |= socp_solve(
        P + static_cast<size_t>(b) * nv * nv, q + static_cast<size_t>(b) * nv,
        A + static_cast<size_t>(b) * m * nv, lb + static_cast<size_t>(b) * n_box,
        ub + static_cast<size_t>(b) * n_box,
        shift ? shift + static_cast<size_t>(b) * m : nullptr,
        nv, m, n_box, soc_dims, n_soc, iters, rho, sigma, alpha,
        nullptr, nullptr, nullptr,
        x_out + static_cast<size_t>(b) * nv, y_out + static_cast<size_t>(b) * m,
        z_out + static_cast<size_t>(b) * m, residuals + 2 * b);
  }
  return rc;
}

}  // extern "C"
