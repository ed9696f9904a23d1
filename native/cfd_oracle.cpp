// cfd_oracle — native CPU oracle for the compact-FD framework.
//
// C++ counterpart of the reference's C/MPI numerical oracle
// (/root/reference/lanl-implementation/npts.c): the phi/psi
// parameterized-LU block-tridiagonal algorithm, plus a plain Thomas solver
// and a full compact-derivative evaluation used by the accuracy/timing
// mains. This is an independent-language implementation of the same math as
// cfd_tpu/oracle/lanl.py — blocks are emulated in-process (the distributed
// dataflow is preserved: per-block local sweeps, two scalars per block face
// crossing block boundaries, a serial closure recurrence over faces).
//
// Exposed via a C ABI for the ctypes wrapper in cfd_tpu/oracle/native.py.
//
// Build: make -C native   (produces libcfd_oracle.so)

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Global LU pivots: beta[i] = d[i] - dl[i]*du[i-1]/beta[i-1]
void compute_beta(const double* dl, const double* d, const double* du, int n,
                  double* beta) {
  beta[0] = d[0];
  for (int i = 1; i < n; ++i) {
    beta[i] = d[i] - dl[i] * du[i - 1] / beta[i - 1];
  }
}

}  // namespace

extern "C" {

// Thomas solve of one set of bands against `batch` right-hand sides.
// rhs/x are (n, batch) row-major (solve axis leading, batch contiguous).
int cfd_thomas_solve(const double* dl, const double* d, const double* du,
                     const double* rhs, double* x, int64_t n, int64_t batch) {
  if (n < 1 || batch < 1) return 1;
  std::vector<double> dhat(n);
  std::vector<double> y(n * batch);
  dhat[0] = d[0];
  std::memcpy(y.data(), rhs, sizeof(double) * batch);
  for (int64_t i = 1; i < n; ++i) {
    const double w = dl[i] / dhat[i - 1];
    dhat[i] = d[i] - w * du[i - 1];
    const double* ym = &y[(i - 1) * batch];
    const double* r = &rhs[i * batch];
    double* yi = &y[i * batch];
    for (int64_t b = 0; b < batch; ++b) yi[b] = r[b] - w * ym[b];
  }
  {
    const double inv = 1.0 / dhat[n - 1];
    const double* yn = &y[(n - 1) * batch];
    double* xn = &x[(n - 1) * batch];
    for (int64_t b = 0; b < batch; ++b) xn[b] = yn[b] * inv;
  }
  for (int64_t i = n - 2; i >= 0; --i) {
    const double inv = 1.0 / dhat[i];
    const double c = du[i];
    const double* yi = &y[i * batch];
    const double* xp = &x[(i + 1) * batch];
    double* xi = &x[i * batch];
    for (int64_t b = 0; b < batch; ++b) xi[b] = (yi[b] - c * xp[b]) * inv;
  }
  return 0;
}

// phi/psi parameterized-LU solve with the line split into `nblocks` equal
// blocks. Dataflow mirrors a distributed line: each block runs local
// forward/backward sweeps expressing its values as affine functions of one
// incoming value; faces are "allgathered" and closed with a serial
// recurrence of length nblocks.
int cfd_phi_psi_solve(const double* dl, const double* d, const double* du,
                      const double* rhs, double* x, int64_t n, int64_t batch,
                      int64_t nblocks) {
  if (n < 1 || batch < 1 || nblocks < 1 || n % nblocks) return 1;
  const int64_t m = n / nblocks;
  std::vector<double> beta(n);
  compute_beta(dl, d, du, n, beta.data());

  // forward sweep: y = phi + psi * y_in per block (psi is RHS-independent)
  std::vector<double> phi(n * batch);
  std::vector<double> psi(n, 0.0);
  for (int64_t r = 0; r < nblocks; ++r) {
    const int64_t s = r * m, e = s + m;
    std::memcpy(&phi[s * batch], &rhs[s * batch], sizeof(double) * batch);
    psi[s] = (s > 0) ? -(dl[s] / beta[s - 1]) : 0.0;
    for (int64_t i = s + 1; i < e; ++i) {
      const double k = dl[i] / beta[i - 1];
      const double* pm = &phi[(i - 1) * batch];
      const double* ri = &rhs[i * batch];
      double* pi = &phi[i * batch];
      for (int64_t b = 0; b < batch; ++b) pi[b] = ri[b] - k * pm[b];
      psi[i] = -k * psi[i - 1];
    }
  }
  // close the forward recurrence over block faces
  std::vector<double> Y(nblocks * batch);
  std::memcpy(&Y[0], &phi[(m - 1) * batch], sizeof(double) * batch);
  for (int64_t r = 1; r < nblocks; ++r) {
    const int64_t last = (r + 1) * m - 1;
    const double ps = psi[last];
    const double* pl = &phi[last * batch];
    const double* ym = &Y[(r - 1) * batch];
    double* yr = &Y[r * batch];
    for (int64_t b = 0; b < batch; ++b) yr[b] = pl[b] + ps * ym[b];
  }
  std::vector<double> y(n * batch);
  for (int64_t r = 0; r < nblocks; ++r) {
    const int64_t s = r * m, e = s + m;
    const double* yin = (r > 0) ? &Y[(r - 1) * batch] : nullptr;
    for (int64_t i = s; i < e; ++i) {
      const double ps = psi[i];
      const double* pi = &phi[i * batch];
      double* yi = &y[i * batch];
      if (yin) {
        for (int64_t b = 0; b < batch; ++b) yi[b] = pi[b] + ps * yin[b];
      } else {
        std::memcpy(yi, pi, sizeof(double) * batch);
      }
    }
  }

  // backward sweep: x = theta + eta * x_in per block
  std::vector<double>& theta = phi;  // reuse storage
  std::vector<double> eta(n, 0.0);
  for (int64_t r = 0; r < nblocks; ++r) {
    const int64_t s = r * m, e = s + m;
    const int64_t i0 = e - 1;
    {
      const double inv = 1.0 / beta[i0];
      const double* yi = &y[i0 * batch];
      double* ti = &theta[i0 * batch];
      for (int64_t b = 0; b < batch; ++b) ti[b] = yi[b] * inv;
      eta[i0] = (i0 < n - 1) ? -(du[i0] / beta[i0]) : 0.0;
    }
    for (int64_t i = e - 2; i >= s; --i) {
      const double inv = 1.0 / beta[i];
      const double c = du[i];
      const double* yi = &y[i * batch];
      const double* tp = &theta[(i + 1) * batch];
      double* ti = &theta[i * batch];
      for (int64_t b = 0; b < batch; ++b) ti[b] = (yi[b] - c * tp[b]) * inv;
      eta[i] = -(c * inv) * eta[i + 1];
    }
  }
  std::vector<double> X(nblocks * batch);
  {
    const int64_t s = (nblocks - 1) * m;
    std::memcpy(&X[(nblocks - 1) * batch], &theta[s * batch],
                sizeof(double) * batch);
  }
  for (int64_t r = nblocks - 2; r >= 0; --r) {
    const int64_t s = r * m;
    const double et = eta[s];
    const double* tf = &theta[s * batch];
    const double* xp = &X[(r + 1) * batch];
    double* xr = &X[r * batch];
    for (int64_t b = 0; b < batch; ++b) xr[b] = tf[b] + et * xp[b];
  }
  for (int64_t r = 0; r < nblocks; ++r) {
    const int64_t s = r * m, e = s + m;
    const double* xin = (r < nblocks - 1) ? &X[(r + 1) * batch] : nullptr;
    for (int64_t i = s; i < e; ++i) {
      const double et = eta[i];
      const double* ti = &theta[i * batch];
      double* xi = &x[i * batch];
      if (xin) {
        for (int64_t b = 0; b < batch; ++b) xi[b] = ti[b] + et * xin[b];
      } else {
        std::memcpy(xi, ti, sizeof(double) * batch);
      }
    }
  }
  return 0;
}

// Compact 4th-order derivative of `batch` lines of length n (Pade interior,
// 3rd-order closures), solved with the phi/psi algorithm — the native
// equivalent of the reference oracle's end-to-end accuracy path.
int cfd_compact_dfdx_pade4(const double* f, double* dfdx, int64_t n,
                           int64_t batch, int64_t nblocks, double dx) {
  if (n < 4) return 1;
  std::vector<double> dl(n, 0.25), d(n, 1.0), du(n, 0.25), rhs(n * batch);
  dl[0] = 0.0;
  du[0] = 2.0;
  dl[n - 1] = 2.0;
  du[n - 1] = 0.0;
  const double w1 = 0.75 / dx;
  for (int64_t b = 0; b < batch; ++b) {
    const double* fb = &f[b];  // strided access: f is (n, batch)
    rhs[b] = (-2.5 * f[b] + 2.0 * f[batch + b] + 0.5 * f[2 * batch + b]) / dx;
    rhs[(n - 1) * batch + b] = (2.5 * f[(n - 1) * batch + b] -
                                2.0 * f[(n - 2) * batch + b] -
                                0.5 * f[(n - 3) * batch + b]) /
                               dx;
    (void)fb;
  }
  for (int64_t i = 1; i < n - 1; ++i) {
    const double* fp = &f[(i + 1) * batch];
    const double* fm = &f[(i - 1) * batch];
    double* ri = &rhs[i * batch];
    for (int64_t b = 0; b < batch; ++b) ri[b] = w1 * (fp[b] - fm[b]);
  }
  return cfd_phi_psi_solve(dl.data(), d.data(), du.data(), rhs.data(), dfdx,
                           n, batch, nblocks);
}

}  // extern "C"
