// Device model of one lambda's population, shared by the hand-written
// kernels of chimera_tpu_torch (fused_kde.cu, rows_contract.cu,
// fused_kde_adjoint.cu, rows_contract_adjoint.cu):
//
//   Model<T, S>  FLRW or MGFLRW with the Chebyshev inverse distance map (z
//                from dGW: the same series either way) and the build's mass
//                model with the analytic conditional CDF (p_m1m2), read from
//                the packed per-lambda rows (ops/cuda/fused.py,
//                pack_params): the two Chebyshev series summed in S, the
//                rest in T.  The device functions mirror the Python
//                expressions operation by operation: exp(a log x) powers, the
//                1e-99 window eps (0 in float), the divisor guard of p_m1m2.
//   MassModel<N> the mass model in the number type N: T in the forward
//                kernels, a forward-mode dual number (adjoint.cuh) in the
//                adjoint kernels' prologue (the derived fields' Jacobian)
//                and as their reverse sweep's oracle in the host tests.
//                One model a build: CHIMERA_MASS_KIND (MassKind, 0 =
//                PowerLawPeak by default) selects it at compile time, so
//                each kernel source builds into one library a mass model
//                (ops/cuda/build.py) and PowerLawPeak's code is that of a
//                build without the macro.
//   block_sum    deterministic block-wide sums of per-thread partials;
//   DeviceBlock  a CUDA block as the `Block` of kde.cuh and adjoint.cuh;
//   WarpBlock    a warp as a `Block` of its own.
//
// Everything lives in an anonymous namespace: each kernel file compiles its
// own copy.  The build hashes this header with every kernel source.

#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGridPerThread = 4;

#ifndef CHIMERA_MASS_KIND
#define CHIMERA_MASS_KIND 0
#endif
// the mass models, in the order of MASS_KINDS in ops/cuda/fused.py
enum MassKind {
  kPowerLawPeak, kTruncatedPowerLaw, kBrokenPowerLaw, kPowerLawTwoPeaks,
  kPowerLawSpline
};
constexpr int kMassKind = CHIMERA_MASS_KIND;
// the conditional CDF below m_join is a Chebyshev window series (every model
// but TruncatedPowerLaw, whose CDF is closed form and has no window series)
constexpr bool kWindowCdf = kMassKind != kTruncatedPowerLaw;

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }
__device__ __forceinline__ float dlog1p(float x) { return log1pf(x); }
__device__ __forceinline__ double dlog1p(double x) { return log1p(x); }
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
__device__ __forceinline__ double dabs(double x) { return fabs(x); }

template <typename T>
__device__ __forceinline__ T dmax(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T dmin(T a, T b) { return a < b ? a : b; }
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) { return dmin(dmax(x, lo), hi); }
__device__ __forceinline__ bool finite(float x) { return fabsf(x) <= FLT_MAX; }
__device__ __forceinline__ bool finite(double x) { return fabs(x) <= DBL_MAX; }

// Clenshaw recurrence of sum_k c_k T_k(t), the order of ops/chebyshev.py
template <typename T>
__device__ __forceinline__ T clenshaw(const T* __restrict__ c, int n, T t) {
  const T t2 = T(2) * t;
  T b1 = T(0), b2 = T(0);
  for (int k = n - 1; k >= 1; --k) {
    const T b0 = t2 * b1 - b2 + c[k];
    b2 = b1;
    b1 = b0;
  }
  return t * b1 - b2 + c[0];
}

// The Clenshaw sum and its derivative in t (the recurrence differentiated
// term by term); returns the sum.
template <typename T>
__device__ __forceinline__ T clenshaw_d(const T* __restrict__ c, int n, T t,
                                        T& ds) {
  const T t2 = T(2) * t;
  T b1 = T(0), b2 = T(0), d1 = T(0), d2 = T(0);
  for (int k = n - 1; k >= 1; --k) {
    const T b0 = t2 * b1 - b2 + c[k];
    const T d0 = T(2) * b1 + t2 * d1 - d2;
    b2 = b1;
    b1 = b0;
    d2 = d1;
    d1 = d0;
  }
  ds = b1 + t * d1 - d2;
  return t * b1 - b2 + c[0];
}

template <typename T>
__device__ __forceinline__ T powx(T x, T a) { return dexp(a * dlog(x)); }

template <typename T>
__device__ __forceinline__ T tpl_unnorm(T m, T alpha, T lo, T hi) {
  return (lo <= m && m <= hi) ? powx(dmax(m, T(1e-30)), alpha) : T(0);
}

template <typename T>
__device__ __forceinline__ T tpl_cdf(T alpha, T m_low, T m) {
  const T mp = dmax(m, T(1e-30));
  if (alpha == T(-1)) return dlog(m_low) - dlog(mp);
  return (powx(mp, T(1) + alpha) - powx(m_low, T(1) + alpha)) / (T(1) + alpha);
}

// LVK low-mass window; eps is 0 in float, as in the JAX package's float32
template <typename T>
__device__ __forceinline__ T smoothing(T m, T dm, T m_low) {
  if (m < m_low) return T(0);
  if (m >= m_low + dm) return T(1);
  const T eps = T(1e-99);
  const T x = dm / (m - m_low + eps) + dm / (m - m_low - dm + eps);
  const T softplus = dmax(x, T(0)) + dlog1p(dexp(-dabs(x)));
  return dexp(-softplus);
}

// Shared-memory bytes of one lambda's Chebyshev series in S (cheb_logh[cd],
// dgw_lo, dgw_max, cheb_cdf_window[wd]), rounded up to 16 bytes so that what
// follows it in shared memory stays aligned for vector loads.
template <typename S>
__host__ __device__ constexpr size_t series_bytes(int cd, int wd) {
  return ((size_t)(cd + 2 + wd) * sizeof(S) + 15) / 16 * 16;
}

// The mass models of one lambda in the number type N (models/mass.py),
// one per build.  Each holds its kMassScalars scalars (MODEL_SCALARS of its
// class in ops/cuda/fused.py, in that order; load() reads them), and the
// derived fields that derive() fills, or that load_derived() reads in the
// record's order (the adjoints' prologue derives them once a lambda);
// kCarried of them carry a cotangent, the others enter comparisons only.
// scalars(), derived() and carried() visit the fields in those orders.
// primary(m) and secondary(m2, m1) are the unnormalized pdfs; joint() is
// p_m1m2 given the conditional CDF at m1.

// p(m1) p(m2 | m1) given the conditional CDF at m1 (models/mass.py::p_m1m2)
template <typename M, typename N>
__device__ __forceinline__ N joint_of(const M& mm, N m1, N m2, N cdf) {
  const N p1 = mm.primary(m1) / mm.norm_p_m1;
  N p21 = mm.secondary(m2, m1);
  const bool ok = cdf > N(0);
  p21 = p21 / (ok ? cdf : N(1));
  if (!(ok && m1 > mm.m1_floor)) p21 = N(0);
  if (!finite(p21)) p21 = N(0);
  return p1 * p21;
}

// the truncated Gaussian peak of mass.py::truncated_gaussian on [m_low, hi]
template <typename N>
__device__ __forceinline__ N gauss_peak(N m, N m_low, N hi, N mu, N sigma,
                                        N log_sigma, N norm) {
  if (!(m_low <= m && m <= hi)) return N(0);
  const N dx = m - mu;
  // -0.5 log(2 pi) - log(sigma) - (x - mu)^2 / (2 sigma^2)
  return dexp(N(-0.91893853320467274178) - log_sigma
              - dx * dx / (N(2) * (sigma * sigma))) / norm;
}

#if CHIMERA_MASS_KIND == 0  // PowerLawPeak
constexpr int kMassScalars = 12;
constexpr int kDerivedFields = 4;
constexpr int kCarried = 2;

template <typename N>
struct MassModel {
  N m_low, m_high, alpha, beta, delta_m, lambda_peak, mu_g, sigma_g;
  N peak_norm, norm_p_m1, m_join, cdf_at_join;
  N pl_norm, peak_hi, log_sigma, m1_floor;

  template <typename U>
  __device__ __forceinline__ void load(const U* s) {
    m_low = s[0]; m_high = s[1]; alpha = s[2];
    beta = s[3]; delta_m = s[4]; lambda_peak = s[5];
    mu_g = s[6]; sigma_g = s[7]; peak_norm = s[8];
    norm_p_m1 = s[9]; m_join = s[10]; cdf_at_join = s[11];
  }
  __device__ __forceinline__ void load_derived(const N* d) {
    pl_norm = d[0]; peak_hi = d[1];
    log_sigma = d[2]; m1_floor = d[3];
  }
  template <typename F>
  __device__ __forceinline__ void scalars(F&& f) {
    f(m_low); f(m_high); f(alpha); f(beta); f(delta_m); f(lambda_peak);
    f(mu_g); f(sigma_g); f(peak_norm); f(norm_p_m1); f(m_join);
    f(cdf_at_join);
  }
  template <typename F>
  __device__ __forceinline__ void derived(F&& f) {
    f(pl_norm); f(peak_hi); f(log_sigma); f(m1_floor);
  }
  template <typename F>
  __device__ __forceinline__ void carried(F&& f) { f(pl_norm); f(log_sigma); }

  __device__ __forceinline__ void derive() {
    pl_norm = tpl_cdf(-alpha, m_low, m_high);
    peak_hi = mu_g + N(5) * sigma_g;
    log_sigma = dlog(sigma_g);
    m1_floor = m_low * N(1.0 + 1e-9);
  }

  __device__ __forceinline__ N primary(N m) const {
    const N pl = tpl_unnorm(m, -alpha, m_low, m_high) / pl_norm;
    N peak = N(0);
    if (m_low <= m && m <= peak_hi) {
      const N dx = m - mu_g;
      // -0.5 log(2 pi) - log(sigma) - (x - mu)^2 / (2 sigma^2)
      peak = dexp(N(-0.91893853320467274178) - log_sigma
                  - dx * dx / (N(2) * (sigma_g * sigma_g))) / peak_norm;
    }
    const N pdf = (N(1) - lambda_peak) * pl + lambda_peak * peak;
    return pdf * smoothing(m, delta_m, m_low);
  }

  __device__ __forceinline__ N secondary(N m2, N m1) const {
    return tpl_unnorm(m2, beta, m_low, m1) * smoothing(m2, delta_m, m_low);
  }

  // the conditional CDF above m_join, in closed form
  __device__ __forceinline__ N cdf_above_join(N m1c) const {
    return cdf_at_join + tpl_cdf(beta, m_join, m1c);
  }

  __device__ __forceinline__ N joint(N m1, N m2, N cdf) const {
    const N p1 = primary(m1) / norm_p_m1;
    N p21 = secondary(m2, m1);
    const bool ok = cdf > N(0);
    p21 = p21 / (ok ? cdf : N(1));
    if (!(ok && m1 > m1_floor)) p21 = N(0);
    if (!finite(p21)) p21 = N(0);
    return p1 * p21;
  }
};

#elif CHIMERA_MASS_KIND == 1  // TruncatedPowerLaw: no window, closed-form CDF
constexpr int kMassScalars = 5;
constexpr int kDerivedFields = 1;
constexpr int kCarried = 0;

template <typename N>
struct MassModel {
  N m_low, m_high, alpha, beta, norm_p_m1;
  N m1_floor;

  template <typename U>
  __device__ __forceinline__ void load(const U* s) {
    int i = 0;
    scalars([&](N& x) { x = N(s[i++]); });
  }
  __device__ __forceinline__ void load_derived(const N* d) { m1_floor = d[0]; }
  template <typename F>
  __device__ __forceinline__ void scalars(F&& f) {
    f(m_low); f(m_high); f(alpha); f(beta); f(norm_p_m1);
  }
  template <typename F>
  __device__ __forceinline__ void derived(F&& f) { f(m1_floor); }
  template <typename F>
  __device__ __forceinline__ void carried(F&&) {}

  __device__ __forceinline__ void derive() { m1_floor = m_low * N(1.0 + 1e-9); }

  __device__ __forceinline__ N primary(N m) const {
    return tpl_unnorm(m, -alpha, m_low, m_high);
  }
  __device__ __forceinline__ N secondary(N m2, N m1) const {
    return tpl_unnorm(m2, beta, m_low, m1);
  }
  // the conditional CDF at m1c in [m_low, m_high], in closed form
  __device__ __forceinline__ N cdf_closed(N m1c) const {
    return tpl_cdf(beta, m_low, m1c);
  }
  __device__ __forceinline__ N joint(N m1, N m2, N cdf) const {
    return joint_of(*this, m1, m2, cdf);
  }
};

#elif CHIMERA_MASS_KIND == 2  // BrokenPowerLaw
constexpr int kMassScalars = 10;
constexpr int kDerivedFields = 4;
constexpr int kCarried = 2;

template <typename N>
struct MassModel {
  N m_low, m_high, alpha_1, alpha_2, beta, delta_m, break_fraction;
  N norm_p_m1, m_join, cdf_at_join;
  N pl1_at_break, pl2_at_break, m_break, m1_floor;

  template <typename U>
  __device__ __forceinline__ void load(const U* s) {
    int i = 0;
    scalars([&](N& x) { x = N(s[i++]); });
  }
  __device__ __forceinline__ void load_derived(const N* d) {
    int i = 0;
    derived([&](N& x) { x = d[i++]; });
  }
  template <typename F>
  __device__ __forceinline__ void scalars(F&& f) {
    f(m_low); f(m_high); f(alpha_1); f(alpha_2); f(beta); f(delta_m);
    f(break_fraction); f(norm_p_m1); f(m_join); f(cdf_at_join);
  }
  template <typename F>
  __device__ __forceinline__ void derived(F&& f) {
    f(pl1_at_break); f(pl2_at_break); f(m_break); f(m1_floor);
  }
  template <typename F>
  __device__ __forceinline__ void carried(F&& f) {
    f(pl1_at_break); f(pl2_at_break);
  }

  __device__ __forceinline__ void derive() {
    m_break = m_low + break_fraction * (m_high - m_low);
    pl1_at_break = tpl_unnorm(m_break, -alpha_1, m_low, m_break);
    pl2_at_break = tpl_unnorm(m_break, -alpha_2, m_break, m_high);
    m1_floor = m_low * N(1.0 + 1e-9);
  }

  __device__ __forceinline__ N primary(N m) const {
    N pdf = tpl_unnorm(m, -alpha_1, m_low, m_break);
    pdf = pdf + tpl_unnorm(m, -alpha_2, m_break, m_high) * pl1_at_break
                    / pl2_at_break;
    return pdf * smoothing(m, delta_m, m_low);
  }
  __device__ __forceinline__ N secondary(N m2, N m1) const {
    return tpl_unnorm(m2, beta, m_low, m1) * smoothing(m2, delta_m, m_low);
  }
  __device__ __forceinline__ N cdf_above_join(N m1c) const {
    return cdf_at_join + tpl_cdf(beta, m_join, m1c);
  }
  __device__ __forceinline__ N joint(N m1, N m2, N cdf) const {
    return joint_of(*this, m1, m2, cdf);
  }
};

#elif CHIMERA_MASS_KIND == 3  // PowerLawTwoPeaks
constexpr int kMassScalars = 16;
constexpr int kDerivedFields = 6;
constexpr int kCarried = 3;

template <typename N>
struct MassModel {
  N m_low, m_high, alpha, beta, delta_m, lambda_peak, lambda1;
  N mu1_g, sigma1_g, mu2_g, sigma2_g, peak1_norm, peak2_norm;
  N norm_p_m1, m_join, cdf_at_join;
  N pl_norm, log_sigma1, log_sigma2, peak1_hi, peak2_hi, m1_floor;

  template <typename U>
  __device__ __forceinline__ void load(const U* s) {
    int i = 0;
    scalars([&](N& x) { x = N(s[i++]); });
  }
  __device__ __forceinline__ void load_derived(const N* d) {
    int i = 0;
    derived([&](N& x) { x = d[i++]; });
  }
  template <typename F>
  __device__ __forceinline__ void scalars(F&& f) {
    f(m_low); f(m_high); f(alpha); f(beta); f(delta_m); f(lambda_peak);
    f(lambda1); f(mu1_g); f(sigma1_g); f(mu2_g); f(sigma2_g); f(peak1_norm);
    f(peak2_norm); f(norm_p_m1); f(m_join); f(cdf_at_join);
  }
  template <typename F>
  __device__ __forceinline__ void derived(F&& f) {
    f(pl_norm); f(log_sigma1); f(log_sigma2); f(peak1_hi); f(peak2_hi);
    f(m1_floor);
  }
  template <typename F>
  __device__ __forceinline__ void carried(F&& f) {
    f(pl_norm); f(log_sigma1); f(log_sigma2);
  }

  __device__ __forceinline__ void derive() {
    pl_norm = tpl_cdf(-alpha, m_low, m_high);
    log_sigma1 = dlog(sigma1_g);
    log_sigma2 = dlog(sigma2_g);
    peak1_hi = mu1_g + N(5) * sigma1_g;
    peak2_hi = mu2_g + N(5) * sigma2_g;
    m1_floor = m_low * N(1.0 + 1e-9);
  }

  __device__ __forceinline__ N primary(N m) const {
    const N pl = tpl_unnorm(m, -alpha, m_low, m_high) / pl_norm;
    const N g1 = gauss_peak(m, m_low, peak1_hi, mu1_g, sigma1_g, log_sigma1,
                            peak1_norm);
    const N g2 = gauss_peak(m, m_low, peak2_hi, mu2_g, sigma2_g, log_sigma2,
                            peak2_norm);
    const N pdf = (N(1) - lambda_peak) * pl + lambda_peak * lambda1 * g1
                  + lambda_peak * (N(1) - lambda1) * g2;
    return pdf * smoothing(m, delta_m, m_low);
  }
  __device__ __forceinline__ N secondary(N m2, N m1) const {
    return tpl_unnorm(m2, beta, m_low, m1) * smoothing(m2, delta_m, m_low);
  }
  __device__ __forceinline__ N cdf_above_join(N m1c) const {
    return cdf_at_join + tpl_cdf(beta, m_join, m1c);
  }
  __device__ __forceinline__ N joint(N m1, N m2, N cdf) const {
    return joint_of(*this, m1, m2, cdf);
  }
};

#elif CHIMERA_MASS_KIND == 4  // PowerLawSpline
// the spline's coefficients follow its 8 scalars and their count in the
// packed row, up to kMaxKnots of them (ops/cuda/fused.py, pack_params)
constexpr int kMaxKnots = 23;
constexpr int kMassScalars = 9 + kMaxKnots;
constexpr int kDerivedFields = 3;
constexpr int kCarried = 2;

// a number's value as a double, for the knots' index arithmetic (the
// adjoints' dual numbers add their own overload)
__device__ __forceinline__ float scalar_of(float x) { return x; }
__device__ __forceinline__ double scalar_of(double x) { return x; }

template <typename N>
struct MassModel {
  N m_low, m_high, alpha, beta, delta_m, norm_p_m1, m_join, cdf_at_join;
  const N* coef;  // the num_knots coefficients, in the packed row
  int num_knots;
  N log_lo, log_hi, m1_floor;

  __device__ __forceinline__ void load(const N* s) {
    m_low = s[0]; m_high = s[1]; alpha = s[2]; beta = s[3]; delta_m = s[4];
    norm_p_m1 = s[5]; m_join = s[6]; cdf_at_join = s[7];
    num_knots = (int)s[8];
    coef = s + 9;
  }
  __device__ __forceinline__ void load_derived(const N* d) {
    log_lo = d[0]; log_hi = d[1]; m1_floor = d[2];
  }
  // the scalars with a cotangent of their own (the adjoints' dual seeds):
  // the 8 before num_knots; the coefficients' cotangents are the knots'
  // points (adjoint.cuh, project_knots)
  template <typename F>
  __device__ __forceinline__ void scalars(F&& f) {
    f(m_low); f(m_high); f(alpha); f(beta); f(delta_m); f(norm_p_m1);
    f(m_join); f(cdf_at_join);
  }
  template <typename F>
  __device__ __forceinline__ void derived(F&& f) {
    f(log_lo); f(log_hi); f(m1_floor);
  }
  // the knots move with m_low and m_high through their logs
  template <typename F>
  __device__ __forceinline__ void carried(F&& f) { f(log_lo); f(log_hi); }
  __device__ __forceinline__ void derive() {
    log_lo = dlog(m_low);
    log_hi = dlog(m_high);
    m1_floor = m_low * N(1.0 + 1e-9);
  }

  // knot j of linspace(log m_low, log m_high, num_knots + 2) in the
  // arithmetic of jnp.linspace (ops/integrate.py::linspace)
  __device__ __forceinline__ N knot(int j, int div) const {
    if (j >= div) return log_hi;
    const N step = N(j) / N(div);
    return log_lo * (N(1) - step) + log_hi * step;
  }
  // the knots' values, the edge ones pinned at 0
  __device__ __forceinline__ N knot_value(int j) const {
    return j >= 1 && j <= num_knots ? coef[j - 1] : N(0);
  }
  // jnp.interp's interval [knot(i - 1), knot(i)] of x in [log m_low,
  // log m_high], 0 outside it: i from the uniform knots' index arithmetic,
  // moved by at most one knot each way to where searchsorted (side
  // 'right') puts x
  __device__ __forceinline__ int interval(N x) const {
    const int div = num_knots + 1;
    if (x < log_lo || x > log_hi) return 0;
    int i = (int)scalar_of((x - log_lo) / (log_hi - log_lo) * N(div)) + 1;
    i = i < 1 ? 1 : (i > div ? div : i);
    if (i < div && knot(i, div) <= x) ++i;
    if (i > 1 && knot(i - 1, div) > x) --i;
    return i;
  }
  // jnp.interp(log max(m, 1e-30), knots, [0, coef, 0]), held at the edge
  // knots' 0 outside [log m_low, log m_high]
  __device__ __forceinline__ N perturbation(N m) const {
    const N x = dlog(dmax(m, N(1e-30)));
    const int i = interval(x);
    if (i == 0) return N(0);
    const int div = num_knots + 1;
    const N lo = knot(i - 1, div), hi = knot(i, div);
    const N f0 = knot_value(i - 1);
    return f0 + ((x - lo) / (hi - lo)) * (knot_value(i) - f0);
  }

  __device__ __forceinline__ N primary(N m) const {
    N pdf = tpl_unnorm(m, -alpha, m_low, m_high);
    pdf = pdf * smoothing(m, delta_m, m_low);
    return pdf * dexp(perturbation(m));
  }
  __device__ __forceinline__ N secondary(N m2, N m1) const {
    return tpl_unnorm(m2, beta, m_low, m1) * smoothing(m2, delta_m, m_low);
  }
  __device__ __forceinline__ N cdf_above_join(N m1c) const {
    return cdf_at_join + tpl_cdf(beta, m_join, m1c);
  }
  __device__ __forceinline__ N joint(N m1, N m2, N cdf) const {
    return joint_of(*this, m1, m2, cdf);
  }
};

#else
#error "CHIMERA_MASS_KIND names no mass model"
#endif
// the mass scalars' slots where a kernel keeps them in shared memory before
// other arrays: a multiple of 16 bytes, so that pairs after them stay
// aligned (PowerLawPeak's 12 as they are)
constexpr int kMassSlots = (kMassScalars + 3) / 4 * 4;

// One lambda's model state.  The two Chebyshev series (the inverse distance
// map and the conditional-CDF window) are summed in S: double in the
// dark-siren kernels, where a float32 sum biases every z of an event alike
// and loses the CDF just above m_low (models/cosmology.py::z_from_dgw,
// models/mass.py::conditional_cdf_at); T in the spectral kernels, whose
// likelihood does not feel either.
template <typename T, typename S>
struct Model {
  const S* cheb_logh;
  const S* window;
  int cheb_deg, window_deg;
  S dgw_lo, dgw_max, log_lo, log_hi;
  MassModel<T> mass;

  // series: cheb_logh[cd], dgw_lo, dgw_max, cheb_cdf_window[wd] (wd = 0
  // without a window series); s: the MODEL_SCALARS of the build's model
  // (ops/cuda/fused.py, pack_params); derived: its derived fields as
  // MassModel::derive() gives them (the adjoint kernels' per-lambda
  // prologue), or null to derive them here
  __device__ Model(const S* series, const T* s, int cd, int wd,
                   const T* derived = nullptr) {
    cheb_logh = series;
    cheb_deg = cd;
    window_deg = wd;
    dgw_lo = series[cd];
    dgw_max = series[cd + 1];
    window = series + cd + 2;
    mass.load(s);
    if (derived == nullptr) {
      mass.derive();
    } else {
      mass.load_derived(derived);
    }
    log_lo = dlog(dgw_lo);
    log_hi = dlog(dgw_max);
  }

  // clamp, log and exp in T, the Clenshaw sum in S (models/cosmology.py::
  // z_from_dgw does the same operations with S = float64)
  __device__ __forceinline__ T z_from_dgw(T dgw) const {
    const T d = clip(dgw, T(dgw_lo), T(dgw_max));
    const S t = (S(2) * S(dlog(d)) - (log_lo + log_hi)) / (log_hi - log_lo);
    return d * dexp(T(clenshaw(cheb_logh, cheb_deg, t)));
  }

  // the window segment's t and Clenshaw sum in S (models/mass.py::
  // conditional_cdf_at with S = float64), or the closed form of a model
  // without a window
  __device__ __forceinline__ T conditional_cdf(T m1) const {
    const T m1c = clip(m1, mass.m_low, mass.m_high);
    if constexpr (!kWindowCdf) {
      return mass.cdf_closed(m1c);
    } else {
      if (m1c <= mass.m_join) {
        const S lo = S(mass.m_low), hi = S(mass.m_join);
        const S x = clip(S(m1c), lo, hi);
        const S t = (S(2) * x - (lo + hi)) / (hi - lo);
        return T(clenshaw(window, window_deg, t));
      }
      return mass.cdf_above_join(m1c);
    }
  }

  __device__ __forceinline__ T p_m1m2(T m1, T m2) const {
    return mass.joint(m1, m2, conditional_cdf(m1));
  }
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sums of N values per thread over a block of W warps, in a
// fixed order (deterministic); every thread receives the totals.
template <typename T, int N, int W = kWarps>
__device__ __forceinline__ void block_sum(T (&v)[N], T (*scratch)[W]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = warp_sum(v[i]);
    if (lane == 0) scratch[i][warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T t = T(0);
    for (int w = 0; w < W; ++w) t += scratch[i][w];
    v[i] = t;
  }
  __syncthreads();
}

// Block-wide min of lo and max of hi; every thread receives both.
template <typename T, int W = kWarps>
__device__ __forceinline__ void block_minmax(T& lo, T& hi, T (*scratch)[W]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int o = 16; o > 0; o >>= 1) {
    lo = dmin(lo, __shfl_down_sync(0xffffffffu, lo, o));
    hi = dmax(hi, __shfl_down_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) {
    scratch[0][warp] = lo;
    scratch[1][warp] = hi;
  }
  __syncthreads();
  lo = scratch[0][0];
  hi = scratch[1][0];
  for (int w = 1; w < W; ++w) {
    lo = dmin(lo, scratch[0][w]);
    hi = dmax(hi, scratch[1][w]);
  }
  __syncthreads();
}

// A CUDA block of W warps (kThreads threads by default) as the `Block` of
// the arithmetic written once for a block (kde.cuh, adjoint.cuh): the
// thread's rank, the stride, its lane in its warp, block-wide sums,
// min/max, any and a barrier; over the thread's warp a min/max, a ballot
// and the span of two ints.  The host emulation (tests/host_emulation)
// runs the same functions with a block of one thread, whose `tile` tallies
// the tiles the pruned pair loops (kde.cuh) test and skip.
template <typename T, int W = kWarps>
struct DeviceBlock {
  T (*scratch)[W];
  static constexpr int kSize = 32 * W;
  static constexpr int kLanes = 32;  // lanes of the warps the block is cut in
  __device__ __forceinline__ int rank() const { return threadIdx.x; }
  __device__ __forceinline__ int lane() const { return threadIdx.x % 32; }
  template <int N>
  __device__ __forceinline__ void sum(T (&v)[N]) const {
    block_sum<T, N, W>(v, scratch);
  }
  __device__ __forceinline__ void minmax(T& lo, T& hi) const {
    block_minmax<T, W>(lo, hi, scratch);
  }
  __device__ __forceinline__ bool any(bool v) const {
    return __syncthreads_or(v) != 0;
  }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  // min of lo and max of hi over the thread's warp; every lane receives both
  __device__ __forceinline__ void warp_minmax(T& lo, T& hi) const {
    for (int o = 16; o > 0; o >>= 1) {
      lo = dmin(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = dmax(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
  }
  // the lanes of the thread's warp where v holds, bit j for lane j
  __device__ __forceinline__ unsigned ballot(bool v) const {
    return __ballot_sync(0xffffffffu, v);
  }
  __device__ __forceinline__ void tile(bool) const {}
  // the least lo and the largest hi over the thread's warp
  __device__ __forceinline__ void warp_span(int& lo, int& hi) const {
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
  }
};

// A warp as a `Block` of its own (K3c and K1d on logical rows: a warp a
// row): its sums, min/max and any over its 32 lanes by xor exchanges, whose
// pairwise sums are commutative so that every lane holds the same bits (in
// another order than a DeviceBlock's: K1d replays the block's sums,
// kde.cuh), and the warp's min/max and ballot of the pruned pair loops.
template <typename T>
struct WarpBlock {
  static constexpr int kSize = 32;
  static constexpr int kLanes = 32;
  __device__ __forceinline__ int rank() const { return threadIdx.x % 32; }
  __device__ __forceinline__ int lane() const { return threadIdx.x % 32; }
  template <int N>
  __device__ __forceinline__ void sum(T (&v)[N]) const {
#pragma unroll
    for (int i = 0; i < N; ++i)
      for (int o = 16; o > 0; o >>= 1)
        v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  }
  __device__ __forceinline__ void minmax(T& lo, T& hi) const {
    for (int o = 16; o > 0; o >>= 1) {
      lo = dmin(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = dmax(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
  }
  __device__ __forceinline__ bool any(bool v) const {
    return __any_sync(0xffffffffu, v) != 0;
  }
  __device__ __forceinline__ void sync() const { __syncwarp(); }
  __device__ __forceinline__ void warp_minmax(T& lo, T& hi) const {
    minmax(lo, hi);
  }
  __device__ __forceinline__ unsigned ballot(bool v) const {
    return __ballot_sync(0xffffffffu, v);
  }
  __device__ __forceinline__ void tile(bool) const {}
};

// Scott (0), Silverman (1) or fixed (2) bandwidth factor of a 1-D KDE, in
// the exp/log form of ops/kde.py::bw_factor.
template <typename T>
__device__ __forceinline__ T bw_factor(T neff, int bw_mode, T bw_value) {
  if (bw_mode == 0) return dexp(T(-0.2) * dlog(neff));
  if (bw_mode == 1) return dexp(T(-0.2) * dlog(neff * T(3) / T(4)));
  return bw_value;
}

}  // namespace
