// Device model of one lambda's population, shared by the hand-written
// kernels of chimera_tpu_torch (fused_kde.cu, rows_contract.cu,
// fused_kde_adjoint.cu):
//
//   Model<T, S>  FLRW with the Chebyshev inverse distance map (z from dL) and
//                PowerLawPeak with the analytic conditional CDF (p_m1m2), read
//                from the packed per-lambda rows (ops/cuda/fused.py,
//                pack_params): the two Chebyshev series summed in S, the
//                rest in T.  The device functions mirror the Python
//                expressions operation by operation: exp(a log x) powers, the
//                1e-99 window eps (0 in float), the divisor guard of p_m1m2.
//   MassModel<N> PowerLawPeak in the number type N: T in the forward
//                kernels, a forward-mode dual number (adjoint.cuh) in the
//                adjoint kernel, so the derivative is the same transcription.
//   block_sum    deterministic block-wide sums of per-thread partials.
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
constexpr int kMassScalars = 12;  // see MASS_SCALARS in ops/cuda/fused.py

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

// acc[k] += a T_k(t) for k < n: the adjoint of a Chebyshev sum in its
// coefficients (ops/chebyshev.py, _ChebEval.backward)
template <typename T>
__device__ __forceinline__ void cheb_project(T* acc, int n, T t, T a) {
  acc[0] += a;
  if (n < 2) return;
  acc[1] += a * t;
  T t_km1 = T(1), t_k = t;
  for (int k = 2; k < n; ++k) {
    const T t_kp = T(2) * t * t_k - t_km1;
    acc[k] += a * t_kp;
    t_km1 = t_k;
    t_k = t_kp;
  }
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

// PowerLawPeak pdfs of one lambda in the number type N (models/mass.py).
// The 12 scalars are set by the owner, then derive() fills the rest.
template <typename N>
struct MassModel {
  N m_low, m_high, alpha, beta, delta_m, lambda_peak, mu_g, sigma_g;
  N peak_norm, norm_p_m1, m_join, cdf_at_join;
  N pl_norm, peak_hi, log_sigma, m1_floor;

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

  // p(m1) p(m2 | m1) given the conditional CDF at m1 (models/mass.py::p_m1m2)
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

  // series: cheb_logh[cd], dgw_lo, dgw_max, cheb_cdf_window[wd]; s: the
  // MASS_SCALARS (ops/cuda/fused.py, pack_params)
  __device__ Model(const S* series, const T* s, int cd, int wd) {
    cheb_logh = series;
    cheb_deg = cd;
    window_deg = wd;
    dgw_lo = series[cd];
    dgw_max = series[cd + 1];
    window = series + cd + 2;
    mass.m_low = s[0]; mass.m_high = s[1]; mass.alpha = s[2];
    mass.beta = s[3]; mass.delta_m = s[4]; mass.lambda_peak = s[5];
    mass.mu_g = s[6]; mass.sigma_g = s[7]; mass.peak_norm = s[8];
    mass.norm_p_m1 = s[9]; mass.m_join = s[10]; mass.cdf_at_join = s[11];
    mass.derive();
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
  // conditional_cdf_at with S = float64)
  __device__ __forceinline__ T conditional_cdf(T m1) const {
    const T m1c = clip(m1, mass.m_low, mass.m_high);
    if (m1c <= mass.m_join) {
      const S lo = S(mass.m_low), hi = S(mass.m_join);
      const S x = clip(S(m1c), lo, hi);
      const S t = (S(2) * x - (lo + hi)) / (hi - lo);
      return T(clenshaw(window, window_deg, t));
    }
    return mass.cdf_above_join(m1c);
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

// Block-wide sums of N values per thread, in a fixed order (deterministic);
// every thread receives the totals.
template <typename T, int N>
__device__ __forceinline__ void block_sum(T (&v)[N], T (*scratch)[kWarps]) {
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
    for (int w = 0; w < kWarps; ++w) t += scratch[i][w];
    v[i] = t;
  }
  __syncthreads();
}

// Block-wide min of lo and max of hi; every thread receives both.
template <typename T>
__device__ __forceinline__ void block_minmax(T& lo, T& hi, T (*scratch)[kWarps]) {
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
  for (int w = 1; w < kWarps; ++w) {
    lo = dmin(lo, scratch[0][w]);
    hi = dmax(hi, scratch[1][w]);
  }
  __syncthreads();
}

// Scott (0), Silverman (1) or fixed (2) bandwidth factor of a 1-D KDE, in
// the exp/log form of ops/kde.py::bw_factor.
template <typename T>
__device__ __forceinline__ T bw_factor(T neff, int bw_mode, T bw_value) {
  if (bw_mode == 0) return dexp(T(-0.2) * dlog(neff));
  if (bw_mode == 1) return dexp(T(-0.2) * dlog(neff * T(3) / T(4)));
  return bw_value;
}

}  // namespace
