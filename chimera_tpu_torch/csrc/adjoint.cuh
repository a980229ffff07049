// Device pieces of the adjoint of the fused weights+KDE pass (K3,
// fused_kde_adjoint.cu), each the derivative of a piece of the forward as
// ops/cuda/fused.py::fused_weights_kde_plain computes it:
//
//   Dual<T, N>        forward-mode dual number with N directions.  The mass
//                     model of population.cuh, MassModel<N>, instantiated on
//                     it gives w and its partials in the 12 mass scalars, in
//                     z and in the window series' value from the very code
//                     of the forward: the derivative cannot drift.
//   kde_pair          one (grid point, sample) term of the KDE adjoint.
//   RowAdjoint        the chain through the safe-math row statistics.
//   SampleAdjoint     the chain of one sample's (dz, dw) through z(dL | cosmo)
//                     and w(m1, m2, z | mass) to the packed rows' gradients.

#pragma once

#include <type_traits>

#include "population.cuh"

namespace {

constexpr int kDirs = 14;     // 12 mass scalars, z, the window series' value
constexpr int kZDir = 12;
constexpr int kCdfDir = 13;
// largest Chebyshev degree of either series (_ADJOINT_MAX_DEG in
// ops/cuda/fused.py): the size of the per-thread coefficient accumulators
constexpr int kMaxDeg = 64;

template <typename T, int N>
struct Dual {
  T v;
  T d[N];

  Dual() = default;
  template <typename U,
            typename = typename std::enable_if<std::is_arithmetic<U>::value>::type>
  __device__ __forceinline__ Dual(U x) : v(T(x)) {
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] = T(0);
  }
};

// the value v with derivative 1 in direction dir
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> seed(T v, int dir) {
  Dual<T, N> r(v);
  r.d[dir] = T(1);
  return r;
}

#define DUAL_TN template <typename T, int N> __device__ __forceinline__

DUAL_TN Dual<T, N> operator+(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}

DUAL_TN Dual<T, N> operator-(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}

DUAL_TN Dual<T, N> operator-(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = -a.d[i];
  return r;
}

DUAL_TN Dual<T, N> operator*(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}

DUAL_TN Dual<T, N> operator/(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  const T inv = T(1) / b.v;
  r.v = a.v * inv;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) * inv;
  return r;
}

// r.v = v, r.d = dv * a.d: the chain rule of a function of one argument
DUAL_TN Dual<T, N> chain(const Dual<T, N>& a, T v, T dv) {
  Dual<T, N> r;
  r.v = v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = dv * a.d[i];
  return r;
}

DUAL_TN Dual<T, N> dexp(const Dual<T, N>& a) {
  const T e = dexp(a.v);
  return chain(a, e, e);
}
DUAL_TN Dual<T, N> dlog(const Dual<T, N>& a) {
  return chain(a, dlog(a.v), T(1) / a.v);
}
DUAL_TN Dual<T, N> dlog1p(const Dual<T, N>& a) {
  return chain(a, dlog1p(a.v), T(1) / (T(1) + a.v));
}
DUAL_TN Dual<T, N> dabs(const Dual<T, N>& a) {
  return chain(a, dabs(a.v), a.v > T(0) ? T(1) : (a.v < T(0) ? T(-1) : T(0)));
}
DUAL_TN bool finite(const Dual<T, N>& a) { return finite(a.v); }
DUAL_TN bool operator<(const Dual<T, N>& a, const Dual<T, N>& b) { return a.v < b.v; }
DUAL_TN bool operator<=(const Dual<T, N>& a, const Dual<T, N>& b) { return a.v <= b.v; }
DUAL_TN bool operator>(const Dual<T, N>& a, const Dual<T, N>& b) { return a.v > b.v; }
DUAL_TN bool operator>=(const Dual<T, N>& a, const Dual<T, N>& b) { return a.v >= b.v; }
DUAL_TN bool operator==(const Dual<T, N>& a, const Dual<T, N>& b) { return a.v == b.v; }

#undef DUAL_TN

// One (grid point, sample) term of the KDE adjoint
// (chimera_tpu/ops/pallas/fused.py:877-892), u = (g - z) / h and c1 the
// density cotangent over (h S).  The kernel-shape constants are left to
// kde_sample: a0 sums c1 K(u), a1 sums -c1 K'(u), a2 sums -c1 K'(u) u, each
// over its constant.  Epanechnikov has the open support -1 < u < 1.
template <typename T, int KERNEL>
__device__ __forceinline__ void kde_pair(T u, T c1, T& a0, T& a1, T& a2) {
  if (KERNEL == 0) {
    const T q = T(1) - u * u;
    const T m = q > T(0) ? c1 : T(0);
    const T mu = m * u;
    a0 += m * q;
    a1 += mu;
    a2 += mu * u;
  } else {
    const T m = c1 * dexp(T(-0.5) * u * u);
    const T mu = m * u;
    a0 += m;
    a1 += mu;
    a2 += mu * u;
  }
}

// From a sample's pair sums: dw = sum_g c1 K(u), dz = -(w / h) sum_g c1 K'(u)
// and wb = w sum_g c1 K'(u) u (its share of the bandwidth's adjoint).
template <typename T, int KERNEL>
__device__ __forceinline__ void kde_sample(T a0, T a1, T a2, T w, T inv_h,
                                           T& dw, T& dz, T& wb) {
  const T kc = KERNEL == 0 ? T(0.75) : T(0.39894228040143267794);
  const T kpc = KERNEL == 0 ? T(1.5) : T(0.39894228040143267794);
  dw = kc * a0;
  dz = inv_h * w * (kpc * a1);
  wb = -w * (kpc * a2);
}

// The row statistics in their safe-math form
// (fused_weights_kde_plain; chimera_tpu/ops/pallas/fused.py:789-822) and the
// chain from their cotangents back to the per-sample ones:
//   dz_s += cz (z_s - z_mean),   dw_s += d_sw + 2 w_s d_sw2.
template <typename T>
struct RowAdjoint {
  T z_mean, z_var, z_sig, sum_w, sum_w2, neff_raw, neff, bwf, h;
  T n_samples, var_floor;
  int bw_mode;

  __device__ __forceinline__ RowAdjoint(T sum_w_, T sum_w2_, T z_mean_,
                                        T z_var_, int S, int bw_mode_,
                                        T bw_value) {
    sum_w = sum_w_;
    sum_w2 = sum_w2_;
    z_mean = z_mean_;
    z_var = z_var_;
    n_samples = T(S);
    bw_mode = bw_mode_;
    var_floor = dsqrt(sizeof(T) == 4 ? T(FLT_MIN) : T(DBL_MIN));
    z_sig = dsqrt(dmax(z_var, var_floor));
    neff_raw = sum_w * sum_w / (sum_w2 > T(0) ? sum_w2 : T(1));
    neff = clip(neff_raw, T(1), n_samples);
    bwf = bw_factor(neff, bw_mode, bw_value);
    h = bwf * z_sig;
  }

  // ct: the stats cotangents in the order of STAT_NAMES; d_h_kde: the
  // bandwidth's cotangent from the KDE
  __device__ __forceinline__ void backward(const T* ct, T d_h_kde, T& cz,
                                           T& d_sw, T& d_sw2) const {
    const T d_h = ct[4] + d_h_kde;
    const T d_zsig = d_h * bwf;
    T d_neff = ct[3];
    if (bw_mode != 2) d_neff += d_h * z_sig * (T(-0.2) * bwf / neff);
    const T d_raw = (neff_raw >= T(1) && neff_raw <= n_samples) ? d_neff : T(0);
    const T den = sum_w2 > T(0) ? sum_w2 : T(1);
    d_sw = ct[5] + ct[2] / n_samples + d_raw * T(2) * sum_w / den;
    d_sw2 = ct[6];
    if (sum_w2 > T(0)) d_sw2 -= d_raw * sum_w * sum_w / (den * den);
    const T d_zvar = z_var >= var_floor ? d_zsig * T(0.5) / z_sig : T(0);
    cz = d_zvar * T(2) / n_samples;
  }
};

// One sample's chain from (dz, dw) to the packed rows.  The per-thread
// accumulators are laid out as the packed rows: g_cheb[cheb_deg], g_lo,
// g_hi, g_win[window_deg], g_mass[12].
template <typename T>
struct SampleAdjoint {
  using N = Dual<T, kDirs>;
  const T* cheb_logh;
  const T* window;
  int cheb_deg, window_deg;
  T dgw_lo, dgw_max, log_lo, log_hi;

  // ser: this lambda's series row in T (cheb_logh, dgw_lo, dgw_max, window)
  __device__ __forceinline__ SampleAdjoint(const T* ser, int cd, int wd) {
    cheb_logh = ser;
    cheb_deg = cd;
    window_deg = wd;
    dgw_lo = ser[cd];
    dgw_max = ser[cd + 1];
    window = ser + cd + 2;
    log_lo = dlog(dgw_lo);
    log_hi = dlog(dgw_max);
  }

  // the dual mass model of a lambda's 12 scalars, direction i for scalar i
  static __device__ __forceinline__ void seed_mass(MassModel<N>& mm,
                                                   const T* s) {
    mm.m_low = seed<T, kDirs>(s[0], 0);
    mm.m_high = seed<T, kDirs>(s[1], 1);
    mm.alpha = seed<T, kDirs>(s[2], 2);
    mm.beta = seed<T, kDirs>(s[3], 3);
    mm.delta_m = seed<T, kDirs>(s[4], 4);
    mm.lambda_peak = seed<T, kDirs>(s[5], 5);
    mm.mu_g = seed<T, kDirs>(s[6], 6);
    mm.sigma_g = seed<T, kDirs>(s[7], 7);
    mm.peak_norm = seed<T, kDirs>(s[8], 8);
    mm.norm_p_m1 = seed<T, kDirs>(s[9], 9);
    mm.m_join = seed<T, kDirs>(s[10], 10);
    mm.cdf_at_join = seed<T, kDirs>(s[11], 11);
    mm.derive();
  }

  // dz, dw: the cotangents of this sample's z and w
  __device__ __forceinline__ void add(const MassModel<N>& mm, T m1det,
                                      T m2det, T dl, T inv_prior, T dz, T dw,
                                      T* g_cheb, T& g_lo, T& g_hi, T* g_win,
                                      T* g_mass) const {
    // ---- z and the series' derivative ---------------------------------
    const T d = clip(dl, dgw_lo, dgw_max);
    const T span = log_hi - log_lo;
    const T t = (T(2) * dlog(d) - (log_lo + log_hi)) / span;
    T ds;
    const T z = d * dexp(clenshaw_d(cheb_logh, cheb_deg, t, ds));

    // ---- w as a dual in the mass scalars, z and the window's value ----
    N inv1pz(T(1) / (T(1) + z));
    inv1pz.d[kZDir] = -inv1pz.v * inv1pz.v;
    const N m1 = N(m1det) * inv1pz;
    const N m2 = N(m2det) * inv1pz;
    const N m1c = clip(m1, mm.m_low, mm.m_high);
    const bool in_window = m1c <= mm.m_join;
    N cdf;
    T t_win = T(0);
    if (in_window) {
      const N x = clip(m1c, mm.m_low, mm.m_join);
      const N tw = (N(2) * x - (mm.m_low + mm.m_join)) / (mm.m_join - mm.m_low);
      T dsw;
      const T val = clenshaw_d(window, window_deg, tw.v, dsw);
      cdf = chain(tw, val, dsw);
      cdf.d[kCdfDir] = T(1);
      t_win = tw.v;
    } else {
      cdf = mm.cdf_above_join(m1c);
    }
    const N p = mm.joint(m1, m2, cdf);
    const T gw = dw * inv_prior;  // the cotangent of p_m1m2
#pragma unroll
    for (int i = 0; i < kMassScalars; ++i) g_mass[i] += gw * p.d[i];
    if (in_window) cheb_project(g_win, window_deg, t_win, gw * p.d[kCdfDir]);

    // ---- z = d exp(c(t)), t from log d, log lo, log hi ------------------
    const T a = (dz + gw * p.d[kZDir]) * z;  // the cotangent of c(t)
    cheb_project(g_cheb, cheb_deg, t, a);
    const T dt = a * ds;
    g_lo += dt * (t - T(1)) / span / dgw_lo;
    g_hi -= dt * (t + T(1)) / span / dgw_max;
    const T dd = (a + dt * (T(2) / span)) / d;  // the cotangent of d
    if (dl < dgw_lo) g_lo += dd;
    else if (dl > dgw_max) g_hi += dd;
  }
};

}  // namespace
