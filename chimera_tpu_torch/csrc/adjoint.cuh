// The adjoints of the fused weights+KDE pass (K3, fused_kde_adjoint.cu) and
// of the rows contraction (K2b, rows_contract_adjoint.cu), each the
// derivative of the forward as the plain versions compute it
// (ops/cuda/fused.py::fused_weights_kde_plain, ops/cuda/rows.py::
// fused_rows_contract_plain):
//
//   Dual<T, N>          forward-mode dual number with N directions.  The
//                       mass model of population.cuh, MassModel<N>,
//                       instantiated on it gives w and its partials in the
//                       12 mass scalars, in z and in the window series' value
//                       from the very code of the forward: the derivative
//                       cannot drift.
//   kde_pair            one (grid point, sample) term of the KDE adjoint.
//   RowAdjoint          the chain through the safe-math row statistics.
//   SampleAdjoint       the chain of one sample's (dz, dw) through
//                       z(dL | cosmo) and w(m1, m2, z | mass) to the packed
//                       rows' gradients, the Chebyshev series summed in S as
//                       the forward sums them (population.cuh, Model).
//   adjoint_row         K3 for one (lambda, row) in every mode of the
//                       forward (kde.cuh, FusedMode);
//   rows_adjoint_event  K2b for one (lambda, event);
//                       both written once for a `Block` (population.cuh,
//                       DeviceBlock; a block of one thread in the host
//                       emulation, tests/host_emulation).
//   store_partials,     the fixed-order sums of the per-thread gradients:
//   reduce_events_kernel  over the block, then over the rows or events.

#pragma once

#include <type_traits>

#include "kde.cuh"

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


// the packed rows' columns: cheb_logh, dgw_lo, dgw_max, window, mass scalars
constexpr int kMaxP = 2 * kMaxDeg + 2 + kMassScalars;
constexpr int kSamplesPerThread = 4;

// One (grid point, sample) term of the KDE adjoint
// (chimera_tpu/ops/pallas/fused.py:877-892), u = (g - z) / h and c1 the
// density cotangent over the density's scale.  The kernel-shape constants
// are left to kde_sample: a0 sums c1 K(u), a1 sums -c1 K'(u), a2 sums
// -c1 K'(u) u, each over its constant; with FRAC, a3 sums -c1 K'(u) frac,
// frac = dg/dub of a linear grid g = lo + (ub - lo) frac.  Epanechnikov has
// the open support -1 < u < 1.
template <typename T, int KERNEL, bool FRAC = false>
__device__ __forceinline__ void kde_pair(T u, T c1, T frac, T& a0, T& a1,
                                         T& a2, T& a3) {
  if (KERNEL == 0) {
    const T q = T(1) - u * u;
    const T m = q > T(0) ? c1 : T(0);
    const T mu = m * u;
    a0 += m * q;
    a1 += mu;
    a2 += mu * u;
    if (FRAC) a3 += mu * frac;
  } else {
    const T m = c1 * dexp(T(-0.5) * u * u);
    const T mu = m * u;
    a0 += m;
    a1 += mu;
    a2 += mu * u;
    if (FRAC) a3 += mu * frac;
  }
}

// K'(u) = -kernel_slope() * u * (shape factor): 1.5 (Epanechnikov),
// 1/sqrt(2 pi) (Gaussian)
template <typename T, int KERNEL>
__device__ __forceinline__ T kernel_slope() {
  return KERNEL == 0 ? T(1.5) : T(0.39894228040143267794);
}

// From a sample's pair sums: dw = sum_g c1 K(u), dz = -(w / h) sum_g c1 K'(u)
// and wb = w sum_g c1 K'(u) u (its share of the bandwidth's adjoint).
template <typename T, int KERNEL>
__device__ __forceinline__ void kde_sample(T a0, T a1, T a2, T w, T inv_h,
                                           T& dw, T& dz, T& wb) {
  const T kpc = kernel_slope<T, KERNEL>();
  dw = kernel_norm<T, KERNEL>() * a0;
  dz = inv_h * w * (kpc * a1);
  wb = -w * (kpc * a2);
}

// The row statistics in their safe-math form
// (fused_weights_kde_plain; chimera_tpu/ops/pallas/fused.py:789-822) and the
// chain from their cotangents back to the per-sample ones:
//   dz_s += cz (z_s - z_mean),   dw_s += d_sw + 2 w_s d_sw2.
// The clamps take jnp.clip's and jnp.maximum's slopes: half at a bound.
template <typename T>
struct RowAdjoint {
  T z_mean, z_var, z_sig, sum_w, sum_w2, neff_raw, neff, bwf, h;
  T n_samples, var_floor;
  int bw_mode;

  // sl: the row's (logical) sample count
  __device__ __forceinline__ RowAdjoint(T sum_w_, T sum_w2_, T z_mean_,
                                        T z_var_, T sl, int bw_mode_,
                                        T bw_value) {
    sum_w = sum_w_;
    sum_w2 = sum_w2_;
    z_mean = z_mean_;
    z_var = z_var_;
    n_samples = sl;
    bw_mode = bw_mode_;
    var_floor = dsqrt(sizeof(T) == 4 ? T(FLT_MIN) : T(DBL_MIN));
    z_sig = dsqrt(dmax(z_var, var_floor));
    neff_raw = sum_w * sum_w / (sum_w2 > T(0) ? sum_w2 : T(1));
    neff = clip(neff_raw, T(1), n_samples);
    bwf = bw_factor(neff, bw_mode, bw_value);
    h = bwf * z_sig;
  }

  // the slope of max(x, lo) and of min(x, hi): 1 inside, half at the bound
  static __device__ __forceinline__ T above(T x, T lo) {
    return x > lo ? T(1) : (x == lo ? T(0.5) : T(0));
  }

  // ct: the stats cotangents in the order of STAT_NAMES (lo and ub are not
  // read); d_h_kde: the bandwidth's cotangent from the KDE; d_sw_extra: sum
  // w's from a unit-mass density; d_sig_extra: sigma's from the bounds of an
  // effective grid
  __device__ __forceinline__ void backward(const T* ct, T d_h_kde,
                                           T d_sw_extra, T d_sig_extra,
                                           T& cz, T& d_sw, T& d_sw2) const {
    const T d_h = ct[4] + d_h_kde;
    const T d_zsig = d_h * bwf + d_sig_extra;
    T d_neff = ct[3];
    if (bw_mode != 2) d_neff += d_h * z_sig * (T(-0.2) * bwf / neff);
    const T d_raw = d_neff * (above(neff_raw, T(1))
                              * above(n_samples, dmax(neff_raw, T(1))));
    const T den = sum_w2 > T(0) ? sum_w2 : T(1);
    d_sw = ct[5] + ct[2] / n_samples + d_raw * T(2) * sum_w / den + d_sw_extra;
    d_sw2 = ct[6];
    if (sum_w2 > T(0)) d_sw2 -= d_raw * sum_w * sum_w / (den * den);
    const T d_zvar = d_zsig * above(z_var, var_floor) * T(0.5) / z_sig;
    cz = d_zvar * T(2) / n_samples;
  }
};

// Per-thread gradients of the packed rows (ops/cuda/fused.py, pack_params).
template <typename T>
struct GradAcc {
  T cheb[kMaxDeg], win[kMaxDeg], mass[kMassScalars];
  T lo, hi;

  __device__ __forceinline__ void zero() {
    for (int k = 0; k < kMaxDeg; ++k) cheb[k] = win[k] = T(0);
#pragma unroll
    for (int i = 0; i < kMassScalars; ++i) mass[i] = T(0);
    lo = hi = T(0);
  }

  // column i of the packed rows: cheb_logh, dgw_lo, dgw_max, window, mass
  __device__ __forceinline__ T at(int i, int cd, int wd) const {
    if (i < cd) return cheb[i];
    if (i == cd) return lo;
    if (i == cd + 1) return hi;
    if (i < cd + 2 + wd) return win[i - cd - 2];
    return mass[i - cd - 2 - wd];
  }
};

// One sample's chain from (dz, dw) to the packed rows, the two Chebyshev
// series summed in S as the forward's Model<T, S> sums them.
template <typename T, typename S>
struct SampleAdjoint {
  using N = Dual<T, kDirs>;
  const S* cheb_logh;
  const S* window;
  int cheb_deg, window_deg;
  S dgw_lo, dgw_max, log_lo, log_hi;

  // ser: this lambda's series row in S (cheb_logh, dgw_lo, dgw_max, window)
  __device__ __forceinline__ SampleAdjoint(const S* ser, int cd, int wd) {
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

  // z = d exp(c(t)) at dL (Model::z_from_dgw) with what its chain needs
  struct ZPoint {
    T d, z;
    S t, ds;
  };
  __device__ __forceinline__ ZPoint z_at(T dl) const {
    ZPoint p;
    p.d = clip(dl, T(dgw_lo), T(dgw_max));
    p.t = (S(2) * S(dlog(p.d)) - (log_lo + log_hi)) / (log_hi - log_lo);
    p.z = p.d * dexp(T(clenshaw_d(cheb_logh, cheb_deg, p.t, p.ds)));
    return p;
  }

  // the chain of dz, the cotangent of z at dL, to the distance series
  __device__ __forceinline__ void chain_z(const ZPoint& p, T dl, T dz,
                                          GradAcc<T>& g) const {
    const T span = T(log_hi - log_lo);
    const T t = T(p.t);
    const T a = dz * p.z;  // the cotangent of c(t)
    cheb_project(g.cheb, cheb_deg, t, a);
    const T dt = a * T(p.ds);
    g.lo += dt * (t - T(1)) / span / T(dgw_lo);
    g.hi -= dt * (t + T(1)) / span / T(dgw_max);
    const T dd = (a + dt * (T(2) / span)) / p.d;  // the cotangent of d
    if (dl < T(dgw_lo)) g.lo += dd;
    else if (dl > T(dgw_max)) g.hi += dd;
  }

  // a z with no weight attached (the logical rows' fillers at dl_fill)
  __device__ __forceinline__ void add_z(T dl, T dz, GradAcc<T>& g) const {
    chain_z(z_at(dl), dl, dz, g);
  }

  // dz, dw: the cotangents of this sample's z and w
  __device__ __forceinline__ void add(const MassModel<N>& mm, T m1det,
                                      T m2det, T dl, T inv_prior, T dz, T dw,
                                      GradAcc<T>& g) const {
    const ZPoint zp = z_at(dl);

    // ---- w as a dual in the mass scalars, z and the window's value ----
    N inv1pz(T(1) / (T(1) + zp.z));
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
      // the window's t in S as Model::conditional_cdf has it (the dual's
      // own value where S is T)
      const S lo = S(mm.m_low.v), hi = S(mm.m_join.v);
      const S ts = std::is_same<S, T>::value
                       ? S(tw.v) : (S(2) * S(x.v) - (lo + hi)) / (hi - lo);
      S dsw;
      const S val = clenshaw_d(window, window_deg, ts, dsw);
      cdf = chain(tw, T(val), T(dsw));
      cdf.d[kCdfDir] = T(1);
      t_win = T(ts);
    } else {
      cdf = mm.cdf_above_join(m1c);
    }
    const N p = mm.joint(m1, m2, cdf);
    const T gw = dw * inv_prior;  // the cotangent of p_m1m2
#pragma unroll
    for (int i = 0; i < kMassScalars; ++i) g.mass[i] += gw * p.d[i];
    if (in_window) cheb_project(g.win, window_deg, t_win, gw * p.d[kCdfDir]);
    chain_z(zp, dl, dz + gw * p.d[kZDir], g);
  }
};

// ---------------------------------------------------------------------------
// K3: the adjoint of the fused pass for one (lambda, row)
// ---------------------------------------------------------------------------

template <typename T>
struct AdjointArgs {
  const T* m1;
  const T* m2;
  const T* dl;
  const T* invp;
  const T* grids;             // (B, G), kAnalysisGrid
  const T* ext;               // (L, B, 2), kExternalBounds
  const long long* n_real;    // (B,) or null: logical rows when given
  const T* dl_fill;           // (B,) with n_real
  const double* series;       // (L, cheb_deg + 2 + window_deg)
  const T* params;            // (L, kMassScalars)
  const T* ct_den;            // (L, B, G), not in kStatsOnly
  const T* ct_stats;          // (L, B, 8), STAT_NAMES
  double* partials;           // (L, B, P): per row, the packed rows' gradients
  T* d_ext;                   // (L, B, 2), kExternalBounds
  int L, B, S, G, cheb_deg, window_deg, logical_s, bw_mode, unit_scale;
  T bw_value, cut_grid;
};

// The block's shared arrays: z, w, dz, dw of the row's samples and the G
// (grid point, scaled density cotangent) pairs.
template <typename T>
struct AdjointSmem {
  T* z;
  T* w;
  T* dz;
  T* dw;
  typename Pair<T>::type* gc;
};

// K3 for the (lambda l, row b) of the forward in MODE (kde.cuh, FusedMode),
// adding its gradients of the packed rows to this thread's `g` and, in
// kExternalBounds, writing d_ext[l, b].  The semantics are
// _adjoint_kernel's (chimera_tpu/ops/pallas/fused.py:713-966):
//
//   phase A  recompute z_s, w_s of the real samples; the row statistics in
//            their safe-math form (variance floored at sqrt(tiny), N_eff
//            clamped to [1, S_l]); a logical row adds its S_l - n fillers at
//            zf = z(dl_fill) analytically, as K1 does (kde.cuh, row_stats).
//   phase B  (not kStatsOnly) the KDE adjoint, kSamplesPerThread samples a
//            thread in registers against the (g, c1) pairs, c1 = cd / (h S_l)
//            ('norms') or cd / (h sum w) ('unit', 0 on a row under sqrt(tiny)
//            total weight):
//              dw_s = sum_g c1 K(u),  dz_s = -(w_s / h) sum_g c1 K'(u),
//              dh   = -(1 / h) sum_s w_s (dw_s + sum_g c1 K'(u) u),
//            and on a linear grid g = lo + (ub - lo) frac the bounds'
//            cotangents dlo = sum_g dg (1 - frac), dub = sum_g dg frac with
//            dg = (c1 / h) sum_s w_s K'(u) (fused.py:929-937).
//   phase C  the chains of lo = max(z_min - c sigma, 1e-8 where not
//            positive) and ub = z_max + c sigma (kEffectiveGrid,
//            kStatsOnly): z_min's cotangent to its samples, split over ties,
//            or to zf where the fillers hold the minimum (all tied values
//            are the same function of lambda); kExternalBounds passes the
//            bounds' cotangents to d_ext (fused.py:939-945).  Then the row
//            statistics (RowAdjoint), with sum w's extra term of 'unit'.
//   phase D  per real sample the chain through z and w (SampleAdjoint); the
//            fillers' zf once, by rank 0.
template <typename T, typename S, int KERNEL, int MODE, typename Block>
__device__ __forceinline__ void adjoint_row(
    const Block& blk, const Model<T, S>& model,
    const SampleAdjoint<T, S>& sample, const MassModel<Dual<T, kDirs>>& mm,
    const AdjointArgs<T>& a, int l, int b, const AdjointSmem<T>& sm,
    GradAcc<T>& g) {
  using T2 = typename Pair<T>::type;
  constexpr bool kRange = MODE == kEffectiveGrid || MODE == kStatsOnly;
  constexpr bool kKde = MODE != kStatsOnly;
  constexpr bool kLinear = MODE == kEffectiveGrid || MODE == kExternalBounds;

  // ---- phase A: source frame, weights, row statistics ---------------------
  const bool logical = a.n_real != nullptr;
  int n = a.S;
  T zf = T(0);
  if (logical) {
    const long long nr = a.n_real[b];
    n = nr < 0 ? 0 : (nr > a.S ? a.S : (int)nr);
    zf = model.z_from_dgw(a.dl_fill[b]);
  }
  const T sl = T(logical ? a.logical_s : a.S);
  const size_t row = (size_t)b * a.S;
  T acc[3] = {T(0), T(0), T(0)};  // sum w, sum w^2, sum z
  T z_lo = largest<T>(), z_hi = -largest<T>();
  for (int s = blk.rank(); s < n; s += Block::kSize) {
    const T z = model.z_from_dgw(a.dl[row + s]);
    const T inv1pz = T(1) / (T(1) + z);
    const T w = model.p_m1m2(a.m1[row + s] * inv1pz, a.m2[row + s] * inv1pz)
                * a.invp[row + s];
    sm.z[s] = z;
    sm.w[s] = w;
    acc[0] += w;
    acc[1] += w * w;
    acc[2] += z;
    if (kRange) {
      z_lo = dmin(z_lo, z);
      z_hi = dmax(z_hi, z);
    }
  }
  blk.template sum<3>(acc);
  if (kRange) blk.minmax(z_lo, z_hi);
  const T f_log = sl - T(n);  // logical fillers (0 on a plain row)
  const T z_mean = (acc[2] + f_log * zf) / sl;
  T ss[1] = {T(0)};
  for (int s = blk.rank(); s < n; s += Block::kSize) {
    const T d = sm.z[s] - z_mean;
    ss[0] += d * d;
  }
  blk.template sum<1>(ss);
  const T dzf = zf - z_mean;
  const RowAdjoint<T> st(acc[0], acc[1], z_mean,
                         (ss[0] + f_log * dzf * dzf) / sl, sl, a.bw_mode,
                         a.bw_value);
  const T inv_h = T(1) / st.h;

  // the z range (the fillers' zf in it on a logical row) and the bounds
  const bool min_zf = kRange && logical && zf <= z_lo;
  const bool max_zf = kRange && logical && zf >= z_hi;
  T lo = T(0), ub = T(0);
  bool lo_pos = false;
  if (kRange) {
    const T lr = (min_zf ? zf : z_lo) - a.cut_grid * st.z_sig;
    lo_pos = lr > T(0);
    lo = lo_pos ? lr : T(1e-8);
    ub = (max_zf ? zf : z_hi) + a.cut_grid * st.z_sig;
  } else if (MODE == kExternalBounds) {
    lo = a.ext[((size_t)l * a.B + b) * 2];
    ub = a.ext[((size_t)l * a.B + b) * 2 + 1];
  }

  // ---- phase B: the KDE adjoint, streamed over the grid -------------------
  const size_t out_row = (size_t)l * a.B + b;
  T denom = sl;
  bool row_ok = true;
  if (a.unit_scale) {
    row_ok = acc[0] > dsqrt(sizeof(T) == 4 ? T(FLT_MIN) : T(DBL_MIN));
    denom = row_ok ? acc[0] : T(1);
  }
  // sum w dw, sum wb, sum w a1, sum w a3
  T kde[4] = {T(0), T(0), T(0), T(0)};
  if (kKde) {
    const T* cd = a.ct_den + out_row * a.G;
    const T c_scale = row_ok ? inv_h / denom : T(0);
    const T delta = (ub - lo) / T(a.G - 1);
    for (int i = blk.rank(); i < a.G; i += Block::kSize) {
      T2 p;
      p.x = MODE == kAnalysisGrid ? a.grids[(size_t)b * a.G + i]
                                  : lo + delta * T(i);
      p.y = cd[i] * c_scale;
      sm.gc[i] = p;
    }
    blk.sync();
    const T inv_gm1 = kLinear ? T(1) / T(a.G - 1) : T(0);
    for (int s0 = 0; s0 < n; s0 += Block::kSize * kSamplesPerThread) {
      T zv[kSamplesPerThread], a0[kSamplesPerThread], a1[kSamplesPerThread],
          a2[kSamplesPerThread], a3[kSamplesPerThread];
#pragma unroll
      for (int j = 0; j < kSamplesPerThread; ++j) {
        const int idx = s0 + j * Block::kSize + blk.rank();
        zv[j] = sm.z[idx < n ? idx : n - 1];
        a0[j] = a1[j] = a2[j] = a3[j] = T(0);
      }
#pragma unroll 2
      for (int i = 0; i < a.G; ++i) {
        const T2 p = sm.gc[i];
        const T frac = T(i) * inv_gm1;
#pragma unroll
        for (int j = 0; j < kSamplesPerThread; ++j)
          kde_pair<T, KERNEL, kLinear>((p.x - zv[j]) * inv_h, p.y, frac,
                                       a0[j], a1[j], a2[j], a3[j]);
      }
#pragma unroll
      for (int j = 0; j < kSamplesPerThread; ++j) {
        const int idx = s0 + j * Block::kSize + blk.rank();
        if (idx < n) {
          const T w = sm.w[idx];
          T dw, dz, wb;
          kde_sample<T, KERNEL>(a0[j], a1[j], a2[j], w, inv_h, dw, dz, wb);
          sm.dw[idx] = dw;
          sm.dz[idx] = dz;
          kde[0] += w * dw;
          kde[1] += wb;
          if (kLinear) {
            kde[2] += w * a1[j];
            kde[3] += w * a3[j];
          }
        }
      }
    }
    blk.template sum<4>(kde);
  }

  // ---- phase C: the grid's bounds, the z range, the row statistics --------
  const T* ct = a.ct_stats + out_row * 8;
  T dlo = T(0), dub = T(0);  // the linear grid's bounds, from the KDE
  if (kLinear) {
    const T kpc = kernel_slope<T, KERNEL>();
    dub = -kpc * inv_h * kde[3];
    dlo = -kpc * inv_h * (kde[2] - kde[3]);
  }
  T ct_lo = T(0), ct_ub = T(0);
  if (MODE == kExternalBounds) {
    if (blk.rank() == 0) {
      a.d_ext[out_row * 2] = ct[0] + dlo;
      a.d_ext[out_row * 2 + 1] = ct[1] + dub;
    }
  } else if (kRange) {
    ct_lo = ct[0] + dlo;
    ct_ub = ct[1] + dub;
  }
  const T d_zmin = lo_pos ? ct_lo : T(0);
  const T d_zmax = ct_ub;
  T cz, d_sw, d_sw2;
  st.backward(ct, -inv_h * (kde[0] + kde[1]),
              a.unit_scale && row_ok ? -kde[0] / denom : T(0),
              kRange ? a.cut_grid * (ct_ub - d_zmin) : T(0), cz, d_sw, d_sw2);
  // z_min's and z_max's cotangents per tied sample
  T share[2] = {T(0), T(0)};
  if (kRange) {
    T cnt[2] = {T(0), T(0)};
    for (int s = blk.rank(); s < n; s += Block::kSize) {
      cnt[0] += sm.z[s] == z_lo ? T(1) : T(0);
      cnt[1] += sm.z[s] == z_hi ? T(1) : T(0);
    }
    blk.template sum<2>(cnt);
    if (!min_zf && cnt[0] > T(0)) share[0] = d_zmin / cnt[0];
    if (!max_zf && cnt[1] > T(0)) share[1] = d_zmax / cnt[1];
  }

  // ---- phase D: per sample, through z and w to the packed rows ------------
  for (int s = blk.rank(); s < n; s += Block::kSize) {
    const T z = sm.z[s], w = sm.w[s];
    T dz = cz * (z - z_mean);
    if (kKde) dz = sm.dz[s] + dz;
    if (kRange) {
      if (z == z_lo) dz += share[0];
      if (z == z_hi) dz += share[1];
    }
    const T dw = kKde ? sm.dw[s] + d_sw + T(2) * w * d_sw2
                      : d_sw + T(2) * w * d_sw2;
    sample.add(mm, a.m1[row + s], a.m2[row + s], a.dl[row + s],
               a.invp[row + s], dz, dw, g);
  }
  if (logical && blk.rank() == 0) {
    T d_zf = f_log * cz * dzf;
    if (min_zf) d_zf += d_zmin;
    if (max_zf) d_zf += d_zmax;
    if (d_zf != T(0)) sample.add_z(a.dl_fill[b], d_zf, g);
  }
}

// ---------------------------------------------------------------------------
// K2b: the adjoint of the rows contraction for one (lambda, event)
// ---------------------------------------------------------------------------

template <typename T>
struct RowsAdjointArgs {
  const T* m1;
  const T* m2;
  const T* dl;
  const T* invp;
  const T* grids;             // (E, G)
  const double* series;       // (L, cheb_deg + 2 + window_deg)
  const T* params;            // (L, kMassScalars)
  const T* hs;                // (L, R, 2): 1/h, scale
  const T* s1;                // (R, G)
  const T* s2;
  const T* f1;                // (L, E, G)
  const T* f2;
  const T* ct;                // (L, R, 2): the cotangents of r
  double* partials;           // (L, E, P)
  T* d_hs;                    // (L, R, 2)
  T* d_f1;                    // (L, E, G)
  T* d_f2;
  int L, E, C, chunk, G, cheb_deg, window_deg;
};

template <typename T>
struct RowsSmem {
  typename Pair<T>::type* zw;  // (z, w) of the row's samples
  typename Pair<T>::type* gc;  // (grid point, c_g)
  T* grid;
  T* f1;
  T* f2;
  T* df1;                      // the event's d_f1, d_f2 over its rows
  T* df2;
  T* dz;                       // the row's samples' cotangents
  T* dw;
};

// K2b for (lambda l, event e): the vector-Jacobian product of
// _rows_reference (chimera_tpu/ops/pallas/fused.py:613-640) over the
// event's C rows, in row order.  Per row r, with a_g = ct1 s1[r, g] f1[g] +
// ct2 s2[r, g] f2[g] and den_g = sum_s w_s K((g - z_s) / h):
//
//   d_scale  = sum_g den_g a_g,  d_f1[g] += scale ct1 s1[r, g] den_g (f2 too)
//            (pass 1, grid points over threads, as K2's forward);
//   c_g = scale a_g:  dw_s = sum_g c_g K(u),  dz_s = -(w_s / h) sum_g c_g K'(u),
//            d(1/h) = h sum_s w_s sum_g c_g K'(u) u
//            (pass 2, samples over threads);
//   then per sample with weight the chain through z and w (SampleAdjoint).
//
// A row that K2 writes as an exact zero (scale 0, no weight, or no
// cotangent) gives exact zero cotangents without either pass.
template <typename T, int KERNEL, typename Block>
__device__ __forceinline__ void rows_adjoint_event(
    const Block& blk, const Model<T, double>& model,
    const SampleAdjoint<T, double>& sample,
    const MassModel<Dual<T, kDirs>>& mm, const RowsAdjointArgs<T>& a, int l,
    int e, const RowsSmem<T>& sm, GradAcc<T>& g) {
  using T2 = typename Pair<T>::type;
  const int G = a.G;
  const size_t R = (size_t)a.E * a.C;
  const size_t ev = (size_t)l * a.E + e;
  for (int i = blk.rank(); i < G; i += Block::kSize) {
    sm.grid[i] = a.grids[(size_t)e * G + i];
    sm.f1[i] = a.f1[ev * G + i];
    sm.f2[i] = a.f2[ev * G + i];
    sm.df1[i] = sm.df2[i] = T(0);
  }
  blk.sync();
  const T kc = kernel_norm<T, KERNEL>();

  for (int c = 0; c < a.C; ++c) {
    const size_t row = (size_t)e * a.C + c;
    const size_t hrow = (size_t)l * R + row;
    const T inv_h = a.hs[hrow * 2];
    const T scale = a.hs[hrow * 2 + 1];
    const T ct1 = a.ct[hrow * 2], ct2 = a.ct[hrow * 2 + 1];
    T* dh = a.d_hs + hrow * 2;
    if (scale == T(0) || (ct1 == T(0) && ct2 == T(0))) {  // block-uniform
      if (blk.rank() == 0) dh[0] = dh[1] = T(0);
      continue;
    }

    // ---- phase A: the row's source frame and weights ---------------------
    const size_t base = row * a.chunk;
    bool live = false;
    for (int s = blk.rank(); s < a.chunk; s += Block::kSize) {
      const T z = model.z_from_dgw(a.dl[base + s]);
      const T inv1pz = T(1) / (T(1) + z);
      const T w = model.p_m1m2(a.m1[base + s] * inv1pz,
                               a.m2[base + s] * inv1pz) * a.invp[base + s];
      T2 p;
      p.x = z;
      p.y = w;
      sm.zw[s] = p;
      live = live || w != T(0);
    }
    if (!blk.any(live)) {  // zero weight everywhere: r = 0 exactly
      if (blk.rank() == 0) dh[0] = dh[1] = T(0);
      continue;
    }

    // ---- pass 1: densities on the grid, d_scale, d_f1, d_f2 ---------------
    const T* s1r = a.s1 + row * G;
    const T* s2r = a.s2 + row * G;
    T part[1] = {T(0)};
    for (int g0 = 0; g0 < G; g0 += Block::kSize * kGridPerThread) {
      T gv[kGridPerThread], sum[kGridPerThread];
#pragma unroll
      for (int k = 0; k < kGridPerThread; ++k) {
        const int idx = g0 + k * Block::kSize + blk.rank();
        gv[k] = sm.grid[idx < G ? idx : G - 1];
        sum[k] = T(0);
      }
#pragma unroll 4
      for (int s = 0; s < a.chunk; ++s) {
        const T2 p = sm.zw[s];
#pragma unroll
        for (int k = 0; k < kGridPerThread; ++k)
          sum[k] += p.y * kernel_shape<T, KERNEL>((gv[k] - p.x) * inv_h);
      }
#pragma unroll
      for (int k = 0; k < kGridPerThread; ++k) {
        const int idx = g0 + k * Block::kSize + blk.rank();
        if (idx < G) {
          const T den = sum[k] * kc;
          const T t1 = ct1 * s1r[idx], t2 = ct2 * s2r[idx];
          const T ag = t1 * sm.f1[idx] + t2 * sm.f2[idx];
          part[0] += den * ag;
          sm.df1[idx] += scale * t1 * den;
          sm.df2[idx] += scale * t2 * den;
          T2 q;
          q.x = gv[k];
          q.y = scale * ag;
          sm.gc[idx] = q;
        }
      }
    }
    blk.template sum<1>(part);  // ends in a barrier: gc is complete

    // ---- pass 2: per sample, dw, dz and the 1/h adjoint --------------------
    T wb_sum[1] = {T(0)};
    for (int s = blk.rank(); s < a.chunk; s += Block::kSize) {
      const T2 zw = sm.zw[s];
      T dw = T(0), dz = T(0);
      if (a.invp[base + s] != T(0)) {  // the fillers carry no weight
        T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
        for (int i = 0; i < G; ++i) {
          const T2 p = sm.gc[i];
          kde_pair<T, KERNEL>((p.x - zw.x) * inv_h, p.y, T(0), a0, a1, a2, a3);
        }
        T wb;
        kde_sample<T, KERNEL>(a0, a1, a2, zw.y, inv_h, dw, dz, wb);
        wb_sum[0] += wb;
      }
      sm.dw[s] = dw;
      sm.dz[s] = dz;
    }
    blk.template sum<1>(wb_sum);
    if (blk.rank() == 0) {
      dh[0] = wb_sum[0] / inv_h;
      dh[1] = part[0];
    }

    // ---- phase D: per sample, through z and w to the packed rows ----------
    for (int s = blk.rank(); s < a.chunk; s += Block::kSize)
      if (a.invp[base + s] != T(0))
        sample.add(mm, a.m1[base + s], a.m2[base + s], a.dl[base + s],
                   a.invp[base + s], sm.dz[s], sm.dw[s], g);
    blk.sync();  // zw and gc are rewritten by the next row
  }
  for (int i = blk.rank(); i < G; i += Block::kSize) {
    a.d_f1[ev * G + i] = sm.df1[i];
    a.d_f2[ev * G + i] = sm.df2[i];
  }
}

// The block's per-thread gradients summed in a fixed order into out[0, P)
// (P = cd + 2 + wd + kMassScalars columns of the packed rows).
template <typename T>
__device__ __forceinline__ void store_partials(const GradAcc<T>& g, int cd,
                                               int wd, double* out,
                                               T (*red)[kMaxP]) {
  const int P = cd + 2 + wd + kMassScalars;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = 0; i < P; ++i) {
    const T v = warp_sum(g.at(i, cd, wd));
    if (lane == 0) red[warp][i] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < P; i += kThreads) {
    T t = T(0);
    for (int w = 0; w < kWarps; ++w) t += red[w][i];
    out[i] = double(t);
  }
}

// Sum the partials (L, N, P) over their N rows (or events) in order and
// split the row into d_series (L, Q) and d_params (L, 12).  One block per
// lambda, one thread per column: no atomics, so equal inputs give equal bits
// and an HMC chain repeats under a fixed generator.
template <typename T>
__global__ void reduce_events_kernel(const double* __restrict__ partials,
                                     double* __restrict__ d_series,
                                     T* __restrict__ d_params, int N, int Q) {
  const int P = Q + kMassScalars;
  const int l = blockIdx.x;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const double* col = partials + (size_t)l * N * P + i;
    double t = 0.0;
#pragma unroll 8
    for (int e = 0; e < N; ++e) t += col[(size_t)e * P];
    if (i < Q) d_series[(size_t)l * Q + i] = t;
    else d_params[(size_t)l * kMassScalars + (i - Q)] = T(t);
  }
}

}  // namespace
