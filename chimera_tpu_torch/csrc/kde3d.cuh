// The arithmetic of K5, the 3-D Gaussian KDE of the 'full' likelihood on
// the (pixel x z-grid) lattice (kde3d.cu), written once for the card and
// for the serial host emulation (tests/host_emulation/kde3d_host.cpp).
// Each function is one phase of a block of `size` threads, run by the
// thread `rank`; a kernel runs the phases with a barrier between them, the
// host emulation runs each phase for every rank in turn.
//
// Semantics: chimera_tpu/ops/kde.py:307-457 (gaussian_kde_3d_lattice) and
// :140-167 (_safe_norm_weights, _weighted_cov), as chimera_tpu/likelihood.py
// ::p_gw_3d_full calls it per (lambda, event); the plain PyTorch version is
// chimera_tpu_torch/ops/kde.py::gaussian_kde_3d_lattice.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace kde3d {

constexpr int kThreads = 128;
// the longest block of the uniform-z recurrence (the plan's top tier)
constexpr int kMaxBlock = 32;
// grid points a thread of the dense sweep takes at once
constexpr int kDensePoints = 4;

// a (lambda, event)'s record, in double: the whitening factor L (lower-
// triangular, inv(cov) / factor^2 = L L^T), exp(log_norm), the weighted
// mean (the centre that the main kernel subtracts), the weight sum (0 where
// the uniform fallback holds), L00 times the grid step, and whether L exists
enum Field {
  kL00, kL10, kL20, kL11, kL21, kL22, kNorm, kMeanZ, kMeanRa, kMeanDec,
  kSumW, kStepH, kOk, kRecord = 16
};

template <typename T>
__device__ __forceinline__ T smallest_normal();
template <>
__device__ __forceinline__ float smallest_normal<float>() { return FLT_MIN; }
template <>
__device__ __forceinline__ double smallest_normal<double>() { return DBL_MIN; }

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

// A sample's sky factor e and z offset t side by side (x, y: one 8- or
// 16-byte load) at slot(s) = s + s / 256: the slices of 256 and 512
// samples that a warp's chains walk then start on different banks of
// shared memory.
template <typename T>
struct SamplePair;
template <>
struct SamplePair<float> {
  using type = float2;
};
template <>
struct SamplePair<double> {
  using type = double2;
};
template <typename T>
using ET = typename SamplePair<T>::type;

__host__ __device__ constexpr int slot(int s) { return s + (s >> 8); }
// the slots of S samples padded to whole 32-sample words, an even count
__host__ __device__ constexpr int slots(int S) {
  return (slot(32 * ((S + 31) / 32) - 1) + 2) & ~1;
}

// _safe_norm_weights: w / sum_w, or 1 / S where the weights do not sum to
// a positive number (a dead (lambda, event), NaN included)
template <typename T>
__device__ __forceinline__ double unit_weight(T w, double sum_w, int S) {
  return sum_w > 0.0 ? double(w) / sum_w : 1.0 / S;
}

// the sums of the phases below, a thread's value at part[k * size + rank];
// thread 0 adds them in rank order (equal bits every run)
__device__ __forceinline__ double ordered_sum(const double* part, int size) {
  double s = 0.0;
  for (int i = 0; i < size; ++i) s += part[i];
  return s;
}

template <typename T>
__device__ void weight_part(const T* w, int S, int rank, int size,
                            double* part) {
  double s = 0.0;
  for (int i = rank; i < S; i += size) s += double(w[i]);
  part[rank] = s;
}

// sum of squared unit weights and the weighted mean of (z, ra, dec)
template <typename T>
__device__ void mean_parts(const T* z, const T* w, const T* ra, const T* dec,
                           int S, double sum_w, int rank, int size,
                           double* part) {
  double s2 = 0.0, mz = 0.0, mr = 0.0, md = 0.0;
  for (int i = rank; i < S; i += size) {
    const double wn = unit_weight(w[i], sum_w, S);
    s2 += wn * wn;
    mz += wn * double(z[i]);
    mr += wn * double(ra[i]);
    md += wn * double(dec[i]);
  }
  part[rank] = s2;
  part[size + rank] = mz;
  part[2 * size + rank] = mr;
  part[3 * size + rank] = md;
}

// the weighted second moments about the mean: 00, 01, 02, 11, 12, 22
template <typename T>
__device__ void cov_parts(const T* z, const T* w, const T* ra, const T* dec,
                          int S, double sum_w, const double* mean, int rank,
                          int size, double* part) {
  double c[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int i = rank; i < S; i += size) {
    const double wn = unit_weight(w[i], sum_w, S);
    const double x[3] = {double(z[i]) - mean[0], double(ra[i]) - mean[1],
                         double(dec[i]) - mean[2]};
    c[0] += wn * x[0] * x[0];
    c[1] += wn * x[0] * x[1];
    c[2] += wn * x[0] * x[2];
    c[3] += wn * x[1] * x[1];
    c[4] += wn * x[1] * x[2];
    c[5] += wn * x[2] * x[2];
  }
  for (int k = 0; k < 6; ++k) part[k * size + rank] = c[k];
}

// The record from the sums: the bandwidth factor of n_eff = 1 / sum wn^2
// (d = 3; bw_mode 0 Scott, 1 Silverman, 2 the scalar bw_value), the
// covariance with the 1 / (1 - sum wn^2) correction, its inverse (closed
// form), over factor^2, the closed-form Cholesky factor; L is NaN and
// ok 0 where either does not exist (the JAX package's NaN).
__device__ __forceinline__ void finish_record(double sum_w, double s2,
                                              const double* mean,
                                              const double* m2, int bw_mode,
                                              double bw_value, double step,
                                              double* rec) {
  const double neff = 1.0 / s2;
  const double factor =
      bw_mode == 0 ? exp((-1.0 / 7.0) * log(neff))
      : bw_mode == 1 ? exp((-1.0 / 7.0) * log(neff * 5.0 / 4.0))
                     : bw_value;
  const double corr = 1.0 - s2;
  const double a = m2[0] / corr, b = m2[1] / corr, c = m2[2] / corr,
               d = m2[3] / corr, e = m2[4] / corr, f = m2[5] / corr;
  // cofactors of the symmetric [[a b c] [b d e] [c e f]]
  const double i00 = d * f - e * e, i01 = c * e - b * f, i02 = b * e - c * d;
  const double i11 = a * f - c * c, i12 = b * c - a * e, i22 = a * d - b * b;
  const double det = a * i00 + b * i01 + c * i02;
  const double s = 1.0 / (det * factor * factor);
  const double l00 = sqrt(i00 * s);
  const double l10 = i01 * s / l00;
  const double l20 = i02 * s / l00;
  const double l11 = sqrt(i11 * s - l10 * l10);
  const double l21 = (i12 * s - l20 * l10) / l11;
  const double l22 = sqrt(i22 * s - l20 * l20 - l21 * l21);
  const bool ok = l00 > 0.0 && l11 > 0.0 && l22 > 0.0 && isfinite(l00) &&
                  isfinite(l10) && isfinite(l20) && isfinite(l11) &&
                  isfinite(l21) && isfinite(l22);
  const double l[6] = {l00, l10, l20, l11, l21, l22};
  for (int k = 0; k < 6; ++k) rec[kL00 + k] = ok ? l[k] : nan("");
  rec[kNorm] = exp(log(l00) + log(l11) + log(l22) -
                   1.5 * log(2.0 * 3.14159265358979323846));
  rec[kMeanZ] = mean[0];
  rec[kMeanRa] = mean[1];
  rec[kMeanDec] = mean[2];
  rec[kSumW] = sum_w > 0.0 ? sum_w : 0.0;
  rec[kStepH] = l00 * step;
  rec[kOk] = ok ? 1.0 : 0.0;
}

// Per sample of a (lambda, event, pixel): the sky factor
// e = wn exp(-(q1^2 + q2^2) / 2) and t, the whitened z offset of
// u = L00 (z_g - mean_z) + t, both in double from coordinates centred on
// the event's weighted mean (the same values in exact arithmetic as the
// JAX package's raw ones, without cancelling digits of L11 ra ~ 1e2 in
// float32), stored in the working type.
template <typename T>
__device__ void sample_factors(const double* rec, const T* z, const T* w,
                               const T* ra, const T* dec, int S, T ra_pix,
                               T dec_pix, ET<T>* et, int rank, int size) {
  const double l00 = rec[kL00], l10 = rec[kL10], l20 = rec[kL20];
  const double l11 = rec[kL11], l21 = rec[kL21], l22 = rec[kL22];
  const double rp = double(ra_pix) - rec[kMeanRa];
  const double dp = double(dec_pix) - rec[kMeanDec];
  const double c0 = l10 * rp + l20 * dp;
  const double c1 = l11 * rp + l21 * dp;
  const double c2 = l22 * dp;
  for (int i = rank; i < S; i += size) {
    const double dz = double(z[i]) - rec[kMeanZ];
    const double dr = double(ra[i]) - rec[kMeanRa];
    const double dd = double(dec[i]) - rec[kMeanDec];
    const double q1 = c1 - (l11 * dr + l21 * dd);
    const double q2 = c2 - l22 * dd;
    ET<T> p;
    p.x = T(unit_weight(w[i], rec[kSumW], S) * exp(-0.5 * (q1 * q1 + q2 * q2)));
    p.y = T(c0 - (l00 * dz + l10 * dr + l20 * dd));
    et[slot(i)] = p;
  }
}

// The dense z sweep, one exp a term: each thread takes kDensePoints grid
// points at a time, the samples in order.
template <typename T>
__device__ void dense_sweep(const double* rec, const ET<T>* et,
                           int S, const T* grid, int G, T* out, int rank,
                           int size) {
  const T norm = T(rec[kNorm]);
  for (int g0 = rank; g0 < G; g0 += kDensePoints * size) {
    T zl[kDensePoints], acc[kDensePoints];
#pragma unroll
    for (int i = 0; i < kDensePoints; ++i) {
      const int g = g0 + i * size;
      zl[i] = g < G ? T(rec[kL00] * (double(grid[g]) - rec[kMeanZ])) : T(0);
      acc[i] = T(0);
    }
    for (int s = 0; s < S; ++s) {
      const ET<T> p = et[slot(s)];
      const T e = p.x, t = p.y;
#pragma unroll
      for (int i = 0; i < kDensePoints; ++i) {
        const T u = zl[i] + t;
        acc[i] += e * exp_t(T(-0.5) * u * u);
      }
    }
#pragma unroll
    for (int i = 0; i < kDensePoints; ++i) {
      const int g = g0 + i * size;
      if (g < G) out[g] = norm * acc[i];
    }
  }
}

// Rounded arithmetic that the compiler may not contract: the recurrence's
// operations are spelled out (no product fused into a sum but the
// refresh's -h u0 - h^2 / 2, one fma), so that its bits do not depend on
// how nvcc contracts the code around them.
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// The start of K-point block j in whitened units, zl0 = L00 (z_g - mean_z)
// at g = j K: L00 (z_0 - mean_z) rounded, then j K times the step added in
// one fma, rounded to the working type.
template <typename T>
__device__ __forceinline__ T block_start(const double* rec, double zg0, int j,
                                         int K) {
  const double zl_start = __dmul_rn(rec[kL00], zg0 - rec[kMeanZ]);
  return T(fma(double(j * K), rec[kStepH], zl_start));
}

// One sample's refresh at a block start: v = e exp(-u0^2 / 2), r =
// exp(-h u0 - h^2 / 2) (two exps), both flushed to 0 where v is below the
// smallest normal (a NaN too).  A flushed refresh adds exactly +0 to every
// sum (the sums are >= +0), which is what lets the pruned walk skip it.
template <typename T>
__device__ __forceinline__ void refresh(T e, T t, T zl0, T h, T half_h2, T& v,
                                        T& r) {
  const T u0 = add_rn(zl0, t);
  v = mul_rn(e, exp_t(mul_rn(mul_rn(T(-0.5), u0), u0)));
  r = exp_t(fma_t(-h, u0, -half_h2));
  if (!(v >= smallest_normal<T>())) {
    v = T(0);
    r = T(0);
  }
}

// One sample's refresh and its multiply-adds into the block's sums: all
// KMAX of them, though only the first K are read (recurrence_sweep's
// stores, recurrence_fold): a sum k < K is the same with or without the
// ones past it, and the loop needs no test of k.
template <typename T, int KMAX>
__device__ __forceinline__ void refresh_terms(T e, T t, T zl0, T h, T half_h2,
                                              T rho, T (&acc)[KMAX]) {
  T v, r;
  refresh(e, t, zl0, h, half_h2, v, r);
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    acc[k] = add_rn(acc[k], v);
    v = mul_rn(v, r);
    r = mul_rn(r, rho);
  }
}

// The refreshes of N samples s[0] < ... < s[N - 1].
template <typename T, int N>
__device__ __forceinline__ void refresh_n(const ET<T>* et, const int (&s)[N],
                                          T zl0, T h, T half_h2, T (&v)[N],
                                          T (&r)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const ET<T> p = et[slot(s[n])];
    refresh(p.x, p.y, zl0, h, half_h2, v[n], r[n]);
  }
}

// Their multiply-adds (refresh_terms'): each sum takes their terms in
// sample order (the order of N calls of refresh_terms), with N
// independent chains in flight.
template <typename T, int KMAX, int N>
__device__ __forceinline__ void terms_n(T (&v)[N], T (&r)[N], T rho,
                                        T (&acc)[KMAX]) {
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    T a = acc[k];
#pragma unroll
    for (int n = 0; n < N; ++n) a = add_rn(a, v[n]);
    acc[k] = a;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      v[n] = mul_rn(v[n], r[n]);
      r[n] = mul_rn(r[n], rho);
    }
  }
}

// One K-point block's sums over the samples [s0, s1), every sample in order
// (the unpruned walk).
template <typename T, int KMAX>
__device__ __forceinline__ void block_sums(const ET<T>* et, int s0,
                                           int s1, T zl0, T h, T half_h2,
                                           T rho, T (&acc)[KMAX]) {
#pragma unroll
  for (int k = 0; k < KMAX; ++k) acc[k] = T(0);
  for (int s = s0; s < s1; ++s) {
    const ET<T> p = et[slot(s)];
    refresh_terms<T, KMAX>(p.x, p.y, zl0, h, half_h2, rho, acc);
  }
}

// ---- the pruned walk -------------------------------------------------------
// A (sample, block) refresh whose start |u0| exceeds the sample's skip
// radius R is provably flushed, and the walk skips it.  The masks keep a
// bit per (block j, sample s) that is set unless |u0| > R:
// masks[(s / 32) * J + j], J x ceil(S / 32) <= kMaskWords words; a block
// (lambda, event, pixel) whose masks do not fit walks every sample.  Each
// chain (block j, slice of samples) adds its set bits' samples in index
// order, so every sum is the unpruned walk's, bit for bit.
constexpr int kMaskWords = 2048;

__device__ __forceinline__ int lowest_bit(unsigned m) { return __ffs(int(m)) - 1; }
__device__ __forceinline__ int bit_count(unsigned m) { return __popc(m); }

__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }

template <typename T>
__device__ __forceinline__ T ln_smallest_normal();
template <>
__device__ __forceinline__ float ln_smallest_normal<float>() { return -87.33654475f; }
template <>
__device__ __forceinline__ double ln_smallest_normal<double>() {
  return -708.39641853226410622;
}

// The skip radius of a sample of sky factor e: every refresh with |u0| > R
// is flushed.  With x = ln e - ln m + 1.5 (m the smallest normal) formed
// in T and R = sqrt(2 x): x is within 2e-5 of its exact value (log 1 ulp,
// two roundings), so |u0| > R gives u0^2 / 2 > ln(e / m) + 1.5 - 4e-5 and
// the refresh's exponent a = (-0.5 u0) u0, one rounding, a < ln(m / e) -
// 1.4999; then e exp(a) < 0.224 m, and exp's error (float: 2 ulp, at most
// 2^-148 absolute on a subnormal result, times e <= 2^20: 0.25 m; double:
// 1 ulp) leaves v = e exp(a) below m: the kernel flushes it.  x <= 0 (e <
// m e^-1.5): v <= e (1 + 2^-22) < m for every a <= 0, skip all (R = -1).
// e <= 0 or NaN: v = e exp(a) is <= 0 or NaN, flushed, skip all.  e >
// 2^20, +inf: no skip (R = +inf).  A NaN u0 is never skipped: the walk's
// flush takes it.
template <typename T>
__device__ __forceinline__ T skip_radius(T e) {
  if (!(e > T(0))) return T(-1);
  if (!(e <= T(1048576))) return T(INFINITY);
  const T x = log_t(e) - ln_smallest_normal<T>() + T(1.5);
  return x > T(0) ? sqrt_t(T(2) * x) : T(-1);
}

// The skip radii of the samples sample_factors gave this rank (the same
// indices: no barrier between), and for the padding to whole 32-sample
// words radius -1 and e, t 0 (their bits are 0).
template <typename T>
__device__ void skip_radii(ET<T>* et, T* radii, int S, int rank, int size) {
  for (int i = rank; i < S; i += size) radii[i] = skip_radius(et[slot(i)].x);
  for (int i = S + rank; i < 32 * ((S + 31) / 32); i += size) {
    ET<T> zero;
    zero.x = zero.y = T(0);
    et[slot(i)] = zero;
    radii[i] = T(-1);
  }
}

// four consecutive values of a 16-byte-aligned array
template <typename T>
struct alignas(16) Quad {
  T v[4];
};

// The samples' extent, for the band of blocks the masks test: per rank,
// the least and greatest t (NaNs left out: their refreshes flush) and the
// greatest skip radius of the samples sample_factors gave it, at red[rank],
// red[size + rank], red[2 size + rank].
template <typename T>
__device__ void sample_extent(const ET<T>* et, const T* radii, int S, T* red,
                              int rank, int size) {
  T lo = T(INFINITY), hi = T(-INFINITY), r = T(-INFINITY);
  for (int i = rank; i < S; i += size) {
    const T t = et[slot(i)].y;
    lo = fmin(lo, t);
    hi = fmax(hi, t);
    r = fmax(r, radii[i]);
  }
  red[rank] = lo;
  red[size + rank] = hi;
  red[2 * size + rank] = r;
}

// Ranks 0, 1, 2 fold sample_extent's rows into red[3 size + 0, 1, 2] (t
// min, t max, R max); rank 3 opens the band (band[0] = J, band[1] = -1).
template <typename T>
__device__ void extent_fold(T* red, int* band, int J, int rank, int size) {
  if (rank < 3) {
    const T* row = red + rank * size;
    T x = row[0];
    for (int i = 1; i < size; ++i) x = rank == 0 ? fmin(x, row[i]) : fmax(x, row[i]);
    red[3 * size + rank] = x;
  } else if (rank == 3) {
    band[0] = J;
    band[1] = -1;
  }
}

// The band [band[0], band[1]] of the blocks j that some sample may reach:
// outside it, fl(zl0 + t_max) < -R_max or fl(zl0 + t_min) > R_max, so every
// sample's u0 = fl(zl0 + t) lies beyond its own radius on that side
// (rounding is monotone), and every refresh of the block is skipped.
template <typename T>
__device__ void live_band(const double* rec, const T* red, double zg0, int K,
                          int J, int* band, int rank, int size) {
  const T t_min = red[3 * size], t_max = red[3 * size + 1];
  const T r_max = red[3 * size + 2];
  for (int j = rank; j < J; j += size) {
    const T zl0 = block_start<T>(rec, zg0, j, K);
    if (add_rn(zl0, t_max) < -r_max || add_rn(zl0, t_min) > r_max) continue;
    atomicMin(band, j);
    atomicMax(band + 1, j);
  }
}

// The masks, a word (j, w) a thread: bit b is set unless |zl0(j) + t_s| >
// R_s for s = 32 w + b (the padding's bits are 0); the words of the blocks
// outside the band are 0 untested.
template <typename T>
__device__ void live_masks(const double* rec, const ET<T>* et, const T* radii,
                           int S, double zg0, int K, int J, const int* band,
                           unsigned* masks, int rank, int size) {
  const int W = (S + 31) / 32, lo = band[0], hi = band[1];
  for (int m = rank; m < J * W; m += size) {
    const int j = m % J;
    if (j < lo || j > hi) masks[m] = 0u;
  }
  const int Jb = hi - lo + 1;
  for (int m = rank; m < Jb * W; m += size) {
    const int j = lo + m % Jb, w = m / Jb;
    const T zl0 = block_start<T>(rec, zg0, j, K);
    // the word's samples sit at slots slot(32 w) + b (no gap inside)
    const ET<T>* tw = et + slot(32 * w);
    const Quad<T>* rq = reinterpret_cast<const Quad<T>*>(radii + 32 * w);
    // the bits shift in from the top, sample 32 w + 31 last
    unsigned bits = 0u;
#pragma unroll 2
    for (int i = 0; i < 8; ++i) {
      const Quad<T> r = rq[i];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        bits = (bits >> 1) |
               (fabs(zl0 + tw[4 * i + b].y) > r.v[b] ? 0u : 0x80000000u);
    }
    masks[w * J + j] = bits;
  }
}

// The chains of J < size blocks: Q = size / J slices of the samples a
// block, chain c = q J + j summing slice q of block j.
__device__ __forceinline__ int chain_start(int q, int Q, int S) {
  return int((long long)q * S / Q);
}

// Per chain c < J Q (J < size): its set bits n, as the key n size + (size -
// 1 - c) (unique, larger first); -1 for the ranks past the chains.
__device__ __forceinline__ void chain_keys(const unsigned* masks, int S,
                                           int J, int* keys, int rank,
                                           int size) {
  const int Q = size / J;
  if (rank >= J * Q) {
    keys[rank] = -1;
    return;
  }
  const int j = rank % J, q = rank / J;
  const int s0 = chain_start(q, Q, S), s1 = chain_start(q + 1, Q, S);
  int n = 0;
  if (s0 < s1) {
    const int w0 = s0 >> 5, w1 = (s1 - 1) >> 5;
    for (int w = w0; w <= w1; ++w) {
      unsigned m = masks[w * J + j];
      if (w == w0) m &= ~0u << (s0 & 31);
      if (w == w1) m &= ~0u >> (31 - ((s1 - 1) & 31));
      n += bit_count(m);
    }
  }
  keys[rank] = n * size + (size - 1 - rank);
}

// The chains by their keys (size of them, 16-byte aligned), most set bits
// first: order[p] is the chain of rank p, so that a warp holds chains of
// like length.
__device__ __forceinline__ void chain_order(const int* keys, int J, int* order,
                                            int rank, int size) {
  if (rank >= J * (size / J)) return;
  const int key = keys[rank];
  const int4* k4 = reinterpret_cast<const int4*>(keys);
  int p = 0;
  for (int i = 0; i < size / 4; ++i) {
    const int4 k = k4[i];
    p += (k.x > key) + (k.y > key) + (k.z > key) + (k.w > key);
  }
  order[p] = rank;
}

// The pruned walk's samples a lane refreshes at once: two chains in
// flight.
constexpr int kWalkGroup = 2;

// The next N set bits of mask word w (m holds at least N), in order.
template <int N>
__device__ __forceinline__ void take_bits(unsigned& m, int w, int (&s)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s[i] = 32 * w + lowest_bit(m);
    m &= m - 1u;
  }
}

// A chain's sums over the samples [s0, s1) whose bits are set in block j's
// masks, in index order: a mask word at a time (a chain's words are as
// many as its lanes' neighbours', since the slices are of one size), its
// set bits kWalkGroup at a time, the last one by one.  Each group's
// refreshes are formed before the previous group's terms are added (no
// sum sees them earlier), so that their loads and exps overlap that
// group's chains of multiplies.  A warp runs as many refreshes in a word
// as its fullest lane there.
template <typename T, int KMAX>
__device__ __forceinline__ void pruned_block_sums(
    const ET<T>* et, const unsigned* masks, int J, int j, int s0,
    int s1, T zl0, T h, T half_h2, T rho, T (&acc)[KMAX]) {
  constexpr int N = kWalkGroup;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) acc[k] = T(0);
  if (s0 >= s1) return;
  const int w0 = s0 >> 5, w1 = (s1 - 1) >> 5;
  for (int w = w0; w <= w1; ++w) {
    unsigned m = masks[w * J + j];
    if (w == w0) m &= ~0u << (s0 & 31);
    if (w == w1) m &= ~0u >> (31 - ((s1 - 1) & 31));
    int n = bit_count(m);
    if (n >= N) {
      int s[N];
      T v[N], r[N];
      take_bits(m, w, s);
      refresh_n(et, s, zl0, h, half_h2, v, r);
      for (n -= N; n >= N; n -= N) {
        int s2[N];
        T v2[N], r2[N];
        take_bits(m, w, s2);
        refresh_n(et, s2, zl0, h, half_h2, v2, r2);
        terms_n<T, KMAX, N>(v, r, rho, acc);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          v[i] = v2[i];
          r[i] = r2[i];
        }
      }
      terms_n<T, KMAX, N>(v, r, rho, acc);
    }
    for (; m != 0u; m &= m - 1u) {
      const ET<T> p = et[slot(32 * w + lowest_bit(m))];
      refresh_terms<T, KMAX>(p.x, p.y, zl0, h, half_h2, rho, acc);
    }
  }
}

// The uniform-z recurrence in blocks of K <= KMAX points over the grid
// padded to J = ceil(G / K) whole blocks (the padding continues the
// uniform spacing), over the masks' set bits (masks, else every sample).
// With J >= size a thread takes whole blocks over every sample and writes
// them, and -1 is returned.  Else the block's threads split into the J Q
// chains (chain_start); rank p takes chain order[p] (the chains by their
// set bits; without masks, chain p), and the chain's index c = q J + j is
// returned with its K sums in acc (the caller stores them at part[c * KMAX
// + k] for recurrence_fold; -1: no chain).
template <typename T, int KMAX>
__device__ int recurrence_sweep(const double* rec, const ET<T>* et,
                                const unsigned* masks, const int* order,
                                int S, double zg0, int G, int K, T* out,
                                T (&acc)[KMAX], int rank, int size) {
  const int J = (G + K - 1) / K;
  const T h = T(rec[kStepH]);
  const T half_h2 = T(0.5) * h * h;
  const T rho = exp_t(-h * h);
  if (J >= size) {
    const T norm = T(rec[kNorm]);
    for (int j = rank; j < J; j += size) {
      const T zl0 = block_start<T>(rec, zg0, j, K);
      if (masks)
        pruned_block_sums<T, KMAX>(et, masks, J, j, 0, S, zl0, h,
                                          half_h2, rho, acc);
      else
        block_sums<T, KMAX>(et, 0, S, zl0, h, half_h2, rho, acc);
#pragma unroll
      for (int k = 0; k < KMAX; ++k)
        if (k < K && j * K + k < G) out[j * K + k] = norm * acc[k];
    }
    return -1;
  }
  const int Q = size / J;
  if (rank >= J * Q) return -1;
  const int c = masks ? order[rank] : rank;
  const int j = c % J, q = c / J;
  const int s0 = chain_start(q, Q, S), s1 = chain_start(q + 1, Q, S);
  const T zl0 = block_start<T>(rec, zg0, j, K);
  if (masks)
    pruned_block_sums<T, KMAX>(et, masks, J, j, s0, s1, zl0, h,
                                      half_h2, rho, acc);
  else
    block_sums<T, KMAX>(et, s0, s1, zl0, h, half_h2, rho, acc);
  return c;
}

// recurrence_sweep's slices added in slice order, a grid point a thread
template <typename T, int KMAX>
__device__ void recurrence_fold(const double* rec, const T* part, int G,
                                int K, T* out, int rank, int size) {
  const int J = (G + K - 1) / K;
  if (J >= size) return;
  const int Q = size / J;
  const T norm = T(rec[kNorm]);
  for (int g = rank; g < G; g += size) {
    const int j = g / K, k = g % K;
    T s = T(0);
    for (int q = 0; q < Q; ++q) s += part[(q * J + j) * KMAX + k];
    out[g] = norm * s;
  }
}

// ---- K5b: the adjoint ------------------------------------------------------
// Given d_out (the cotangent of K5's output) of a (lambda, event), with
// k = exp(-u^2 / 2), u = zl_g + t, zl_g = L00 (z_g - mean_z), t = c0 - a,
// q1 = c1 - b, q2 = c2 - c (a, b, c a sample's whitened coordinates centred
// on the mean, c0, c1, c2 a pixel's), sky = exp(-(q1^2 + q2^2) / 2), E =
// wn sky and N = exp(log_norm), per (pixel, sample):
//
//   Gs = N sum_g d_out k,  Hs = N sum_g d_out u k,  Zs = N sum_g d_out u k zeta_g
//   (zeta_g = z_g - mean_z), then
//   d wn += Gs sky,  dq1 = -q1 E Gs,  dq2 = -q2 E Gs,  dt = -E Hs,
//   d a -= dt, d b -= dq1, d c -= dq2 (the sample's, summed over its pixels),
//   d c0 += dt, d c1 += dq1, d c2 += dq2 (the pixel's, over its samples),
//   and per (lambda, event) d L00 = -sum E Zs (through zl_g), d log_norm =
//   sum E Gs (= sum d_out out), and A = sum dt, the cotangent of a shift
//   of every zl_g (mean_z's there is -L00 A).
//
// The sums over g are dense: every grid point a term, in T, as the dense
// sweep's; on the recurrence's path (K > 0) only the K-point blocks whose
// refresh the forward keeps (v = e exp(-u0^2 / 2) >= the smallest normal,
// the forward's own test and rounding): a flushed block adds +0 to K5's
// output whatever its inputs, so its terms carry no cotangent, and a sample
// whose e is below the smallest normal carries none on that path.  The
// kept blocks of a (sample, pixel) lie in one range of j, found from the
// sample's skip radius (kept_range): outside it every refresh is flushed.
// A sample's sums run over its pixels in order, each pixel's over the kept
// blocks in order: whichever thread takes the sample, its cotangents are
// the same bits.  The pixel and event sums go through each warp's shuffle
// tree and fixed-order sums over warps and ranks: equal bits every run.
enum SampleGrad { kGradW, kGradA, kGradB, kGradC, kSampleGrads };
enum PixelGrad { kGradC0, kGradC1, kGradC2, kPixelGrads };
enum EventGrad { kGradShift, kGradL00, kGradLogNorm, kEventGrads };

// Whether the forward keeps the refresh of block start zl0 for a sample of
// sky factor e and offset t (refresh()'s v and flush, r left out).
template <typename T>
__device__ __forceinline__ bool kept(T e, T t, T zl0) {
  const T u0 = add_rn(zl0, t);
  return mul_rn(e, exp_t(mul_rn(mul_rn(T(-0.5), u0), u0))) >= smallest_normal<T>();
}

// One grid point's term into (sg, su, sz), each rounding spelled out (one
// fma, into sz), so that the sums' bits do not depend on how nvcc
// contracts the code around them.
template <typename T>
__device__ __forceinline__ void adjoint_term(T t, T zl, T zeta, T dg, T& sg,
                                             T& su, T& sz) {
  const T u = add_rn(zl, t);
  const T d = mul_rn(dg, exp_t(mul_rn(mul_rn(T(-0.5), u), u)));
  const T du = mul_rn(d, u);
  sg = add_rn(sg, d);
  su = add_rn(su, du);
  sz = fma_t(du, zeta, sz);
}

// the terms of grid points [g0, g1) into (sg, su, sz), in order
template <typename T>
__device__ __forceinline__ void adjoint_terms(T t, const T* zl, const T* zeta,
                                              const T* dg, int g0, int g1,
                                              T& sg, T& su, T& sz) {
  for (int g = g0; g < g1; ++g) adjoint_term(t, zl[g], zeta[g], dg[g], sg, su, sz);
}

// The N (a multiple of 4) terms of a whole block from g0, in order, its
// grid points four at a time in 16-byte loads (g0 a multiple of 4; zl,
// zeta and dg 16-byte aligned).
template <typename T, int N>
__device__ __forceinline__ void block_terms(T t, const T* zl, const T* zeta,
                                            const T* dg, int g0, T& sg, T& su,
                                            T& sz) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const Quad<T> a = *reinterpret_cast<const Quad<T>*>(zl + g0 + i);
    const Quad<T> b = *reinterpret_cast<const Quad<T>*>(zeta + g0 + i);
    const Quad<T> c = *reinterpret_cast<const Quad<T>*>(dg + g0 + i);
#pragma unroll
    for (int k = 0; k < 4; ++k) adjoint_term(t, a.v[k], b.v[k], c.v[k], sg, su, sz);
  }
}

// The start of block j in whitened units, zl_start = L00 (z_0 - mean_z)
// (grid_start) plus j K steps in one fma: block_start's bits.
__device__ __forceinline__ double grid_start(const double* rec, double zg0) {
  return __dmul_rn(rec[kL00], zg0 - rec[kMeanZ]);
}

template <typename T>
__device__ __forceinline__ T start_of(double zl_start, double step_h, int j,
                                      int K) {
  return T(fma(double(j * K), step_h, zl_start));
}

// K5b's warps a block (kThreads threads), and the shared memory its chunks
// of pixels' cotangent rows may fill (at least one pixel a chunk).
constexpr int kWarpSize = 32;
constexpr int kAdjointWarps = kThreads / kWarpSize;
constexpr int kAdjointSmem = 96 * 1024;

// a row's stride in shared memory: G padded to whole 16-byte quads of
// float32
__host__ __device__ constexpr int row_stride(int G) { return (G + 3) & ~3; }

// Byte offsets of K5b's shared memory for chunks of pc pixels: the ranks'
// event sums, the chunk's pixel centres (c0, c1, c2) and the warps' pixel
// sums (double); the chunk's cotangent rows, the grid whitened and about
// the mean and the blocks' starts (T, each padded by row_stride, from a
// 16-byte boundary); the chunk's live pixels, their flags and count (int).
struct AdjointLayout {
  size_t epart, centres, part, rows, zl, zeta, starts, live, flags, count, total;
};

__host__ __device__ inline AdjointLayout adjoint_layout(int G, int pc,
                                                        size_t t_size) {
  AdjointLayout a;
  const size_t row = size_t(row_stride(G)) * t_size;
  a.epart = 0;
  a.centres = a.epart + 2 * kThreads * sizeof(double);
  a.part = a.centres + size_t(pc) * kPixelGrads * sizeof(double);
  // the rows, the grid and the starts are read in 16-byte loads
  a.rows = (a.part + size_t(pc) * kPixelGrads * kAdjointWarps * sizeof(double) +
            15) / 16 * 16;
  a.zl = a.rows + size_t(pc) * row;
  a.zeta = a.zl + row;
  a.starts = a.zeta + row;
  a.live = a.starts + row;
  a.flags = a.live + size_t(pc) * sizeof(int);
  a.count = a.flags + size_t(pc) * sizeof(int);
  a.total = a.count + sizeof(int);
  return a;
}

// the pixels a chunk: as many of the P as fit in kAdjointSmem, at least one
__host__ __device__ inline int adjoint_chunk(int P, int G, size_t t_size) {
  int pc = P;
  while (pc > 1 && adjoint_layout(G, pc, t_size).total > size_t(kAdjointSmem)) --pc;
  return pc;
}

// The z grid in whitened units and about the mean (zl and zeta), and for
// K > 0 the starts of the J K-point blocks (start_of: block_start's bits).
template <typename T>
__device__ void adjoint_grid(const double* rec, const T* grid, int G, int K,
                             T* zl, T* zeta, T* starts, int rank, int size) {
  for (int g = rank; g < G; g += size) {
    const double dz = double(grid[g]) - rec[kMeanZ];
    zl[g] = T(rec[kL00] * dz);
    zeta[g] = T(dz);
  }
  if (K > 0) {
    const double zl_start = grid_start(rec, double(grid[0]));
    for (int j = rank; j < (G + K - 1) / K; j += size)
      starts[j] = start_of<T>(zl_start, rec[kStepH], j, K);
  }
}

// A sample's double factors, formed once for all of its pixels: its
// coordinates about the weighted mean and its unit weight.
struct SampleFactors {
  double dz, dr, dd, wn;
};

template <typename T>
__device__ __forceinline__ SampleFactors sample_of(const double* rec,
                                                   const T* z, const T* w,
                                                   const T* ra, const T* dec,
                                                   int s, int S) {
  SampleFactors f;
  f.dz = double(z[s]) - rec[kMeanZ];
  f.dr = double(ra[s]) - rec[kMeanRa];
  f.dd = double(dec[s]) - rec[kMeanDec];
  f.wn = unit_weight(w[s], rec[kSumW], S);
  return f;
}

// ---- a chunk of pixels -----------------------------------------------------
// The chunk's np cotangent rows into rows (row i at i row_stride(G); a
// fake pixel's row 0) and a flag for each row that holds a value other
// than 0 (flags zeroed before).
template <typename T>
__device__ void stage_rows(const T* d_out, const unsigned char* mask, int np,
                           int G, T* rows, int* flags, int rank, int size) {
  for (int m = rank; m < np * G; m += size) {
    const int i = m / G;
    const T v = mask[i] ? d_out[m] : T(0);
    rows[i * row_stride(G) + m % G] = v;
    if (v != T(0)) flags[i] = 1;
  }
}

// rank 0: the flagged pixels of the chunk in order, and their count
__device__ __forceinline__ void live_pixels(const int* flags, int np,
                                            int* live, int* count, int rank) {
  if (rank != 0) return;
  int n = 0;
  for (int i = 0; i < np; ++i)
    if (flags[i]) live[n++] = i;
  *count = n;
}

// a pixel's whitened centre (c0, c1, c2) about the mean
template <typename T>
__device__ __forceinline__ void pixel_centre(const double* rec, T ra_pix,
                                             T dec_pix, double* c) {
  const double rp = double(ra_pix) - rec[kMeanRa];
  const double dp = double(dec_pix) - rec[kMeanDec];
  c[kGradC0] = fma(rec[kL10], rp, __dmul_rn(rec[kL20], dp));
  c[kGradC1] = fma(rec[kL11], rp, __dmul_rn(rec[kL21], dp));
  c[kGradC2] = __dmul_rn(rec[kL22], dp);
}

// ---- one (sample, pixel) ----------------------------------------------------
struct Whitening {
  double l00, l10, l20, l11, l21, l22, norm;
};

__device__ __forceinline__ Whitening whitening(const double* rec) {
  return {rec[kL00], rec[kL10], rec[kL20], rec[kL11], rec[kL21], rec[kL22],
          rec[kNorm]};
}

// the sample's sky offsets q1, q2, its sky factor, e and t at the pixel of
// centre c, formed as sample_factors forms them; this and pixel_centre's
// and pixel_tail's roundings are spelled out, the fmas included, so that
// d_samp's bits do not depend on how nvcc contracts the code around them
template <typename T>
__device__ __forceinline__ void sample_pixel(const Whitening& L,
                                             const SampleFactors& f,
                                             const double* c, double& q1,
                                             double& q2, double& sky, T& e,
                                             T& t) {
  q1 = __dadd_rn(c[kGradC1], -fma(L.l11, f.dr, __dmul_rn(L.l21, f.dd)));
  q2 = fma(-L.l22, f.dd, c[kGradC2]);
  sky = exp(__dmul_rn(fma(q2, q2, __dmul_rn(q1, q1)), -0.5));
  e = T(__dmul_rn(f.wn, sky));
  const double a = fma(L.l20, f.dd, fma(L.l00, f.dz, __dmul_rn(L.l10, f.dr)));
  t = T(__dadd_rn(c[kGradC0], -a));
}

// The blocks [lo, hi] whose refresh K5 may keep for a sample of sky factor
// e and offset t (J blocks of K points starting at starts[j] = start_of(j);
// empty: lo > hi).  With step_h > 0 the refresh's u0_j = fl(starts[j] + t)
// is non-decreasing in j (each rounding is monotone), so the blocks with
// |u0_j| <= R, R = skip_radius(e), are one range: an estimate from the
// blocks' spacing (inv_w = 1 / (K step_h), in float), then moved block by
// block until u0 of its ends says it is exact.  Outside it |u0_j| > R, and
// skip_radius proves every such refresh flushed.  e below the smallest
// normal keeps none; R = +inf, step_h not a positive number, or t not
// finite: every block (kept() decides).
template <typename T>
__device__ __forceinline__ void kept_range(T e, T t, const T* starts,
                                           double zl_start, double step_h,
                                           double inv_w, int J, int& lo,
                                           int& hi) {
  lo = J;
  hi = -1;
  if (!(e >= smallest_normal<T>())) return;
  const T r = skip_radius(e);
  if (!(r >= T(0))) return;
  if (!(r < T(INFINITY)) || !(step_h > 0.0) || !(fabs(t) < T(INFINITY))) {
    lo = 0;
    hi = J - 1;
    return;
  }
  const float c = float(t) + float(zl_start), w = float(inv_w);
  lo = int(floorf(fminf(fmaxf((-float(r) - c) * w, 0.0f), float(J))));
  hi = int(ceilf(fminf(fmaxf((float(r) - c) * w, -1.0f), float(J - 1))));
  while (lo > 0 && add_rn(starts[lo - 1], t) >= -r) --lo;
  while (lo < J && add_rn(starts[lo], t) < -r) ++lo;
  while (hi < J - 1 && add_rn(starts[hi + 1], t) <= r) ++hi;
  while (hi >= 0 && add_rn(starts[hi], t) > r) --hi;
}

// The sample's sums over one pixel's terms (sg, su, sz): on the dense
// sweep's events every grid point; else, for j in [wlo, whi] (the range a
// warp walks in step: the union of its lanes'), the blocks of its own
// range [lo, hi] whose refresh K5 keeps, in order, a block of 8, 16 or 32
// points from a multiple of 4 through block_terms.
template <typename T>
__device__ __forceinline__ void pixel_sums(T e, T t, const T* zl,
                                           const T* zeta, const T* starts,
                                           const T* dg, int G, int K, int lo,
                                           int hi, int wlo, int whi, T& sg,
                                           T& su, T& sz) {
  sg = su = sz = T(0);
  if (K == 0) {
    adjoint_terms(t, zl, zeta, dg, 0, G, sg, su, sz);
    return;
  }
  for (int j = wlo; j <= whi; ++j) {
    if (j < lo || j > hi || !kept(e, t, starts[j])) continue;
    const int g0 = j * K, g1 = g0 + K < G ? g0 + K : G;
    if ((g0 & 3) != 0)
      adjoint_terms(t, zl, zeta, dg, g0, g1, sg, su, sz);
    else if (g1 - g0 == 16)
      block_terms<T, 16>(t, zl, zeta, dg, g0, sg, su, sz);
    else if (g1 - g0 == 8)
      block_terms<T, 8>(t, zl, zeta, dg, g0, sg, su, sz);
    else if (g1 - g0 == 32)
      block_terms<T, 32>(t, zl, zeta, dg, g0, sg, su, sz);
    else
      adjoint_terms(t, zl, zeta, dg, g0, g1, sg, su, sz);
  }
}

// The (sample, pixel)'s cotangents from its sums: the sample's into acc
// (SampleGrad, pixels in order), d L00's and d log_norm's into pl and pn,
// and the pixel's (dt, dq1, dq2) returned.
template <typename T>
__device__ __forceinline__ void pixel_tail(double norm, double wn, double q1,
                                           double q2, double sky, T sg, T su,
                                           T sz, double (&acc)[kSampleGrads],
                                           double& pl, double& pn, double& dt,
                                           double& dq1, double& dq2) {
  const double gs = __dmul_rn(norm, double(sg)), big_e = __dmul_rn(wn, sky);
  const double nb = __dmul_rn(norm, big_e), q1b = __dmul_rn(q1, big_e),
               q2b = __dmul_rn(q2, big_e);
  acc[kGradW] = fma(gs, sky, acc[kGradW]);
  acc[kGradA] = fma(double(su), nb, acc[kGradA]);
  acc[kGradB] = fma(gs, q1b, acc[kGradB]);
  acc[kGradC] = fma(gs, q2b, acc[kGradC]);
  pl = fma(-nb, double(sz), pl);
  pn = fma(big_e, gs, pn);
  dt = -__dmul_rn(nb, double(su));
  dq1 = -__dmul_rn(q1b, gs);
  dq2 = -__dmul_rn(q2b, gs);
}

// A warp's range: the union of its lanes' (all 32 lanes call it).
__device__ __forceinline__ void warp_range(int lo, int hi, int& wlo, int& whi) {
  wlo = __reduce_min_sync(0xffffffffu, lo);
  whi = __reduce_max_sync(0xffffffffu, hi);
}

// A warp's sum of v in lane 0, by the shuffle tree (offsets 16, 8, ..., 1).
__device__ __forceinline__ double warp_sum(double v) {
  for (int o = kWarpSize / 2; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// A dead (lambda, event) (no whitening, or a block length K5 does not
// take: K5's NaN rows): every cotangent NaN, as autograd of the plain
// version gives it there.
__device__ __forceinline__ void adjoint_dead(double* d_samp, double* d_pix,
                                             double* d_event, int S, int P,
                                             int rank, int size) {
  const double q = nan("");
  for (int i = rank; i < kSampleGrads * S; i += size) d_samp[i] = q;
  for (int i = rank; i < kPixelGrads * P; i += size) d_pix[i] = q;
  for (int i = rank; i < kEventGrads; i += size) d_event[i] = q;
}

// Rank 0's event sums: the shift's over d_pix's kGradC0 (pixels in order),
// d L00's and d log_norm's over the ranks' (epart[rank], epart[size +
// rank]) in rank order.
__device__ __forceinline__ void adjoint_event(const double* epart,
                                              const double* d_pix,
                                              double* d_event, int P, int rank,
                                              int size) {
  if (rank != 0) return;
  double a = 0.0;
  for (int p = 0; p < P; ++p) a += d_pix[p * kPixelGrads + kGradC0];
  d_event[kGradShift] = a;
  d_event[kGradL00] = ordered_sum(epart, size);
  d_event[kGradLogNorm] = ordered_sum(epart + size, size);
}

}  // namespace kde3d
