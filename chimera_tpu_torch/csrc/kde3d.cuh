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
                               T dec_pix, T* es, T* ts, int rank, int size) {
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
    es[i] = T(unit_weight(w[i], rec[kSumW], S) * exp(-0.5 * (q1 * q1 + q2 * q2)));
    ts[i] = T(c0 - (l00 * dz + l10 * dr + l20 * dd));
  }
}

// The dense z sweep, one exp a term: each thread takes kDensePoints grid
// points at a time, the samples in order.
template <typename T>
__device__ void dense_sweep(const double* rec, const T* es, const T* ts,
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
      const T e = es[s], t = ts[s];
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

// One K-point block's sums over the samples [s0, s1): per sample an exact
// refresh v = e exp(-u0^2 / 2), r = exp(-h u0 - h^2 / 2) (two exps), flushed
// to 0 below the smallest normal (a NaN too), then K multiply-adds.
template <typename T, int KMAX>
__device__ __forceinline__ void block_sums(const T* es, const T* ts, int s0,
                                           int s1, T zl0, T h, T half_h2,
                                           T rho, int K, T (&acc)[KMAX]) {
#pragma unroll
  for (int k = 0; k < KMAX; ++k) acc[k] = T(0);
  for (int s = s0; s < s1; ++s) {
    const T u0 = zl0 + ts[s];
    T v = es[s] * exp_t(T(-0.5) * u0 * u0);
    T r = exp_t(-h * u0 - half_h2);
    if (!(v >= smallest_normal<T>())) {
      v = T(0);
      r = T(0);
    }
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) {
        acc[k] += v;
        v *= r;
        r *= rho;
      }
    }
  }
}

// The uniform-z recurrence in blocks of K <= KMAX points over the grid
// padded to J = ceil(G / K) whole blocks (the padding continues the
// uniform spacing).  With J >= size a thread takes whole blocks over every
// sample and writes them; else the block's threads split into J blocks x
// Q = size / J slices of the samples, and each stores its K sums in
// part[rank * KMAX + k] for recurrence_fold.
template <typename T, int KMAX>
__device__ void recurrence_sweep(const double* rec, const T* es, const T* ts,
                                 int S, double zg0, int G, int K, T* part,
                                 T* out, int rank, int size) {
  const int J = (G + K - 1) / K;
  const T h = T(rec[kStepH]);
  const T half_h2 = T(0.5) * h * h;
  const T rho = exp_t(-h * h);
  const double zl_start = rec[kL00] * (zg0 - rec[kMeanZ]);
  T acc[KMAX];
  if (J >= size) {
    const T norm = T(rec[kNorm]);
    for (int j = rank; j < J; j += size) {
      block_sums<T, KMAX>(es, ts, 0, S, T(zl_start + double(j * K) * rec[kStepH]),
                          h, half_h2, rho, K, acc);
#pragma unroll
      for (int k = 0; k < KMAX; ++k)
        if (k < K && j * K + k < G) out[j * K + k] = norm * acc[k];
    }
    return;
  }
  const int Q = size / J;
  if (rank >= J * Q) return;
  const int j = rank % J, q = rank / J;
  block_sums<T, KMAX>(es, ts, int((long long)q * S / Q),
                      int((long long)(q + 1) * S / Q),
                      T(zl_start + double(j * K) * rec[kStepH]), h, half_h2,
                      rho, K, acc);
#pragma unroll
  for (int k = 0; k < KMAX; ++k) part[rank * KMAX + k] = acc[k];
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

}  // namespace kde3d
