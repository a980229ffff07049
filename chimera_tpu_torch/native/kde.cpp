// Host-side weighted N-D Gaussian KDE and 1-D KDE on a grid: independent
// oracles of the port's tensor KDEs (chimera_tpu_torch/ops/kde.py
// gaussian_kde_nd, kde1d) in the port's copy of chimera_tpu/native/kde.cpp.
//
// Inputs are pre-whitened (the d x d covariance / Cholesky is negligible and
// stays in the caller); this routine does the O(n_points * n_samples) sum
// with per-point log-sum-exp when requested; the omp pragmas parallelize
// over points where it is built with OpenMP (the port builds it serial).

#include <cmath>
#include <cstdint>

extern "C" {

// points_w: (n_points, d) whitened evaluation points, row-major
// data_w:   (n_samples, d) whitened samples, row-major
// weights:  (n_samples,) normalized weights
// log_norm: scalar log-normalization (sum log diag L - d/2 log 2pi)
// out:      (n_points,) density (or log-density if in_log)
void chimera_gkde_whitened(const double* points_w, const double* data_w,
                           const double* weights, double log_norm,
                           int64_t n_points, int64_t n_samples, int64_t d,
                           int in_log, double* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n_points; ++i) {
    const double* p = points_w + i * d;
    if (in_log) {
      // two-pass log-sum-exp for stability
      double max_arg = -INFINITY;
      for (int64_t j = 0; j < n_samples; ++j) {
        const double* s = data_w + j * d;
        double chi2 = 0.0;
        for (int64_t k = 0; k < d; ++k) {
          double dk = s[k] - p[k];
          chi2 += dk * dk;
        }
        double arg = std::log(weights[j]) - 0.5 * chi2;
        if (arg > max_arg) max_arg = arg;
      }
      double acc = 0.0;
      for (int64_t j = 0; j < n_samples; ++j) {
        const double* s = data_w + j * d;
        double chi2 = 0.0;
        for (int64_t k = 0; k < d; ++k) {
          double dk = s[k] - p[k];
          chi2 += dk * dk;
        }
        acc += std::exp(std::log(weights[j]) - 0.5 * chi2 - max_arg);
      }
      out[i] = log_norm + max_arg + std::log(acc);
    } else {
      // Neumaier-compensated accumulation keeps f64 round-off negligible
      // even for ~1e7-sample reductions.
      double sum = 0.0, comp = 0.0;
      for (int64_t j = 0; j < n_samples; ++j) {
        const double* s = data_w + j * d;
        double chi2 = 0.0;
        for (int64_t k = 0; k < d; ++k) {
          double dk = s[k] - p[k];
          chi2 += dk * dk;
        }
        double term = weights[j] * std::exp(-0.5 * chi2);
        double t = sum + term;
        comp += (std::fabs(sum) >= std::fabs(term)) ? (sum - t) + term
                                                    : (term - t) + sum;
        sum = t;
      }
      out[i] = std::exp(log_norm) * (sum + comp);
    }
  }
}

// Weighted 1-D KDE on a grid (Epanechnikov or Gaussian), the host analog of
// chimera_tpu_torch/ops/kde.py kde1d.  kernel: 0 = epanechnikov, 1 = gaussian.
void chimera_kde1d(const double* data, const double* weights, double bandwidth,
                   const double* grid, int64_t n_samples, int64_t n_grid,
                   int kernel, double* out) {
  const double inv_sqrt_2pi = 0.3989422804014327;
#pragma omp parallel for schedule(static)
  for (int64_t g = 0; g < n_grid; ++g) {
    double acc = 0.0;
    for (int64_t s = 0; s < n_samples; ++s) {
      double u = (grid[g] - data[s]) / bandwidth;
      if (kernel == 0) {
        double v = 1.0 - u * u;
        if (v > 0) acc += weights[s] * 0.75 * v;
      } else {
        acc += weights[s] * inv_sqrt_2pi * std::exp(-0.5 * u * u);
      }
    }
    out[g] = acc / bandwidth;
  }
}

}  // extern "C"
