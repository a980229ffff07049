// Serial host emulation of the adjoint kernel K3
// (chimera_tpu_torch/csrc/fused_kde_adjoint.cu) in every mode, from the same
// device functions (adjoint.cuh's adjoint_row, population.cuh): per
// (lambda, row) the kernel's phases with a block of one thread, whose block
// sums are the identity, and the rows' gradients summed in row order in
// double.  Same C interface as the kernel's (its `partials` scratch is not
// used), without the stream.  Built by tests/test_torch_host_emulation.py.
#include <algorithm>
#include <vector>

#include "host_block.h"
#include "adjoint.cuh"

namespace {

template <typename T, typename S, int KERNEL, int MODE>
void run_mode(const AdjointArgs<T>& a, double* d_series, T* d_params) {
  using N = Dual<T, kDirs>;
  const int Q = a.cheb_deg + 2 + a.window_deg, P = Q + kMassScalars;
  std::vector<S> ser(Q);
  std::vector<T> z(a.S), w(a.S), dz(a.S), dw(a.S);
  std::vector<typename Pair<T>::type> gc(std::max(a.G, 1));
  const AdjointSmem<T> sm{z.data(), w.data(), dz.data(), dw.data(), gc.data()};
  for (int l = 0; l < a.L; ++l) {
    for (int i = 0; i < Q; ++i) ser[i] = S(a.series[(size_t)l * Q + i]);
    const T* prm = a.params + (size_t)l * kMassScalars;
    MassModel<N> mm;
    SampleAdjoint<T, S>::seed_mass(mm, prm);
    const Model<T, S> model(ser.data(), prm, a.cheb_deg, a.window_deg);
    const SampleAdjoint<T, S> sample(ser.data(), a.cheb_deg, a.window_deg);
    std::vector<double> total(P, 0.0);
    for (int b = 0; b < a.B; ++b) {
      GradAcc<T> g;
      g.zero();
      adjoint_row<T, S, KERNEL, MODE>(HostBlock<T>{}, model, sample, mm, a, l,
                                      b, sm, g);
      for (int i = 0; i < P; ++i) total[i] += double(g.at(i, a.cheb_deg,
                                                          a.window_deg));
    }
    for (int i = 0; i < Q; ++i) d_series[(size_t)l * Q + i] = total[i];
    for (int i = 0; i < kMassScalars; ++i)
      d_params[(size_t)l * kMassScalars + i] = T(total[Q + i]);
  }
}

template <typename T, int KERNEL>
void run_kernel(const AdjointArgs<T>& a, int mode, double* ds, T* dp) {
  if (mode == kAnalysisGrid) run_mode<T, T, KERNEL, kAnalysisGrid>(a, ds, dp);
  if (mode == kEffectiveGrid) run_mode<T, T, KERNEL, kEffectiveGrid>(a, ds, dp);
  if (mode == kExternalBounds)
    run_mode<T, double, KERNEL, kExternalBounds>(a, ds, dp);
  if (mode == kStatsOnly) run_mode<T, double, KERNEL, kStatsOnly>(a, ds, dp);
}

template <typename T>
void run(const T* m1, const T* m2, const T* dl, const T* invp, const T* grids,
         const T* ext, const long long* n_real, const T* dl_fill,
         const double* series, const T* params, const T* ct_den,
         const T* ct_stats, double* d_series, T* d_params, T* d_ext, int L,
         int B, int S, int G, int cd, int wd, int logical_s, int mode,
         int kernel, int bw_mode, double bw_value, double cut_grid,
         int unit_scale) {
  const AdjointArgs<T> a{m1, m2, dl, invp, grids, ext, n_real, dl_fill,
                         series, params, ct_den, ct_stats, nullptr, d_ext, L,
                         B, S, G, cd, wd, logical_s, bw_mode, unit_scale,
                         (T)bw_value, (T)cut_grid};
  if (kernel == 0) run_kernel<T, 0>(a, mode, d_series, d_params);
  else run_kernel<T, 1>(a, mode, d_series, d_params);
}

}  // namespace

extern "C" void host_fused_kde_adjoint_f32(
    const float* m1, const float* m2, const float* dl, const float* invp,
    const float* grids, const float* ext, const long long* n_real,
    const float* dl_fill, const double* series, const float* params,
    const float* ct_den, const float* ct_stats, double* partials,
    double* d_series,
    float* d_params, float* d_ext, int L, int B, int S, int G, int cd, int wd,
    int logical_s, int mode, int kernel, int bw_mode, double bw_value,
    double cut_grid, int unit_scale) {
  (void)partials;
  run<float>(m1, m2, dl, invp, grids, ext, n_real, dl_fill, series, params,
             ct_den, ct_stats, d_series, d_params, d_ext, L, B, S, G, cd, wd,
             logical_s, mode, kernel, bw_mode, bw_value, cut_grid, unit_scale);
}

extern "C" void host_fused_kde_adjoint_f64(
    const double* m1, const double* m2, const double* dl, const double* invp,
    const double* grids, const double* ext, const long long* n_real,
    const double* dl_fill, const double* series, const double* params,
    const double* ct_den, const double* ct_stats, double* partials,
    double* d_series,
    double* d_params, double* d_ext, int L, int B, int S, int G, int cd,
    int wd, int logical_s, int mode, int kernel, int bw_mode, double bw_value,
    double cut_grid, int unit_scale) {
  (void)partials;
  run<double>(m1, m2, dl, invp, grids, ext, n_real, dl_fill, series, params,
              ct_den, ct_stats, d_series, d_params, d_ext, L, B, S, G, cd, wd,
              logical_s, mode, kernel, bw_mode, bw_value, cut_grid, unit_scale);
}
