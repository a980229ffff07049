// Serial host emulation of the fused weights+KDE kernel
// (chimera_tpu_torch/csrc/fused_kde.cu, K1 in its four modes) and of the
// batched KDE (chimera_tpu_torch/csrc/kde1d.cu, K4) from the same device
// functions (kde.cuh, population.cuh): per (lambda, row) the kernel's
// phases with a block of one thread, whose block sums are the identity.
// Same C interfaces as the kernels', without the stream.  Built by
// tests/test_torch_host_emulation.py.
#include <vector>

#include "host_block.h"
#include "kde.cuh"

namespace {

template <typename T, typename S, int KERNEL, int MODE>
void run_mode(const FusedArgs<T>& a) {
  const int Q = a.cheb_deg + 2 + a.window_deg;
  std::vector<S> ser(Q);
  std::vector<typename Pair<T>::type> zw(a.S);
  for (int l = 0; l < a.L; ++l) {
    for (int i = 0; i < Q; ++i) ser[i] = S(a.series[(size_t)l * Q + i]);
    const Model<T, S> model(ser.data(), a.params + (size_t)l * kMassScalars,
                            a.cheb_deg, a.window_deg);
    for (int b = 0; b < a.B; ++b)
      fused_row<T, S, KERNEL, MODE>(HostBlock<T>{}, model, a, l, b, zw.data());
  }
}

template <typename T, int KERNEL>
void run_kernel(const FusedArgs<T>& a, int mode) {
  if (mode == kAnalysisGrid) run_mode<T, T, KERNEL, kAnalysisGrid>(a);
  if (mode == kEffectiveGrid) run_mode<T, T, KERNEL, kEffectiveGrid>(a);
  if (mode == kExternalBounds) run_mode<T, double, KERNEL, kExternalBounds>(a);
  if (mode == kStatsOnly) run_mode<T, double, KERNEL, kStatsOnly>(a);
}

template <typename T>
void run(const T* m1, const T* m2, const T* dl, const T* invp, const T* grids,
         const T* ext, const long long* n_real, const T* dl_fill,
         const double* series, const T* params, T* den, T* stats, int L,
         int B, int S, int G, int cheb_deg, int window_deg, int logical_s,
         int mode, int kernel, int bw_mode, double bw_value, double cut_grid,
         int unit_scale) {
  const FusedArgs<T> a{m1, m2, dl, invp, grids, ext, n_real, dl_fill, series,
                       params, den, stats, L, B, S, G, cheb_deg, window_deg,
                       logical_s, bw_mode, unit_scale, (T)bw_value,
                       (T)cut_grid};
  if (kernel == 0) run_kernel<T, 0>(a, mode);
  else run_kernel<T, 1>(a, mode);
}

template <typename T, int KERNEL>
void run_kde1d(const T* z, const T* w, const T* grids, const T* h, T* out,
               int B, int S, int G) {
  std::vector<typename Pair<T>::type> zw(S);
  for (int b = 0; b < B; ++b) {
    for (int s = 0; s < S; ++s) {
      zw[s].x = z[(size_t)b * S + s];
      zw[s].y = w[(size_t)b * S + s];
    }
    kde_row<T, KERNEL>(HostBlock<T>{}, zw.data(), S, grids + (size_t)b * G, G,
                       h[b], out + (size_t)b * G);
  }
}

}  // namespace

#define FUSED_ARGS(T)                                                        \
  const T *m1, const T *m2, const T *dl, const T *invp, const T *grids,     \
      const T *ext, const long long *n_real, const T *dl_fill,              \
      const double *series, const T *params, T *den, T *stats, int L, int B, \
      int S, int G, int cheb_deg, int window_deg, int logical_s, int mode,   \
      int kernel, int bw_mode, double bw_value, double cut_grid,             \
      int unit_scale
#define FUSED_CALL                                                            \
  run(m1, m2, dl, invp, grids, ext, n_real, dl_fill, series, params, den,    \
      stats, L, B, S, G, cheb_deg, window_deg, logical_s, mode, kernel,      \
      bw_mode, bw_value, cut_grid, unit_scale)

extern "C" void host_fused_kde_f32(FUSED_ARGS(float)) { FUSED_CALL; }
extern "C" void host_fused_kde_f64(FUSED_ARGS(double)) { FUSED_CALL; }

extern "C" void host_kde1d_f32(const float* z, const float* w,
                               const float* grids, const float* h, float* out,
                               int B, int S, int G, int kernel) {
  if (kernel == 0) run_kde1d<float, 0>(z, w, grids, h, out, B, S, G);
  else run_kde1d<float, 1>(z, w, grids, h, out, B, S, G);
}

extern "C" void host_kde1d_f64(const double* z, const double* w,
                               const double* grids, const double* h,
                               double* out, int B, int S, int G, int kernel) {
  if (kernel == 0) run_kde1d<double, 0>(z, w, grids, h, out, B, S, G);
  else run_kde1d<double, 1>(z, w, grids, h, out, B, S, G);
}
