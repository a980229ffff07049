// Adjoint of the fused weights+KDE pass (K3): one kernel template,
// fused_kde_adjoint_kernel, that replaces chimera_tpu/ops/pallas/fused.py::
// _adjoint_kernel (fused.py:713-966, pallas_call at fused.py:1055) in every
// mode of the forward (FusedMode in kde.cuh), Epanechnikov or Gaussian:
//
//   K3a  kAnalysisGrid    the analysis grids, 'norms' (the spectral samplers:
//                         '1d' and 'approximate', cut_grid=None);
//   K3b  kEffectiveGrid   each row's own grid over [z_min - c sigma,
//                         z_max + c sigma], 'norms', with the chains of the
//                         bounds (fused.py:929-948): '1d' and 'approximate'
//                         with cut_grid;
//   K3c  kStatsOnly       the row statistics and their bounds alone, of
//                         logical rows or plain ones: pass 1 of
//                         'marginalized' (both cut_grid settings);
//   K3d  kExternalBounds  given bounds, returned d_ext (L, B, 2), logical
//                         rows, 'unit' with the row_ok select
//                         (fused.py:847-851, 923-927): pass 2 of
//                         'marginalized' with cut_grid.
//
// Semantics: the vector-Jacobian product of the forward in the packed rows
// (and the bounds); the plain PyTorch twin is chimera_tpu_torch/ops/cuda/
// fused.py::fused_weights_kde_adjoint_plain (autograd through
// fused_weights_kde_plain).  The arithmetic of one (lambda, row) is
// adjoint.cuh's adjoint_row, written once for a block of threads (the host
// emulation runs it with a block of one thread); the device model is in
// population.cuh.
//
// Given the cotangents cd (L, B, G) of the densities and cs (L, B, 8) of the
// row statistics, it returns the gradients of the two packed per-lambda rows
// (pack_params): d_series (L, cheb_deg + 2 + window_deg) and d_params
// (L, 12), summed over the rows.  The PE data and the grids get no gradient.
// One thread block per (lambda, row), lambda fastest, as in K1; the per-row
// gradients go to `partials` (L, B, P) and a second kernel sums them over
// the rows in row order, in double: no atomics anywhere, so equal inputs
// give equal bits and an HMC chain repeats under a fixed generator.  As in
// the forward, the Chebyshev series are summed in T in the spectral modes
// (a, b) and in double in the dark-siren modes (c, d): the backward
// differentiates the z the forward computed.
//
// What bounds it on an H100: arithmetic.  Phase B evaluates L*B*G*n pair
// terms, ~11 FP32 operations each against K1a's 7 (13 on a linear grid,
// whose bounds need one more sum); phases A and D add the two Clenshaw
// recurrences (value, derivative and projection) and the mass model on
// 14-direction duals per sample, about a third of phase B's work at G = 500
// and all of K3c's.  The kernel reads the (B, S) PE rows and the (L, B, G)
// cotangents once and writes (L, B, P) partials.
//
// What the design does about it: z, w, dz and dw of the block's row stay in
// shared memory, the grid loop feeds kSamplesPerThread samples per
// shared-memory load, the kernel-shape constants are applied once per
// sample, and a logical row maps only its real samples (its fillers enter
// analytically, as in K1).  Later work: prune the grid loop to the kernel
// support of the dL-sorted samples, and tile phase D's dual arithmetic (it
// spills registers).

#include "adjoint.cuh"

namespace {

template <typename T, typename S, int KERNEL, int MODE>
__global__ void __launch_bounds__(kThreads)
fused_kde_adjoint_kernel(const AdjointArgs<T> a) {
  using N = Dual<T, kDirs>;
  using T2 = typename Pair<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  S* ser = reinterpret_cast<S*>(smem);  // Chebyshev series, summed in S
  AdjointSmem<T> sm;
  sm.z = reinterpret_cast<T*>(smem + series_bytes<S>(a.cheb_deg, a.window_deg));
  sm.w = sm.z + a.S;
  sm.dz = sm.w + a.S;
  sm.dw = sm.dz + a.S;
  sm.gc = reinterpret_cast<T2*>(sm.dw + a.S);  // G (grid point, c1) pairs
  T* prm = reinterpret_cast<T*>(sm.gc + (MODE == kStatsOnly ? 0 : a.G));
  __shared__ T scratch[4][kWarps];
  __shared__ T red[kWarps][kMaxP];
  __shared__ MassModel<N> dual_mass;

  const int l = blockIdx.x % a.L;
  const int b = blockIdx.x / a.L;
  const int Q = a.cheb_deg + 2 + a.window_deg;
  for (int i = threadIdx.x; i < Q; i += kThreads)
    ser[i] = S(a.series[(size_t)l * Q + i]);
  for (int i = threadIdx.x; i < kMassScalars; i += kThreads)
    prm[i] = a.params[(size_t)l * kMassScalars + i];
  __syncthreads();
  if (threadIdx.x == 0) SampleAdjoint<T, S>::seed_mass(dual_mass, prm);
  const Model<T, S> model(ser, prm, a.cheb_deg, a.window_deg);
  const SampleAdjoint<T, S> sample(ser, a.cheb_deg, a.window_deg);
  GradAcc<T> g;
  g.zero();
  adjoint_row<T, S, KERNEL, MODE>(DeviceBlock<T>{scratch}, model, sample,
                                  dual_mass, a, l, b, sm, g);
  store_partials(g, a.cheb_deg, a.window_deg,
                 a.partials + ((size_t)l * a.B + b) * (Q + kMassScalars), red);
}

template <typename T, typename S, int KERNEL, int MODE>
int launch_mode(const AdjointArgs<T>& a, double* d_series, T* d_params,
                cudaStream_t stream) {
  const size_t smem = series_bytes<S>(a.cheb_deg, a.window_deg)
                      + ((size_t)4 * a.S + (MODE == kStatsOnly ? 0 : 2 * (size_t)a.G)
                         + kMassScalars) * sizeof(T);
  auto kernel = fused_kde_adjoint_kernel<T, S, KERNEL, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)a.L * (unsigned)a.B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_events_kernel<T><<<a.L, 160, 0, stream>>>(
      a.partials, d_series, d_params, a.B, a.cheb_deg + 2 + a.window_deg);
  return (int)cudaGetLastError();
}

template <typename T, int KERNEL>
int launch_kernel(const AdjointArgs<T>& a, int mode, double* d_series,
                  T* d_params, cudaStream_t s) {
  switch (mode) {
    case kAnalysisGrid:
      return launch_mode<T, T, KERNEL, kAnalysisGrid>(a, d_series, d_params, s);
    case kEffectiveGrid:
      return launch_mode<T, T, KERNEL, kEffectiveGrid>(a, d_series, d_params, s);
    case kExternalBounds:
      return launch_mode<T, double, KERNEL, kExternalBounds>(a, d_series,
                                                             d_params, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const T* m1, const T* m2, const T* dl, const T* invp,
           const T* grids, const T* ext, const long long* n_real,
           const T* dl_fill, const double* series, const T* params,
           const T* ct_den, const T* ct_stats, double* partials,
           double* d_series, T* d_params, T* d_ext, int L, int B, int S, int G,
           int cheb_deg, int window_deg, int logical_s, int mode, int kernel,
           int bw_mode, double bw_value, double cut_grid, int unit_scale,
           void* stream) {
  const bool dense = mode != kStatsOnly;
  if (L <= 0 || B <= 0 || S <= 0 || cheb_deg < 1 || window_deg < 1
      || cheb_deg > kMaxDeg || window_deg > kMaxDeg
      || (dense && G <= 0) || (dense && mode != kAnalysisGrid && G < 2)
      || (n_real != nullptr && logical_s <= 0)
      || (mode == kExternalBounds && d_ext == nullptr))
    return (int)cudaErrorInvalidValue;
  const AdjointArgs<T> a{m1, m2, dl, invp, grids, ext, n_real, dl_fill,
                         series, params, ct_den, ct_stats, partials, d_ext, L,
                         B, S, G, cheb_deg, window_deg, logical_s, bw_mode,
                         unit_scale, (T)bw_value, (T)cut_grid};
  auto s = static_cast<cudaStream_t>(stream);
  if (!dense)
    return launch_mode<T, double, 0, kStatsOnly>(a, d_series, d_params, s);
  if (kernel == 0) return launch_kernel<T, 0>(a, mode, d_series, d_params, s);
  return launch_kernel<T, 1>(a, mode, d_series, d_params, s);
}

}  // namespace

// C interface (loaded with ctypes by chimera_tpu_torch/ops/cuda/fused.py).
// grids, ext, n_real, dl_fill, ct_den and d_ext may be null where the mode
// does not use them.  `partials` is scratch of (L, B, P) doubles.  Returns
// the CUDA error code of the launches (0 = cudaSuccess).
extern "C" int chimera_fused_kde_adjoint_f32(
    const float* m1, const float* m2, const float* dl, const float* invp,
    const float* grids, const float* ext, const long long* n_real,
    const float* dl_fill, const double* series, const float* params,
    const float* ct_den, const float* ct_stats, double* partials,
    double* d_series, float* d_params, float* d_ext, int L, int B, int S,
    int G, int cheb_deg, int window_deg, int logical_s, int mode, int kernel,
    int bw_mode, double bw_value, double cut_grid, int unit_scale,
    void* stream) {
  return launch<float>(m1, m2, dl, invp, grids, ext, n_real, dl_fill, series,
                       params, ct_den, ct_stats, partials, d_series, d_params,
                       d_ext, L, B, S, G, cheb_deg, window_deg, logical_s,
                       mode, kernel, bw_mode, bw_value, cut_grid, unit_scale,
                       stream);
}

extern "C" int chimera_fused_kde_adjoint_f64(
    const double* m1, const double* m2, const double* dl, const double* invp,
    const double* grids, const double* ext, const long long* n_real,
    const double* dl_fill, const double* series, const double* params,
    const double* ct_den, const double* ct_stats, double* partials,
    double* d_series, double* d_params, double* d_ext, int L, int B, int S,
    int G, int cheb_deg, int window_deg, int logical_s, int mode, int kernel,
    int bw_mode, double bw_value, double cut_grid, int unit_scale,
    void* stream) {
  return launch<double>(m1, m2, dl, invp, grids, ext, n_real, dl_fill, series,
                        params, ct_den, ct_stats, partials, d_series,
                        d_params, d_ext, L, B, S, G, cheb_deg, window_deg,
                        logical_s, mode, kernel, bw_mode, bw_value, cut_grid,
                        unit_scale, stream);
}
