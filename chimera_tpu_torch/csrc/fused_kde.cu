// Fused detector->source map + population weights (+ weighted KDE) for a
// batch of L hyper-parameter samples (lambda): one kernel template,
// fused_kde_kernel, that replaces chimera_tpu/ops/pallas/fused.py::
// _fused_kernel in its five modes.  Semantics: fused.py:71-219 (kernel)
// and fused.py:372-482 (_reference_impl); the plain PyTorch twin is
// chimera_tpu_torch/ops/cuda/fused.py::fused_weights_kde_plain.  The
// arithmetic is in kde.cuh, the model device functions in population.cuh.
// One thread block per (lambda, row), lambda fastest in blockIdx.x so the
// blocks that read one row's PE samples run together and find them in L2.
//
//   phase A  z_s = z_from_dgw(cosmo_l, dL_bs)     clamp + 64-term Clenshaw
//            w_s = p_m1m2(mass_l, m1/(1+z), m2/(1+z)) * inv_pe_prior
//            row stats: sum w, sum w^2, two-pass mean and variance of z,
//            Kish N_eff = (sum w)^2 / sum w^2, bandwidth h = bw(N_eff) std(z)
//   phase B  den[g] = sum_s w_s K((grid_g - z_s) / h) / (h S)    ('norms')
//                  or sum_s w_s K((grid_g - z_s) / h) / (h sum w) ('unit')
//
// Modes (FusedMode in kde.cuh) and where the port runs them:
//   K1a  kAnalysisGrid    the (E, G) analysis grids, 'norms': the spectral
//                         hot loop ('1d' and 'approximate', cut_grid=None);
//   K1b  kEffectiveGrid   grid_g = lo + (ub - lo)/(G - 1) g over
//                         [z_min - c sigma (floored at 1e-8), z_max + c sigma]
//                         from a block min/max of z, 'norms': '1d' and
//                         'approximate' with cut_grid;
//   K1c  kStatsOnly       the stats only, lo/ub as K1b: pass 1 of
//                         'marginalized' (both cut_grid settings);
//   K1d  kExternalBounds  grid over the given (lo, ub) of each (lambda,
//                         row), logical-row stats, 'unit': pass 2 of
//                         'marginalized' with cut_grid;
//   K1e  kContract        the (B, G) analysis grids, logical-row stats,
//                         'unit' with the dead-row guard, and the density
//                         contracted in the block against s1 f1 and s2 f2
//                         (fused.py:192-211): r (L, B, 2) and the stats, no
//                         (L, B, G) density in HBM: the one pass of
//                         'marginalized', cut_grid=None, on a layout
//                         without chunk rows.
// Logical rows (n_real given: the dark-siren per-pixel rectangle,
// data/pixelize.py::compact_samples_by_pixel) map only their n_real real
// slots and add the logical fillers analytically (kde.cuh, row_stats).
//
// What bounds it on an H100: arithmetic, not bytes.  Phase A -- two
// Clenshaw series and a handful of exp/log per sample, 16 * 1000 * 4096
// samples per batch at the spectral headline -- is most of K1a once its
// pair loop is pruned; the kernel reads the (B, S) PE rows
// (lambda-independent, L2-resident across the lambda batch) and writes only
// the (L, B, G) densities.  K1a's pair loop evaluates only the tiles of
// (grid point, sample) pairs that can be non-zero: at the headline 0.81 %
// of the L*B*G*S = 3.3e10 terms are, and its 32 x 32 tiles keep ~7 % of
// them; K1b's on the row's own effective grid, K1d's on its logical row's
// linear grid over the event's bounds and K1e's on its row's real samples
// likewise.  K1c does phase A only: on logical rows, ~S_l / npix real
// samples each (the dark flagship's pixel rows, ~128), a block of kThreads
// threads a row left most threads idle behind a block's fixed costs, so
// K1c there gives each row one warp (logical_stats_kernel, kde.cuh:
// logical_row_stats), whose lanes keep the partial sums of the block's
// ranks and fold them as the block would: the same bits, the series and
// mass scalars loaded once per kStatsRows rows, shuffles in place of five
// block barriers.  What bounds it then is phase A's instructions per sample
// and each row's filler z, folds and tail.  The Epanechnikov K1d takes the
// same layout (logical_kde_kernel: 1.61-1.62 ms against 1.95-1.97 for its
// pruned loop in the 4-warp block at the dark cut_grid path's 8 000 pixel
// rows, 38.5 % of them empty, ~208 real samples in the others; PERF.md
// §6).  Plain rows (the events of the dark cut_grid path, S real samples
// each) keep a block a row.
//
// What the design does about it: every intermediate stays on chip.  z and w
// of the block's row live in shared memory as interleaved (z, w) pairs, so
// one broadcast load feeds the grid points each thread holds in registers;
// the kernel-shape constant and the density scale are applied once per
// density, leaving sub, mul, fma, max and fma per term.  K1a with the
// Epanechnikov kernel (kde.cuh, contract_pruned): after phase A each warp
// bounds the z of 32-sample tiles of its row (the samples are sorted by
// distance, hence by z), then takes runs of 32 consecutive grid points, a
// point a lane, tests the tiles 32 at a time against the run's corners
// with the kernel's own arithmetic and walks the kept ones in order: the
// densities have the bits of the full loop (the argument is in kde.cuh).
// K1b (kEffectiveGrid) takes the same loop on its row's sorted linear grid
// lo + delta g, K1e (kContract) on its event's analysis grid over the
// row's real samples (the pixel rows keep the events' dL order), folding
// each density into r1 and r2 as it is stored, in the order of the full
// loop's fold (kde.cuh, fused_row), and K1d (kExternalBounds) on its
// logical row's linear grid over the given (lo, ub), a warp a row
// (kde.cuh, external_kde).  The Gaussian kernel, whose terms are never
// exactly zero, keeps the full loop (contract: two grid points a thread for
// grids up to 256 points, four above; contract_epilogue_tiles in
// kContract).  The raw row statistics
// of the TPU kernel are kept (a dead row gives NaN, which the caller's
// N_eff gate and nan_to_num remove).  The two Chebyshev series are summed
// in T in the spectral modes (a, b) and in double in the dark-siren modes
// (c, d, e), whose float32 likelihood needs it (population.cuh, Model).
// Later work: phase A.

#include "kde.cuh"

namespace {

template <typename T, typename S, int KERNEL, int MODE>
__global__ void __launch_bounds__(kThreads)
fused_kde_kernel(const FusedArgs<T> a) {
  using T2 = typename Pair<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  S* ser = reinterpret_cast<S*>(smem);  // Chebyshev series, summed in S
  T2* zw = reinterpret_cast<T2*>(smem + series_bytes<S>(a.cheb_deg,
                                                        a.window_deg));
  T* prm = reinterpret_cast<T*>(zw + a.S);  // this lambda's mass scalars
  T2* tiles = reinterpret_cast<T2*>(prm + kMassSlots);  // pruned loop's
  __shared__ T scratch[3][kWarps];

  const int l = blockIdx.x % a.L;
  const int b = blockIdx.x / a.L;
  const int Q = a.cheb_deg + 2 + a.window_deg;
  for (int i = threadIdx.x; i < Q; i += kThreads)
    ser[i] = S(a.series[(size_t)l * Q + i]);
  for (int i = threadIdx.x; i < kMassScalars; i += kThreads)
    prm[i] = a.params[(size_t)l * kMassScalars + i];
  __syncthreads();
  const Model<T, S> model(ser, prm, a.cheb_deg, a.window_deg);
  const DeviceBlock<T> blk{scratch};
  fused_row<T, S, KERNEL, MODE>(blk, model, a, l, b, zw, tiles);
}

// K1c on logical rows (n_real given): kStatsWarps warps a block (one), a
// warp a row, kStatsRows rows of one lambda a block in row order (warp w
// takes the block's rows w, w + kStatsWarps, ...), the lambda's series and
// mass scalars loaded once a block, each warp's z of its row in shared
// memory; the sums replay those of the block-a-row kernel (kde.cuh,
// logical_row_stats).
template <typename T>
__global__ void __launch_bounds__(32 * kStatsWarps)
logical_stats_kernel(const FusedArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* ser = reinterpret_cast<double*>(smem);
  T* prm = reinterpret_cast<T*>(smem + series_bytes<double>(a.cheb_deg,
                                                            a.window_deg));
  T* z = prm + kMassScalars;  // (kStatsWarps, S): each warp's row

  const int l = blockIdx.x % a.L;
  const int blk = blockIdx.x / a.L;
  const int Q = a.cheb_deg + 2 + a.window_deg;
  for (int i = threadIdx.x; i < Q; i += 32 * kStatsWarps)
    ser[i] = a.series[(size_t)l * Q + i];
  for (int i = threadIdx.x; i < kMassScalars; i += 32 * kStatsWarps)
    prm[i] = a.params[(size_t)l * kMassScalars + i];
  __syncthreads();
  const Model<T, double> model(ser, prm, a.cheb_deg, a.window_deg);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int end = (blk + 1) * kStatsRows < a.B ? (blk + 1) * kStatsRows : a.B;
  for (int b = blk * kStatsRows + warp; b < end; b += kStatsWarps)
    logical_row_stats(model, a, l, b, lane, z + (size_t)warp * a.S);
}

// K1d on logical rows (n_real given), Epanechnikov: logical_stats_kernel's
// layout, a warp a row, kStatsRows rows of one lambda a block, the series
// and mass scalars loaded once a block; each warp's (z, w) pairs of its row
// and their tiles' bounds in shared memory.  The stats replay the
// block-a-row kernel's sums (logical_row_stats), the densities take the
// pruned pair loop on a one-warp block (external_kde): every output has the
// bits of fused_kde_kernel's, and an empty row costs a warp's stats and
// stores, not a block's barriers.
template <typename T>
__global__ void __launch_bounds__(32 * kStatsWarps)
logical_kde_kernel(const FusedArgs<T> a) {
  using T2 = typename Pair<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  double* ser = reinterpret_cast<double*>(smem);
  T2* zw = reinterpret_cast<T2*>(smem + series_bytes<double>(a.cheb_deg,
                                                             a.window_deg));
  const int n_tiles = (a.S + kTileS - 1) / kTileS;
  T2* tiles = zw + (size_t)kStatsWarps * a.S;       // (kStatsWarps, n_tiles)
  T* prm = reinterpret_cast<T*>(tiles + (size_t)kStatsWarps * n_tiles);

  const int l = blockIdx.x % a.L;
  const int blk = blockIdx.x / a.L;
  const int Q = a.cheb_deg + 2 + a.window_deg;
  for (int i = threadIdx.x; i < Q; i += 32 * kStatsWarps)
    ser[i] = a.series[(size_t)l * Q + i];
  for (int i = threadIdx.x; i < kMassScalars; i += 32 * kStatsWarps)
    prm[i] = a.params[(size_t)l * kMassScalars + i];
  __syncthreads();
  const Model<T, double> model(ser, prm, a.cheb_deg, a.window_deg);
  const WarpBlock<T> wblk{};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T2* row_zw = zw + (size_t)warp * a.S;
  T2* row_tiles = tiles + (size_t)warp * n_tiles;
  const int end = (blk + 1) * kStatsRows < a.B ? (blk + 1) * kStatsRows : a.B;
  for (int b = blk * kStatsRows + warp; b < end; b += kStatsWarps) {
    const RowStats<T> st = logical_row_stats<T, double, kExternalBounds>(
        model, a, l, b, lane, row_zw);
    const T inv_h = T(1) / st.h;
    const T scale = kernel_norm<T, 0>() * inv_h
                    / (a.unit_scale ? st.sum_w : st.sl);
    external_kde(wblk, st, a.G, inv_h, scale, row_zw, row_tiles,
                 a.den + ((size_t)l * a.B + b) * a.G);
    wblk.sync();  // every lane has read the row's pairs before the next's
  }
}

template <typename T>
int launch_logical_kde(const FusedArgs<T>& a, cudaStream_t stream) {
  const size_t smem = series_bytes<double>(a.cheb_deg, a.window_deg)
                      + (size_t)kStatsWarps * (a.S + (a.S + kTileS - 1) / kTileS)
                            * sizeof(typename Pair<T>::type)
                      + kMassScalars * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      logical_kde_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((a.B + kStatsRows - 1) / kStatsRows);
  logical_kde_kernel<T><<<(unsigned)a.L * blocks, 32 * kStatsWarps, smem,
                          stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_logical_stats(const FusedArgs<T>& a, cudaStream_t stream) {
  const size_t smem = series_bytes<double>(a.cheb_deg, a.window_deg)
                      + (kMassScalars + (size_t)kStatsWarps * a.S) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      logical_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((a.B + kStatsRows - 1) / kStatsRows);
  logical_stats_kernel<T><<<(unsigned)a.L * blocks, 32 * kStatsWarps, smem,
                            stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, typename S, int KERNEL, int MODE>
int launch_mode(const FusedArgs<T>& a, cudaStream_t stream) {
  const bool pruned = MODE != kStatsOnly && KERNEL == 0;
  const size_t smem = series_bytes<S>(a.cheb_deg, a.window_deg)
                      + (size_t)a.S * sizeof(typename Pair<T>::type)
                      + kMassSlots * sizeof(T)
                      + (pruned ? (size_t)(a.S + kTileS - 1) / kTileS
                                      * sizeof(typename Pair<T>::type)
                                : 0);
  auto kernel = fused_kde_kernel<T, S, KERNEL, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)a.L * (unsigned)a.B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int KERNEL>
int launch_kernel(const FusedArgs<T>& a, int mode, cudaStream_t stream) {
  switch (mode) {
    case kAnalysisGrid:
      return launch_mode<T, T, KERNEL, kAnalysisGrid>(a, stream);
    case kEffectiveGrid:
      return launch_mode<T, T, KERNEL, kEffectiveGrid>(a, stream);
    case kExternalBounds:
      return launch_mode<T, double, KERNEL, kExternalBounds>(a, stream);
    case kContract:
      return launch_mode<T, double, KERNEL, kContract>(a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const T* m1, const T* m2, const T* dl, const T* invp,
           const T* grids, const T* ext, const long long* n_real,
           const T* dl_fill, const double* series, const T* params,
           const T* s1, const T* s2, const T* f1, const T* f2, T* den,
           T* stats, int L, int B, int S, int G, int cheb_deg, int window_deg,
           int logical_s, int mode, int kernel, int bw_mode, double bw_value,
           double cut_grid, int unit_scale, int npix, void* stream) {
  const bool dense = mode != kStatsOnly;
  const bool grid_given = mode == kAnalysisGrid || mode == kContract;
  if (L <= 0 || B <= 0 || S <= 0 || (dense && G <= 0)
      || (dense && !grid_given && G < 2)
      || (n_real != nullptr && logical_s <= 0)
      || (mode == kContract && (npix <= 0 || B % npix != 0 || s1 == nullptr
                                || s2 == nullptr || f1 == nullptr
                                || f2 == nullptr)))
    return (int)cudaErrorInvalidValue;
  const FusedArgs<T> a{m1, m2, dl, invp, grids, ext, n_real, dl_fill, series,
                       params, s1, s2, f1, f2, den, stats, L, B, S, G,
                       cheb_deg, window_deg, logical_s, bw_mode, unit_scale,
                       npix, (T)bw_value, (T)cut_grid};
  auto s = static_cast<cudaStream_t>(stream);
  if (!dense)
    return n_real != nullptr ? launch_logical_stats<T>(a, s)
                             : launch_mode<T, double, 0, kStatsOnly>(a, s);
  if (mode == kExternalBounds && kernel == 0 && n_real != nullptr)
    return launch_logical_kde<T>(a, s);
  if (kernel == 0) return launch_kernel<T, 0>(a, mode, s);
  return launch_kernel<T, 1>(a, mode, s);
}

}  // namespace

// C interface (loaded with ctypes by chimera_tpu_torch/ops/cuda/fused.py).
// grids, ext, n_real, dl_fill and s1, s2, f1, f2 may be null where the mode
// does not read them (den too in the stats-only mode); npix, the rows per
// event of f1 and f2, is read in the contract mode only.  Returns the CUDA
// error code of the launch (0 = cudaSuccess).
extern "C" int chimera_fused_kde_f32(
    const float* m1, const float* m2, const float* dl, const float* invp,
    const float* grids, const float* ext, const long long* n_real,
    const float* dl_fill, const double* series, const float* params,
    const float* s1, const float* s2, const float* f1, const float* f2,
    float* den, float* stats, int L, int B, int S, int G, int cheb_deg,
    int window_deg, int logical_s, int mode, int kernel, int bw_mode,
    double bw_value, double cut_grid, int unit_scale, int npix,
    void* stream) {
  return launch<float>(m1, m2, dl, invp, grids, ext, n_real, dl_fill, series,
                       params, s1, s2, f1, f2, den, stats, L, B, S, G,
                       cheb_deg, window_deg, logical_s, mode, kernel, bw_mode,
                       bw_value, cut_grid, unit_scale, npix, stream);
}

extern "C" int chimera_fused_kde_f64(
    const double* m1, const double* m2, const double* dl, const double* invp,
    const double* grids, const double* ext, const long long* n_real,
    const double* dl_fill, const double* series, const double* params,
    const double* s1, const double* s2, const double* f1, const double* f2,
    double* den, double* stats, int L, int B, int S, int G, int cheb_deg,
    int window_deg, int logical_s, int mode, int kernel, int bw_mode,
    double bw_value, double cut_grid, int unit_scale, int npix,
    void* stream) {
  return launch<double>(m1, m2, dl, invp, grids, ext, n_real, dl_fill,
                        series, params, s1, s2, f1, f2, den, stats, L, B, S,
                        G, cheb_deg, window_deg, logical_s, mode, kernel,
                        bw_mode, bw_value, cut_grid, unit_scale, npix, stream);
}
