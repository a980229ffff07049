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
//                         logical rows (stats_rows_kernel) or plain ones:
//                         pass 1 of 'marginalized' (both cut_grid settings);
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
//
// Three launches, one K3 (the wrapper counts them as one): the prologue
// writes each lambda's record (the series in the summation type, the mass
// model's derived fields and their Jacobian in the 12 scalars, adjoint.cuh)
// into the scratch after the partials; the main kernel runs one thread
// block per (lambda, row), lambda fastest, as K1, or in K3c on logical rows
// blocks of one warp, a warp a row, kWarpRows rows of one lambda a block;
// each block sums its gradients into `partials` (L, blocks, P) and
// a last kernel sums those over the blocks in order, in double: no atomics
// anywhere, so equal inputs give equal bits and an HMC chain repeats under a
// fixed generator.  As in the forward, the Chebyshev series are summed in T
// in the spectral modes (a, b) and in double in the dark-siren modes (c, d):
// the backward differentiates the z the forward computed.
//
// What bounds it on an H100: arithmetic.  Phase B evaluates L*B*G*n pair
// terms, ~11 FP32 operations each against K1a's 7 (13 on a linear grid,
// whose bounds need one more sum); phases A and D add per sample the two
// Clenshaw recurrences (value, then value with derivative), the mass
// model's forward and its reverse sweep, and the projections of the two
// series' cotangents (a recurrence and an FMA per coefficient), all of
// K3c's work.  The kernel reads the (B, S) PE rows and the (L, B, G)
// cotangents once and writes (L, blocks, P) partials.
//
// What the design does about it: z, w, dz and dw of the block's row stay in
// shared memory, the grid loop feeds kSamplesPerThread samples per
// shared-memory load and forms the Epanechnikov weight in one saturating
// FMA, the kernel-shape constants are applied once per sample, a logical
// row maps only its real samples (its fillers enter analytically, as in
// K1); the mass model's derivative is a scalar reverse sweep into 14
// registers with the per-lambda reciprocals of the prologue, the
// projections sum each thread's points in registers and leave 2
// coefficients per series in each lane, so a thread keeps 20 accumulators,
// no local array, and __launch_bounds__ caps it at 128 registers.  K3 and
// K3b take blocks of 8 warps (their rows of S samples fill them; 16 warps an
// SM), K3d and K3c's event rows blocks of 4, and K3c's logical rows (~S /
// npix real samples, unequal) blocks of one warp, so that a warp with a
// large pixel holds back no other.  K3d's logical rows hold ~200 real
// samples each at the dark flagship (those with any): a warp a row ran
// them slower on an H100 (PERF.md).  The Epanechnikov phase B of K3b and
// K3d skips the tiles of kGridTile grid points whose corners prove every
// term of a warp's 32 samples of a slot exactly zero (the dL-sorted
// samples of a slot lie in a sliver of the row, their support ~ +-h of
// it; K3d's grid spans the whole event's range, a pixel's samples a part
// of it): K3b by a ballot per tile and slot, K3d by each slot's run of
// tiles, whose two ends each lane finds by the corner test from either
// end of the grid (slot_pair_sums: faster than the ballot for K3d on an
// H100); K3d, either kernel, also skips the slots of a round that no lane
// of the warp holds a sample for.  Their tiles' bounds are ceil(G /
// kGridTile) pairs more of shared memory.  Every output keeps the bits of
// the full loop.  Later work: the same pruning for K3 on analysis grids.

#include "adjoint.cuh"

namespace {

// Warps a block of fused_kde_adjoint_kernel: 8 on the events' rows of S
// samples that K3 and K3b take, 4 (kThreads) on the rows of ~S / npix real
// samples of K3d and on K3c's event rows.  Registers: 65 536 / (threads x
// blocks an SM) = 128 a thread at most either way.
__host__ __device__ constexpr int row_warps(int mode) {
  return mode == kAnalysisGrid || mode == kEffectiveGrid ? 8 : kWarps;
}

template <typename T, typename S, int KERNEL, int MODE>
__global__ void __launch_bounds__(32 * row_warps(MODE), 16 / row_warps(MODE))
fused_kde_adjoint_kernel(const AdjointArgs<T> a,
                         const unsigned char* __restrict__ records) {
  using T2 = typename Pair<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t rb = record_bytes<T, S>(a.cheb_deg, a.window_deg);
  AdjointSmem<T> sm;
  sm.z = reinterpret_cast<T*>(smem + rb);
  sm.w = sm.z + a.S;
  sm.dz = sm.w + a.S;
  sm.dw = sm.dz + a.S;
#if CHIMERA_MASS_KIND == 4
  // phase D's stash: the row's own slots, then two rows of the knots' points
  sm.gc = reinterpret_cast<T2*>(sm.z + kStashRows * a.S);
#else
  sm.gc = reinterpret_cast<T2*>(sm.dw + a.S);  // G (grid point, c1) pairs
#endif
  sm.st = sm.z;  // phase D's stash: the row's own slots
  sm.cap = a.S;
  sm.gt = sm.gc + a.G;  // the pruned phase B's tile bounds
  constexpr int W = row_warps(MODE);
  __shared__ T scratch[4][W];
  __shared__ T red[W + 1][kRedCols];

  const int l = blockIdx.x % a.L;
  const int b = blockIdx.x / a.L;
  copy_record(records + (size_t)l * rb, smem, rb);
  __syncthreads();
  const Record<T, S> rec(smem, a.cheb_deg, a.window_deg);
  const Model<T, S> model(rec.series, rec.fields, a.cheb_deg, a.window_deg,
                          rec.fields + kMassScalars);
  const SampleAdjoint<T, S> sample(model, rec.consts);
  GradAcc<T, 32> g;
  g.zero();
  adjoint_row<T, S, KERNEL, MODE>(DeviceBlock<T, W>{scratch}, model, sample,
                                  a, l, b, sm, g);
  const int P = a.cheb_deg + 2 + a.window_deg + kMassScalars;
  store_partials<W>(g, rec.jac, a.cheb_deg, a.window_deg,
                    a.partials + ((size_t)l * a.B + b) * P, red);
}

// K3c on logical rows (a pixel's samples, ~S_l / npix of them): a warp a
// row (WarpBlock): a block is one warp, which takes the rows
// blk kWarpRows + r, r < kWarpRows, in order, so that the record, the
// sums and the partials row are paid once per kWarpRows rows and a warp
// with a pixel of many samples holds back no other warp.
template <typename T>
__global__ void __launch_bounds__(32, 16)
stats_rows_kernel(const AdjointArgs<T> a,
                  const unsigned char* __restrict__ records, int n_blocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t rb = record_bytes<T, double>(a.cheb_deg, a.window_deg);
  AdjointSmem<T> sm;
  sm.z = reinterpret_cast<T*>(smem + rb);
  sm.w = sm.z + a.S;
  sm.dz = sm.dw = nullptr;  // no pair loop
  sm.gc = nullptr;
  sm.st = sm.w + a.S;
  sm.cap = kStash;
  __shared__ T red[2][kRedCols];

  const int l = blockIdx.x % a.L;
  const int blk = blockIdx.x / a.L;
  copy_record(records + (size_t)l * rb, smem, rb);
  __syncthreads();
  const Record<T, double> rec(smem, a.cheb_deg, a.window_deg);
  const Model<T, double> model(rec.series, rec.fields, a.cheb_deg,
                               a.window_deg, rec.fields + kMassScalars);
  const SampleAdjoint<T, double> sample(model, rec.consts);
  GradAcc<T, 32> g;
  g.zero();
  for (int b = blk * kWarpRows; b < (blk + 1) * kWarpRows && b < a.B; ++b)
    adjoint_row<T, double, 0, kStatsOnly>(WarpBlock<T>{}, model, sample, a, l,
                                          b, sm, g);
  const int P = a.cheb_deg + 2 + a.window_deg + kMassScalars;
  store_partials<1>(g, rec.jac, a.cheb_deg, a.window_deg,
                    a.partials + ((size_t)l * n_blocks + blk) * P, red);
}

// The prologue, the main kernel and the sum over blocks, on the stream.
template <typename T, typename S, int KERNEL, int MODE>
int launch_mode(const AdjointArgs<T>& a, double* d_series, T* d_params,
                cudaStream_t stream) {
  const int P = a.cheb_deg + 2 + a.window_deg + kMassScalars;
  unsigned char* records = reinterpret_cast<unsigned char*>(
      a.partials + records_offset((size_t)a.L * a.B * P));
  cudaError_t err = write_records<T, S>(a.series, a.params, a.L, a.cheb_deg,
                                        a.window_deg, records, stream);
  if (err != cudaSuccess) return (int)err;
  const bool by_warp = MODE == kStatsOnly && warp_rows(a);
  const int n_blocks = by_warp ? (a.B + kWarpRows - 1) / kWarpRows : a.B;
  const size_t rb = record_bytes<T, S>(a.cheb_deg, a.window_deg);
  if (by_warp) {
    const size_t smem = warp_rows_smem<T, S>(a.cheb_deg, a.window_deg, a.S);
    auto kernel = stats_rows_kernel<T>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) {
      kernel<<<(unsigned)a.L * (unsigned)n_blocks, 32, smem, stream>>>(
          a, records, n_blocks);
      err = cudaGetLastError();
    }
  } else {
    const size_t smem = rb + ((size_t)kStashRows * a.S
                              + (MODE == kStatsOnly ? 0 : 2 * (size_t)a.G)
                              + 2 * (size_t)grid_tiles(MODE, KERNEL, a.G))
                                 * sizeof(T);
    auto kernel = fused_kde_adjoint_kernel<T, S, KERNEL, MODE>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) {
      kernel<<<(unsigned)a.L * (unsigned)a.B, 32 * row_warps(MODE), smem,
               stream>>>(
          a, records);
      err = cudaGetLastError();
    }
  }
  if (err != cudaSuccess) return (int)err;
  reduce_events_kernel<T><<<a.L, 160, 0, stream>>>(
      a.partials, d_series, d_params, n_blocks, a.cheb_deg + 2 + a.window_deg);
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
  // a window series exactly where the model has one
  if (L <= 0 || B <= 0 || S <= 0 || cheb_deg < 1
      || (window_deg < 1) == kWindowCdf
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
// does not use them.  `partials` is scratch of records_offset(L B P)
// doubles and L prologue records (record_bytes each, adjoint.cuh) more.
// Returns the CUDA error code of the launches (0 = cudaSuccess).
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
