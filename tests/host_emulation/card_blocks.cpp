// The adjoint kernels' device functions instantiated as the kernels
// instantiate them, with the card's blocks (population.cuh: DeviceBlock of
// 8 or 4 warps, WarpBlock), for a syntax check by g++
// (tests/test_torch_host_card.py): the host emulations run them with a
// block of one thread only, whose members every block does not have.  Each
// mode and KDE kernel of K3 (fused_kde_adjoint.cu, K3c's logical rows a
// warp a row), K4 and K4b (kde1d.cu), K1e and K1d (fused_kde.cu, K1d's
// logical rows a warp a row, logical_kde_kernel, and K1c's), float32 and
// float64; K5's recurrence (kde3d.cuh: the skip radii, masks, chain
// keys and order, the samples' extent and band, the pruned and unpruned
// walks of every tier, and the fold) as kde3d.cu instantiates it; and
// K5b's phases (the grid and blocks' starts, the rows, a (sample, pixel)
// with its warp's union of ranges and shuffle tree) as
// kde3d_adjoint_kernel calls them.
#include "adjoint.cuh"
#include "kde3d.cuh"

namespace {

template <typename T, typename S, int KERNEL, int MODE, typename Block>
void k3_row(const Block& blk, const AdjointArgs<T>& a,
            const AdjointSmem<T>& sm, const Model<T, S>& model,
            const SampleAdjoint<T, S>& sample) {
  GradAcc<T, 32> g;
  adjoint_row<T, S, KERNEL, MODE>(blk, model, sample, a, 0, 0, sm, g);
}

template <typename T>
void card_blocks(const AdjointArgs<T>& a, const AdjointSmem<T>& sm,
                 const Model<T, T>& mt, const SampleAdjoint<T, T>& st,
                 const Model<T, double>& md,
                 const SampleAdjoint<T, double>& sd, T* o) {
  const DeviceBlock<T, 8> b8{nullptr};
  const DeviceBlock<T, 4> b4{nullptr};
  k3_row<T, T, 0, kAnalysisGrid>(b8, a, sm, mt, st);
  k3_row<T, T, 1, kAnalysisGrid>(b8, a, sm, mt, st);
  k3_row<T, T, 0, kEffectiveGrid>(b8, a, sm, mt, st);
  k3_row<T, T, 1, kEffectiveGrid>(b8, a, sm, mt, st);
  k3_row<T, double, 0, kExternalBounds>(b4, a, sm, md, sd);
  k3_row<T, double, 1, kExternalBounds>(b4, a, sm, md, sd);
  k3_row<T, double, 0, kStatsOnly>(b4, a, sm, md, sd);
  k3_row<T, double, 0, kStatsOnly>(WarpBlock<T>{}, a, sm, md, sd);
  const DeviceBlock<double> bd{nullptr};
  const double2* p = nullptr;
  double2* t = nullptr;
  kde_row_adjoint<double, 0>(bd, p, 1, p, 1, o, 1.0, o, o, o, o, t, t);
  kde_row_adjoint<double, 1>(bd, p, 1, p, 1, o, 1.0, o, o, o, o, t, t);
  // K4 (kde1d.cu) and K1e (fused_kde.cu, kContract)
  const DeviceBlock<T> bt{nullptr};
  using T2 = typename Pair<T>::type;
  const T2* q = nullptr;
  T2* u = nullptr;
  kde_row<T, 0>(bt, q, 1, o, 1, T(1), o, u);
  kde_row<T, 1>(bt, q, 1, o, 1, T(1), o, u);
  const FusedArgs<T> f{};
  fused_row<T, double, 0, kContract>(bt, md, f, 0, 0, u, u);
  fused_row<T, double, 1, kContract>(bt, md, f, 0, 0, u, u);
  fused_row<T, double, 0, kExternalBounds>(bt, md, f, 0, 0, u, u);
  fused_row<T, double, 1, kExternalBounds>(bt, md, f, 0, 0, u, u);
  const RowStats<T> rs =
      logical_row_stats<T, double, kExternalBounds>(md, f, 0, 0, 0, u);
  external_kde(WarpBlock<T>{}, rs, 1, T(1), T(1), q, u, o);
  logical_row_stats(md, f, 0, 0, 0, o);
}

}  // namespace

template void card_blocks<float>(const AdjointArgs<float>&,
                                 const AdjointSmem<float>&,
                                 const Model<float, float>&,
                                 const SampleAdjoint<float, float>&,
                                 const Model<float, double>&,
                                 const SampleAdjoint<float, double>&, float*);
template void card_blocks<double>(const AdjointArgs<double>&,
                                  const AdjointSmem<double>&,
                                  const Model<double, double>&,
                                  const SampleAdjoint<double, double>&,
                                  const Model<double, double>&,
                                  const SampleAdjoint<double, double>&,
                                  double*);

namespace {

template <typename T, int KMAX>
void k5_recurrence(const double* rec, kde3d::ET<T>* et, T* radii,
                   unsigned* masks, int* keys, T* part, T* out) {
  using namespace kde3d;
  const int rank = threadIdx.x;
  T* red = reinterpret_cast<T*>(masks);
  skip_radii(et, radii, 1, rank, kThreads);
  sample_extent(et, radii, 1, red, rank, kThreads);
  extent_fold(red, keys, 1, rank, kThreads);
  live_band(rec, red, 0.0, KMAX, 1, keys, rank, kThreads);
  live_masks<T>(rec, et, radii, 1, 0.0, KMAX, 1, keys, masks, rank, kThreads);
  chain_keys(masks, 1, 1, keys, rank, kThreads);
  chain_order(keys, 1, keys + kThreads, rank, kThreads);
  T acc[KMAX];
  const int c = recurrence_sweep<T, KMAX>(rec, et, masks, keys + kThreads, 1,
                                          0.0, 1, KMAX, out, acc, rank,
                                          kThreads);
  if (c >= 0) part[c] = acc[0];
  recurrence_fold<T, KMAX>(rec, part, 1, KMAX, out, rank, kThreads);
}

}  // namespace

template <typename T>
void k5_tiers(kde3d::ET<T>* et, T* p, unsigned* m, int* k) {
  k5_recurrence<T, 8>(nullptr, et, p, m, k, p, p);
  k5_recurrence<T, 16>(nullptr, et, p, m, k, p, p);
  k5_recurrence<T, 32>(nullptr, et, p, m, k, p, p);
}

template void k5_tiers<float>(float2*, float*, unsigned*, int*);
template void k5_tiers<double>(double2*, double*, unsigned*, int*);

namespace {

template <typename T>
void k5b_phases(const double* rec, const T* v, const unsigned char* mask,
                double* d, int* ints, T* o) {
  using namespace kde3d;
  const int rank = threadIdx.x;
  const int pc = adjoint_chunk(1, 1, sizeof(T));
  const AdjointLayout lay = adjoint_layout(1, pc, sizeof(T));
  adjoint_grid(rec, v, 1, 8, o, o, o, rank, kThreads);
  stage_rows(v, mask, 1, 1, o, ints, rank, kThreads);
  live_pixels(ints, 1, ints, ints, rank);
  pixel_centre(rec, v[0], v[0], d);
  const Whitening wh = whitening(rec);
  const SampleFactors f = sample_of(rec, v, v, v, v, 0, 1);
  double q1, q2, sky, acc[kSampleGrads] = {}, pl = 0.0, pn = 0.0, dt, dq1, dq2;
  T e, t, sg, su, sz;
  sample_pixel(wh, f, d, q1, q2, sky, e, t);
  int lo, hi, wlo, whi;
  kept_range(e, t, o, grid_start(rec, 0.0), 1.0, 1.0, 1, lo, hi);
  warp_range(lo, hi, wlo, whi);
  pixel_sums(e, t, o, o, o, o, 1, 8, lo, hi, wlo, whi, sg, su, sz);
  pixel_tail(wh.norm, f.wn, q1, q2, sky, sg, su, sz, acc, pl, pn, dt, dq1, dq2);
  d[int(lay.total % 2)] = warp_sum(dt + dq1 + dq2);
  adjoint_event(d, d, d, 1, rank, kThreads);
  adjoint_dead(d, d, d, 1, 1, rank, kThreads);
}

}  // namespace

template <typename T>
void k5b_kernel_phases(const double* rec, const T* v, const unsigned char* m,
                       double* d, int* i, T* o) {
  k5b_phases<T>(rec, v, m, d, i, o);
}

template void k5b_kernel_phases<float>(const double*, const float*,
                                       const unsigned char*, double*, int*,
                                       float*);
template void k5b_kernel_phases<double>(const double*, const double*,
                                        const unsigned char*, double*, int*,
                                        double*);
