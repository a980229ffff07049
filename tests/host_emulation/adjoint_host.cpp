// Serial host emulation of the adjoint kernel K3
// (chimera_tpu_torch/csrc/fused_kde_adjoint.cu) in every mode, from the same
// device functions (adjoint.cuh's write_record and adjoint_row,
// population.cuh): per lambda the prologue's record, per block of the
// kernel (a row, or kWarpRows logical rows of K3c in row order) the
// kernel's phases with a block of one thread,
// whose block sums are the identity and whose warp of one lane keeps every
// projected coefficient, and the blocks' gradients summed in block order in
// double.  Same C interface as the kernel's (its `partials` scratch is not
// used), without the stream.  Also the host tests' checks of three pieces:
// the reverse sweep of the mass model against the dual one (host_mass_vjp),
// the warp's projections emulated lane by lane (host_warp_project) and the
// kernels' layout of their scratch (host_adjoint_scratch); K3b with phase
// B's full loop (its pruned loop's oracle), phase B's pair sums alone on
// given samples and grid (host_slot_pair_sums), and a tally of the tiles
// the pruned loop skips.  Built by the host-emulation tests (tests/host_harness.py).
#include <algorithm>
#include <vector>

#include "host_block.h"
#include "adjoint.cuh"

namespace {

// the tiles that the pruned phase B tested and skipped (host_tile_tally)
long long g_tally[2] = {0, 0};
// K3b's and K3d's oracle: phase B's full loop
// (host_fused_kde_adjoint_unpruned)
bool g_unpruned = false;

// acc[k] += a T_k(t) for k < n, serially: the adjoint of a Chebyshev sum in
// its coefficients (ops/chebyshev.py, _ChebEval.backward), the oracle of
// the warp's projections.
void cheb_project(double* acc, int n, double t, double a) {
  acc[0] += a;
  if (n < 2) return;
  acc[1] += a * t;
  double t_km1 = 1.0, t_k = t;
  for (int k = 2; k < n; ++k) {
    const double t_kp = 2.0 * t * t_k - t_km1;
    acc[k] += a * t_kp;
    t_km1 = t_k;
    t_k = t_kp;
  }
}

// A record's bytes in doubles (16-byte aligned storage).
template <typename T, typename S>
std::vector<double> record_storage(int cd, int wd) {
  return std::vector<double>(record_bytes<T, S>(cd, wd) / sizeof(double) + 2);
}

template <typename T, typename S, int KERNEL, int MODE, bool PRUNE = true>
void run_mode(const AdjointArgs<T>& a, double* d_series, T* d_params) {
  const int cd = a.cheb_deg, wd = a.window_deg;
  const int Q = cd + 2 + wd, P = Q + kMassScalars;
  std::vector<double> store = record_storage<T, S>(cd, wd);
  unsigned char* rec_bytes = reinterpret_cast<unsigned char*>(store.data());
  // the kernels' layouts: z, w, dz, dw of a row in one array (its stash),
  // or z, w and a stash of kStash samples' points
  std::vector<T> zwd(kStashRows * a.S), z(a.S), w(a.S),
      stash(kStashRows * kStash);
  std::vector<typename Pair<T>::type> gc(std::max(a.G, 1)),
      gt((std::max(a.G, 1) + kGridTile - 1) / kGridTile);
  const bool by_warp = MODE == kStatsOnly && warp_rows(a);
  const AdjointSmem<T> sm =
      by_warp ? AdjointSmem<T>{z.data(), w.data(), nullptr, nullptr,
                               gc.data(), stash.data(), kStash, nullptr}
              : AdjointSmem<T>{zwd.data(), zwd.data() + a.S,
                               zwd.data() + 2 * a.S, zwd.data() + 3 * a.S,
                               gc.data(), zwd.data(), a.S, gt.data()};
  const int n_blocks = by_warp ? (a.B + kWarpRows - 1) / kWarpRows : a.B;
  for (int l = 0; l < a.L; ++l) {
    write_record<T, S>(a.series + (size_t)l * Q,
                       a.params + (size_t)l * kMassScalars, cd, wd, rec_bytes,
                       0, 1);
    const Record<T, S> rec(rec_bytes, cd, wd);
    const Model<T, S> model(rec.series, rec.fields, cd, wd,
                            rec.fields + kMassScalars);
    const SampleAdjoint<T, S> sample(model, rec.consts);
    std::vector<double> total(P, 0.0);
    for (int blk = 0; blk < n_blocks; ++blk) {
      GradAcc<T, 1> g;
      g.zero();
      if (by_warp) {
        for (int b = blk * kWarpRows; b < (blk + 1) * kWarpRows && b < a.B;
             ++b)
          adjoint_row<T, S, KERNEL, MODE, PRUNE>(HostBlock<T>{g_tally}, model,
                                                 sample, a, l, b, sm, g);
      } else {
        adjoint_row<T, S, KERNEL, MODE, PRUNE>(HostBlock<T>{g_tally}, model,
                                               sample, a, l, blk, sm, g);
      }
      for (int i = 0; i < P; ++i) total[i] += double(column(g, rec.jac, i, cd, wd));
    }
    for (int i = 0; i < Q; ++i) d_series[(size_t)l * Q + i] = total[i];
    for (int i = 0; i < kMassScalars; ++i)
      d_params[(size_t)l * kMassScalars + i] = T(total[Q + i]);
  }
}

template <typename T, int KERNEL>
void run_kernel(const AdjointArgs<T>& a, int mode, double* ds, T* dp) {
  if (mode == kAnalysisGrid) run_mode<T, T, KERNEL, kAnalysisGrid>(a, ds, dp);
  if (mode == kEffectiveGrid && g_unpruned)
    run_mode<T, T, KERNEL, kEffectiveGrid, false>(a, ds, dp);
  else if (mode == kEffectiveGrid)
    run_mode<T, T, KERNEL, kEffectiveGrid>(a, ds, dp);
  if (mode == kExternalBounds && g_unpruned)
    run_mode<T, double, KERNEL, kExternalBounds, false>(a, ds, dp);
  else if (mode == kExternalBounds)
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

// K3 with phase B's full loop (K3b's and K3d's oracle), the same interface
#define UNPRUNED(T, NAME)                                                     \
  extern "C" void NAME(                                                       \
      const T* m1, const T* m2, const T* dl, const T* invp, const T* grids,   \
      const T* ext, const long long* n_real, const T* dl_fill,                \
      const double* series, const T* params, const T* ct_den,                 \
      const T* ct_stats, double* partials, double* d_series, T* d_params,     \
      T* d_ext, int L, int B, int S, int G, int cd, int wd, int logical_s,    \
      int mode, int kernel, int bw_mode, double bw_value, double cut_grid,    \
      int unit_scale) {                                                       \
    (void)partials;                                                           \
    g_unpruned = true;                                                        \
    run<T>(m1, m2, dl, invp, grids, ext, n_real, dl_fill, series, params,     \
           ct_den, ct_stats, d_series, d_params, d_ext, L, B, S, G, cd, wd,   \
           logical_s, mode, kernel, bw_mode, bw_value, cut_grid, unit_scale); \
    g_unpruned = false;                                                       \
  }
UNPRUNED(float, host_fused_kde_adjoint_unpruned_f32)
UNPRUNED(double, host_fused_kde_adjoint_unpruned_f64)

// Phase B's pair sums (slot_pair_sums, a linear grid: frac = i / (G - 1))
// of n samples z against the G (grid point, c1) pairs at 1/h, a block of
// one thread: the full loop (walk 0), K3b's ballot walk (1) or K3d's run
// walk (2); out (n, 4) a0-a3 of each sample.
template <typename T>
void run_slot_pair_sums(const T* z, int n, const T* grid, const T* c1, int G,
                        T inv_h, int walk, T* out) {
  std::vector<typename Pair<T>::type> gc(G), gt((G + kGridTile - 1) / kGridTile);
  for (int i = 0; i < G; ++i) {
    gc[i].x = grid[i];
    gc[i].y = c1[i];
  }
  const HostBlock<T> blk{g_tally};
  tile_bounds<T, kGridTile, false>(blk, gc.data(), G, gt.data());
  const T inv_gm1 = T(1) / T(G - 1);
  const bool prune = inv_h > T(0);
  for (int s0 = 0; s0 < n; s0 += kSamplesPerThread) {
    T zv[kSamplesPerThread], a[4][kSamplesPerThread];
    for (int j = 0; j < kSamplesPerThread; ++j) {
      zv[j] = z[s0 + j < n ? s0 + j : n - 1];
      a[0][j] = a[1][j] = a[2][j] = a[3][j] = T(0);
    }
    if (walk == 1)
      slot_pair_sums<T, 0, true, kBallotWalk>(blk, zv, s0, n, gc.data(),
                                              gt.data(), G, inv_h, prune,
                                              inv_gm1, a[0], a[1], a[2], a[3]);
    else if (walk == 2)
      slot_pair_sums<T, 0, true, kRunWalk>(blk, zv, s0, n, gc.data(),
                                           gt.data(), G, inv_h, prune,
                                           inv_gm1, a[0], a[1], a[2], a[3]);
    else
      slot_pair_sums<T, 0, true, kFullLoop>(blk, zv, s0, n, gc.data(),
                                            gt.data(), G, inv_h, false,
                                            inv_gm1, a[0], a[1], a[2], a[3]);
    for (int j = 0; j < kSamplesPerThread && s0 + j < n; ++j)
      for (int k = 0; k < 4; ++k) out[(size_t)(s0 + j) * 4 + k] = a[k][j];
  }
}

extern "C" void host_slot_pair_sums_f32(const float* z, int n,
                                        const float* grid, const float* c1,
                                        int G, float inv_h, int walk,
                                        float* out) {
  run_slot_pair_sums<float>(z, n, grid, c1, G, inv_h, walk, out);
}

extern "C" void host_slot_pair_sums_f64(const double* z, int n,
                                        const double* grid, const double* c1,
                                        int G, double inv_h, int walk,
                                        double* out) {
  run_slot_pair_sums<double>(z, n, grid, c1, G, inv_h, walk, out);
}

// the tiles that the pruned phase B tested and skipped since the last
// call: out[0] tested, out[1] skipped
extern "C" void host_tile_tally(long long* out) {
  out[0] = g_tally[0];
  out[1] = g_tally[1];
  g_tally[0] = g_tally[1] = 0;
}

// The mass model's reverse sweep (SampleAdjoint::mass_vjp, through the
// prologue's Jacobian) against the dual one (joint_dual), float64, at n
// points: scalars (n, 12) the mass scalars, m1det, m2det, z and gw (n,), the
// window series (wd) in double.  out_rev and out_dual (n, 14): the
// cotangents of the 12 scalars, of z and of the window series' value;
// t_win (n, 2): the window's t of each (0 outside the window).
extern "C" void host_mass_vjp(const double* scalars, const double* m1det,
                              const double* m2det, const double* z,
                              const double* gw, const double* window, int wd,
                              int n, double* out_rev, double* out_dual,
                              double* t_win) {
  const int cd = 1;
  std::vector<double> ser(cd + 2 + wd);
  ser[0] = 0.0;
  ser[1] = 1.0;
  ser[2] = 2.0;
  for (int k = 0; k < wd; ++k) ser[cd + 2 + k] = window[k];
  std::vector<double> store = record_storage<double, double>(cd, wd);
  unsigned char* rec_bytes = reinterpret_cast<unsigned char*>(store.data());
  for (int i = 0; i < n; ++i) {
    const double* s = scalars + (size_t)i * kMassScalars;
    write_record<double, double>(ser.data(), s, cd, wd, rec_bytes, 0, 1);
    const Record<double, double> rec(rec_bytes, cd, wd);
    const Model<double, double> model(rec.series, rec.fields, cd, wd,
                                      rec.fields + kMassScalars);
    const SampleAdjoint<double, double> sample(model, rec.consts);
    GradAcc<double, 1> g;
    g.zero();
    double tw, b;
#if CHIMERA_MASS_KIND == 4
    // the knots' point projected as the kernels project it (one sample)
    double kx, kg;
    const double gz = sample.mass_vjp(model.mass, m1det[i], m2det[i], z[i],
                                      gw[i], g.mass, tw, b, kx, kg);
    if (kg != 0.0) knot_accumulate(g.knot, model.mass.num_knots, kx, kg);
#else
    const double gz = sample.mass_vjp(model.mass, m1det[i], m2det[i], z[i],
                                      gw[i], g.mass, tw, b);
#endif
    double* r = out_rev + (size_t)i * kDirs;
    for (int k = 0; k < kMassScalars; ++k)
      r[k] = column(g, rec.jac, cd + 2 + wd + k, cd, wd);
    r[kZDir] = gz;
    r[kCdfDir] = b;
    // the dual: the window's value and slope where the reverse sweep took them
    MassModel<Dual<double, kDirs>> mm;
    seed_mass(mm, s);
#if CHIMERA_MASS_KIND == 4
    // the coefficients, direction 9 + j for coefficient j
    Dual<double, kDirs> coefs[kMaxKnots];
    for (int j = 0; j < kMaxKnots; ++j) coefs[j] = seed<double, kDirs>(s[9 + j], 9 + j);
    mm.coef = coefs;
    mm.num_knots = (int)s[8];
#endif
    double val = 0.0, slope = 0.0;
    if (b != 0.0 || tw != 0.0) val = clenshaw_d(ser.data() + cd + 2, wd, tw, slope);
    const Dual<double, kDirs> p = joint_dual(mm, m1det[i], m2det[i], z[i], val,
                                             slope);
    double* d = out_dual + (size_t)i * kDirs;
    for (int k = 0; k < kDirs; ++k) d[k] = gw[i] * p.d[k];
    t_win[2 * i] = tw;
    t_win[2 * i + 1] = p.v;
  }
}

// The projections sum_s a_s T_k(t_s), k < deg, of n points with the warp of
// the kernels emulated lane by lane: point s on lane s % 32, each lane's
// 64 coefficients in registers (cheb_accumulate), then the stages of the
// reduce-scatter of each chunk of 32 as a fixed-order loop over the lanes
// (rs_keep, rs_send); lane j keeps k = j and j + 32.  Against cheb_project
// in a serial loop (serial).
extern "C" void host_warp_project(const double* t, const double* a, int n,
                                  int deg, double* warp, double* serial) {
  for (int k = 0; k < deg; ++k) serial[k] = 0.0;
  for (int s = 0; s < n; ++s) cheb_project(serial, deg, t[s], a[s]);
  double acc[32][2][kChunk], sent[32][kChunk];
  for (int j = 0; j < 32; ++j) {
    for (int i = 0; i < kChunk; ++i) acc[j][0][i] = acc[j][1][i] = 0.0;
    for (int s = j; s < n; s += 32) cheb_accumulate(acc[j], deg, t[s], a[s]);
  }
  for (int c = 0; c < 2; ++c) {
    double v[32][kChunk];
    for (int j = 0; j < 32; ++j)
      for (int i = 0; i < kChunk; ++i) v[j][i] = acc[j][c][i];
    for (int off = 16; off > 0; off /= 2) {
      for (int j = 0; j < 32; ++j)
        for (int i = 0; i < off; ++i)
          sent[j][i] = off == 16 ? rs_send<16>(v[j], i, j)
                     : off == 8 ? rs_send<8>(v[j], i, j)
                     : off == 4 ? rs_send<4>(v[j], i, j)
                     : off == 2 ? rs_send<2>(v[j], i, j) : rs_send<1>(v[j], i, j);
      for (int j = 0; j < 32; ++j)
        for (int i = 0; i < off; ++i)
          v[j][i] = (off == 16 ? rs_keep<16>(v[j], i, j)
                     : off == 8 ? rs_keep<8>(v[j], i, j)
                     : off == 4 ? rs_keep<4>(v[j], i, j)
                     : off == 2 ? rs_keep<2>(v[j], i, j) : rs_keep<1>(v[j], i, j))
                    + sent[j ^ off][i];
    }
    for (int j = 0; j < 32; ++j)
      if (32 * c + j < deg) warp[32 * c + j] = v[j][0];
  }
}

// z(dL) of n distances as the float64 kernels compute it (Model::z_from_dgw,
// the series in double), from one lambda's packed rows.
extern "C" void host_z_from_dgw(const double* series, const double* params,
                                int cd, int wd, const double* dl, int n,
                                double* z) {
  const Model<double, double> model(series, params, cd, wd);
  for (int i = 0; i < n; ++i) z[i] = model.z_from_dgw(dl[i]);
}

// The adjoint kernels' `partials` scratch in doubles as the kernels lay it
// out (fused_kde_adjoint.cu, rows_contract_adjoint.cu): L rows x P partial
// rows up to records_offset, then L prologue records; T of t_size bytes,
// the series summed in S of s_size bytes.  *record: record_bytes.
extern "C" long long host_adjoint_scratch(int t_size, int s_size, int L,
                                          int rows, int cd, int wd,
                                          long long* record) {
  const size_t P = cd + 2 + wd + kMassScalars;
  const size_t rb = t_size == 8 ? record_bytes<double, double>(cd, wd)
                    : s_size == 8 ? record_bytes<float, double>(cd, wd)
                                  : record_bytes<float, float>(cd, wd);
  *record = (long long)rb;
  return (long long)(records_offset((size_t)L * rows * P)
                     + (size_t)L * rb / sizeof(double));
}
