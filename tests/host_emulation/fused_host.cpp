// Serial host emulation of the fused weights+KDE kernel
// (chimera_tpu_torch/csrc/fused_kde.cu, K1 in its five modes) and of the
// batched KDE and its adjoint (chimera_tpu_torch/csrc/kde1d.cu, K4 and K4b)
// from the same device functions (kde.cuh, population.cuh): per (lambda,
// row) the kernel's phases with a block of one thread, whose block sums are
// the identity.
// K1c, and K1d's Epanechnikov kernel, on logical rows run as their
// kernels do, a warp a row (kde.cuh, logical_row_stats): each of the 32
// lanes' partials from the kernel's own device functions in turn, then the
// warp's shuffle-down folds emulated lane by lane; K1d's densities then by
// external_kde with a block of one thread.
// Same C interfaces as the kernels', without the stream; besides, K1a,
// K1b, K1d, K1e, K4 and K4b with the unpruned loops (the pruned loops'
// oracles), the pruned
// loop on given (z, w) and a tally of the tiles it skips, and K1c and K1d on
// logical rows in the block-a-row layout (K1c's: that the warp's sums
// replay, its kThreads ranks and their warps emulated one by one, the
// replay's oracle; K1d's: that block's sums, then the pruned loop).  Built
// by the host-emulation tests (tests/host_harness.py).
#include <array>
#include <vector>

#include "host_block.h"
#include "kde.cuh"

namespace {

// the tiles that the pruned pair loops tested and skipped (host_tile_tally)
long long g_tally[2] = {0, 0};
// kAnalysisGrid's, kEffectiveGrid's, kExternalBounds' and kContract's
// oracle: the unpruned loops of contract and contract_epilogue_tiles
// (host_fused_kde_unpruned)
bool g_unpruned = false;

// K1c and K1d on logical rows in the block-a-row layout
// (host_logical_stats_block)
bool g_block_layout = false;

// warp_sum's (or block_minmax's) shuffle-down fold over the 32 lanes' v,
// emulated: at each offset o every lane j combines its value with lane
// j + o's as they were before the step (its own where j + o is past the
// warp); lane 0's result.
template <typename T, typename Op>
T fold_down(std::array<T, 32> v, Op op) {
  for (int o = 16; o > 0; o >>= 1) {
    const std::array<T, 32> src = v;
    for (int j = 0; j < 32; ++j) v[j] = op(v[j], j + o < 32 ? src[j + o] : src[j]);
  }
  return v[0];
}

template <typename T>
T add(T x, T y) { return x + y; }

// logical_row_stats of row (l, b) in MODE lane by lane: rank_partials and
// rank_squares of each lane (z, or K1d's (z, w) pairs, to z), replay_sum's
// and replay_minmax's folds.
template <typename T, int MODE = kStatsOnly, typename Z>
RowStats<T> warp_row(const Model<T, double>& model, const FusedArgs<T>& a,
                     int l, int b, Z* z) {
  RowStats<T> st;
  const long long nr = a.n_real[b];
  st.n = nr < 0 ? 0 : (nr > a.S ? a.S : (int)nr);
  const T zf = model.z_from_dgw(a.dl_fill[b]);
  st.sl = T(a.logical_s);
  std::vector<std::array<T, kReplay>> acc(32 * 3), lo(32), hi(32), ss(32);
  for (int j = 0; j < 32; ++j) {
    T p[3][kReplay], q[kReplay], r[kReplay];
    for (int k = 0; k < kReplay; ++k) {
      p[0][k] = p[1][k] = p[2][k] = T(0);
      q[k] = r[k] = zf;
    }
    rank_partials(model, a, (size_t)b * a.S, st.n, j, z, p, q, r);
    for (int k = 0; k < kReplay; ++k) {
      for (int i = 0; i < 3; ++i) acc[3 * j + i][k] = p[i][k];
      lo[j][k] = q[k];
      hi[j][k] = r[k];
    }
  }
  // rank k's partials over the lanes, folded as warp k would fold them
  auto lanes = [](const std::vector<std::array<T, kReplay>>& v, int stride,
                  int off, int k) {
    std::array<T, 32> out;
    for (int j = 0; j < 32; ++j) out[j] = v[stride * j + off][k];
    return out;
  };
  T sums[3];
  for (int i = 0; i < 3; ++i) {
    sums[i] = T(0);
    for (int k = 0; k < kReplay; ++k) sums[i] += fold_down(lanes(acc, 3, i, k), add<T>);
  }
  T z_lo = fold_down(lanes(lo, 1, 0, 0), dmin<T>);
  T z_hi = fold_down(lanes(hi, 1, 0, 0), dmax<T>);
  for (int k = 1; k < kReplay; ++k) {
    z_lo = dmin(z_lo, fold_down(lanes(lo, 1, 0, k), dmin<T>));
    z_hi = dmax(z_hi, fold_down(lanes(hi, 1, 0, k), dmax<T>));
  }
  const T f_log = st.sl - T(st.n);
  const T z_mean = (sums[2] + f_log * zf) / st.sl;
  for (int j = 0; j < 32; ++j) {
    T q[kReplay];
    for (int k = 0; k < kReplay; ++k) q[k] = T(0);
    rank_squares(z, st.n, j, z_mean, q);
    for (int k = 0; k < kReplay; ++k) ss[j][k] = q[k];
  }
  T ss_sum = T(0);
  for (int k = 0; k < kReplay; ++k) ss_sum += fold_down(lanes(ss, 1, 0, k), add<T>);
  finish_stats<T, MODE>(st, a, l, b, sums, ss_sum, zf, z_mean, f_log, z_lo,
                        z_hi);
  write_stats(st, a, (size_t)l * a.B + b);
  return st;
}

// row_stats of row (l, b) as the block-a-row kernel runs it (logical, in
// MODE): rank t's loops over the samples t, t + kThreads, ..., each warp's
// shuffle-down folds, block_sum's and block_minmax's sums over the warps in
// order; z, or K1d's (z, w) pairs, to z.
template <typename T, int MODE = kStatsOnly, typename Z>
RowStats<T> block_row(const Model<T, double>& model, const FusedArgs<T>& a,
                      int l, int b, Z* z) {
  RowStats<T> st;
  const long long nr = a.n_real[b];
  st.n = nr < 0 ? 0 : (nr > a.S ? a.S : (int)nr);
  const T zf = model.z_from_dgw(a.dl_fill[b]);
  st.sl = T(a.logical_s);
  const size_t row = (size_t)b * a.S;
  std::array<std::array<T, kThreads>, 3> acc{};
  std::array<T, kThreads> lo, hi, ss{};
  for (int t = 0; t < kThreads; ++t) {
    lo[t] = hi[t] = zf;
    for (int s = t; s < st.n; s += kThreads) {
      const T zs = model.z_from_dgw(a.dl[row + s]);
      const T inv1pz = T(1) / (T(1) + zs);
      const T w = model.p_m1m2(a.m1[row + s] * inv1pz, a.m2[row + s] * inv1pz)
                  * a.invp[row + s];
      if constexpr (sizeof(Z) == sizeof(T)) {
        z[s] = zs;
      } else {
        z[s].x = zs;
        z[s].y = w;
      }
      acc[0][t] += w;
      acc[1][t] += w * w;
      acc[2][t] += zs;
      lo[t] = dmin(lo[t], zs);
      hi[t] = dmax(hi[t], zs);
    }
  }
  auto warp = [](const std::array<T, kThreads>& v, int w) {
    std::array<T, 32> out;
    for (int j = 0; j < 32; ++j) out[j] = v[32 * w + j];
    return out;
  };
  T sums[3];
  for (int i = 0; i < 3; ++i) {
    sums[i] = T(0);
    for (int w = 0; w < kWarps; ++w) sums[i] += fold_down(warp(acc[i], w), add<T>);
  }
  T z_lo = fold_down(warp(lo, 0), dmin<T>), z_hi = fold_down(warp(hi, 0), dmax<T>);
  for (int w = 1; w < kWarps; ++w) {
    z_lo = dmin(z_lo, fold_down(warp(lo, w), dmin<T>));
    z_hi = dmax(z_hi, fold_down(warp(hi, w), dmax<T>));
  }
  const T f_log = st.sl - T(st.n);
  const T z_mean = (sums[2] + f_log * zf) / st.sl;
  for (int t = 0; t < kThreads; ++t)
    for (int s = t; s < st.n; s += kThreads) {
      const T d = z_of(z[s]) - z_mean;
      ss[t] += d * d;
    }
  T ss_sum = T(0);
  for (int w = 0; w < kWarps; ++w) ss_sum += fold_down(warp(ss, w), add<T>);
  finish_stats<T, MODE>(st, a, l, b, sums, ss_sum, zf, z_mean, f_log, z_lo,
                        z_hi);
  write_stats(st, a, (size_t)l * a.B + b);
  return st;
}

// K1c on logical rows: per lambda, the kernel's blocks of kStatsRows rows,
// warp w of a block taking its rows w, w + kStatsWarps, ... (or the
// block-a-row layout, a row at a time).
template <typename T>
void run_logical_stats(const FusedArgs<T>& a) {
  const int Q = a.cheb_deg + 2 + a.window_deg;
  std::vector<T> z(a.S);
  for (int l = 0; l < a.L; ++l) {
    const Model<T, double> model(a.series + (size_t)l * Q,
                                 a.params + (size_t)l * kMassScalars,
                                 a.cheb_deg, a.window_deg);
    for (int blk = 0; blk * kStatsRows < a.B; ++blk)
      for (int w = 0; w < kStatsWarps; ++w)
        for (int b = blk * kStatsRows + w;
             b < (blk + 1) * kStatsRows && b < a.B; b += kStatsWarps) {
          if (g_block_layout) block_row(model, a, l, b, z.data());
          else warp_row(model, a, l, b, z.data());
        }
  }
}

// K1d on logical rows (Epanechnikov) as logical_kde_kernel runs it: per
// lambda, blocks of kStatsRows rows, a warp a row; the stats lane by lane
// (warp_row), the densities by external_kde with a block of one thread.
// With g_block_layout the stats as fused_kde_kernel's 4-warp block sums
// them (block_row); with g_unpruned the densities by the full loop
// (contract), the oracle of both layouts.
template <typename T>
void run_logical_kde(const FusedArgs<T>& a) {
  const int Q = a.cheb_deg + 2 + a.window_deg;
  std::vector<typename Pair<T>::type> zw(a.S), tiles((a.S + kTileS - 1) / kTileS);
  for (int l = 0; l < a.L; ++l) {
    const Model<T, double> model(a.series + (size_t)l * Q,
                                 a.params + (size_t)l * kMassScalars,
                                 a.cheb_deg, a.window_deg);
    for (int blk = 0; blk * kStatsRows < a.B; ++blk)
      for (int w = 0; w < kStatsWarps; ++w)
        for (int b = blk * kStatsRows + w;
             b < (blk + 1) * kStatsRows && b < a.B; b += kStatsWarps) {
          const RowStats<T> st =
              g_block_layout
                  ? block_row<T, kExternalBounds>(model, a, l, b, zw.data())
                  : warp_row<T, kExternalBounds>(model, a, l, b, zw.data());
          const T inv_h = T(1) / st.h;
          const T scale = kernel_norm<T, 0>() * inv_h
                          / (a.unit_scale ? st.sum_w : st.sl);
          const HostBlock<T> blk{g_tally};
          T* out = a.den + ((size_t)l * a.B + b) * a.G;
          if (g_unpruned) {
            const T lo = st.lo, delta = (st.ub - st.lo) / T(a.G - 1);
            contract<T, 0>(blk, zw.data(), st.n, a.G, inv_h, scale,
                           [lo, delta](int g) { return lo + delta * T(g); },
                           out);
          } else {
            external_kde(blk, st, a.G, inv_h, scale, zw.data(), tiles.data(),
                         out);
          }
        }
  }
}

template <typename T, typename S, int KERNEL, int MODE, bool PRUNE = true>
void run_mode(const FusedArgs<T>& a) {
  const int Q = a.cheb_deg + 2 + a.window_deg;
  std::vector<S> ser(Q);
  std::vector<typename Pair<T>::type> zw(a.S), tiles((a.S + kTileS - 1) / kTileS);
  for (int l = 0; l < a.L; ++l) {
    for (int i = 0; i < Q; ++i) ser[i] = S(a.series[(size_t)l * Q + i]);
    const Model<T, S> model(ser.data(), a.params + (size_t)l * kMassScalars,
                            a.cheb_deg, a.window_deg);
    for (int b = 0; b < a.B; ++b)
      fused_row<T, S, KERNEL, MODE, PRUNE>(HostBlock<T>{g_tally}, model, a, l,
                                           b, zw.data(), tiles.data());
  }
}

template <typename T, int KERNEL>
void run_kernel(const FusedArgs<T>& a, int mode) {
  if (mode == kAnalysisGrid && g_unpruned)
    run_mode<T, T, KERNEL, kAnalysisGrid, false>(a);
  else if (mode == kAnalysisGrid) run_mode<T, T, KERNEL, kAnalysisGrid>(a);
  if (mode == kEffectiveGrid && g_unpruned)
    run_mode<T, T, KERNEL, kEffectiveGrid, false>(a);
  else if (mode == kEffectiveGrid) run_mode<T, T, KERNEL, kEffectiveGrid>(a);
  if (mode == kExternalBounds && KERNEL == 0 && a.n_real != nullptr)
    run_logical_kde<T>(a);
  else if (mode == kExternalBounds && g_unpruned)
    run_mode<T, double, KERNEL, kExternalBounds, false>(a);
  else if (mode == kExternalBounds)
    run_mode<T, double, KERNEL, kExternalBounds>(a);
  if (mode == kStatsOnly && a.n_real != nullptr) run_logical_stats<T>(a);
  else if (mode == kStatsOnly) run_mode<T, double, KERNEL, kStatsOnly>(a);
  if (mode == kContract && g_unpruned)
    run_mode<T, double, KERNEL, kContract, false>(a);
  else if (mode == kContract) run_mode<T, double, KERNEL, kContract>(a);
}

template <typename T>
void run(const T* m1, const T* m2, const T* dl, const T* invp, const T* grids,
         const T* ext, const long long* n_real, const T* dl_fill,
         const double* series, const T* params, const T* s1, const T* s2,
         const T* f1, const T* f2, T* den, T* stats, int L, int B, int S,
         int G, int cheb_deg, int window_deg, int logical_s, int mode,
         int kernel, int bw_mode, double bw_value, double cut_grid,
         int unit_scale, int npix) {
  const FusedArgs<T> a{m1, m2, dl, invp, grids, ext, n_real, dl_fill, series,
                       params, s1, s2, f1, f2, den, stats, L, B, S, G,
                       cheb_deg, window_deg, logical_s, bw_mode, unit_scale,
                       npix, (T)bw_value, (T)cut_grid};
  if (kernel == 0) run_kernel<T, 0>(a, mode);
  else run_kernel<T, 1>(a, mode);
}

// The Epanechnikov densities (the shape without its constant) of rows of
// given (z, w) on their grids at 1/h: the pruned loop (tile_bounds and
// contract_pruned) where prune, else the unpruned one of contract.
template <typename T>
void run_contract(const T* z, const T* w, const T* grids, const T* inv_h,
                  T* out, int B, int S, int G, int prune) {
  std::vector<typename Pair<T>::type> zw(S), tiles((S + kTileS - 1) / kTileS);
  const HostBlock<T> blk{g_tally};
  for (int b = 0; b < B; ++b) {
    for (int s = 0; s < S; ++s) {
      zw[s].x = z[(size_t)b * S + s];
      zw[s].y = w[(size_t)b * S + s];
    }
    const T* grid = grids + (size_t)b * G;
    T* o = out + (size_t)b * G;
    auto grid_at = [grid](int g) { return grid[g]; };
    if (prune) {
      tile_bounds<T, kTileS, true>(blk, zw.data(), S, tiles.data());
      contract_pruned<T, kTileS, kTileG>(blk, zw.data(), tiles.data(), S, G,
                                         inv_h[b], grid_at,
                                         [o](int g, T sum) { o[g] = sum; });
    } else {
      contract<T, 0>(blk, zw.data(), S, G, inv_h[b], T(1), grid_at, o);
    }
  }
}

template <typename T, int KERNEL, bool PRUNE = KERNEL == 0>
void run_kde1d(const T* z, const T* w, const T* grids, const T* h, T* out,
               int B, int S, int G) {
  std::vector<typename Pair<T>::type> zw(S), tiles((S + kK4Tile - 1) / kK4Tile);
  for (int b = 0; b < B; ++b) {
    for (int s = 0; s < S; ++s) {
      zw[s].x = z[(size_t)b * S + s];
      zw[s].y = w[(size_t)b * S + s];
    }
    kde_row<T, KERNEL, PRUNE>(HostBlock<T>{g_tally}, zw.data(), S,
                              grids + (size_t)b * G, G, h[b],
                              out + (size_t)b * G, tiles.data());
  }
}

template <typename T, int KERNEL, bool PRUNE = KERNEL == 0>
void run_kde1d_adjoint(const T* z, const T* w, const T* grids, const T* h,
                       const T* out, const T* d_out, T* d_z, T* d_w,
                       T* d_grid, T* d_h, int B, int S, int G) {
  std::vector<double2> zw(S), gd(G), zt((S + kK4bTile - 1) / kK4bTile),
      gt((G + kK4bTile - 1) / kK4bTile);
  for (int b = 0; b < B; ++b) {
    for (int s = 0; s < S; ++s) {
      zw[s].x = z[(size_t)b * S + s];
      zw[s].y = w[(size_t)b * S + s];
    }
    for (int g = 0; g < G; ++g) {
      gd[g].x = grids[(size_t)b * G + g];
      gd[g].y = d_out[(size_t)b * G + g];
    }
    kde_row_adjoint<double, KERNEL, PRUNE>(
        HostBlock<double>{g_tally}, zw.data(), S, gd.data(), G,
        out + (size_t)b * G, double(h[b]), d_z + (size_t)b * S,
        d_w + (size_t)b * S, d_grid + (size_t)b * G, d_h + b, zt.data(),
        gt.data());
  }
}

}  // namespace

#define FUSED_ARGS(T)                                                        \
  const T *m1, const T *m2, const T *dl, const T *invp, const T *grids,     \
      const T *ext, const long long *n_real, const T *dl_fill,              \
      const double *series, const T *params, const T *s1, const T *s2,      \
      const T *f1, const T *f2, T *den, T *stats, int L, int B, int S, int G, \
      int cheb_deg, int window_deg, int logical_s, int mode, int kernel,     \
      int bw_mode, double bw_value, double cut_grid, int unit_scale,         \
      int npix
#define FUSED_CALL                                                            \
  run(m1, m2, dl, invp, grids, ext, n_real, dl_fill, series, params, s1, s2, \
      f1, f2, den, stats, L, B, S, G, cheb_deg, window_deg, logical_s, mode,  \
      kernel, bw_mode, bw_value, cut_grid, unit_scale, npix)

extern "C" void host_fused_kde_f32(FUSED_ARGS(float)) { FUSED_CALL; }
extern "C" void host_fused_kde_f64(FUSED_ARGS(double)) { FUSED_CALL; }

// K1a, K1b, K1d and K1e with the unpruned pair loops (contract,
// contract_epilogue_tiles), the pruned loop's oracle
#define UNPRUNED(T, NAME)                                                    \
  extern "C" void NAME(FUSED_ARGS(T)) {                                      \
    g_unpruned = true;                                                       \
    FUSED_CALL;                                                              \
    g_unpruned = false;                                                      \
  }
UNPRUNED(float, host_fused_kde_unpruned_f32)
UNPRUNED(double, host_fused_kde_unpruned_f64)

// K1c and K1d on logical rows in the block-a-row layout: the warp's
// oracle, and K1d's pruned loop in the 4-warp block (k1d_block)
#define BLOCK_LAYOUT(T, NAME)                                                \
  extern "C" void NAME(FUSED_ARGS(T)) {                                      \
    g_block_layout = true;                                                   \
    FUSED_CALL;                                                              \
    g_block_layout = false;                                                  \
  }
BLOCK_LAYOUT(float, host_logical_stats_block_f32)
BLOCK_LAYOUT(double, host_logical_stats_block_f64)

extern "C" void host_contract_f32(const float* z, const float* w,
                                  const float* grids, const float* inv_h,
                                  float* out, int B, int S, int G, int prune) {
  run_contract<float>(z, w, grids, inv_h, out, B, S, G, prune);
}

extern "C" void host_contract_f64(const double* z, const double* w,
                                  const double* grids, const double* inv_h,
                                  double* out, int B, int S, int G,
                                  int prune) {
  run_contract<double>(z, w, grids, inv_h, out, B, S, G, prune);
}

// the tiles that the pruned pair loops tested and skipped since the last
// call: out[0] tested, out[1] skipped
extern "C" void host_tile_tally(long long* out) {
  out[0] = g_tally[0];
  out[1] = g_tally[1];
  g_tally[0] = g_tally[1] = 0;
}

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

// K4 with the full loop (Epanechnikov, contract), the pruned loop's oracle
extern "C" void host_kde1d_unpruned_f32(const float* z, const float* w,
                                        const float* grids, const float* h,
                                        float* out, int B, int S, int G) {
  run_kde1d<float, 0, false>(z, w, grids, h, out, B, S, G);
}

extern "C" void host_kde1d_unpruned_f64(const double* z, const double* w,
                                        const double* grids, const double* h,
                                        double* out, int B, int S, int G) {
  run_kde1d<double, 0, false>(z, w, grids, h, out, B, S, G);
}

#define KDE1D_ADJOINT(T, NAME)                                               \
  extern "C" void NAME(const T* z, const T* w, const T* grids, const T* h,   \
                       const T* out, const T* d_out, T* d_z, T* d_w,        \
                       T* d_grid, T* d_h, int B, int S, int G, int kernel) { \
    if (kernel == 0)                                                         \
      run_kde1d_adjoint<T, 0>(z, w, grids, h, out, d_out, d_z, d_w, d_grid,  \
                              d_h, B, S, G);                                 \
    else                                                                     \
      run_kde1d_adjoint<T, 1>(z, w, grids, h, out, d_out, d_z, d_w, d_grid,  \
                              d_h, B, S, G);                                 \
  }
KDE1D_ADJOINT(float, host_kde1d_adjoint_f32)
KDE1D_ADJOINT(double, host_kde1d_adjoint_f64)

// K4b with the full sweeps (Epanechnikov), the pruned sweeps' oracle
#define KDE1D_ADJOINT_UNPRUNED(T, NAME)                                      \
  extern "C" void NAME(const T* z, const T* w, const T* grids, const T* h,   \
                       const T* out, const T* d_out, T* d_z, T* d_w,        \
                       T* d_grid, T* d_h, int B, int S, int G) {            \
    run_kde1d_adjoint<T, 0, false>(z, w, grids, h, out, d_out, d_z, d_w,     \
                                   d_grid, d_h, B, S, G);                    \
  }
KDE1D_ADJOINT_UNPRUNED(float, host_kde1d_adjoint_unpruned_f32)
KDE1D_ADJOINT_UNPRUNED(double, host_kde1d_adjoint_unpruned_f64)
