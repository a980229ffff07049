// The arithmetic of the fused weights+KDE pass (fused_kde.cu, K1 in its
// five modes) and of the batched 1-D KDE and its adjoint (kde1d.cu, K4 and
// K4b), written once for a block of threads.  A `Block` gives the thread's
// rank, the stride (kSize) and the block-wide sums: DeviceBlock
// (population.cuh) is a CUDA block of kThreads threads; the host emulation
// (tests/host_emulation/fused_host.cpp) runs the same functions serially
// with a block of one thread.
//
// Semantics: chimera_tpu/ops/pallas/fused.py:71-219 (_fused_kernel) and
// :372-482 (_reference_impl); chimera_tpu/ops/kde.py:94-102 (kde1d_core)
// and its vector-Jacobian product.  The plain PyTorch versions are
// ops/cuda/fused.py::fused_weights_kde_plain and ops/cuda/kde.py::
// kde1d_grid_plain and kde1d_grid_adjoint_plain.

#pragma once

#include "population.cuh"

namespace {

// Where the fused pass's KDE grid comes from (fused.py:147-168), or none.
enum FusedMode {
  kAnalysisGrid = 0,    // (a) the (B, G) grids given
  kEffectiveGrid = 1,   // (b) linspace over [z_min - c sigma, z_max + c sigma]
  kExternalBounds = 2,  // (d) linspace over the given (lo, ub) of (l, b)
  kStatsOnly = 3,       // (c) no KDE
  kContract = 4,        // (e) the (B, G) grids given, unit mass, the
                        //     density contracted in the block (fused.py:192-211)
};

template <typename T>
struct FusedArgs {
  const T* m1;
  const T* m2;
  const T* dl;
  const T* invp;
  const T* grids;             // (B, G), mode (a)
  const T* ext;               // (L, B, 2), mode (d)
  const long long* n_real;    // (B,) or null: logical rows when given
  const T* dl_fill;           // (B,) with n_real
  const double* series;       // (L, cheb_deg + 2 + window_deg)
  const T* params;            // (L, kMassScalars)
  const T* s1;                // (B, G), mode (e): the static factors
  const T* s2;                // (B, G)
  const T* f1;                // (L, B / npix, G), mode (e): per-lambda factors
  const T* f2;                // (L, B / npix, G)
  T* den;                     // (L, B, G); r (L, B, 2) in mode (e); not in (c)
  T* stats;                   // (L, B, 8)
  int L, B, S, G, cheb_deg, window_deg, logical_s, bw_mode, unit_scale, npix;
  T bw_value, cut_grid;
};

template <typename T>
struct RowStats {
  T lo, ub, sl, sum_w, sum_w2, neff, h, z_sig;
  int n;  // the row's slots that hold samples
};

template <typename T>
__device__ __forceinline__ T largest() {
  if constexpr (sizeof(T) == 4) return T(FLT_MAX);
  else return T(DBL_MAX);
}

// The row statistics after the sums (fused.py:126-141): sigma_z with the
// logical fillers, N_eff, h and the mode's lo and ub, given st's n and sl,
// the sums of w, w^2 and z (acc) and of (z - z_mean)^2 (ss) over the real
// samples, the fillers' z_f and the z range.
template <typename T, int MODE>
__device__ __forceinline__ void finish_stats(RowStats<T>& st,
                                             const FusedArgs<T>& a, int l,
                                             int b, const T (&acc)[3], T ss,
                                             T zf, T z_mean, T f_log, T z_lo,
                                             T z_hi) {
  const T dz = zf - z_mean;
  st.z_sig = dsqrt((ss + f_log * dz * dz) / st.sl);
  st.sum_w = acc[0];
  st.sum_w2 = acc[1];
  st.neff = st.sum_w * st.sum_w / st.sum_w2;
  st.h = bw_factor(st.neff, a.bw_mode, a.bw_value) * st.z_sig;
  if (MODE == kEffectiveGrid || MODE == kStatsOnly) {
    const T lo = z_lo - a.cut_grid * st.z_sig;
    st.lo = lo > T(0) ? lo : T(1e-8);
    st.ub = z_hi + a.cut_grid * st.z_sig;
  } else if (MODE == kExternalBounds) {
    st.lo = a.ext[((size_t)l * a.B + b) * 2];
    st.ub = a.ext[((size_t)l * a.B + b) * 2 + 1];
  } else {
    st.lo = T(0);  // analysis grids: no effective grid
    st.ub = T(0);
  }
}

// Phase A and the row statistics of (l, b) (fused.py:102-141, the raw
// formulas: a row without weight gives NaN neff and h).  z and w of the
// row's first n slots go to zw.  A logical row (n_real given) maps only its
// n_real samples and adds the logical_s - n_real fillers at
// z_f = z(dl_fill) analytically:
//   mean = (sum_real z + f z_f) / S_l,  var = (sum_real (z - mean)^2
//          + f (z_f - mean)^2) / S_l,   z range = that of z_real and z_f,
// the same function as the TPU kernel's form (which maps every slot and
// corrects for the fillers present).
template <typename T, typename S, int MODE, typename Block>
__device__ __forceinline__ RowStats<T> row_stats(
    const Block& blk, const Model<T, S>& model, const FusedArgs<T>& a, int l,
    int b, typename Pair<T>::type* zw) {
  RowStats<T> st;
  const bool logical = a.n_real != nullptr;
  st.n = a.S;
  T zf = T(0);
  if (logical) {
    const long long nr = a.n_real[b];
    st.n = nr < 0 ? 0 : (nr > a.S ? a.S : (int)nr);
    zf = model.z_from_dgw(a.dl_fill[b]);
  }
  st.sl = T(logical ? a.logical_s : a.S);
  const size_t row = (size_t)b * a.S;
  T acc[3] = {T(0), T(0), T(0)};  // sum w, sum w^2, sum z
  T z_lo = logical ? zf : largest<T>(), z_hi = logical ? zf : -largest<T>();
  for (int s = blk.rank(); s < st.n; s += Block::kSize) {
    const T z = model.z_from_dgw(a.dl[row + s]);
    const T inv1pz = T(1) / (T(1) + z);
    const T w = model.p_m1m2(a.m1[row + s] * inv1pz, a.m2[row + s] * inv1pz)
                * a.invp[row + s];
    typename Pair<T>::type p;
    p.x = z;
    p.y = w;
    zw[s] = p;
    acc[0] += w;
    acc[1] += w * w;
    acc[2] += z;
    z_lo = dmin(z_lo, z);
    z_hi = dmax(z_hi, z);
  }
  // K1d's empty logical rows in a block (the Gaussian kernel's: 38.5 % of
  // the dark cut_grid path's rows) skip the block sums, whose totals over
  // no sample are the +0 they start at
  const bool sums = MODE != kExternalBounds || st.n > 0;
  if (sums) blk.template sum<3>(acc);
  if (MODE == kEffectiveGrid || MODE == kStatsOnly) blk.minmax(z_lo, z_hi);
  const T f_log = st.sl - T(st.n);  // logical fillers (0 on a plain row)
  const T z_mean = (acc[2] + f_log * zf) / st.sl;
  T ss[1] = {T(0)};
  for (int s = blk.rank(); s < st.n; s += Block::kSize) {
    const T d = zw[s].x - z_mean;
    ss[0] += d * d;
  }
  if (sums) blk.template sum<1>(ss);
  finish_stats<T, MODE>(st, a, l, b, acc, ss[0], zf, z_mean, f_log, z_lo,
                        z_hi);
  return st;
}

// The row statistics (stats row l, b: lo, ub, norms, neff, h, sum w,
// sum w^2, sigma_z), written by one thread.
template <typename T>
__device__ __forceinline__ void write_stats(const RowStats<T>& st,
                                            const FusedArgs<T>& a,
                                            size_t out_row) {
  T* o = a.stats + out_row * 8;
  o[0] = st.lo;
  o[1] = st.ub;
  o[2] = st.sum_w / st.sl;
  o[3] = st.neff;
  o[4] = st.h;
  o[5] = st.sum_w;
  o[6] = st.sum_w2;
  o[7] = st.z_sig;
}

// ---------------------------------------------------------------------------
// K1c and K1d on logical rows: a warp a row, the block's sums replayed
// ---------------------------------------------------------------------------
//
// logical_stats_kernel and logical_kde_kernel (fused_kde.cu) give each
// logical row (the dark siren's pixel rows, ~S_l / npix real samples, or
// none) one warp in place of a block of kThreads threads, and keep that
// block's sums.  In row_stats the
// block's rank t sums the samples t, t + kThreads, ... in order; its warps
// fold their ranks' partials with warp_sum's shuffle-down pattern and
// block_sum adds the warps' totals to T(0) in warp order; block_minmax
// folds the same way with dmin and dmax (whose NaN handling follows the
// operand order).  Here lane j keeps the partials of the ranks j + 32 k,
// k < kReplay, fed in the same order: its i-th sample, lane + 32 i, is rank
// lane + 32 (i mod kReplay)'s, so the lane feeds its current partials and
// rotates the kReplay of them after each sample, kReplay at a time, and no
// per-thread array is indexed at run time.  replay_sum and replay_minmax
// then fold rank k's partials over the warp as warp k would and combine the
// kReplay totals as block_sum and block_minmax do: every sum, the z range
// and the stats have the bits of the block-a-row kernel.

// the block's warps that a lane's partials stand for
constexpr int kReplay = kThreads / 32;
// logical_stats_kernel's and logical_kde_kernel's warps a block and rows a
// block (_STATS_WARPS in ops/cuda/fused.py sizes their shared memory: a
// row's z, or its (z, w) pairs and tiles' bounds, for each warp).  One
// warp taking 4 rows in turn: blocks of 4 warps, a row each, took ~25 %
// longer at the dark flagship on an H100 (PERF.md §6): a block holds its
// slot until the warp of its largest pixel ends.
constexpr int kStatsWarps = 1;
constexpr int kStatsRows = 4;

// rotate v[0] <- v[1] <- ... <- v[kReplay - 1] <- v[0]
template <typename T>
__device__ __forceinline__ void rotate(T (&v)[kReplay]) {
  const T first = v[0];
#pragma unroll
  for (int k = 0; k + 1 < kReplay; ++k) v[k] = v[k + 1];
  v[kReplay - 1] = first;
}

// z of a sample kept as z alone (K1c) or as the pair (z, w) (K1d)
template <typename T>
__device__ __forceinline__ T z_of(T z) { return z; }
__device__ __forceinline__ float z_of(float2 p) { return p.x; }
__device__ __forceinline__ double z_of(double2 p) { return p.x; }

// Pass 1 of row_stats for lane `lane` of a warp standing for the block:
// z and w of the row's samples lane + 32 i (i < ceil(n / kThreads)
// kReplay), z to z[s] (Z = T) or (z, w) to z[s] (Z a pair); rank lane +
// 32 k's sums of w, w^2 and z in acc[.][k], its z range in lo[k], hi[k]
// (which start at the caller's).
template <typename T, typename S, typename Z>
__device__ __forceinline__ void rank_partials(
    const Model<T, S>& model, const FusedArgs<T>& a, size_t row, int n,
    int lane, Z* z, T (&acc)[3][kReplay], T (&lo)[kReplay],
    T (&hi)[kReplay]) {
  const int steps = (n + kThreads - 1) / kThreads * kReplay;
  for (int i = 0; i < steps; ++i) {
    const int s = lane + 32 * i;
    if (s < n) {
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
      acc[0][0] += w;
      acc[1][0] += w * w;
      acc[2][0] += zs;
      lo[0] = dmin(lo[0], zs);
      hi[0] = dmax(hi[0], zs);
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) rotate(acc[j]);
    rotate(lo);
    rotate(hi);
  }
}

// Pass 2 of row_stats for that lane: rank lane + 32 k's sum of
// (z - z_mean)^2 in ss[k].
template <typename T, typename Z>
__device__ __forceinline__ void rank_squares(const Z* z, int n, int lane,
                                             T z_mean, T (&ss)[kReplay]) {
  const int steps = (n + kThreads - 1) / kThreads * kReplay;
  for (int i = 0; i < steps; ++i) {
    const int s = lane + 32 * i;
    if (s < n) {
      const T d = z_of(z[s]) - z_mean;
      ss[0] += d * d;
    }
    rotate(ss);
  }
}

// block_sum of the ranks' partials v[k] (rank lane + 32 k), replayed by the
// warp; every lane receives the total.
template <typename T>
__device__ __forceinline__ T replay_sum(const T (&v)[kReplay]) {
  T t = T(0);
#pragma unroll
  for (int k = 0; k < kReplay; ++k)
    t += __shfl_sync(0xffffffffu, warp_sum(v[k]), 0);
  return t;
}

// block_minmax of the ranks' lo[k] and hi[k], replayed by the warp.
template <typename T>
__device__ __forceinline__ void replay_minmax(T (&lo)[kReplay],
                                              T (&hi)[kReplay], T& z_lo,
                                              T& z_hi) {
#pragma unroll
  for (int k = 0; k < kReplay; ++k) {
    for (int o = 16; o > 0; o >>= 1) {
      lo[k] = dmin(lo[k], __shfl_down_sync(0xffffffffu, lo[k], o));
      hi[k] = dmax(hi[k], __shfl_down_sync(0xffffffffu, hi[k], o));
    }
    lo[k] = __shfl_sync(0xffffffffu, lo[k], 0);
    hi[k] = __shfl_sync(0xffffffffu, hi[k], 0);
  }
  z_lo = lo[0];
  z_hi = hi[0];
#pragma unroll
  for (int k = 1; k < kReplay; ++k) {
    z_lo = dmin(z_lo, lo[k]);
    z_hi = dmax(z_hi, hi[k]);
  }
}

// The stats of the logical row (l, b) by one warp (row_stats with n_real
// given, and fused_row's write): K1c's in kStatsOnly, z of its real
// samples in z[0, S); K1d's in kExternalBounds, their (z, w) pairs there
// (which takes no z range).
template <typename T, typename S, int MODE = kStatsOnly, typename Z>
__device__ __forceinline__ RowStats<T> logical_row_stats(
    const Model<T, S>& model, const FusedArgs<T>& a, int l, int b, int lane,
    Z* z) {
  RowStats<T> st;
  const long long nr = a.n_real[b];
  st.n = nr < 0 ? 0 : (nr > a.S ? a.S : (int)nr);
  const T zf = model.z_from_dgw(a.dl_fill[b]);
  st.sl = T(a.logical_s);
  T acc[3][kReplay], lo[kReplay], hi[kReplay], ss[kReplay];
#pragma unroll
  for (int k = 0; k < kReplay; ++k) {
    acc[0][k] = acc[1][k] = acc[2][k] = ss[k] = T(0);
    lo[k] = hi[k] = zf;
  }
  rank_partials(model, a, (size_t)b * a.S, st.n, lane, z, acc, lo, hi);
  const T sums[3] = {replay_sum(acc[0]), replay_sum(acc[1]),
                     replay_sum(acc[2])};
  T z_lo = zf, z_hi = zf;
  if (MODE == kStatsOnly) replay_minmax(lo, hi, z_lo, z_hi);
  const T f_log = st.sl - T(st.n);
  const T z_mean = (sums[2] + f_log * zf) / st.sl;
  rank_squares(z, st.n, lane, z_mean, ss);
  finish_stats<T, MODE>(st, a, l, b, sums, replay_sum(ss), zf, z_mean, f_log,
                        z_lo, z_hi);
  if (lane == 0) write_stats(st, a, (size_t)l * a.B + b);
  return st;
}

// The kernel's shape without its constant: Epanechnikov max(1 - u^2, 0),
// Gaussian exp(-u^2 / 2); kernel_norm() is the constant (0.75, 1/sqrt(2 pi)).
template <typename T, int KERNEL>
__device__ __forceinline__ T kernel_shape(T u) {
  if (KERNEL == 0) return dmax(T(1) - u * u, T(0));
  return dexp(T(-0.5) * u * u);
}

template <typename T, int KERNEL>
__device__ __forceinline__ T kernel_norm() {
  return KERNEL == 0 ? T(0.75) : T(0.39894228040143267794);
}

// out[g] = scale * sum_{s < n} w_s K((grid(g) - z_s) inv_h) for g < G: each
// thread holds GPT grid points in registers, and one broadcast load of a
// (z, w) pair from shared memory feeds all of them.
template <typename T, int KERNEL, int GPT, typename Block, typename GridAt>
__device__ __forceinline__ void contract_tiles(
    const Block& blk, const typename Pair<T>::type* zw, int n, int G,
    T inv_h, T scale, const GridAt& grid_at, T* out) {
  for (int g0 = 0; g0 < G; g0 += Block::kSize * GPT) {
    T gv[GPT], sum[GPT];
#pragma unroll
    for (int k = 0; k < GPT; ++k) {
      const int idx = g0 + k * Block::kSize + blk.rank();
      gv[k] = grid_at(idx < G ? idx : G - 1);
      sum[k] = T(0);
    }
#pragma unroll 4
    for (int s = 0; s < n; ++s) {
      const typename Pair<T>::type p = zw[s];
#pragma unroll
      for (int k = 0; k < GPT; ++k)
        sum[k] += p.y * kernel_shape<T, KERNEL>((gv[k] - p.x) * inv_h);
    }
#pragma unroll
    for (int k = 0; k < GPT; ++k) {
      const int idx = g0 + k * Block::kSize + blk.rank();
      if (idx < G) out[idx] = sum[k] * scale;
    }
  }
}

// Two grid points a thread for grids up to 2 tiles of threads wide (the
// half-resolution effective grids, 250 points), four for wider ones.
template <typename T, int KERNEL, typename Block, typename GridAt>
__device__ __forceinline__ void contract(
    const Block& blk, const typename Pair<T>::type* zw, int n, int G,
    T inv_h, T scale, const GridAt& grid_at, T* out) {
  if (G <= 2 * Block::kSize)
    contract_tiles<T, KERNEL, 2>(blk, zw, n, G, inv_h, scale, grid_at, out);
  else
    contract_tiles<T, KERNEL, 4>(blk, zw, n, G, inv_h, scale, grid_at, out);
}

// ---------------------------------------------------------------------------
// The pair loop pruned to the Epanechnikov support (K1a, K2b's pass 1)
// ---------------------------------------------------------------------------
//
// A term w K((g - z) inv_h) of the Epanechnikov kernel is exactly zero where
// |u| >= 1: max(1 - u^2, 0) is then +0 (1 - u^2 <= 0, or NaN, selects the
// 0), and an fma or add of w * (+0) = +-0 leaves a sum's bits as they were
// for any finite w (a sum that starts at +0 never becomes -0).  Rounding is
// monotone, so for every g >= g_lo and z <= z_hi (inv_h > 0)
//   fl(fl(g - z) inv_h) >= fl(fl(g_lo - z_hi) inv_h),
// and if the kernel's own expression gives u >= 1 at a tile's corner (its
// lowest grid point against its highest z), every pair of the tile has
// u >= 1; mirrored, u <= -1 from the highest grid point against the lowest
// z.  Such a tile is skipped; the others run the full loop's arithmetic
// in the same sample order, so every density keeps the bits of `contract`.
// The bounds are computed, not assumed: the min and max of the tile's z
// over its samples with weight (w = 0 gives a zero term whatever z is) and
// of the run's grid points.  A sample with a non-finite z or w, or a
// non-finite grid point, spoils its tile's bounds to (-largest, largest),
// which no corner test passes; a NaN bandwidth fails every comparison.  A
// row out of order, or a z that float32 rounding of the Chebyshev inverse
// takes out of order, costs speed only.  The Gaussian kernel's terms are
// never exactly zero: it keeps `contract`.

// samples a tile and grid points a run (a warp's, one a lane on the card)
constexpr int kTileS = 32;
constexpr int kTileG = 32;

// the largest |u| whose u^2 is finite, with room: an adjoint's tile is
// skipped only where every u of its pairs lies within it (K2b's pass 2,
// K3b's phase B, K4b's sweeps: outside_support)
template <typename T>
__device__ __forceinline__ T max_u() {
  if constexpr (sizeof(T) == 4) return T(1e19);
  else return T(1e154);
}

// Whether the u of a tile's pairs, all in [u_lo, u_hi], are all > 1 or all
// < -1, within max_u: there an adjoint's Epanechnikov terms are exactly 0.
// The support's closed edge |u| = 1 is not skipped (an adjoint's slope
// factor is not 0 there); a NaN u fails both tests.  (K2b's pass 2 makes
// the same test inline: called from there, nvcc scheduled K2b otherwise
// and it ran 0.5-4 % slower on an H100, PERF.md.)
template <typename T>
__device__ __forceinline__ bool outside_support(T u_lo, T u_hi) {
  return (u_lo > T(1) && u_hi <= max_u<T>())
         || (u_hi < T(-1) && u_lo >= -max_u<T>());
}

// (lo, hi) of each tile of TILE entries of x[0, n), the pairs (x, y): the
// min and max x over every entry (WEIGHTED: over the entries whose y is not
// 0, (largest, -largest) for a tile with none, as tile_bounds); (-largest,
// largest) for a tile with a non-finite x, or a y that is not finite or is
// above max_u in size, which no outside_support test passes (K4b: a
// skipped term y u f is then y u 0 with |y u| finite).  A thread a tile,
// for tiles narrower than a warp (tile_bounds takes a warp a tile); ends
// in a barrier.
template <typename T, int TILE, bool WEIGHTED = false, typename Block>
__device__ __forceinline__ void thread_tile_bounds(
    const Block& blk, const typename Pair<T>::type* x, int n,
    typename Pair<T>::type* tiles) {
  for (int t = blk.rank(); t * TILE < n; t += Block::kSize) {
    T lo = largest<T>(), hi = -largest<T>();
    const int i1 = (t + 1) * TILE < n ? (t + 1) * TILE : n;
    for (int i = t * TILE; i < i1; ++i) {
      const typename Pair<T>::type p = x[i];
      if (!(finite(p.x) && dabs(p.y) <= max_u<T>())) {
        lo = -largest<T>();
        hi = largest<T>();
        break;
      }
      if (WEIGHTED && p.y == T(0)) continue;
      lo = dmin(lo, p.x);
      hi = dmax(hi, p.x);
    }
    tiles[t].x = lo;
    tiles[t].y = hi;
  }
  blk.sync();
}

// body(i0, i1) for each tile [i0, i1) of TILE of the n entries, in order,
// but those that outside(t) proves exactly zero (tested and tallied) where
// prune.  A warp walks the tiles in step, so it spends the union of its
// lanes' kept tiles, with every lane on the same entry (a broadcast load):
// lanes each on their own next kept tile, which spend only the lanes' most,
// took the same time at K4b's two binned shapes on an H100 (PERF.md §6).
template <int TILE, typename Block, typename Outside, typename Body>
__device__ __forceinline__ void walk_tiles(const Block& blk, int n, bool prune,
                                           const Outside& outside,
                                           const Body& body) {
  for (int t = 0; t * TILE < n; ++t) {
    if (prune) {
      const bool skip = outside(t);
      blk.tile(skip);
      if (skip) continue;
    }
    body(t * TILE, (t + 1) * TILE < n ? (t + 1) * TILE : n);
  }
}

// (lo, hi) of each tile of TILE entries of x[0, n), the pairs (x, y) of
// (z, w) or (grid point, c): the min and max x, over the entries whose y is
// not 0 where WEIGHTED; (-largest, largest) for a tile with a non-finite x
// or y, (largest, -largest) for one with nothing to bound.  The warps take
// the tiles in turn, TILE / kLanes entries a lane; ends in a barrier.
template <typename T, int TILE, bool WEIGHTED, typename Block>
__device__ __forceinline__ void tile_bounds(
    const Block& blk, const typename Pair<T>::type* x, int n,
    typename Pair<T>::type* tiles) {
  static_assert(TILE % Block::kLanes == 0, "a tile is whole lanes");
  constexpr int kPer = TILE / Block::kLanes;
  const int warps = Block::kSize / Block::kLanes;
  const int warp = blk.rank() / Block::kLanes, lane = blk.lane();
  const int n_tiles = (n + TILE - 1) / TILE;
  for (int t = warp; t < n_tiles; t += warps) {
    T lo = largest<T>(), hi = -largest<T>();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = t * TILE + j * Block::kLanes + lane;
      if (i < n) {
        const typename Pair<T>::type p = x[i];
        if (!(finite(p.x) && finite(p.y))) {
          lo = -largest<T>();
          hi = largest<T>();
        } else if (!WEIGHTED || p.y != T(0)) {
          lo = dmin(lo, p.x);
          hi = dmax(hi, p.x);
        }
      }
    }
    blk.warp_minmax(lo, hi);
    if (lane == 0) {
      tiles[t].x = lo;
      tiles[t].y = hi;
    }
  }
  blk.sync();
}

// As contract, Epanechnikov only, with its pair loop pruned: store(g, sum)
// for g < G receives sum_{s < n} w_s max(1 - u^2, 0), u = (grid(g) - z_s)
// inv_h, of the same bits as contract_tiles' sum.  `tiles` holds the
// (z_lo, z_hi) of each TILE_S samples of zw (tile_bounds, WEIGHTED).  Each
// warp takes runs of TILE_G consecutive grid points in turn, TILE_G /
// kLanes a lane; per run its lanes test TILE_S-sample tiles kLanes at a
// time and the warp walks the tiles that a ballot keeps, in order: the
// decision is warp-uniform.
template <typename T, int TILE_S, int TILE_G, typename Block, typename GridAt,
          typename Store>
__device__ __forceinline__ void contract_pruned(
    const Block& blk, const typename Pair<T>::type* zw,
    const typename Pair<T>::type* tiles, int n, int G, T inv_h,
    const GridAt& grid_at, const Store& store) {
  static_assert(TILE_G % Block::kLanes == 0, "a run is whole lanes");
  constexpr int kGpt = TILE_G / Block::kLanes;
  const int warps = Block::kSize / Block::kLanes;
  const int warp = blk.rank() / Block::kLanes, lane = blk.lane();
  const int n_tiles = (n + TILE_S - 1) / TILE_S;
  const bool prune = inv_h > T(0);
  for (int g0 = warp * TILE_G; g0 < G; g0 += warps * TILE_G) {
    T gv[kGpt], sum[kGpt];
    T lo = largest<T>(), hi = -largest<T>();
#pragma unroll
    for (int k = 0; k < kGpt; ++k) {
      const int idx = g0 + k * Block::kLanes + lane;
      gv[k] = grid_at(idx < G ? idx : G - 1);
      sum[k] = T(0);
      if (idx < G) {
        if (finite(gv[k])) {
          lo = dmin(lo, gv[k]);
          hi = dmax(hi, gv[k]);
        } else {
          lo = -largest<T>();
          hi = largest<T>();
        }
      }
    }
    blk.warp_minmax(lo, hi);
    for (int t0 = 0; t0 < n_tiles; t0 += Block::kLanes) {
      bool keep = false;
      if (t0 + lane < n_tiles) {
        const typename Pair<T>::type b = tiles[t0 + lane];
        keep = !(prune && ((lo - b.y) * inv_h >= T(1)
                           || (hi - b.x) * inv_h <= T(-1)));
        blk.tile(!keep);
      }
      for (unsigned m = blk.ballot(keep); m != 0u; m &= m - 1u) {
        const int t = t0 + __ffs((int)m) - 1;
        const int s1 = (t + 1) * TILE_S < n ? (t + 1) * TILE_S : n;
#pragma unroll 4
        for (int s = t * TILE_S; s < s1; ++s) {
          const typename Pair<T>::type p = zw[s];
#pragma unroll
          for (int k = 0; k < kGpt; ++k)
            sum[k] += p.y * kernel_shape<T, 0>((gv[k] - p.x) * inv_h);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kGpt; ++k) {
      const int idx = g0 + k * Block::kLanes + lane;
      if (idx < G) store(idx, sum[k]);
    }
  }
}

// K1d's Epanechnikov densities of a row with stats st on its linear grid
// lo + delta g over the given (lo, ub), the expression of contract's
// grid_at in fused_row: out[g] = scale * contract_pruned's sum, the row's
// sample tiles' bounds in `tiles`, by a block or (logical_kde_kernel) a
// warp.  A row without samples has no tile to bound or walk: it stores the
// full loop's 0 * scale (NaN where its h is NaN, as every empty row's).
template <typename T, typename Block>
__device__ __forceinline__ void external_kde(const Block& blk,
                                             const RowStats<T>& st, int G,
                                             T inv_h, T scale,
                                             const typename Pair<T>::type* zw,
                                             typename Pair<T>::type* tiles,
                                             T* out) {
  if (st.n == 0) {
    for (int g = blk.rank(); g < G; g += Block::kSize) out[g] = T(0) * scale;
    return;
  }
  const T lo = st.lo, delta = (st.ub - st.lo) / T(G - 1);
  tile_bounds<T, kTileS, true>(blk, zw, st.n, tiles);
  contract_pruned<T, kTileS, kTileG>(
      blk, zw, tiles, st.n, G, inv_h,
      [lo, delta](int g) { return lo + delta * T(g); },
      [out, scale](int g, T sum) { out[g] = sum * scale; });
}

// sqrt of the smallest normal T: a row of less total weight has no
// unit-mass density (fused.py:459-468)
template <typename T>
__device__ __forceinline__ T sqrt_tiny() {
  if constexpr (sizeof(T) == 4) return T(1.0842021724855044e-19);
  else return T(1.4916681462400413e-154);
}

// Mode (e): r[0] += sum_g den[g] s1[g] f1[g], r[1] likewise with s2, f2,
// for den[g] = sum_{s < n} w_s K((grid[g] - z_s) inv_h) (the kernel
// shape; the caller applies the row's scale).  Each thread holds GPT grid
// points in registers as contract_tiles does and folds its densities into
// its two partial sums at once: no density leaves the registers.
template <typename T, int KERNEL, int GPT, typename Block>
__device__ __forceinline__ void contract_epilogue_tiles(
    const Block& blk, const typename Pair<T>::type* zw, int n, int G,
    T inv_h, const T* grid, const T* s1, const T* s2, const T* f1,
    const T* f2, T (&r)[2]) {
  for (int g0 = 0; g0 < G; g0 += Block::kSize * GPT) {
    T gv[GPT], sum[GPT];
#pragma unroll
    for (int k = 0; k < GPT; ++k) {
      const int idx = g0 + k * Block::kSize + blk.rank();
      gv[k] = grid[idx < G ? idx : G - 1];
      sum[k] = T(0);
    }
#pragma unroll 4
    for (int s = 0; s < n; ++s) {
      const typename Pair<T>::type p = zw[s];
#pragma unroll
      for (int k = 0; k < GPT; ++k)
        sum[k] += p.y * kernel_shape<T, KERNEL>((gv[k] - p.x) * inv_h);
    }
#pragma unroll
    for (int k = 0; k < GPT; ++k) {
      const int idx = g0 + k * Block::kSize + blk.rank();
      if (idx < G) {
        r[0] += sum[k] * s1[idx] * f1[idx];
        r[1] += sum[k] * s2[idx] * f2[idx];
      }
    }
  }
}

// One (lambda, row) of the fused pass: phase A, the stats (lo, ub, norms,
// neff, h, sum w, sum w^2, sigma_z), then the KDE on the mode's grid with
// den_scale 'norms' (1 / (h S_l)) or 'unit' (1 / (h sum w)); in mode (e)
// the unit-mass KDE contracted in the block, r = (r1, r2) of the row, 0
// exactly where the row's weight is below sqrt(tiny).  On the analysis
// grids (K1a; K1e's, contracted), on the effective grid (K1b: the row's
// sorted linear grid lo + delta g, computed as contract computes it) and on
// the given bounds (K1d, external_kde: the same linear grid; an empty
// logical row skips its sums and tiles) the Epanechnikov KDE takes the
// pruned pair loop (contract_pruned, its sample tiles' bounds in `tiles`,
// ceil(S / kTileS) pairs) unless PRUNE is false (the host emulation's
// oracle); the Gaussian kernel keeps contract.
template <typename T, typename S, int KERNEL, int MODE, bool PRUNE = true,
          typename Block>
__device__ __forceinline__ void fused_row(const Block& blk,
                                          const Model<T, S>& model,
                                          const FusedArgs<T>& a, int l, int b,
                                          typename Pair<T>::type* zw,
                                          typename Pair<T>::type* tiles) {
  const RowStats<T> st = row_stats<T, S, MODE>(blk, model, a, l, b, zw);
  const size_t out_row = (size_t)l * a.B + b;
  if (blk.rank() == 0) write_stats(st, a, out_row);
  if (MODE == kStatsOnly) return;
  const T inv_h = T(1) / st.h;
  if (MODE == kContract) {
    // every thread holds the same block sums: the branch is block-uniform
    T r[2] = {T(0), T(0)};
    if (st.sum_w > sqrt_tiny<T>()) {
      const T* grid = a.grids + (size_t)b * a.G;
      const size_t fr = ((size_t)l * (a.B / a.npix) + b / a.npix) * a.G;
      const T* s1 = a.s1 + (size_t)b * a.G;
      const T* s2 = a.s2 + (size_t)b * a.G;
      if (KERNEL == 0 && PRUNE) {
        // contract_pruned hands thread `rank` the grid points rank + kSize
        // j, j ascending, a run of kTileG a warp, a point a lane (every
        // point in order in a block of one thread): the sequence that
        // contract_epilogue_tiles folds into its r, so r1, r2 and their
        // block sum keep its bits.  Another tile or block width would
        // change that order.
        static_assert(Block::kSize == 1
                      || kTileG * (Block::kSize / Block::kLanes) == Block::kSize,
                      "a thread's grid points are rank + kSize j");
        const T* f1 = a.f1 + fr;
        const T* f2 = a.f2 + fr;
        tile_bounds<T, kTileS, true>(blk, zw, st.n, tiles);
        contract_pruned<T, kTileS, kTileG>(
            blk, zw, tiles, st.n, a.G, inv_h, [grid](int g) { return grid[g]; },
            [&r, s1, s2, f1, f2](int g, T sum) {
              r[0] += sum * s1[g] * f1[g];
              r[1] += sum * s2[g] * f2[g];
            });
      } else if (a.G <= 2 * Block::kSize)
        contract_epilogue_tiles<T, KERNEL, 2>(blk, zw, st.n, a.G, inv_h, grid,
                                              s1, s2, a.f1 + fr, a.f2 + fr, r);
      else
        contract_epilogue_tiles<T, KERNEL, 4>(blk, zw, st.n, a.G, inv_h, grid,
                                              s1, s2, a.f1 + fr, a.f2 + fr, r);
      blk.template sum<2>(r);
      const T scale = kernel_norm<T, KERNEL>() * inv_h / st.sum_w;
      r[0] *= scale;
      r[1] *= scale;
    }
    if (blk.rank() == 0) {
      a.den[out_row * 2] = r[0];
      a.den[out_row * 2 + 1] = r[1];
    }
    return;
  }
  const T scale = kernel_norm<T, KERNEL>() * inv_h
                  / (a.unit_scale ? st.sum_w : st.sl);
  T* out = a.den + out_row * a.G;
  if (MODE == kAnalysisGrid) {
    const T* grid = a.grids + (size_t)b * a.G;
    if (KERNEL == 0 && PRUNE) {
      tile_bounds<T, kTileS, true>(blk, zw, st.n, tiles);
      contract_pruned<T, kTileS, kTileG>(
          blk, zw, tiles, st.n, a.G, inv_h, [grid](int g) { return grid[g]; },
          [out, scale](int g, T sum) { out[g] = sum * scale; });
    } else {
      contract<T, KERNEL>(blk, zw, st.n, a.G, inv_h, scale,
                          [grid](int g) { return grid[g]; }, out);
    }
  } else {
    const T lo = st.lo, delta = (st.ub - st.lo) / T(a.G - 1);
    const auto grid_at = [lo, delta](int g) { return lo + delta * T(g); };
    if (MODE == kEffectiveGrid && KERNEL == 0 && PRUNE) {
      tile_bounds<T, kTileS, true>(blk, zw, st.n, tiles);
      contract_pruned<T, kTileS, kTileG>(
          blk, zw, tiles, st.n, a.G, inv_h, grid_at,
          [out, scale](int g, T sum) { out[g] = sum * scale; });
    } else if (MODE == kExternalBounds && KERNEL == 0 && PRUNE) {
      external_kde(blk, st, a.G, inv_h, scale, zw, tiles, out);
    } else {
      contract<T, KERNEL>(blk, zw, st.n, a.G, inv_h, scale, grid_at, out);
    }
  }
}

// bins a tile of K4's pruned pair loop (_K4_TILE in ops/cuda/fused.py
// sizes their bounds' shared memory); tiles narrower than a warp take a
// thread a tile for their bounds
constexpr int kK4Tile = 32;

// K4, one row: out[g] = sum_s w_s K((grid_g - z_s) / h) / h with the
// row's (z, w) pairs in zw (kde1d_core).  With PRUNE (the default for the
// Epanechnikov kernel; the host emulation's oracle takes it off) the pair
// loop is contract_pruned over tiles of kK4Tile bins, their bounds over
// the bins with weight in `tiles` (ceil(S / kK4Tile) pairs): the binned
// path's bins are a histogram's sorted centres and its grid a sorted
// linear one, so a run of kTileG grid points meets few tiles, and a row
// without weight (an empty pixel) none.  Every density keeps the bits of
// contract's; the Gaussian kernel keeps contract.
template <typename T, int KERNEL, bool PRUNE = KERNEL == 0, typename Block>
__device__ __forceinline__ void kde_row(const Block& blk,
                                        const typename Pair<T>::type* zw,
                                        int S, const T* grid, int G, T h,
                                        T* out, typename Pair<T>::type* tiles) {
  static_assert(!PRUNE || KERNEL == 0, "only Epanechnikov terms are pruned");
  const T inv_h = T(1) / h;
  const T scale = kernel_norm<T, KERNEL>() * inv_h;
  const auto grid_at = [grid](int g) { return grid[g]; };
  if constexpr (PRUNE) {
    if constexpr (kK4Tile % 32 == 0)
      tile_bounds<T, kK4Tile, true>(blk, zw, S, tiles);
    else
      thread_tile_bounds<T, kK4Tile, true>(blk, zw, S, tiles);
    contract_pruned<T, kK4Tile, kTileG>(
        blk, zw, tiles, S, G, inv_h, grid_at,
        [out, scale](int g, T sum) { out[g] = sum * scale; });
  } else {
    contract<T, KERNEL>(blk, zw, S, G, inv_h, scale, grid_at, out);
  }
}

// The kernel's shape k (as kernel_shape) and the factor f of its slope,
// K'(u) = -kernel_slope_norm() u f: Epanechnikov f = 1 on the closed
// support |u| <= 1 (kde1d_core's select form, whose slope at |u| = 1 is
// all of -1.5 u), 0 outside; Gaussian f = k = exp(-u^2 / 2).
template <typename T, int KERNEL>
__device__ __forceinline__ void shape_and_slope(T u, T& k, T& f) {
  if (KERNEL == 0) {
    k = dmax(T(1) - u * u, T(0));
    f = dabs(u) <= T(1) ? T(1) : T(0);
  } else {
    k = dexp(T(-0.5) * u * u);
    f = k;
  }
}

// 1.5 (Epanechnikov: d/du 0.75 (1 - u^2) = -1.5 u), 1/sqrt(2 pi) (Gaussian)
template <typename T, int KERNEL>
__device__ __forceinline__ T kernel_slope_norm() {
  return KERNEL == 0 ? T(1.5) : T(0.39894228040143267794);
}

// bins and grid points a tile of K4b's pruned sweeps (_K4B_TILE in
// ops/cuda/fused.py sizes their bounds' shared memory; tiles of 8 took
// longer on an H100, PERF.md)
constexpr int kK4bTile = 16;

// K4b, one row: the cotangents of kde_row's out given d_out, with
// u = (grid_g - z_s) / h, K(u) = norm k, K'(u) = -slope u f:
//
//   d_w[s]    = (norm / h)     sum_g d_out[g] k
//   d_z[s]    = (slope / h^2)  w_s sum_g d_out[g] u f
//   d_grid[g] = -(slope / h^2) d_out[g] sum_s w_s u f
//   d_h       = sum_g d_out[g] ((slope / h^2) sum_s w_s u^2 f - out[g] / h)
//
// zw holds the row's (z, w) pairs, gd its (grid, d_out) pairs, both in the
// arithmetic type A (double: the sum of d_z over the grid cancels to a small
// part of its terms where a smooth cotangent spans a sample's support, and a
// float32 sum misses the float64 one by several 1e-3 of its row's largest
// entry on the binned main path, chip_smoke.py phase 24); the outputs are
// rounded to the working type T once.  A
// sample-major sweep (a thread per sample) gives d_w and d_z, a grid-major
// sweep (a thread per grid point) d_grid and the block-summed d_h.
//
// With PRUNE (the default for the Epanechnikov kernel; the host emulation's
// oracle takes it off) each sweep walks its inputs in tiles of kK4bTile
// (walk_tiles) and skips the tiles whose corners give every u > 1, or
// every u < -1, within max_u (outside_support): there f is 0 and k is +0
// (1 - u^2 < 0, u^2 finite), so d_out k, d_out u f, w u f and w u f u are
// +-0 wherever |d_out u| and |w u| are finite, and leave the sums, which
// start at +0, as they were.  The tiles' bounds (zt over the bins, gt over
// the grid points, thread_tile_bounds) are spoiled by a non-finite z or
// grid point, or a w or d_out that is not finite or is above max_u in size
// (an infinite d_out times 0 is NaN; |w u| <= max_u^2 is finite).  At
// |u| = 1 f is 1: the test is strict.  A non-finite z or grid point, a
// NaN h or one that is not positive, prunes nothing.  Every output keeps
// the bits of the full loops; the Gaussian kernel keeps them (none of its
// terms is exactly zero).
template <typename A, int KERNEL, bool PRUNE = KERNEL == 0, typename Block,
          typename T>
__device__ __forceinline__ void kde_row_adjoint(
    const Block& blk, const typename Pair<A>::type* zw, int S,
    const typename Pair<A>::type* gd, int G, const T* out, A h, T* d_z,
    T* d_w, T* d_grid, T* d_h, typename Pair<A>::type* zt,
    typename Pair<A>::type* gt) {
  static_assert(!PRUNE || KERNEL == 0, "only Epanechnikov terms are pruned");
  using A2 = typename Pair<A>::type;
  const A inv_h = A(1) / h;
  const A c_w = kernel_norm<A, KERNEL>() * inv_h;
  const A c_s = kernel_slope_norm<A, KERNEL>() * inv_h * inv_h;
  const bool prune = PRUNE && inv_h > A(0);
  if constexpr (PRUNE) {
    thread_tile_bounds<A, kK4bTile>(blk, zw, S, zt);
    thread_tile_bounds<A, kK4bTile>(blk, gd, G, gt);
  }
  for (int s = blk.rank(); s < S; s += Block::kSize) {
    const A2 p = zw[s];
    A a0 = A(0), a1 = A(0);
    if constexpr (PRUNE) {
      walk_tiles<kK4bTile>(
          blk, G, prune,
          [&](int t) {
            return outside_support((gt[t].x - p.x) * inv_h,
                                   (gt[t].y - p.x) * inv_h);
          },
          [&](int g0, int g1) {
#pragma unroll 4
            for (int g = g0; g < g1; ++g) {
              const A2 q = gd[g];
              const A u = (q.x - p.x) * inv_h;
              A k, f;
              shape_and_slope<A, KERNEL>(u, k, f);
              a0 += q.y * k;
              a1 += q.y * u * f;
            }
          });
    } else {
#pragma unroll 4
      for (int g = 0; g < G; ++g) {
        const A2 q = gd[g];
        const A u = (q.x - p.x) * inv_h;
        A k, f;
        shape_and_slope<A, KERNEL>(u, k, f);
        a0 += q.y * k;
        a1 += q.y * u * f;
      }
    }
    d_w[s] = T(c_w * a0);
    d_z[s] = T(c_s * p.y * a1);
  }
  A acc[1] = {A(0)};
  for (int g = blk.rank(); g < G; g += Block::kSize) {
    const A2 q = gd[g];
    A b0 = A(0), b1 = A(0);
    if constexpr (PRUNE) {
      walk_tiles<kK4bTile>(
          blk, S, prune,
          [&](int t) {
            return outside_support((q.x - zt[t].y) * inv_h,
                                   (q.x - zt[t].x) * inv_h);
          },
          [&](int s0, int s1) {
#pragma unroll 4
            for (int s = s0; s < s1; ++s) {
              const A2 p = zw[s];
              const A u = (q.x - p.x) * inv_h;
              A k, f;
              shape_and_slope<A, KERNEL>(u, k, f);
              const A wuf = p.y * u * f;
              b0 += wuf;
              b1 += wuf * u;
            }
          });
    } else {
#pragma unroll 4
      for (int s = 0; s < S; ++s) {
        const A2 p = zw[s];
        const A u = (q.x - p.x) * inv_h;
        A k, f;
        shape_and_slope<A, KERNEL>(u, k, f);
        const A wuf = p.y * u * f;
        b0 += wuf;
        b1 += wuf * u;
      }
    }
    d_grid[g] = T(-c_s * q.y * b0);
    acc[0] += q.y * (c_s * b1 - inv_h * A(out[g]));
  }
  blk.template sum<1>(acc);
  if (blk.rank() == 0) *d_h = T(acc[0]);
}

}  // namespace
