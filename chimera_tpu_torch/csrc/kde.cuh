// The arithmetic of the fused weights+KDE pass (fused_kde.cu, K1 in its
// four modes) and of the batched 1-D KDE (kde1d.cu, K4), written once for
// a block of threads.  A `Block` gives the thread's rank, the stride
// (kSize) and the block-wide sums: DeviceBlock (population.cuh) is a CUDA
// block of kThreads threads; the host emulation (tests/host_emulation/fused_host.cpp) runs
// the same functions serially with a block of one thread.
//
// Semantics: chimera_tpu/ops/pallas/fused.py:71-219 (_fused_kernel) and
// :372-482 (_reference_impl); chimera_tpu/ops/kde.py:94-102 (kde1d_core).
// The plain PyTorch versions are ops/cuda/fused.py::fused_weights_kde_plain
// and ops/cuda/kde.py::kde1d_grid_plain.

#pragma once

#include "population.cuh"

namespace {

// Where the fused pass's KDE grid comes from (fused.py:147-168), or none.
enum FusedMode {
  kAnalysisGrid = 0,    // (a) the (B, G) grids given
  kEffectiveGrid = 1,   // (b) linspace over [z_min - c sigma, z_max + c sigma]
  kExternalBounds = 2,  // (d) linspace over the given (lo, ub) of (l, b)
  kStatsOnly = 3,       // (c) no KDE
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
  T* den;                     // (L, B, G), not in mode (c)
  T* stats;                   // (L, B, 8)
  int L, B, S, G, cheb_deg, window_deg, logical_s, bw_mode, unit_scale;
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
  blk.template sum<3>(acc);
  if (MODE == kEffectiveGrid || MODE == kStatsOnly) blk.minmax(z_lo, z_hi);
  const T f_log = st.sl - T(st.n);  // logical fillers (0 on a plain row)
  const T z_mean = (acc[2] + f_log * zf) / st.sl;
  T ss[1] = {T(0)};
  for (int s = blk.rank(); s < st.n; s += Block::kSize) {
    const T d = zw[s].x - z_mean;
    ss[0] += d * d;
  }
  blk.template sum<1>(ss);
  const T dz = zf - z_mean;
  st.z_sig = dsqrt((ss[0] + f_log * dz * dz) / st.sl);
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

// One (lambda, row) of the fused pass: phase A, the stats (lo, ub, norms,
// neff, h, sum w, sum w^2, sigma_z), then the KDE on the mode's grid with
// den_scale 'norms' (1 / (h S_l)) or 'unit' (1 / (h sum w)).
template <typename T, typename S, int KERNEL, int MODE, typename Block>
__device__ __forceinline__ void fused_row(const Block& blk,
                                          const Model<T, S>& model,
                                          const FusedArgs<T>& a, int l, int b,
                                          typename Pair<T>::type* zw) {
  const RowStats<T> st = row_stats<T, S, MODE>(blk, model, a, l, b, zw);
  const size_t out_row = (size_t)l * a.B + b;
  if (blk.rank() == 0) {
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
  if (MODE == kStatsOnly) return;
  const T inv_h = T(1) / st.h;
  const T scale = kernel_norm<T, KERNEL>() * inv_h
                  / (a.unit_scale ? st.sum_w : st.sl);
  T* out = a.den + out_row * a.G;
  if (MODE == kAnalysisGrid) {
    const T* grid = a.grids + (size_t)b * a.G;
    contract<T, KERNEL>(blk, zw, st.n, a.G, inv_h, scale,
                        [grid](int g) { return grid[g]; }, out);
  } else {
    const T lo = st.lo, delta = (st.ub - st.lo) / T(a.G - 1);
    contract<T, KERNEL>(blk, zw, st.n, a.G, inv_h, scale,
                        [lo, delta](int g) { return lo + delta * T(g); }, out);
  }
}

// K4, one row: out[g] = sum_s w_s K((grid_g - z_s) / h) / h with the
// row's (z, w) pairs in zw (kde1d_core).
template <typename T, int KERNEL, typename Block>
__device__ __forceinline__ void kde_row(const Block& blk,
                                        const typename Pair<T>::type* zw,
                                        int S, const T* grid, int G, T h,
                                        T* out) {
  const T inv_h = T(1) / h;
  contract<T, KERNEL>(blk, zw, S, G, inv_h, kernel_norm<T, KERNEL>() * inv_h,
                      [grid](int g) { return grid[g]; }, out);
}

}  // namespace
