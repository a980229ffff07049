// Adjoint of the fused weights+KDE pass (K3): replaces
// chimera_tpu/ops/pallas/fused.py::_adjoint_kernel in the mode the samplers
// run -- analysis grids (grid_mode='input'), den_scale='norms', no
// logical-row correction, Epanechnikov or Gaussian.  Semantics:
// fused.py:713-966; the plain PyTorch twin is
// chimera_tpu_torch/ops/cuda/fused.py::fused_weights_kde_adjoint_plain
// (autograd through fused_weights_kde_plain).  The per-sample and per-row
// derivative pieces are in adjoint.cuh, the device model in population.cuh.
//
// Given the cotangents cd (L, E, G) of the densities and cs (L, E, 8) of the
// row statistics, it returns the gradients of the two packed per-lambda
// rows (pack_params): d_series (L, cheb_deg + 2 + window_deg) and d_params
// (L, 12), summed over events.  The PE data and the grids get no gradient.
//
// One thread block per (lambda, event), lambda fastest, as in K1a:
//
//   phase A  recompute z_s, w_s into shared memory; the row statistics in
//            their safe-math form (variance floored at sqrt(tiny), N_eff
//            clamped to [1, S]): a dead row with zero cotangents then adds
//            exact zeros instead of 0 * NaN.
//   phase B  the KDE adjoint, one sample per thread and kSamplesPerThread
//            samples in registers, streamed over the grid points held in
//            shared memory as (g, c1 = cd / (h S)) pairs:
//              dw_s = sum_g c1 K(u),  dz_s = -(w_s / h) sum_g c1 K'(u),
//              dh   = -(1 / h) sum_s w_s (dw_s + sum_g c1 K'(u) u)
//            (fused.py:877-892, 920-921, with sum_g cd r_g / S rewritten as
//            h sum_s w_s dw_s: no (G,) density is needed).
//   phase C  the chain through the row statistics (RowAdjoint) adds
//            cz (z_s - mean) to dz_s and d_sw + 2 w_s d_sw2 to dw_s.
//   phase D  per sample, the chain through z(dL | cosmo) and
//            w(m1, m2, z | mass) to the packed rows (SampleAdjoint): the
//            mass model on dual numbers, the two Chebyshev series by their
//            T_k projections; per-thread accumulators, then a fixed-order
//            block sum into this block's row of `partials` (L, E, P).
//
// A second kernel sums `partials` over the events in event order, in
// double: no atomics anywhere, so equal inputs give equal bits and an HMC
// chain repeats under a fixed generator.
//
// What bounds it on an H100: arithmetic.  Phase B evaluates L*E*G*S pair
// terms, ~11 FP32 operations each against K1a's 7; phases A and D add the
// two Clenshaw recurrences (value, derivative and projection) and the mass
// model on 14-direction duals per sample, about a third of phase B's work at
// G = 500.  The kernel reads the (E, S) PE rows and the (L, E, G)
// cotangents once and writes (L, E, P) partials.
//
// What the design does about it: z, w, dz and dw of the block's event stay
// in shared memory (4 S values: 64 KB in float32 at S = 4096), the grid
// loop feeds kSamplesPerThread samples per shared-memory load, and the
// kernel-shape constants are applied once per sample.  Later work: prune
// the grid loop to the kernel support of the dL-sorted samples, and tile
// phase D's dual arithmetic (it spills registers).

#include "adjoint.cuh"

namespace {

constexpr int kSamplesPerThread = 4;
constexpr int kMaxP = 2 * kMaxDeg + 2 + kMassScalars;

template <typename T, int KERNEL>  // KERNEL 0: Epanechnikov, 1: Gaussian
__global__ void __launch_bounds__(kThreads)
fused_kde_adjoint_kernel(const T* __restrict__ m1det, const T* __restrict__ m2det,
                         const T* __restrict__ dl, const T* __restrict__ inv_prior,
                         const T* __restrict__ grids,
                         const double* __restrict__ series,
                         const T* __restrict__ params,
                         const T* __restrict__ ct_den,
                         const T* __restrict__ ct_stats,
                         double* __restrict__ partials, int L, int E, int S,
                         int G, int cheb_deg, int window_deg, int bw_mode,
                         T bw_value) {
  using T2 = typename Pair<T>::type;
  using N = Dual<T, kDirs>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* zs = reinterpret_cast<T*>(smem);          // z, w, dz, dw of every sample
  T* ws = zs + S;
  T* dzs = ws + S;
  T* dws = dzs + S;
  T2* gc = reinterpret_cast<T2*>(dws + S);     // G (grid point, c1) pairs
  T* prm = reinterpret_cast<T*>(gc + G);       // this lambda's mass scalars
  T* ser = prm + kMassScalars;                 // Chebyshev series, summed in T
  __shared__ T scratch[3][kWarps];
  __shared__ T red[kWarps][kMaxP];
  __shared__ MassModel<N> dual_mass;

  const int l = blockIdx.x % L;
  const int e = blockIdx.x / L;
  const int tid = threadIdx.x;
  const int Q = cheb_deg + 2 + window_deg;
  for (int i = tid; i < Q; i += kThreads) ser[i] = T(series[(size_t)l * Q + i]);
  for (int i = tid; i < kMassScalars; i += kThreads)
    prm[i] = params[(size_t)l * kMassScalars + i];
  __syncthreads();
  if (tid == 0) SampleAdjoint<T>::seed_mass(dual_mass, prm);
  const Model<T, T> model(ser, prm, cheb_deg, window_deg);

  // ---- phase A: source frame, weights, row statistics --------------------
  const size_t row = (size_t)e * S;
  T acc[3] = {T(0), T(0), T(0)};  // sum w, sum w^2, sum z
  for (int s = tid; s < S; s += kThreads) {
    const T z = model.z_from_dgw(dl[row + s]);
    const T inv1pz = T(1) / (T(1) + z);
    const T w = model.p_m1m2(m1det[row + s] * inv1pz, m2det[row + s] * inv1pz)
                * inv_prior[row + s];
    zs[s] = z;
    ws[s] = w;
    acc[0] += w;
    acc[1] += w * w;
    acc[2] += z;
  }
  block_sum<T, 3>(acc, scratch);
  const T z_mean = acc[2] / T(S);
  T ss[1] = {T(0)};
  for (int s = tid; s < S; s += kThreads) {
    const T d = zs[s] - z_mean;
    ss[0] += d * d;
  }
  block_sum<T, 1>(ss, scratch);
  const RowAdjoint<T> stats(acc[0], acc[1], z_mean, ss[0] / T(S), S, bw_mode,
                            bw_value);
  const T inv_h = T(1) / stats.h;

  // ---- phase B: the KDE adjoint, streamed over the grid -------------------
  const size_t out_row = (size_t)l * E + e;
  {
    const T* grid = grids + (size_t)e * G;
    const T* cd = ct_den + out_row * G;
    const T c_scale = inv_h / T(S);
    for (int g = tid; g < G; g += kThreads) {
      T2 p;
      p.x = grid[g];
      p.y = cd[g] * c_scale;
      gc[g] = p;
    }
  }
  __syncthreads();
  T kde[2] = {T(0), T(0)};  // sum w dw, sum w sum_g c1 K'(u) u
  for (int s0 = 0; s0 < S; s0 += kThreads * kSamplesPerThread) {
    T zv[kSamplesPerThread], a0[kSamplesPerThread], a1[kSamplesPerThread],
        a2[kSamplesPerThread];
#pragma unroll
    for (int j = 0; j < kSamplesPerThread; ++j) {
      const int idx = s0 + j * kThreads + tid;
      zv[j] = zs[idx < S ? idx : S - 1];
      a0[j] = a1[j] = a2[j] = T(0);
    }
#pragma unroll 2
    for (int g = 0; g < G; ++g) {
      const T2 p = gc[g];
#pragma unroll
      for (int j = 0; j < kSamplesPerThread; ++j)
        kde_pair<T, KERNEL>((p.x - zv[j]) * inv_h, p.y, a0[j], a1[j], a2[j]);
    }
#pragma unroll
    for (int j = 0; j < kSamplesPerThread; ++j) {
      const int idx = s0 + j * kThreads + tid;
      if (idx < S) {
        const T w = ws[idx];
        T dw, dz, wb;
        kde_sample<T, KERNEL>(a0[j], a1[j], a2[j], w, inv_h, dw, dz, wb);
        dws[idx] = dw;
        dzs[idx] = dz;
        kde[0] += w * dw;
        kde[1] += wb;
      }
    }
  }
  block_sum<T, 2>(kde, scratch);

  // ---- phase C: the chain through the row statistics ----------------------
  T cz, d_sw, d_sw2;
  stats.backward(ct_stats + out_row * 8, -inv_h * (kde[0] + kde[1]), cz,
                 d_sw, d_sw2);

  // ---- phase D: per sample, through z and w to the packed rows ------------
  T g_cheb[kMaxDeg], g_win[kMaxDeg], g_mass[kMassScalars];
  T g_lo = T(0), g_hi = T(0);
  for (int k = 0; k < kMaxDeg; ++k) g_cheb[k] = g_win[k] = T(0);
#pragma unroll
  for (int i = 0; i < kMassScalars; ++i) g_mass[i] = T(0);
  const SampleAdjoint<T> sample(ser, cheb_deg, window_deg);
  for (int s = tid; s < S; s += kThreads) {
    const T w = ws[s];
    sample.add(dual_mass, m1det[row + s], m2det[row + s], dl[row + s],
               inv_prior[row + s], dzs[s] + cz * (zs[s] - z_mean),
               dws[s] + d_sw + T(2) * w * d_sw2, g_cheb, g_lo, g_hi, g_win,
               g_mass);
  }

  // fixed-order block sum of the P per-thread accumulators, laid out as the
  // packed rows: cheb_logh, dgw_lo, dgw_max, window, mass scalars
  const int P = Q + kMassScalars;
  const int warp = tid / 32, lane = tid % 32;
  for (int i = 0; i < P; ++i) {
    T v;
    if (i < cheb_deg) v = g_cheb[i];
    else if (i == cheb_deg) v = g_lo;
    else if (i == cheb_deg + 1) v = g_hi;
    else if (i < Q) v = g_win[i - cheb_deg - 2];
    else v = g_mass[i - Q];
    v = warp_sum(v);
    if (lane == 0) red[warp][i] = v;
  }
  __syncthreads();
  for (int i = tid; i < P; i += kThreads) {
    T t = T(0);
    for (int w = 0; w < kWarps; ++w) t += red[w][i];
    partials[out_row * P + i] = double(t);
  }
}

// Sum the per-event partials (L, E, P) over the events in event order and
// split the row into d_series (L, Q) and d_params (L, 12).  One block per
// lambda, one thread per column.
template <typename T>
__global__ void reduce_events_kernel(const double* __restrict__ partials,
                                     double* __restrict__ d_series,
                                     T* __restrict__ d_params, int E, int Q) {
  const int P = Q + kMassScalars;
  const int l = blockIdx.x;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const double* col = partials + (size_t)l * E * P + i;
    double t = 0.0;
#pragma unroll 8
    for (int e = 0; e < E; ++e) t += col[(size_t)e * P];
    if (i < Q) d_series[(size_t)l * Q + i] = t;
    else d_params[(size_t)l * kMassScalars + (i - Q)] = T(t);
  }
}

template <typename T, int KERNEL>
int launch_kernel(const T* m1, const T* m2, const T* dl, const T* invp,
                  const T* grids, const double* series, const T* params,
                  const T* ct_den, const T* ct_stats, double* partials,
                  double* d_series, T* d_params, int L, int E, int S, int G,
                  int cheb_deg, int window_deg, int bw_mode, double bw_value,
                  cudaStream_t stream) {
  const size_t smem = series_bytes<T>(cheb_deg, window_deg)
                      + ((size_t)4 * S + 2 * G + kMassScalars) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      fused_kde_adjoint_kernel<T, KERNEL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)L * (unsigned)E);
  fused_kde_adjoint_kernel<T, KERNEL><<<grid, kThreads, smem, stream>>>(
      m1, m2, dl, invp, grids, series, params, ct_den, ct_stats, partials, L,
      E, S, G, cheb_deg, window_deg, bw_mode, (T)bw_value);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_events_kernel<T><<<L, 160, 0, stream>>>(
      partials, d_series, d_params, E, cheb_deg + 2 + window_deg);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* m1, const T* m2, const T* dl, const T* invp,
           const T* grids, const double* series, const T* params,
           const T* ct_den, const T* ct_stats, double* partials,
           double* d_series, T* d_params, int L, int E, int S, int G,
           int cheb_deg, int window_deg, int kernel, int bw_mode,
           double bw_value, void* stream) {
  if (L <= 0 || E <= 0 || S <= 0 || G <= 0 || cheb_deg < 1 || window_deg < 1
      || cheb_deg > kMaxDeg || window_deg > kMaxDeg)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (kernel == 0)
    return launch_kernel<T, 0>(m1, m2, dl, invp, grids, series, params, ct_den,
                               ct_stats, partials, d_series, d_params, L, E, S,
                               G, cheb_deg, window_deg, bw_mode, bw_value, s);
  return launch_kernel<T, 1>(m1, m2, dl, invp, grids, series, params, ct_den,
                             ct_stats, partials, d_series, d_params, L, E, S,
                             G, cheb_deg, window_deg, bw_mode, bw_value, s);
}

}  // namespace

// C interface (loaded with ctypes by chimera_tpu_torch/ops/cuda/fused.py).
// Returns the CUDA error code of the launches (0 = cudaSuccess).
extern "C" int chimera_fused_kde_adjoint_f32(
    const float* m1, const float* m2, const float* dl, const float* invp,
    const float* grids, const double* series, const float* params,
    const float* ct_den, const float* ct_stats, double* partials,
    double* d_series, float* d_params, int L, int E, int S, int G,
    int cheb_deg, int window_deg, int kernel, int bw_mode, double bw_value,
    void* stream) {
  return launch<float>(m1, m2, dl, invp, grids, series, params, ct_den,
                       ct_stats, partials, d_series, d_params, L, E, S, G,
                       cheb_deg, window_deg, kernel, bw_mode, bw_value, stream);
}

extern "C" int chimera_fused_kde_adjoint_f64(
    const double* m1, const double* m2, const double* dl, const double* invp,
    const double* grids, const double* series, const double* params,
    const double* ct_den, const double* ct_stats, double* partials,
    double* d_series, double* d_params, int L, int E, int S, int G,
    int cheb_deg, int window_deg, int kernel, int bw_mode, double bw_value,
    void* stream) {
  return launch<double>(m1, m2, dl, invp, grids, series, params, ct_den,
                        ct_stats, partials, d_series, d_params, L, E, S, G,
                        cheb_deg, window_deg, kernel, bw_mode, bw_value, stream);
}
