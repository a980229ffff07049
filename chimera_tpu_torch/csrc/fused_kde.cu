// Fused detector->source map + population weights for a batch of L
// hyper-parameter samples (lambda): two kernels that replace
// chimera_tpu/ops/pallas/fused.py::_fused_kernel in the two modes the
// port's main paths run.  Semantics: fused.py:71-219 (kernel) and
// fused.py:372-482 (_reference_impl); the plain PyTorch twin is
// chimera_tpu_torch/ops/cuda/fused.py::fused_weights_kde_plain.  The model
// device functions are in population.cuh.
//
// ---- K1a: fused_kde_kernel, analysis grids, den_scale='norms' -----------
// The spectral-siren hot loop.  One thread block per (lambda, event),
// lambda fastest in blockIdx.x so the blocks that read one event's PE rows
// run together and find them in L2.
//
//   phase A  z_s = z_from_dgw(cosmo_l, dL_es)     clamp + 64-term Clenshaw
//            w_s = p_m1m2(mass_l, m1/(1+z), m2/(1+z)) * inv_pe_prior
//            row stats: sum w, sum w^2, two-pass mean and variance of z,
//            Kish N_eff = (sum w)^2 / sum w^2, bandwidth h = bw(N_eff) std(z)
//   phase B  den[g] = sum_s w_s K((grid_g - z_s) / h) / (h S)
//
// What bounds it on an H100: arithmetic, not bytes.  Phase B evaluates
// L*E*G*S kernel terms -- 16 * 1000 * 500 * 4096 = 3.3e10 per batch at the
// headline shape, ~5 FP32 instructions each -- while the kernel reads the
// (E, S) PE rows (lambda-independent, L2-resident across the lambda batch)
// and writes only the (L, E, G) densities.  Phase A is ~1/10 of the work:
// two Clenshaw series and a handful of exp/log per sample.
//
// What the design does about it: every intermediate stays on chip.  z and w
// of the block's event live in shared memory as interleaved (z, w) pairs, so
// one broadcast load feeds kGridPerThread grid points held in registers; the
// kernel-shape constant (0.75, or 1/sqrt(2 pi)) and 1/(h S) are applied once
// per density, leaving sub, mul, fma, max and fma per term.  The raw row
// statistics of the TPU kernel are kept (a dead row gives NaN, which the
// caller's N_eff gate and nan_to_num remove).  The z min/max of the TPU
// kernel feed only its effective-grid mode and are not computed here.
// Later work: prune the sample loop to the kernel support (samples are
// sorted by distance, hence by z) and put the contraction on tensor cores.
//
// ---- K1c: row_stats_kernel, stats only, logical-row correction ----------
// The first pass of the dark-siren 'marginalized' path
// (chimera_tpu/likelihood.py:1048-1056): per (lambda, row) of the (E*P,
// S_pp) per-pixel rectangle (data/pixelize.py::compact_samples_by_pixel),
// the row statistics of the LOGICAL row -- the event's S samples with the
// out-of-pixel ones at the filler z_f = z(dl_fill) and zero weight
// (fused.py:111-141).  One block per (lambda, row), lambda fastest.
//
// The rectangle stores each pixel's n_real samples first and fillers at
// dl_fill with zero weight after them, so the block maps only the first
// n_real slots and adds the S - n_real logical fillers analytically:
//   mean = (sum_real z + (S - n) z_f) / S
//   var  = (sum_real (z - mean)^2 + (S - n) (z_f - mean)^2) / S
//   lo, ub = min/max(z_real, z_f) -/+ cut_grid sigma (lo floored at 1e-8)
// The same function as the TPU kernel's form, at 1/8 of the slots at the
// dark flagship (1.0 M real of 8.2 M), and with no negative filler
// coefficient (the TPU form adds (S - S_pp)(z_f - mean)^2, negative when
// S_pp > S).  No KDE: the stats feed the rows-contract kernel.
//
// What bounds it: phase A of the real samples (two Clenshaw series and the
// mass model per sample), a few hundred FP32 instructions per sample, and
// the read of the real samples once per lambda (L2-resident across lambda).
// Raw formulas as the TPU kernel: a dead pixel gives NaN in neff and h; the
// caller's guard (likelihood.py:1061) turns it into a zero scale.

#include "population.cuh"

namespace {

template <typename T, int KERNEL>  // KERNEL 0: Epanechnikov, 1: Gaussian
__global__ void __launch_bounds__(kThreads)
fused_kde_kernel(const T* __restrict__ m1det, const T* __restrict__ m2det,
                 const T* __restrict__ dl, const T* __restrict__ inv_prior,
                 const T* __restrict__ grids, const double* __restrict__ series,
                 const T* __restrict__ params, T* __restrict__ den,
                 T* __restrict__ stats, int L, int E, int S, int G,
                 int cheb_deg, int window_deg, int bw_mode, T bw_value) {
  using T2 = typename Pair<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  T2* zw = reinterpret_cast<T2*>(smem);       // S (z, w) pairs
  T* prm = reinterpret_cast<T*>(zw + S);      // this lambda's mass scalars
  T* ser = prm + kMassScalars;                // Chebyshev series, summed in T
  __shared__ T scratch[3][kWarps];

  const int l = blockIdx.x % L;
  const int e = blockIdx.x / L;
  const int tid = threadIdx.x;
  const int Q = cheb_deg + 2 + window_deg;
  for (int i = tid; i < Q; i += kThreads) ser[i] = T(series[(size_t)l * Q + i]);
  for (int i = tid; i < kMassScalars; i += kThreads)
    prm[i] = params[(size_t)l * kMassScalars + i];
  __syncthreads();
  const Model<T, T> model(ser, prm, cheb_deg, window_deg);

  // ---- phase A: source frame, weights, first-pass sums -------------------
  const size_t row = (size_t)e * S;
  T acc[3] = {T(0), T(0), T(0)};  // sum w, sum w^2, sum z
  for (int s = tid; s < S; s += kThreads) {
    const T z = model.z_from_dgw(dl[row + s]);
    const T inv1pz = T(1) / (T(1) + z);
    const T w = model.p_m1m2(m1det[row + s] * inv1pz, m2det[row + s] * inv1pz)
                * inv_prior[row + s];
    T2 p;
    p.x = z;
    p.y = w;
    zw[s] = p;
    acc[0] += w;
    acc[1] += w * w;
    acc[2] += z;
  }
  block_sum<T, 3>(acc, scratch);
  const T sum_w = acc[0], sum_w2 = acc[1];
  const T z_mean = acc[2] / T(S);
  T ss[1] = {T(0)};
  for (int s = tid; s < S; s += kThreads) {
    const T d = zw[s].x - z_mean;
    ss[0] += d * d;
  }
  block_sum<T, 1>(ss, scratch);
  const T z_sig = dsqrt(ss[0] / T(S));
  const T neff = sum_w * sum_w / sum_w2;
  const T h = bw_factor(neff, bw_mode, bw_value) * z_sig;
  const T inv_h = T(1) / h;

  const size_t out_row = (size_t)l * E + e;
  if (tid == 0) {
    T* st = stats + out_row * 8;
    st[0] = T(0);  // lo, ub: no effective grid in this mode
    st[1] = T(0);
    st[2] = sum_w / T(S);
    st[3] = neff;
    st[4] = h;
    st[5] = sum_w;
    st[6] = sum_w2;
    st[7] = z_sig;
  }

  // ---- phase B: KDE contraction on the analysis grid ---------------------
  const T scale = (KERNEL == 0 ? T(0.75) : T(0.39894228040143267794)) * inv_h / T(S);
  const T* grid = grids + (size_t)e * G;
  T* out = den + out_row * G;
  for (int g0 = 0; g0 < G; g0 += kThreads * kGridPerThread) {
    T gv[kGridPerThread], sum[kGridPerThread];
#pragma unroll
    for (int k = 0; k < kGridPerThread; ++k) {
      const int idx = g0 + k * kThreads + tid;
      gv[k] = grid[idx < G ? idx : G - 1];
      sum[k] = T(0);
    }
#pragma unroll 4
    for (int s = 0; s < S; ++s) {
      const T2 p = zw[s];
#pragma unroll
      for (int k = 0; k < kGridPerThread; ++k) {
        const T u = (gv[k] - p.x) * inv_h;
        T kern;
        if (KERNEL == 0) kern = dmax(T(1) - u * u, T(0));
        else kern = dexp(T(-0.5) * u * u);
        sum[k] += p.y * kern;
      }
    }
#pragma unroll
    for (int k = 0; k < kGridPerThread; ++k) {
      const int idx = g0 + k * kThreads + tid;
      if (idx < G) out[idx] = sum[k] * scale;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_stats_kernel(const T* __restrict__ m1det, const T* __restrict__ m2det,
                 const T* __restrict__ dl, const T* __restrict__ inv_prior,
                 const long long* __restrict__ n_real,
                 const T* __restrict__ dl_fill,
                 const double* __restrict__ series,
                 const T* __restrict__ params, T* __restrict__ stats, int L,
                 int B, int S, int cheb_deg, int window_deg,
                 int logical_s, int bw_mode, T bw_value, T cut_grid) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* ser = reinterpret_cast<double*>(smem);  // series, summed in double
  T* zs = reinterpret_cast<T*>(smem + series_bytes<double>(cheb_deg, window_deg));
  T* prm = zs + S;                            // this lambda's mass scalars
  __shared__ T scratch[3][kWarps];

  const int l = blockIdx.x % L;
  const int b = blockIdx.x / L;
  const int tid = threadIdx.x;
  const int Q = cheb_deg + 2 + window_deg;
  for (int i = tid; i < Q; i += kThreads) ser[i] = series[(size_t)l * Q + i];
  for (int i = tid; i < kMassScalars; i += kThreads)
    prm[i] = params[(size_t)l * kMassScalars + i];
  __syncthreads();
  const Model<T, double> model(ser, prm, cheb_deg, window_deg);

  const long long nr = n_real[b];
  const int n = nr < 0 ? 0 : (nr > S ? S : (int)nr);
  const T zf = model.z_from_dgw(dl_fill[b]);
  const size_t row = (size_t)b * S;
  T acc[3] = {T(0), T(0), T(0)};  // sum w, sum w^2, sum z
  T z_lo = zf, z_hi = zf;
  for (int s = tid; s < n; s += kThreads) {
    const T z = model.z_from_dgw(dl[row + s]);
    const T inv1pz = T(1) / (T(1) + z);
    const T w = model.p_m1m2(m1det[row + s] * inv1pz, m2det[row + s] * inv1pz)
                * inv_prior[row + s];
    zs[s] = z;
    acc[0] += w;
    acc[1] += w * w;
    acc[2] += z;
    z_lo = dmin(z_lo, z);
    z_hi = dmax(z_hi, z);
  }
  block_sum<T, 3>(acc, scratch);
  block_minmax(z_lo, z_hi, scratch);
  const T sl = T(logical_s);
  const T f_log = T(logical_s - n);           // logical fillers
  const T z_mean = (acc[2] + f_log * zf) / sl;
  T ss[1] = {T(0)};
  for (int s = tid; s < n; s += kThreads) {
    const T d = zs[s] - z_mean;
    ss[0] += d * d;
  }
  block_sum<T, 1>(ss, scratch);
  const T dz = zf - z_mean;
  const T z_sig = dsqrt((ss[0] + f_log * dz * dz) / sl);
  const T sum_w = acc[0], sum_w2 = acc[1];
  const T neff = sum_w * sum_w / sum_w2;
  const T h = bw_factor(neff, bw_mode, bw_value) * z_sig;
  if (tid == 0) {
    T* st = stats + ((size_t)l * B + b) * 8;
    const T lo = z_lo - cut_grid * z_sig;
    st[0] = lo > T(0) ? lo : T(1e-8);
    st[1] = z_hi + cut_grid * z_sig;
    st[2] = sum_w / sl;
    st[3] = neff;
    st[4] = h;
    st[5] = sum_w;
    st[6] = sum_w2;
    st[7] = z_sig;
  }
}

template <typename T>
int launch_row_stats(const T* m1, const T* m2, const T* dl, const T* invp,
                     const long long* n_real, const T* dl_fill,
                     const double* series, const T* params, T* stats, int L,
                     int B, int S, int cheb_deg, int window_deg,
                     int logical_s, int bw_mode, double bw_value,
                     double cut_grid, void* stream) {
  if (L <= 0 || B <= 0 || S <= 0 || logical_s <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = series_bytes<double>(cheb_deg, window_deg)
                      + ((size_t)S + kMassScalars) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      row_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)L * (unsigned)B);
  row_stats_kernel<T><<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      m1, m2, dl, invp, n_real, dl_fill, series, params, stats, L, B, S,
      cheb_deg, window_deg, logical_s, bw_mode, (T)bw_value, (T)cut_grid);
  return (int)cudaGetLastError();
}

template <typename T, int KERNEL>
int launch_kernel(const T* m1, const T* m2, const T* dl, const T* invp,
                  const T* grids, const double* series, const T* params,
                  T* den, T* stats, int L, int E, int S, int G,
                  int cheb_deg, int window_deg, int bw_mode, double bw_value,
                  cudaStream_t stream) {
  const size_t smem = series_bytes<T>(cheb_deg, window_deg)
                      + (size_t)S * sizeof(typename Pair<T>::type)
                      + kMassScalars * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      fused_kde_kernel<T, KERNEL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)L * (unsigned)E);
  fused_kde_kernel<T, KERNEL><<<grid, kThreads, smem, stream>>>(
      m1, m2, dl, invp, grids, series, params, den, stats, L, E, S, G,
      cheb_deg, window_deg, bw_mode, (T)bw_value);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* m1, const T* m2, const T* dl, const T* invp,
           const T* grids, const double* series, const T* params, T* den,
           T* stats, int L, int E, int S, int G, int cheb_deg,
           int window_deg, int kernel, int bw_mode, double bw_value,
           void* stream) {
  if (L <= 0 || E <= 0 || S <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (kernel == 0)
    return launch_kernel<T, 0>(m1, m2, dl, invp, grids, series, params, den,
                               stats, L, E, S, G, cheb_deg, window_deg,
                               bw_mode, bw_value, s);
  return launch_kernel<T, 1>(m1, m2, dl, invp, grids, series, params, den,
                             stats, L, E, S, G, cheb_deg, window_deg,
                             bw_mode, bw_value, s);
}

}  // namespace

// C interface (loaded with ctypes by chimera_tpu_torch/ops/cuda/fused.py).
// Returns the CUDA error code of the launch (0 = cudaSuccess).
extern "C" int chimera_fused_kde_f32(
    const float* m1, const float* m2, const float* dl, const float* invp,
    const float* grids, const double* series, const float* params,
    float* den, float* stats, int L, int E, int S, int G, int cheb_deg,
    int window_deg, int kernel, int bw_mode, double bw_value, void* stream) {
  return launch<float>(m1, m2, dl, invp, grids, series, params, den, stats,
                       L, E, S, G, cheb_deg, window_deg, kernel, bw_mode,
                       bw_value, stream);
}

extern "C" int chimera_fused_kde_f64(
    const double* m1, const double* m2, const double* dl, const double* invp,
    const double* grids, const double* series, const double* params,
    double* den, double* stats, int L, int E, int S, int G,
    int cheb_deg, int window_deg, int kernel, int bw_mode, double bw_value,
    void* stream) {
  return launch<double>(m1, m2, dl, invp, grids, series, params, den, stats,
                        L, E, S, G, cheb_deg, window_deg, kernel, bw_mode,
                        bw_value, stream);
}

extern "C" int chimera_row_stats_f32(
    const float* m1, const float* m2, const float* dl, const float* invp,
    const long long* n_real, const float* dl_fill, const double* series,
    const float* params, float* stats, int L, int B, int S,
    int cheb_deg, int window_deg, int logical_s, int bw_mode, double bw_value,
    double cut_grid, void* stream) {
  return launch_row_stats<float>(m1, m2, dl, invp, n_real, dl_fill, series,
                                 params, stats, L, B, S, cheb_deg,
                                 window_deg, logical_s, bw_mode, bw_value,
                                 cut_grid, stream);
}

extern "C" int chimera_row_stats_f64(
    const double* m1, const double* m2, const double* dl, const double* invp,
    const long long* n_real, const double* dl_fill, const double* series,
    const double* params, double* stats, int L, int B, int S,
    int cheb_deg, int window_deg, int logical_s, int bw_mode, double bw_value,
    double cut_grid, void* stream) {
  return launch_row_stats<double>(m1, m2, dl, invp, n_real, dl_fill, series,
                                  params, stats, L, B, S, cheb_deg,
                                  window_deg, logical_s, bw_mode, bw_value,
                                  cut_grid, stream);
}
