// Fused detector->source map + population weights + weighted KDE on the
// analysis grids, for a batch of L hyper-parameter samples (lambda).
//
// Replaces the TPU kernel chimera_tpu/ops/pallas/fused.py::_fused_kernel in
// its analysis-grid mode (cut_grid=None, den_scale='norms'), the one kernel of
// the spectral-siren main path.  Semantics: fused.py:71-219 (kernel) and
// fused.py:372-482 (_reference_impl); the plain PyTorch twin is
// chimera_tpu_torch/ops/cuda/fused.py::fused_weights_kde_plain.
//
// One thread block per (lambda, event), lambda fastest in blockIdx.x so the
// blocks that read one event's PE rows run together and find them in L2.
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

#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGridPerThread = 4;
constexpr int kMassScalars = 12;  // see MASS_SCALARS in ops/cuda/fused.py

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }
__device__ __forceinline__ float dlog1p(float x) { return log1pf(x); }
__device__ __forceinline__ double dlog1p(double x) { return log1p(x); }
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
__device__ __forceinline__ double dabs(double x) { return fabs(x); }

template <typename T>
__device__ __forceinline__ T dmax(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T dmin(T a, T b) { return a < b ? a : b; }
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) { return dmin(dmax(x, lo), hi); }
__device__ __forceinline__ bool finite(float x) { return fabsf(x) <= FLT_MAX; }
__device__ __forceinline__ bool finite(double x) { return fabs(x) <= DBL_MAX; }

// Clenshaw recurrence of sum_k c_k T_k(t), the order of ops/chebyshev.py
template <typename T>
__device__ __forceinline__ T clenshaw(const T* __restrict__ c, int n, T t) {
  const T t2 = T(2) * t;
  T b1 = T(0), b2 = T(0);
  for (int k = n - 1; k >= 1; --k) {
    const T b0 = t2 * b1 - b2 + c[k];
    b2 = b1;
    b1 = b0;
  }
  return t * b1 - b2 + c[0];
}

template <typename T>
__device__ __forceinline__ T powx(T x, T a) { return dexp(a * dlog(x)); }

template <typename T>
__device__ __forceinline__ T tpl_unnorm(T m, T alpha, T lo, T hi) {
  return (lo <= m && m <= hi) ? powx(dmax(m, T(1e-30)), alpha) : T(0);
}

template <typename T>
__device__ __forceinline__ T tpl_cdf(T alpha, T m_low, T m) {
  const T mp = dmax(m, T(1e-30));
  if (alpha == T(-1)) return dlog(m_low) - dlog(mp);
  return (powx(mp, T(1) + alpha) - powx(m_low, T(1) + alpha)) / (T(1) + alpha);
}

// LVK low-mass window; eps is 0 in float, as in the JAX package's float32
template <typename T>
__device__ __forceinline__ T smoothing(T m, T dm, T m_low) {
  if (m < m_low) return T(0);
  if (m >= m_low + dm) return T(1);
  const T eps = T(1e-99);
  const T x = dm / (m - m_low + eps) + dm / (m - m_low - dm + eps);
  const T softplus = dmax(x, T(0)) + dlog1p(dexp(-dabs(x)));
  return dexp(-softplus);
}

// One lambda's model state, read from the packed parameter row.
template <typename T>
struct Model {
  const T* cheb_logh;
  const T* window;
  int cheb_deg, window_deg;
  T dgw_lo, dgw_max, log_lo, log_hi;
  T m_low, m_high, alpha, beta, delta_m, lambda_peak, mu_g, sigma_g;
  T peak_norm, norm_p_m1, m_join, cdf_at_join;
  T pl_norm, peak_hi, log_sigma, m1_floor;

  __device__ Model(const T* prm, int cd, int wd) {
    cheb_logh = prm;
    cheb_deg = cd;
    window_deg = wd;
    dgw_lo = prm[cd];
    dgw_max = prm[cd + 1];
    const T* s = prm + cd + 2;
    m_low = s[0]; m_high = s[1]; alpha = s[2]; beta = s[3]; delta_m = s[4];
    lambda_peak = s[5]; mu_g = s[6]; sigma_g = s[7]; peak_norm = s[8];
    norm_p_m1 = s[9]; m_join = s[10]; cdf_at_join = s[11];
    window = s + kMassScalars;
    log_lo = dlog(dgw_lo);
    log_hi = dlog(dgw_max);
    pl_norm = tpl_cdf(-alpha, m_low, m_high);
    peak_hi = mu_g + T(5) * sigma_g;
    log_sigma = dlog(sigma_g);
    m1_floor = m_low * T(1.0 + 1e-9);
  }

  __device__ __forceinline__ T z_from_dgw(T dgw) const {
    const T d = clip(dgw, dgw_lo, dgw_max);
    const T t = (T(2) * dlog(d) - (log_lo + log_hi)) / (log_hi - log_lo);
    return d * dexp(clenshaw(cheb_logh, cheb_deg, t));
  }

  __device__ __forceinline__ T primary(T m) const {
    const T pl = tpl_unnorm(m, -alpha, m_low, m_high) / pl_norm;
    T peak = T(0);
    if (m_low <= m && m <= peak_hi) {
      const T dx = m - mu_g;
      // -0.5 log(2 pi) - log(sigma) - (x - mu)^2 / (2 sigma^2)
      peak = dexp(T(-0.91893853320467274178) - log_sigma
                  - dx * dx / (T(2) * (sigma_g * sigma_g))) / peak_norm;
    }
    const T pdf = (T(1) - lambda_peak) * pl + lambda_peak * peak;
    return pdf * smoothing(m, delta_m, m_low);
  }

  __device__ __forceinline__ T secondary(T m2, T m1) const {
    return tpl_unnorm(m2, beta, m_low, m1) * smoothing(m2, delta_m, m_low);
  }

  __device__ __forceinline__ T conditional_cdf(T m1) const {
    const T m1c = clip(m1, m_low, m_high);
    if (m1c <= m_join) {
      const T x = clip(m1c, m_low, m_join);
      const T t = (T(2) * x - (m_low + m_join)) / (m_join - m_low);
      return clenshaw(window, window_deg, t);
    }
    return cdf_at_join + tpl_cdf(beta, m_join, m1c);
  }

  __device__ __forceinline__ T p_m1m2(T m1, T m2) const {
    const T p1 = primary(m1) / norm_p_m1;
    T p21 = secondary(m2, m1);
    const T cdf = conditional_cdf(m1);
    const bool ok = cdf > T(0);
    p21 = p21 / (ok ? cdf : T(1));
    if (!(ok && m1 > m1_floor)) p21 = T(0);
    if (!finite(p21)) p21 = T(0);
    return p1 * p21;
  }
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sums of N values per thread, in a fixed order (deterministic);
// every thread receives the totals.
template <typename T, int N>
__device__ __forceinline__ void block_sum(T (&v)[N], T (*scratch)[kWarps]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = warp_sum(v[i]);
    if (lane == 0) scratch[i][warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T t = T(0);
    for (int w = 0; w < kWarps; ++w) t += scratch[i][w];
    v[i] = t;
  }
  __syncthreads();
}

template <typename T, int KERNEL>  // KERNEL 0: Epanechnikov, 1: Gaussian
__global__ void __launch_bounds__(kThreads)
fused_kde_kernel(const T* __restrict__ m1det, const T* __restrict__ m2det,
                 const T* __restrict__ dl, const T* __restrict__ inv_prior,
                 const T* __restrict__ grids, const T* __restrict__ params,
                 T* __restrict__ den, T* __restrict__ stats,
                 int L, int E, int S, int G, int P, int cheb_deg,
                 int window_deg, int bw_mode, T bw_value) {
  using T2 = typename Pair<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  T2* zw = reinterpret_cast<T2*>(smem);       // S (z, w) pairs
  T* prm = reinterpret_cast<T*>(zw + S);      // this lambda's P parameters
  __shared__ T scratch[3][kWarps];

  const int l = blockIdx.x % L;
  const int e = blockIdx.x / L;
  const int tid = threadIdx.x;
  for (int i = tid; i < P; i += kThreads) prm[i] = params[(size_t)l * P + i];
  __syncthreads();
  const Model<T> model(prm, cheb_deg, window_deg);

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
  T bw;
  if (bw_mode == 0) bw = dexp(T(-0.2) * dlog(neff));
  else if (bw_mode == 1) bw = dexp(T(-0.2) * dlog(neff * T(3) / T(4)));
  else bw = bw_value;
  const T h = bw * z_sig;
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

template <typename T, int KERNEL>
int launch_kernel(const T* m1, const T* m2, const T* dl, const T* invp,
                  const T* grids, const T* params, T* den, T* stats, int L,
                  int E, int S, int G, int P, int cheb_deg, int window_deg,
                  int bw_mode, double bw_value, cudaStream_t stream) {
  const size_t smem = (size_t)S * sizeof(typename Pair<T>::type)
                      + (size_t)P * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      fused_kde_kernel<T, KERNEL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)L * (unsigned)E);
  fused_kde_kernel<T, KERNEL><<<grid, kThreads, smem, stream>>>(
      m1, m2, dl, invp, grids, params, den, stats, L, E, S, G, P, cheb_deg,
      window_deg, bw_mode, (T)bw_value);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* m1, const T* m2, const T* dl, const T* invp,
           const T* grids, const T* params, T* den, T* stats, int L, int E,
           int S, int G, int P, int cheb_deg, int window_deg, int kernel,
           int bw_mode, double bw_value, void* stream) {
  if (L <= 0 || E <= 0 || S <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (kernel == 0)
    return launch_kernel<T, 0>(m1, m2, dl, invp, grids, params, den, stats, L,
                               E, S, G, P, cheb_deg, window_deg, bw_mode,
                               bw_value, s);
  return launch_kernel<T, 1>(m1, m2, dl, invp, grids, params, den, stats, L, E,
                             S, G, P, cheb_deg, window_deg, bw_mode, bw_value, s);
}

}  // namespace

// C interface (loaded with ctypes by chimera_tpu_torch/ops/cuda/fused.py).
// Returns the CUDA error code of the launch (0 = cudaSuccess).
extern "C" int chimera_fused_kde_f32(
    const float* m1, const float* m2, const float* dl, const float* invp,
    const float* grids, const float* params, float* den, float* stats, int L,
    int E, int S, int G, int P, int cheb_deg, int window_deg, int kernel,
    int bw_mode, double bw_value, void* stream) {
  return launch<float>(m1, m2, dl, invp, grids, params, den, stats, L, E, S, G,
                       P, cheb_deg, window_deg, kernel, bw_mode, bw_value,
                       stream);
}

extern "C" int chimera_fused_kde_f64(
    const double* m1, const double* m2, const double* dl, const double* invp,
    const double* grids, const double* params, double* den, double* stats,
    int L, int E, int S, int G, int P, int cheb_deg, int window_deg,
    int kernel, int bw_mode, double bw_value, void* stream) {
  return launch<double>(m1, m2, dl, invp, grids, params, den, stats, L, E, S,
                        G, P, cheb_deg, window_deg, kernel, bw_mode, bw_value,
                        stream);
}
