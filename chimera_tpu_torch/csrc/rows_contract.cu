// KDE + dark-siren epilogue contraction over dense 128-sample chunk rows,
// for a batch of L hyper-parameter samples (lambda).
//
// Replaces the TPU kernel chimera_tpu/ops/pallas/fused.py::_rows_kernel
// (fused.py:495-553, launched by _rows_pallas, pallas_call at fused.py:695),
// the second pass of the dark-siren 'marginalized' path
// (chimera_tpu/likelihood.py:1019-1089).  Semantics: _rows_reference
// (fused.py:613-640); the plain PyTorch twin is
// chimera_tpu_torch/ops/cuda/rows.py::fused_rows_contract_plain.
//
// Rows are event-major, C rows per event (data/pixelize.py::
// chunk_rows_from_compact); each row holds up to `chunk` samples of one
// pixel.  Per (lambda l, row r of event e), with hs[l, r] = (1/h, scale)
// from the stats pass:
//
//   phase A  z_s = z_from_dgw(cosmo_l, dL_rs), w_s = p_m1m2(...) inv_prior
//   phase B  den[g] = sum_s w_s K((grid_eg - z_s) / h)
//   out      r1 = scale sum_g den[g] s1[r, g] f1[l, e, g]
//            r2 = scale sum_g den[g] s2[r, g] f2[l, e, g]
//
// One thread block per (lambda, event), lambda fastest in blockIdx.x so the
// blocks that read one event's rows and static factors run together and
// find them in L2.  The block keeps the event's grid and its f1, f2 row in
// shared memory and sweeps the event's C rows: phase A puts the row's
// (z, w) pairs in shared memory, each thread holds kGridPerThread grid
// points in registers against each broadcast pair, multiplies its densities
// into s1 and s2 (read once, coalesced) and the block reduces the two sums.
//
// What bounds it on an H100: arithmetic.  Phase B is L * R * chunk * G
// kernel terms at ~5 FP32 instructions each (16 * 16 000 * 128 * 500 =
// 1.6e10 at the dark flagship) against a read of the rows and of s1, s2
// (R * G values each, L2-resident across the lambda batch).  What the design
// does about it: rows whose scale is 0 (dead pixels) or whose weights are
// all 0 (the padding rows that round each event up to C, about half of the
// rows at the flagship) are written as exact zeros without phase B, which is
// what the TPU kernel computes there; the kernel-shape constant is applied
// once per row.  Later work: prune the sample loop to the kernel support
// and put the contraction on tensor cores.

#include "population.cuh"

namespace {

template <typename T, int KERNEL>  // KERNEL 0: Epanechnikov, 1: Gaussian
__global__ void __launch_bounds__(kThreads)
rows_contract_kernel(const T* __restrict__ m1det, const T* __restrict__ m2det,
                     const T* __restrict__ dl, const T* __restrict__ inv_prior,
                     const T* __restrict__ grids,
                     const double* __restrict__ series,
                     const T* __restrict__ params,
                     const T* __restrict__ hs, const T* __restrict__ s1,
                     const T* __restrict__ s2, const T* __restrict__ f1,
                     const T* __restrict__ f2, T* __restrict__ out, int L,
                     int E, int C, int chunk, int G, int cheb_deg,
                     int window_deg) {
  using T2 = typename Pair<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  double* ser = reinterpret_cast<double*>(smem);  // series, summed in double
  T2* zw = reinterpret_cast<T2*>(smem + series_bytes<double>(cheb_deg, window_deg));
  T* grid = reinterpret_cast<T*>(zw + chunk);  // the event's G grid points
  T* f1s = grid + G;                          // f1[l, e, :]
  T* f2s = f1s + G;                           // f2[l, e, :]
  T* prm = f2s + G;                           // this lambda's mass scalars
  __shared__ T scratch[2][kWarps];

  const int l = blockIdx.x % L;
  const int e = blockIdx.x / L;
  const int tid = threadIdx.x;
  const size_t R = (size_t)E * C;
  const size_t ev = (size_t)l * E + e;
  const int Q = cheb_deg + 2 + window_deg;
  for (int i = tid; i < Q; i += kThreads) ser[i] = series[(size_t)l * Q + i];
  for (int i = tid; i < kMassScalars; i += kThreads)
    prm[i] = params[(size_t)l * kMassScalars + i];
  for (int i = tid; i < G; i += kThreads) {
    grid[i] = grids[(size_t)e * G + i];
    f1s[i] = f1[ev * G + i];
    f2s[i] = f2[ev * G + i];
  }
  __syncthreads();
  const Model<T, double> model(ser, prm, cheb_deg, window_deg);
  const T kconst = KERNEL == 0 ? T(0.75) : T(0.39894228040143267794);

  for (int c = 0; c < C; ++c) {
    const size_t row = (size_t)e * C + c;
    const size_t hrow = (size_t)l * R + row;
    const T inv_h = hs[hrow * 2];
    const T scale = hs[hrow * 2 + 1];
    T* o = out + hrow * 2;
    if (scale == T(0)) {  // dead pixel: block-uniform branch
      if (tid == 0) o[0] = o[1] = T(0);
      continue;
    }

    // ---- phase A: the row's source frame and weights -------------------
    const size_t base = row * chunk;
    int live = 0;
    for (int s = tid; s < chunk; s += kThreads) {
      const T z = model.z_from_dgw(dl[base + s]);
      const T inv1pz = T(1) / (T(1) + z);
      const T w = model.p_m1m2(m1det[base + s] * inv1pz,
                               m2det[base + s] * inv1pz) * inv_prior[base + s];
      T2 p;
      p.x = z;
      p.y = w;
      zw[s] = p;
      live |= (w != T(0));
    }
    if (!__syncthreads_or(live)) {  // zero weight everywhere: r = 0 exactly
      if (tid == 0) o[0] = o[1] = T(0);
      continue;
    }

    // ---- phase B: KDE on the event grid, contracted against s1, s2 -----
    const T* s1r = s1 + row * G;
    const T* s2r = s2 + row * G;
    T r[2] = {T(0), T(0)};
    for (int g0 = 0; g0 < G; g0 += kThreads * kGridPerThread) {
      T gv[kGridPerThread], sum[kGridPerThread];
#pragma unroll
      for (int k = 0; k < kGridPerThread; ++k) {
        const int idx = g0 + k * kThreads + tid;
        gv[k] = grid[idx < G ? idx : G - 1];
        sum[k] = T(0);
      }
#pragma unroll 4
      for (int s = 0; s < chunk; ++s) {
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
        if (idx < G) {
          r[0] += sum[k] * s1r[idx] * f1s[idx];
          r[1] += sum[k] * s2r[idx] * f2s[idx];
        }
      }
    }
    block_sum<T, 2>(r, scratch);  // ends in __syncthreads: zw is free again
    if (tid == 0) {
      o[0] = r[0] * kconst * scale;
      o[1] = r[1] * kconst * scale;
    }
  }
}

template <typename T, int KERNEL>
int launch_kernel(const T* m1, const T* m2, const T* dl, const T* invp,
                  const T* grids, const double* series, const T* params,
                  const T* hs, const T* s1, const T* s2, const T* f1,
                  const T* f2, T* out, int L, int E, int C, int chunk, int G,
                  int cheb_deg, int window_deg, cudaStream_t stream) {
  const size_t smem = series_bytes<double>(cheb_deg, window_deg)
                      + (size_t)chunk * sizeof(typename Pair<T>::type)
                      + (3 * (size_t)G + kMassScalars) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      rows_contract_kernel<T, KERNEL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)L * (unsigned)E);
  rows_contract_kernel<T, KERNEL><<<grid, kThreads, smem, stream>>>(
      m1, m2, dl, invp, grids, series, params, hs, s1, s2, f1, f2, out, L, E,
      C, chunk, G, cheb_deg, window_deg);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* m1, const T* m2, const T* dl, const T* invp,
           const T* grids, const double* series, const T* params,
           const T* hs, const T* s1, const T* s2, const T* f1, const T* f2,
           T* out, int L, int E, int C, int chunk, int G, int cheb_deg,
           int window_deg, int kernel, void* stream) {
  if (L <= 0 || E <= 0 || C <= 0 || chunk <= 0 || G <= 0)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (kernel == 0)
    return launch_kernel<T, 0>(m1, m2, dl, invp, grids, series, params, hs,
                               s1, s2, f1, f2, out, L, E, C, chunk, G,
                               cheb_deg, window_deg, s);
  return launch_kernel<T, 1>(m1, m2, dl, invp, grids, series, params, hs, s1,
                             s2, f1, f2, out, L, E, C, chunk, G, cheb_deg,
                             window_deg, s);
}

}  // namespace

// C interface (loaded with ctypes by chimera_tpu_torch/ops/cuda/rows.py).
// Returns the CUDA error code of the launch (0 = cudaSuccess).
extern "C" int chimera_rows_contract_f32(
    const float* m1, const float* m2, const float* dl, const float* invp,
    const float* grids, const double* series, const float* params,
    const float* hs, const float* s1, const float* s2, const float* f1,
    const float* f2, float* out, int L, int E, int C, int chunk, int G,
    int cheb_deg, int window_deg, int kernel, void* stream) {
  return launch<float>(m1, m2, dl, invp, grids, series, params, hs, s1, s2,
                       f1, f2, out, L, E, C, chunk, G, cheb_deg, window_deg,
                       kernel, stream);
}

extern "C" int chimera_rows_contract_f64(
    const double* m1, const double* m2, const double* dl, const double* invp,
    const double* grids, const double* series, const double* params,
    const double* hs, const double* s1, const double* s2, const double* f1,
    const double* f2, double* out, int L, int E, int C, int chunk, int G,
    int cheb_deg, int window_deg, int kernel, void* stream) {
  return launch<double>(m1, m2, dl, invp, grids, series, params, hs, s1, s2,
                        f1, f2, out, L, E, C, chunk, G, cheb_deg,
                        window_deg, kernel, stream);
}
