// Adjoint of the rows contraction (K2b): the backward of
// chimera_tpu_torch/csrc/rows_contract.cu (K2) in the hyper-parameters, for
// the dark-siren 'marginalized' flagship path.  In the JAX package this
// backward is jax.vjp of _rows_reference (chimera_tpu/ops/pallas/fused.py:
// 605-607, semantics :613-640), an XLA recompute that materializes
// u = (g - z) / h at (L, R, G, chunk); the plain PyTorch twin is
// chimera_tpu_torch/ops/cuda/rows.py::fused_rows_contract_adjoint_plain
// (autograd through fused_rows_contract_plain in row chunks).
//
// Given the cotangents ct (L, R, 2) of r, it returns
//   d_series (L, cheb_deg + 2 + window_deg), d_params (L, 12): the packed
//            rows (pack_params), summed over the events in event order;
//   d_hs     (L, R, 2): the cotangents of 1/h and of the scale;
//   d_f1, d_f2 (L, E, G).
// The PE data, the grids, s1 and s2 get none.
//
// One thread block per (lambda, event), lambda fastest, as K2.  The block
// sweeps the event's C rows in order (adjoint.cuh, rows_adjoint_event), so
// d_f1[l, e, :] and d_f2[l, e, :] sum in a fixed order without atomics.
// Per row it recomputes phase A and the density per grid point (grid points
// over threads, as K2's forward), which gives d_f and d_scale; then, with
// the samples over threads, dw, dz and the 1/h adjoint per sample, chained
// through z and w (SampleAdjoint) into per-thread gradients that the block
// sums into `partials` (L, E, P).  A second kernel sums those over the
// events.  The Chebyshev series are summed in double, as in K2.  A
// prologue writes each lambda's record first, and the mass model's
// derivative is K3's reverse sweep (adjoint.cuh): the three launches count
// as one K2b.
//
// What bounds it on an H100: arithmetic, and since both passes are pruned
// to the Epanechnikov support (adjoint.cuh, rows_adjoint_event), the
// per-sample work: phase A and the chain through z and w (the mass model's
// reverse sweep, the two projections) of every weighted sample of a live
// row.  Pass 1 takes the densities from K1a's pruned loop (kde.cuh,
// contract_pruned: 32-sample tiles against runs of 32 grid points) and
// keeps the full loop's layout for its per-grid-point epilogue, so that
// d_scale sums in the same order; pass 2 keeps a sample a thread and skips
// the 32-point grid tiles that its support misses.  At the flagship 0.94 %
// of the (λ, row, grid point, slot) pairs are terms of the closed support,
// and the passes evaluate ~5 % and ~4 % of the pairs; every output keeps
// the bits of the full loops, which the Gaussian kernel runs.  Rows that
// K2 writes as exact zeros (scale 0, no weight, or here also no cotangent)
// are skipped whole and give exact zero cotangents.

#include "adjoint.cuh"

namespace {

template <typename T, int KERNEL>  // KERNEL 0: Epanechnikov, 1: Gaussian
__global__ void __launch_bounds__(kThreads, 4)
rows_adjoint_kernel(const RowsAdjointArgs<T> a,
                    const unsigned char* __restrict__ records) {
  using T2 = typename Pair<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t rb = record_bytes<T, double>(a.cheb_deg, a.window_deg);
  RowsSmem<T> sm;
  sm.zw = reinterpret_cast<T2*>(smem + rb);
  sm.gc = sm.zw + a.chunk;
  sm.zt = sm.gc + a.G;
  sm.gt = sm.zt + (a.chunk + kTileS - 1) / kTileS;
  sm.grid = reinterpret_cast<T*>(sm.gt + (a.G + kGridTile - 1) / kGridTile);
  sm.f1 = sm.grid + a.G;
  sm.f2 = sm.f1 + a.G;
  sm.df1 = sm.f2 + a.G;
  sm.df2 = sm.df1 + a.G;
  sm.dz = sm.df2 + a.G;
  sm.dw = sm.dz + a.chunk;
#if CHIMERA_MASS_KIND == 4
  sm.kx = sm.dw + a.chunk;
  sm.kg = sm.kx + a.chunk;
#endif
  __shared__ T scratch[2][kWarps];
  __shared__ T red[kWarps + 1][kRedCols];

  const int l = blockIdx.x % a.L;
  const int e = blockIdx.x / a.L;
  copy_record(records + (size_t)l * rb, smem, rb);
  __syncthreads();
  const Record<T, double> rec(smem, a.cheb_deg, a.window_deg);
  const Model<T, double> model(rec.series, rec.fields, a.cheb_deg,
                               a.window_deg, rec.fields + kMassScalars);
  const SampleAdjoint<T, double> sample(model, rec.consts);
  GradAcc<T, 32> g;
  g.zero();
  rows_adjoint_event<T, KERNEL>(DeviceBlock<T>{scratch}, model, sample, a, l,
                                e, sm, g);
  const int P = a.cheb_deg + 2 + a.window_deg + kMassScalars;
  store_partials<kWarps>(g, rec.jac, a.cheb_deg, a.window_deg,
                 a.partials + ((size_t)l * a.E + e) * P, red);
}

template <typename T, int KERNEL>
int launch_kernel(const RowsAdjointArgs<T>& a, double* d_series, T* d_params,
                  cudaStream_t stream) {
  const int P = a.cheb_deg + 2 + a.window_deg + kMassScalars;
  unsigned char* records = reinterpret_cast<unsigned char*>(
      a.partials + records_offset((size_t)a.L * a.E * P));
  cudaError_t err = write_records<T, double>(a.series, a.params, a.L,
                                             a.cheb_deg, a.window_deg, records,
                                             stream);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = record_bytes<T, double>(a.cheb_deg, a.window_deg)
                      + ((size_t)a.chunk + a.G + (a.chunk + kTileS - 1) / kTileS
                         + (a.G + kGridTile - 1) / kGridTile)
                            * sizeof(typename Pair<T>::type)
                      + (5 * (size_t)a.G
                         + (kStashRows - 2) * (size_t)a.chunk) * sizeof(T);
  err = cudaFuncSetAttribute(rows_adjoint_kernel<T, KERNEL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess) {
    const dim3 grid((unsigned)a.L * (unsigned)a.E);
    rows_adjoint_kernel<T, KERNEL><<<grid, kThreads, smem, stream>>>(a, records);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  reduce_events_kernel<T><<<a.L, 160, 0, stream>>>(
      a.partials, d_series, d_params, a.E, a.cheb_deg + 2 + a.window_deg);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* m1, const T* m2, const T* dl, const T* invp,
           const T* grids, const double* series, const T* params,
           const T* hs, const T* s1, const T* s2, const T* f1, const T* f2,
           const T* ct, double* partials, double* d_series, T* d_params,
           T* d_hs, T* d_f1, T* d_f2, int L, int E, int C, int chunk, int G,
           int cheb_deg, int window_deg, int kernel, void* stream) {
  // a window series exactly where the model has one
  if (L <= 0 || E <= 0 || C <= 0 || chunk <= 0 || G <= 0 || cheb_deg < 1
      || (window_deg < 1) == kWindowCdf || cheb_deg > kMaxDeg
      || window_deg > kMaxDeg)
    return (int)cudaErrorInvalidValue;
  const RowsAdjointArgs<T> a{m1, m2, dl, invp, grids, series, params, hs, s1,
                             s2, f1, f2, ct, partials, d_hs, d_f1, d_f2, L,
                             E, C, chunk, G, cheb_deg, window_deg};
  auto s = static_cast<cudaStream_t>(stream);
  if (kernel == 0) return launch_kernel<T, 0>(a, d_series, d_params, s);
  return launch_kernel<T, 1>(a, d_series, d_params, s);
}

}  // namespace

// C interface (loaded with ctypes by chimera_tpu_torch/ops/cuda/rows.py).
// `partials` is scratch of records_offset(L E P) doubles and L prologue
// records (record_bytes each, adjoint.cuh) more.  Returns the CUDA error code
// of the launches (0 = cudaSuccess).
extern "C" int chimera_rows_contract_adjoint_f32(
    const float* m1, const float* m2, const float* dl, const float* invp,
    const float* grids, const double* series, const float* params,
    const float* hs, const float* s1, const float* s2, const float* f1,
    const float* f2, const float* ct, double* partials, double* d_series,
    float* d_params, float* d_hs, float* d_f1, float* d_f2, int L, int E,
    int C, int chunk, int G, int cheb_deg, int window_deg, int kernel,
    void* stream) {
  return launch<float>(m1, m2, dl, invp, grids, series, params, hs, s1, s2,
                       f1, f2, ct, partials, d_series, d_params, d_hs, d_f1,
                       d_f2, L, E, C, chunk, G, cheb_deg, window_deg, kernel,
                       stream);
}

extern "C" int chimera_rows_contract_adjoint_f64(
    const double* m1, const double* m2, const double* dl, const double* invp,
    const double* grids, const double* series, const double* params,
    const double* hs, const double* s1, const double* s2, const double* f1,
    const double* f2, const double* ct, double* partials, double* d_series,
    double* d_params, double* d_hs, double* d_f1, double* d_f2, int L, int E,
    int C, int chunk, int G, int cheb_deg, int window_deg, int kernel,
    void* stream) {
  return launch<double>(m1, m2, dl, invp, grids, series, params, hs, s1, s2,
                        f1, f2, ct, partials, d_series, d_params, d_hs, d_f1,
                        d_f2, L, E, C, chunk, G, cheb_deg, window_deg, kernel,
                        stream);
}
