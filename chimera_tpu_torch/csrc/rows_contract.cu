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
// shared memory and sweeps the event's C rows (adjoint.cuh,
// rows_contract_event, which the host emulation runs too): phase A puts
// the row's (z, w) pairs in shared memory, phase B forms the row's
// densities on the grid and the contraction multiplies them into s1 and s2
// (read once, coalesced), each thread holding kGridPerThread grid points,
// and the block reduces the two sums.
//
// What bounds it on an H100: phase A and the per-row work.  Rows whose
// scale is 0 (dead pixels) are written as exact zeros without either
// phase, rows whose weights are all 0 (the padding rows that round each
// event up to C among them) after phase A; the kernel-shape constant is
// applied once per row.  With the Epanechnikov kernel phase B evaluates
// only the (32 grid points, 32 samples) tiles of pairs that can be
// non-zero (kde.cuh, contract_pruned, on the dL-sorted samples): at the
// flagship about 1 % of the L * R * chunk * G = 1.6e10 pair terms are, and
// the tiles keep a few percent of the pairs, so that what remains per row
// is phase A (the 64-term Clenshaw inverse in double and the mass model of
// each of its 128 slots), the tile bounds, the grid points' epilogue and
// five barriers.  The densities keep the bits of the full loop, which the
// Gaussian kernel (none of whose terms is exactly zero) runs.

#include "adjoint.cuh"

namespace {

template <typename T, int KERNEL>  // KERNEL 0: Epanechnikov, 1: Gaussian
__global__ void __launch_bounds__(kThreads)
rows_contract_kernel(const RowsArgs<T> a) {
  using T2 = typename Pair<T>::type;
  constexpr bool kPrune = KERNEL == 0;
  extern __shared__ __align__(16) unsigned char smem[];
  double* ser = reinterpret_cast<double*>(smem);  // series, summed in double
  RowsContractSmem<T> sm;
  sm.zw = reinterpret_cast<T2*>(smem + series_bytes<double>(a.cheb_deg,
                                                            a.window_deg));
  sm.zt = sm.zw + a.chunk;
  sm.grid = reinterpret_cast<T*>(
      sm.zt + (kPrune ? (a.chunk + kTileS - 1) / kTileS : 0));
  sm.f1 = sm.grid + a.G;
  sm.f2 = sm.f1 + a.G;
  sm.den = sm.f2 + a.G;
  T* prm = sm.den + (kPrune ? a.G : 0);  // this lambda's mass scalars
  __shared__ T scratch[2][kWarps];

  const int l = blockIdx.x % a.L;
  const int e = blockIdx.x / a.L;
  const int Q = a.cheb_deg + 2 + a.window_deg;
  for (int i = threadIdx.x; i < Q; i += kThreads)
    ser[i] = a.series[(size_t)l * Q + i];
  for (int i = threadIdx.x; i < kMassScalars; i += kThreads)
    prm[i] = a.params[(size_t)l * kMassScalars + i];
  __syncthreads();
  const Model<T, double> model(ser, prm, a.cheb_deg, a.window_deg);
  rows_contract_event<T, KERNEL>(DeviceBlock<T>{scratch}, model, a, l, e, sm);
}

template <typename T, int KERNEL>
int launch_kernel(const RowsArgs<T>& a, cudaStream_t stream) {
  const bool prune = KERNEL == 0;
  const size_t smem = series_bytes<double>(a.cheb_deg, a.window_deg)
                      + ((size_t)a.chunk
                         + (prune ? (a.chunk + kTileS - 1) / kTileS : 0))
                            * sizeof(typename Pair<T>::type)
                      + ((3 + prune) * (size_t)a.G + kMassScalars) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      rows_contract_kernel<T, KERNEL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)a.L * (unsigned)a.E);
  rows_contract_kernel<T, KERNEL><<<grid, kThreads, smem, stream>>>(a);
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
  const RowsArgs<T> a{m1, m2, dl, invp, grids, series, params, hs, s1, s2,
                      f1, f2, out, L, E, C, chunk, G, cheb_deg, window_deg};
  auto s = static_cast<cudaStream_t>(stream);
  if (kernel == 0) return launch_kernel<T, 0>(a, s);
  return launch_kernel<T, 1>(a, s);
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
