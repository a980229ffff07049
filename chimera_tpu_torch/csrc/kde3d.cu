// The 3-D Gaussian KDE of the 'full' likelihood on the (pixel x z-grid)
// lattice (K5).  The JAX package has no TPU kernel for it: its hot loop is
// XLA, chimera_tpu/ops/kde.py:307-457 (gaussian_kde_3d_lattice), vmapped
// over events by chimera_tpu/likelihood.py::p_gw_3d_full.  Per (lambda l,
// event e, real pixel p) and z-grid point g, with unit weights wn over the
// event's S samples (z, ra, dec) and the whitening L of their weighted
// covariance over the bandwidth factor (d = 3):
//
//   out[l, e, p, g] = exp(log_norm) sum_s wn_s exp(-(q1^2 + q2^2) / 2)
//                                          exp(-(L00 z_g + t)^2 / 2)
//
// (the factorisation of chimera_tpu/ops/kde.py:322-333), by the dense z
// sweep where the event's block length K is 0, else by the uniform-z
// block-refresh recurrence: an exact refresh of v and r every K grid
// points (two exps), flushed to 0 below FLT_MIN / DBL_MIN, then K
// multiply-adds.  A fake pixel's row is 0; a (lambda, event) whose
// whitening does not exist gives NaN (the likelihood's nan_to_num and gate
// make it 0, as in the JAX package).  The plain PyTorch version is
// chimera_tpu_torch/ops/kde.py::gaussian_kde_3d_lattice, called by
// ops/cuda/kde3d.py::lattice_kde3d_plain.  The arithmetic is kde3d.cuh's.
//
// What bounds it on an H100: arithmetic on every (lambda, event, pixel,
// grid point, sample) term.  At the dark width (16 x 1000 events x ~5 real
// pixels x 500 grid points x 1024 samples, ~4e10 terms) the recurrence
// costs 3 FP32 operations a term and 2 exps per (sample, K-point block),
// the dense sweep one exp (the MUFU pipe, an eighth of the FP32 rate in
// results a clock) and ~6 FP32 operations a term; the output is ~0.26 GB.
//
// What the design does about it: two kernels in one call.  The prologue,
// a block per (lambda, event), sums the weights, the weighted mean and the
// second moments in double in a fixed order and writes the whitening
// record (kde3d.cuh, finish_record).  The main kernel takes a block per
// (lambda, event, pixel): the sky factor e and the z offset t of each
// sample, formed in double from coordinates centred on the event's mean,
// sit in shared memory; then every term lives in registers.  The dense
// sweep gives each thread kDensePoints grid points at a time; the
// recurrence gives each thread one K-point block (K accumulators in
// registers, K <= kMaxBlock = 32) over a slice of the samples, and a
// second pass adds the slices in order, so that the short grids of the
// K = 32 tier (16 blocks of 500 points) still fill the block's 128
// threads.  No atomics: equal bits every run.  Zero-weight samples are not
// skipped, and the FP32 pipe against the MUFU is the lever of a later PR.

#include "kde3d.cuh"

namespace {

using namespace kde3d;

template <typename T>
__global__ void __launch_bounds__(kThreads)
kde3d_prologue(const T* __restrict__ z, const T* __restrict__ w,
               const T* __restrict__ ra, const T* __restrict__ dec,
               const T* __restrict__ grids, int E, int S, int G, int bw_mode,
               double bw_value, double* __restrict__ records) {
  __shared__ double part[6 * kThreads];
  __shared__ double tot[5];
  const size_t le = blockIdx.x;
  const int e = int(le % E), rank = threadIdx.x;
  const T* zr = z + le * S;
  const T* wr = w + le * S;
  const T* rar = ra + size_t(e) * S;
  const T* der = dec + size_t(e) * S;
  weight_part(wr, S, rank, kThreads, part);
  __syncthreads();
  if (rank == 0) tot[0] = ordered_sum(part, kThreads);
  __syncthreads();
  mean_parts(zr, wr, rar, der, S, tot[0], rank, kThreads, part);
  __syncthreads();
  if (rank == 0)
    for (int k = 0; k < 4; ++k) tot[1 + k] = ordered_sum(part + k * kThreads, kThreads);
  __syncthreads();
  cov_parts(zr, wr, rar, der, S, tot[0], tot + 2, rank, kThreads, part);
  __syncthreads();
  if (rank == 0) {
    double m2[6];
    for (int k = 0; k < 6; ++k) m2[k] = ordered_sum(part + k * kThreads, kThreads);
    const T* grid = grids + size_t(e) * G;
    const double step = (double(grid[G - 1]) - double(grid[0])) / (G > 1 ? G - 1 : 1);
    finish_record(tot[0], tot[1], tot + 2, m2, bw_mode, bw_value, step,
                  records + le * kRecord);
  }
}

template <typename T, int KMAX>
__device__ void recurrence(const double* rec, const T* es, const T* ts, int S,
                           double zg0, int G, int K, T* part, T* out) {
  recurrence_sweep<T, KMAX>(rec, es, ts, S, zg0, G, K, part, out, threadIdx.x,
                            kThreads);
  __syncthreads();
  recurrence_fold<T, KMAX>(rec, part, G, K, out, threadIdx.x, kThreads);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
kde3d_kernel(const T* __restrict__ z, const T* __restrict__ w,
             const T* __restrict__ ra, const T* __restrict__ dec,
             const T* __restrict__ ra_pix, const T* __restrict__ dec_pix,
             const unsigned char* __restrict__ mask,
             const T* __restrict__ grids, const int* __restrict__ z_block,
             const double* __restrict__ records, T* __restrict__ out, int E,
             int S, int P, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* es = reinterpret_cast<T*>(smem);
  T* ts = es + S;
  T* part = ts + S;  // kThreads x kMaxBlock slice sums of the recurrence
  const size_t blk = blockIdx.x;
  const int p = int(blk % P);
  const size_t le = blk / P;
  const int e = int(le % E);
  T* o = out + blk * G;
  const double* rec = records + le * kRecord;
  const int k_req = z_block[e];
  const bool valid = rec[kOk] != 0.0 && k_req >= 0 && k_req <= kMaxBlock;
  if (!mask[size_t(e) * P + p] || !valid) {
    // a fake pixel is 0; no whitening, or a block length the kernel does
    // not take, NaN
    const T fill = mask[size_t(e) * P + p] ? T(nan("")) : T(0);
    for (int g = threadIdx.x; g < G; g += kThreads) o[g] = fill;
    return;
  }
  sample_factors(rec, z + le * S, w + le * S, ra + size_t(e) * S,
                 dec + size_t(e) * S, S, ra_pix[size_t(e) * P + p],
                 dec_pix[size_t(e) * P + p], es, ts, threadIdx.x, kThreads);
  __syncthreads();
  const T* grid = grids + size_t(e) * G;
  const int K = k_req < G ? k_req : G;
  if (K == 0)
    dense_sweep(rec, es, ts, S, grid, G, o, threadIdx.x, kThreads);
  else if (K <= 8)
    recurrence<T, 8>(rec, es, ts, S, double(grid[0]), G, K, part, o);
  else if (K <= 16)
    recurrence<T, 16>(rec, es, ts, S, double(grid[0]), G, K, part, o);
  else
    recurrence<T, kMaxBlock>(rec, es, ts, S, double(grid[0]), G, K, part, o);
}

template <typename T>
int launch(const T* z, const T* w, const T* ra, const T* dec,
           const T* ra_pix, const T* dec_pix, const unsigned char* mask,
           const T* grids, const int* z_block, double* records, T* out,
           int L, int E, int S, int P, int G, int bw_mode, double bw_value,
           void* stream) {
  if (L <= 0 || E <= 0 || S <= 0 || P <= 0 || G <= 0)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  kde3d_prologue<T><<<(unsigned)(L * E), kThreads, 0, s>>>(
      z, w, ra, dec, grids, E, S, G, bw_mode, bw_value, records);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)(2 * S + kThreads * kMaxBlock) * sizeof(T);
  err = cudaFuncSetAttribute(kde3d_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  kde3d_kernel<T><<<(unsigned)((size_t)L * E * P), kThreads, smem, s>>>(
      z, w, ra, dec, ra_pix, dec_pix, mask, grids, z_block, records, out, E,
      S, P, G);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes by chimera_tpu_torch/ops/cuda/kde3d.py).
// records: (L, E, kRecord) double scratch; mask: (E, P) bool; z_block:
// (E,) int32.

extern "C" int chimera_kde3d_f32(const float* z, const float* w,
                                 const float* ra, const float* dec,
                                 const float* ra_pix, const float* dec_pix,
                                 const unsigned char* mask,
                                 const float* grids, const int* z_block,
                                 double* records, float* out, int L, int E,
                                 int S, int P, int G, int bw_mode,
                                 double bw_value, void* stream) {
  return launch<float>(z, w, ra, dec, ra_pix, dec_pix, mask, grids, z_block,
                       records, out, L, E, S, P, G, bw_mode, bw_value, stream);
}

extern "C" int chimera_kde3d_f64(const double* z, const double* w,
                                 const double* ra, const double* dec,
                                 const double* ra_pix, const double* dec_pix,
                                 const unsigned char* mask,
                                 const double* grids, const int* z_block,
                                 double* records, double* out, int L, int E,
                                 int S, int P, int G, int bw_mode,
                                 double bw_value, void* stream) {
  return launch<double>(z, w, ra, dec, ra_pix, dec_pix, mask, grids, z_block,
                        records, out, L, E, S, P, G, bw_mode, bw_value,
                        stream);
}
