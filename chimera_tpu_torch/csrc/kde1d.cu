// Batched weighted 1-D KDE on per-row grids (K4): replaces
// chimera_tpu/ops/pallas/kde.py::_kde_kernel (launched by kde1d_grid,
// kde.py:67-117), the KDE of the stage-by-stage path that every binned
// configuration takes; and its adjoint (K4b), the counterpart of jax.vjp of
// chimera_tpu/ops/kde.py::kde1d_core (XLA: the JAX package has no kernel
// for it).  Per row b of B:
//
//   out[b, g] = sum_s w[b, s] K((grid[b, g] - z[b, s]) / h[b]) / h[b]
//
// with normalized weights (chimera_tpu/ops/kde.py::kde1d_core); the plain
// PyTorch twin is chimera_tpu_torch/ops/cuda/kde.py::kde1d_grid_plain.  The
// arithmetic is kde.cuh's kde_row.
//
// What bounds it on an H100: on every pair, arithmetic.  On the binned
// path a row is one event (or one (event, pixel)) with S = num_bins = 200
// bin centres and a G = 250-point effective grid, so B * G * S terms of ~5
// FP32 instructions against 4 (2 S + G) + 4 G bytes per row: 6.4e9 terms
// and ~0.5 GB at the dark flagship (B = 16 * 8000).  Only the terms within
// h of their bin are not exactly 0 (chip_smoke.k4_pairs counts them), and
// on those the bytes bound it.
//
// What the design does about it: one block per row.  The row's (z, w)
// pairs sit in shared memory (1.6 KB at S = 200 in float32); the kernel
// constant and 1/h are applied once per output.  The bins are a
// histogram's sorted centres and the grid a sorted linear one, h ~ 0.2
// sigma: a grid point sees ~1/20 of the bins, and an empty pixel's row has
// no weight at all.  So the Epanechnikov kernel takes K1a's pruned pair
// loop (kde.cuh, kde_row: contract_pruned): the bounds of the z of each
// kK4Tile bins with weight, then each warp takes runs of kTileG consecutive
// grid points, a point a lane, tests the tiles against the run's corners
// with the kernel's own arithmetic and walks the kept ones in order, every
// density of the full loop's bits; the bounds take ceil(S / kK4Tile)
// pairs more of shared memory.  The Gaussian kernel keeps the full loop
// (contract: the grid points in registers, two a thread up to 256 points,
// four above).  The TPU kernel's 8 x 128 tiling with the bandwidth folded
// into the operands is not carried over.
//
// K4b, given d_out (B, G) and the forward's out, returns d_z, d_w (B, S),
// d_grid (B, G) and d_h (B,) (kde.cuh, kde_row_adjoint): one block per row,
// the row's (z, w) and (grid, d_out) pairs in shared memory in double
// (2 (S + G) doubles; the arithmetic is double in both instantiations, as
// d_z's sums cancel), a sample-major sweep for d_z and d_w, a grid-major one
// for d_grid and d_h, which the block sums in a fixed order (equal bits
// every run), and no atomics.  Each sweep forms u and the kernel's shape
// and slope factor of its terms at the card's double rate.  On the binned
// path (200 sorted bin centres, a 250-point linear grid, h ~ 0.2 sigma) a
// grid point sees ~1/20 of the bins and a bin ~1/20 of the grid: the
// Epanechnikov sweeps walk their inputs in tiles of kK4bTile and skip the
// tiles whose corners prove every term exactly zero for a thread's own
// output (outside_support; a warp walks the union of its lanes' kept tiles,
// walk_tiles), with every output of the full loops' bits; the tiles'
// bounds are ceil(S / kK4bTile) + ceil(G / kK4bTile) double pairs more of
// shared memory.  The Gaussian kernel keeps the full sweeps.

#include "kde.cuh"

namespace {

template <typename T, int KERNEL>
__global__ void __launch_bounds__(kThreads)
kde1d_kernel(const T* __restrict__ z, const T* __restrict__ w,
             const T* __restrict__ grids, const T* __restrict__ h,
             T* __restrict__ out, int S, int G) {
  using T2 = typename Pair<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  T2* zw = reinterpret_cast<T2*>(smem);
  T2* tiles = zw + S;  // the pruned loop's bin tiles' bounds
  const size_t b = blockIdx.x;
  for (int s = threadIdx.x; s < S; s += kThreads) {
    T2 p;
    p.x = z[b * S + s];
    p.y = w[b * S + s];
    zw[s] = p;
  }
  __syncthreads();
  const DeviceBlock<T> blk{nullptr};
  kde_row<T, KERNEL>(blk, zw, S, grids + b * G, G, h[b], out + b * G, tiles);
}

template <typename T, int KERNEL>
int launch_kernel(const T* z, const T* w, const T* grids, const T* h, T* out,
                  int B, int S, int G, cudaStream_t stream) {
  const size_t smem = (size_t)(S + (KERNEL == 0 ? (S + kK4Tile - 1) / kK4Tile : 0))
                      * sizeof(typename Pair<T>::type);
  auto kernel = kde1d_kernel<T, KERNEL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)B, kThreads, smem, stream>>>(z, w, grids, h, out, S, G);
  return (int)cudaGetLastError();
}

template <typename T, int KERNEL>
__global__ void __launch_bounds__(kThreads)
kde1d_adjoint_kernel(const T* __restrict__ z, const T* __restrict__ w,
                     const T* __restrict__ grids, const T* __restrict__ h,
                     const T* __restrict__ out, const T* __restrict__ d_out,
                     T* __restrict__ d_z, T* __restrict__ d_w,
                     T* __restrict__ d_grid, T* __restrict__ d_h, int S,
                     int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  double2* zw = reinterpret_cast<double2*>(smem);  // arithmetic in double
  double2* gd = zw + S;
  double2* zt = gd + G;  // the pruned sweeps' tile bounds
  double2* gt = zt + (S + kK4bTile - 1) / kK4bTile;
  __shared__ double scratch[1][kWarps];
  const size_t b = blockIdx.x;
  for (int s = threadIdx.x; s < S; s += kThreads)
    zw[s] = make_double2(z[b * S + s], w[b * S + s]);
  for (int g = threadIdx.x; g < G; g += kThreads)
    gd[g] = make_double2(grids[b * G + g], d_out[b * G + g]);
  __syncthreads();
  const DeviceBlock<double> blk{scratch};
  kde_row_adjoint<double, KERNEL>(blk, zw, S, gd, G, out + b * G, double(h[b]),
                                  d_z + b * S, d_w + b * S, d_grid + b * G,
                                  d_h + b, zt, gt);
}

template <typename T, int KERNEL>
int launch_adjoint_kernel(const T* z, const T* w, const T* grids,
                          const T* h, const T* out, const T* d_out, T* d_z,
                          T* d_w, T* d_grid, T* d_h, int B, int S, int G,
                          cudaStream_t stream) {
  const size_t smem = (size_t)(S + G + (S + kK4bTile - 1) / kK4bTile
                                + (G + kK4bTile - 1) / kK4bTile)
                      * sizeof(double2);
  auto kernel = kde1d_adjoint_kernel<T, KERNEL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)B, kThreads, smem, stream>>>(z, w, grids, h, out, d_out,
                                                  d_z, d_w, d_grid, d_h, S, G);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_adjoint(const T* z, const T* w, const T* grids, const T* h,
                   const T* out, const T* d_out, T* d_z, T* d_w, T* d_grid,
                   T* d_h, int B, int S, int G, int kernel, void* stream) {
  if (B <= 0 || S <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (kernel == 0)
    return launch_adjoint_kernel<T, 0>(z, w, grids, h, out, d_out, d_z, d_w,
                                       d_grid, d_h, B, S, G, s);
  return launch_adjoint_kernel<T, 1>(z, w, grids, h, out, d_out, d_z, d_w,
                                     d_grid, d_h, B, S, G, s);
}

template <typename T>
int launch(const T* z, const T* w, const T* grids, const T* h, T* out, int B,
           int S, int G, int kernel, void* stream) {
  if (B <= 0 || S <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (kernel == 0) return launch_kernel<T, 0>(z, w, grids, h, out, B, S, G, s);
  return launch_kernel<T, 1>(z, w, grids, h, out, B, S, G, s);
}

}  // namespace

// C interface (loaded with ctypes by chimera_tpu_torch/ops/cuda/kde.py).
// Returns the CUDA error code of the launch (0 = cudaSuccess).
extern "C" int chimera_kde1d_f32(const float* z, const float* w,
                                 const float* grids, const float* h,
                                 float* out, int B, int S, int G, int kernel,
                                 void* stream) {
  return launch<float>(z, w, grids, h, out, B, S, G, kernel, stream);
}

extern "C" int chimera_kde1d_f64(const double* z, const double* w,
                                 const double* grids, const double* h,
                                 double* out, int B, int S, int G, int kernel,
                                 void* stream) {
  return launch<double>(z, w, grids, h, out, B, S, G, kernel, stream);
}

extern "C" int chimera_kde1d_adjoint_f32(
    const float* z, const float* w, const float* grids, const float* h,
    const float* out, const float* d_out, float* d_z, float* d_w,
    float* d_grid, float* d_h, int B, int S, int G, int kernel,
    void* stream) {
  return launch_adjoint<float>(z, w, grids, h, out, d_out, d_z, d_w, d_grid,
                               d_h, B, S, G, kernel, stream);
}

extern "C" int chimera_kde1d_adjoint_f64(
    const double* z, const double* w, const double* grids, const double* h,
    const double* out, const double* d_out, double* d_z, double* d_w,
    double* d_grid, double* d_h, int B, int S, int G, int kernel,
    void* stream) {
  return launch_adjoint<double>(z, w, grids, h, out, d_out, d_z, d_w, d_grid,
                                d_h, B, S, G, kernel, stream);
}
