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
// What bounds it on an H100: arithmetic on the (lambda, event, pixel, grid
// point, sample) terms that are not exactly 0.  At the dark width (16 x
// 1000 events x ~5 real pixels x 500 grid points x 1024 samples, ~4e10
// terms) the recurrence costs 3 FP32 operations a term and 2 exps per
// (sample, K-point block), the dense sweep one exp (the MUFU pipe, an
// eighth of the FP32 rate in results a clock) and ~6 FP32 operations a
// term; the output is ~0.26 GB.  But the flush zeroes ~83 % of the
// refreshes there: a sample is live only within ~13 bandwidths (float32;
// ~37.6 in float64) of a block's start, and the grids span ~90.
//
// What the design does about it: the prologue, a block per (lambda,
// event), sums the weights, the weighted mean and the second moments in
// double in a fixed order and writes the whitening record (kde3d.cuh,
// finish_record).  Then a main kernel a tier of K (8, 16, 32 accumulators:
// each built for its own registers), a block per (lambda, event, pixel)
// (tier 32: per (lambda, event), walking its pixels; see tier_blocks):
// the sky factor e and the z offset t of each sample, formed
// in double from coordinates centred on the event's mean, sit side by side
// in shared memory; then every term lives in registers.  The dense sweep
// gives each thread kDensePoints grid points at a time.  The recurrence's
// chains (one K-point block over a slice of the samples, K accumulators in
// registers; a second pass adds the slices in order, so that short grids
// still fill the block's 128 threads) walk only the (sample, block) pairs
// whose refresh the flush may keep: a skip radius per sample (kde3d.cuh,
// skip_radius: every skipped refresh provably flushes, and a flushed
// refresh adds exactly +0), the band of blocks some sample reaches, a bit
// per pair in shared memory within it, each chain's set bits in sample
// order two at a time, and the chains ranked by their set bits so that a
// warp holds chains of like length: the unpruned walk's bits, at ~17 % of
// its refreshes at the dark width.  A (lambda, event, pixel) whose masks
// exceed kMaskWords walks every sample (same bits).  No atomics in any
// sum: equal bits every run.
//
// What still bounds it: a block's chains are fixed by the sums' order
// (Q = 128 / J slices a block, each added in sample order), so the
// longest, whose every sample is live, set a warp's pace; the walk issues
// ~90 instructions a live sample (two exps, 3 K chain operations, its
// loads), and each (pixel, sample) still takes its double sky factor.

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

// The recurrence of one (lambda, event, pixel): the pruned walk where its
// masks fit (the band of blocks some sample reaches, live_masks within it;
// the chains ranked by their set bits where the threads split into
// chains), else every sample; the chains' sums stored after a barrier
// (part overlays the samples' arrays) and folded.
template <typename T, int KMAX>
__device__ void recurrence(const double* rec, const ET<T>* et, const T* radii,
                           unsigned* masks, int* keys, int S, double zg0,
                           int G, int K, T* part, T* out) {
  const int J = (G + K - 1) / K;
  const bool pruned = (long long)J * ((S + 31) / 32) <= kMaskWords;
  int* order = keys + kThreads;
  if (pruned) {
    T* red = reinterpret_cast<T*>(masks);  // sample_extent's rows
    extent_fold(red, keys, J, threadIdx.x, kThreads);
    __syncthreads();
    live_band(rec, red, zg0, K, J, keys, threadIdx.x, kThreads);
    __syncthreads();
    live_masks<T>(rec, et, radii, S, zg0, K, J, keys, masks, threadIdx.x,
                  kThreads);
    __syncthreads();
    if (J < kThreads) {
      chain_keys(masks, S, J, keys, threadIdx.x, kThreads);
      __syncthreads();
      chain_order(keys, J, order, threadIdx.x, kThreads);
      __syncthreads();
    }
  }
  T acc[KMAX];
  const int c = recurrence_sweep<T, KMAX>(rec, et, pruned ? masks : nullptr,
                                          order, S, zg0, G, K, out, acc,
                                          threadIdx.x, kThreads);
  __syncthreads();
  if (c >= 0) {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) part[c * KMAX + k] = acc[k];
  }
  __syncthreads();
  recurrence_fold<T, KMAX>(rec, part, G, K, out, threadIdx.x, kThreads);
}

// Shared memory of the main kernels: the samples' (e, t) slots and skip
// radii (padded to whole 32-sample words), the masks (first the samples'
// extent), the band, then the chains' keys and order; the recurrence's
// part overlays them once the walk is done.
template <typename T>
size_t main_smem(int S) {
  const size_t samples = (size_t)slots(S) * sizeof(ET<T>) +
                         (size_t)(32 * ((S + 31) / 32)) * sizeof(T) +
                         (size_t)kMaskWords * 4 + 2 * kThreads * 4;
  const size_t part = (size_t)kThreads * kMaxBlock * sizeof(T);
  return samples > part ? samples : part;
}

// The main kernel of the (lambda, event)s whose block length K lies in
// TIER's range (TIER 8: the dense sweep and K <= 8, with the rows without
// a whitening or with a K the kernel does not take; 16: 8 < K <= 16; 32:
// 16 < K <= 32), its K accumulators TIER registers: one kernel a tier, so
// that the K = 8 and K = 16 tiers are not held to the registers of the
// K = 32 one.  A block a (lambda, event, pixel) in tiers 8 and 16; in
// tier 32 a block a (lambda, event) walking its pixels.  That layout was
// timed against a block a (lambda, event, pixel) (tools/k3_variants.py,
// k5_tier32_pixel; float32, 16 lambda, 1024 samples, on an H100 80GB HBM3
// at 700 W) and is faster both where the plan gives tier 32 no event (1000
// events on 500-point grids: 5.09-5.10 ms a call against 5.20-5.22; its
// empty launch 0.016 ms against 0.125) and where it gives it most (500
// events on 800-point grids, 340 at K = 32: 4.10-4.20 ms against
// 4.45-4.51).  Tiers 8 and 16 in that layout were slower.  Blocks an SM
// each float32 tier is built for (the registers it may take: 64K /
// (blocks x 128)); float64 takes what it needs.
template <typename T>
__host__ __device__ constexpr int tier_blocks(int tier) {
  return sizeof(T) > 4 ? 1 : tier == 8 ? 10 : tier == 16 ? 9 : 6;
}

// One (lambda, event, pixel) of a tier's kernel.
template <typename T, int TIER>
__device__ __forceinline__ void pixel_row(
    const T* z, const T* w, const T* ra, const T* dec, const T* ra_pix,
    const T* dec_pix, const unsigned char* mask, const T* grid,
    const double* rec, bool valid, int K, T* out, size_t le, int e, int p,
    int S, int P, int G, unsigned char* smem) {
  const int S32 = 32 * ((S + 31) / 32);
  ET<T>* et = reinterpret_cast<ET<T>*>(smem);
  T* radii = reinterpret_cast<T*>(et + slots(S));
  unsigned* masks = reinterpret_cast<unsigned*>(radii + S32);
  int* keys = reinterpret_cast<int*>(masks + kMaskWords);
  T* part = reinterpret_cast<T*>(smem);  // kThreads x kMaxBlock slice sums, after the walk
  T* o = out + (le * P + p) * G;
  if (!mask[size_t(e) * P + p] || !valid) {
    // a fake pixel is 0; no whitening, or a block length the kernel does
    // not take, NaN
    const T fill = mask[size_t(e) * P + p] ? T(nan("")) : T(0);
    for (int g = threadIdx.x; g < G; g += kThreads) o[g] = fill;
    return;
  }
  sample_factors(rec, z + le * S, w + le * S, ra + size_t(e) * S,
                 dec + size_t(e) * S, S, ra_pix[size_t(e) * P + p],
                 dec_pix[size_t(e) * P + p], et, threadIdx.x, kThreads);
  skip_radii(et, radii, S, threadIdx.x, kThreads);
  sample_extent(et, radii, S, reinterpret_cast<T*>(masks), threadIdx.x,
                kThreads);
  __syncthreads();
  if (K == 0)
    dense_sweep(rec, et, S, grid, G, o, threadIdx.x, kThreads);
  else
    recurrence<T, TIER>(rec, et, radii, masks, keys, S, double(grid[0]), G, K,
                        part, o);
}

template <typename T, int TIER>
__global__ void __launch_bounds__(kThreads, tier_blocks<T>(TIER))
kde3d_kernel(const T* __restrict__ z, const T* __restrict__ w,
             const T* __restrict__ ra, const T* __restrict__ dec,
             const T* __restrict__ ra_pix, const T* __restrict__ dec_pix,
             const unsigned char* __restrict__ mask,
             const T* __restrict__ grids, const int* __restrict__ z_block,
             const double* __restrict__ records, T* __restrict__ out, int E,
             int S, int P, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kPixelLoop = TIER == kMaxBlock;
  const size_t le = kPixelLoop ? blockIdx.x : blockIdx.x / P;
  const int e = int(le % E);
  const double* rec = records + le * kRecord;
  const int k_req = z_block[e];
  const bool valid = rec[kOk] != 0.0 && k_req >= 0 && k_req <= kMaxBlock;
  const int K = k_req < G ? k_req : G;
  if ((!valid || K <= 8 ? 8 : K <= 16 ? 16 : kMaxBlock) != TIER) return;
  const T* grid = grids + size_t(e) * G;
  if constexpr (kPixelLoop) {
    for (int p = 0; p < P; ++p) {
      pixel_row<T, TIER>(z, w, ra, dec, ra_pix, dec_pix, mask, grid, rec,
                         valid, K, out, le, e, p, S, P, G, smem);
      __syncthreads();  // the next pixel's sample factors overwrite part
    }
  } else {
    pixel_row<T, TIER>(z, w, ra, dec, ra_pix, dec_pix, mask, grid, rec, valid,
                       K, out, le, e, int(blockIdx.x % P), S, P, G, smem);
  }
}

template <typename T, int TIER>
cudaError_t launch_tier(const T* z, const T* w, const T* ra, const T* dec,
                        const T* ra_pix, const T* dec_pix,
                        const unsigned char* mask, const T* grids,
                        const int* z_block, const double* records, T* out,
                        int L, int E, int S, int P, int G, cudaStream_t s) {
  const size_t smem = main_smem<T>(S);
  cudaError_t err = cudaFuncSetAttribute(
      kde3d_kernel<T, TIER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const size_t blocks = (size_t)L * E * (TIER == kMaxBlock ? 1 : P);
  kde3d_kernel<T, TIER><<<(unsigned)blocks, kThreads, smem, s>>>(
      z, w, ra, dec, ra_pix, dec_pix, mask, grids, z_block, records, out, E,
      S, P, G);
  return cudaGetLastError();
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
  err = launch_tier<T, 8>(z, w, ra, dec, ra_pix, dec_pix, mask, grids,
                          z_block, records, out, L, E, S, P, G, s);
  if (err == cudaSuccess)
    err = launch_tier<T, 16>(z, w, ra, dec, ra_pix, dec_pix, mask, grids,
                             z_block, records, out, L, E, S, P, G, s);
  if (err == cudaSuccess)
    err = launch_tier<T, kMaxBlock>(z, w, ra, dec, ra_pix, dec_pix, mask,
                                    grids, z_block, records, out, L, E, S, P,
                                    G, s);
  return (int)err;
}

// ---- K5b, the adjoint -------------------------------------------------------
// The JAX package differentiates the lattice KDE with jax.grad through XLA
// (chimera_tpu/ops/kde.py:307-457); K5b replaces no TPU kernel.  Given
// d_out (L, E, P, G), the cotangent of K5's output, it writes per (lambda,
// event) the cotangents of the record's quantities that K5's terms read
// (kde3d.cuh, K5b): per sample (unit weight, whitened centred a, b, c), per
// pixel (c0, c1, c2), and the event's three sums; ops/cuda/kde3d.py chains
// them to z and w through a float64 rebuild of the record.  The plain
// version is autograd of lattice_kde3d_plain (lattice_kde3d_adjoint_plain).
//
// What bounds it on an H100: the exps of its terms (one a (pixel, sample,
// grid point) of the dense sweep's events, every sample; one a grid point
// of each block whose refresh the forward keeps, else, and one a kept
// block's refresh test), at the MUFU rate, and ~9 FP32 operations a term.
// d_out is read once and the outputs (~0.5 GB of sample cotangents in
// double at the dark width) written once.
//
// What the design does about it: it reads the record that K5's prologue
// wrote in the forward (the same bits, so its refresh tests are the
// forward's).  A block per (lambda, event) stages the grid (whitened, about
// the mean, and each K-point block's start) and the cotangent rows of as
// many real pixels as kAdjointSmem allows (a chunk; all of them at the
// dark width), skipping the rows that are all 0.  A thread takes the
// samples s = rank, rank + 128, ..., forms each one's double factors once
// and walks the chunk's pixels in order, its sample's four cotangents in
// registers (written to d_samp once; read back only between chunks).  At a
// pixel the kept blocks lie in one range of j found from the sample's skip
// radius (kept_range: no exp outside it), and a warp walks the union of
// its lanes' ranges in step, its lanes reading the same grid point of
// shared memory at once, a whole block of 8, 16 or 32 points in 16-byte
// loads.  The likelihood hands the samples sorted by distance
// (HyperLikelihood.create; the JAX package's order, which from_state
// keeps, is the same), so a warp's 32 samples are neighbours in z, and
// their t = c0 - a and ranges nearly the same at every pixel (sorting them
// by a in the block gave no more lanes active and cost time; PERF.md).
// Each pixel's sums over a warp's samples go through the warp's shuffle
// tree into the warp's own column of part, summed over the warps in order;
// d L00's and d log_norm's stay in each thread's registers until the end:
// no atomics, equal bits every run.  The per-sample sums take the terms in
// the order of K5b's first kernel (a sample's pixels in order, a pixel's
// kept blocks and grid points in order) with its roundings, so d_samp
// keeps its bits; the pixel and event sums are summed in another order.
// Blocks an SM: 5 in float32 (the registers ptxas may give a thread, 102),
// timed faster than 4; float64 takes 2.

template <typename T>
__host__ __device__ constexpr int adjoint_blocks() {
  return sizeof(T) > 4 ? 2 : 5;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, adjoint_blocks<T>())
kde3d_adjoint_kernel(const T* __restrict__ z, const T* __restrict__ w,
                     const T* __restrict__ ra, const T* __restrict__ dec,
                     const T* __restrict__ ra_pix,
                     const T* __restrict__ dec_pix,
                     const unsigned char* __restrict__ mask,
                     const T* __restrict__ grids,
                     const int* __restrict__ z_block,
                     const double* __restrict__ records,
                     const T* __restrict__ d_out, double* __restrict__ d_samp,
                     double* __restrict__ d_pix, double* __restrict__ d_event,
                     int E, int S, int P, int G, int pc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const AdjointLayout lay = adjoint_layout(G, pc, sizeof(T));
  double* epart = reinterpret_cast<double*>(smem + lay.epart);
  double* centres = reinterpret_cast<double*>(smem + lay.centres);
  double* part = reinterpret_cast<double*>(smem + lay.part);
  T* rows = reinterpret_cast<T*>(smem + lay.rows);
  T* zl = reinterpret_cast<T*>(smem + lay.zl);
  T* zeta = reinterpret_cast<T*>(smem + lay.zeta);
  T* starts = reinterpret_cast<T*>(smem + lay.starts);
  int* live = reinterpret_cast<int*>(smem + lay.live);
  int* flags = reinterpret_cast<int*>(smem + lay.flags);
  int* count = reinterpret_cast<int*>(smem + lay.count);
  const size_t le = blockIdx.x;
  const int e = int(le % E), rank = threadIdx.x;
  const int lane = rank % kWarpSize, warp = rank / kWarpSize;
  const double* rec = records + le * kRecord;
  double* ds = d_samp + le * S * kSampleGrads;
  double* dp = d_pix + le * P * kPixelGrads;
  double* dv = d_event + le * kEventGrads;
  const int k_req = z_block[e];
  if (rec[kOk] == 0.0 || k_req < 0 || k_req > kMaxBlock) {
    adjoint_dead(ds, dp, dv, S, P, rank, kThreads);
    return;
  }
  const int K = k_req < G ? k_req : G, J = K > 0 ? (G + K - 1) / K : 0;
  const T* grid = grids + size_t(e) * G;
  const T* zs = z + le * S;
  const T* ws = w + le * S;
  const T* ras = ra + size_t(e) * S;
  const T* decs = dec + size_t(e) * S;
  adjoint_grid(rec, grid, G, K, zl, zeta, starts, rank, kThreads);
  const Whitening wh = whitening(rec);
  const double zl_start = grid_start(rec, double(grid[0]));
  const double step_h = rec[kStepH];
  const double inv_w = K > 0 ? 1.0 / (double(K) * step_h) : 0.0;
  double pl = 0.0, pn = 0.0;
  bool started = false;  // some chunk has written the samples' rows
  for (int p0 = 0; p0 < P; p0 += pc) {
    const int np = P - p0 < pc ? P - p0 : pc;
    for (int i = rank; i < np; i += kThreads) flags[i] = 0;
    __syncthreads();  // the grid written, the last chunk's rows read
    stage_rows(d_out + (le * P + p0) * G, mask + size_t(e) * P + p0, np, G,
               rows, flags, rank, kThreads);
    __syncthreads();
    live_pixels(flags, np, live, count, rank);
    for (int i = rank; i < np * kPixelGrads; i += kThreads)
      if (!flags[i / kPixelGrads]) dp[p0 * kPixelGrads + i] = 0.0;
    __syncthreads();
    const int n = *count;
    for (int i = rank; i < n; i += kThreads)
      pixel_centre(rec, ra_pix[size_t(e) * P + p0 + live[i]],
                   dec_pix[size_t(e) * P + p0 + live[i]],
                   centres + kPixelGrads * i);
    for (int i = rank; i < n * kPixelGrads * kAdjointWarps; i += kThreads)
      part[i] = 0.0;
    __syncthreads();
    if (n == 0) continue;
    for (int base = 0; base < S; base += kThreads) {
      const int pos = base + rank;
      const int s = pos < S ? pos : -1;
      SampleFactors f = {0.0, 0.0, 0.0, 0.0};
      double acc[kSampleGrads] = {0.0, 0.0, 0.0, 0.0};
      if (s >= 0) {
        f = sample_of(rec, zs, ws, ras, decs, s, S);
        if (started)
          for (int k = 0; k < kSampleGrads; ++k) acc[k] = ds[s * kSampleGrads + k];
      }
      for (int i = 0; i < n; ++i) {
        const double* c = centres + kPixelGrads * i;
        double q1 = 0.0, q2 = 0.0, sky = 0.0;
        T ef = T(0), t = T(0);
        int lo = J, hi = -1;
        if (s >= 0) {
          sample_pixel(wh, f, c, q1, q2, sky, ef, t);
          if (K > 0) kept_range(ef, t, starts, zl_start, step_h, inv_w, J, lo, hi);
        }
        int wlo = lo, whi = hi;
        if (K > 0) warp_range(lo, hi, wlo, whi);
        double dt = 0.0, dq1 = 0.0, dq2 = 0.0;
        if (s >= 0) {
          T sg, su, sz;
          pixel_sums(ef, t, zl, zeta, starts,
                     rows + size_t(live[i]) * row_stride(G), G, K, lo, hi, wlo,
                     whi, sg, su, sz);
          pixel_tail(wh.norm, f.wn, q1, q2, sky, sg, su, sz, acc, pl, pn, dt,
                     dq1, dq2);
        }
        dt = warp_sum(dt);
        dq1 = warp_sum(dq1);
        dq2 = warp_sum(dq2);
        if (lane == 0) {
          double* pp = part + kPixelGrads * kAdjointWarps * i + warp;
          pp[kGradC0 * kAdjointWarps] += dt;
          pp[kGradC1 * kAdjointWarps] += dq1;
          pp[kGradC2 * kAdjointWarps] += dq2;
        }
      }
      if (s >= 0)
        for (int k = 0; k < kSampleGrads; ++k) ds[s * kSampleGrads + k] = acc[k];
    }
    started = true;
    __syncthreads();
    for (int m = rank; m < n * kPixelGrads; m += kThreads) {
      const double* pp = part + kAdjointWarps * m;
      double sum = 0.0;
      for (int v = 0; v < kAdjointWarps; ++v) sum += pp[v];
      dp[(p0 + live[m / kPixelGrads]) * kPixelGrads + m % kPixelGrads] = sum;
    }
  }
  if (!started)  // no pixel with a cotangent: every sample's is 0
    for (int i = rank; i < S * kSampleGrads; i += kThreads) ds[i] = 0.0;
  epart[rank] = pl;
  epart[kThreads + rank] = pn;
  __syncthreads();
  adjoint_event(epart, dp, dv, P, rank, kThreads);
}

template <typename T>
int launch_adjoint(const T* z, const T* w, const T* ra, const T* dec,
                   const T* ra_pix, const T* dec_pix,
                   const unsigned char* mask, const T* grids,
                   const int* z_block, const double* records, const T* d_out,
                   double* d_samp, double* d_pix, double* d_event, int L,
                   int E, int S, int P, int G, void* stream) {
  if (L <= 0 || E <= 0 || S <= 0 || P <= 0 || G <= 0)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int pc = adjoint_chunk(P, G, sizeof(T));
  const size_t smem = adjoint_layout(G, pc, sizeof(T)).total;
  cudaError_t err = cudaFuncSetAttribute(
      kde3d_adjoint_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  kde3d_adjoint_kernel<T><<<(unsigned)(L * E), kThreads, smem, s>>>(
      z, w, ra, dec, ra_pix, dec_pix, mask, grids, z_block, records, d_out,
      d_samp, d_pix, d_event, E, S, P, G, pc);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes by chimera_tpu_torch/ops/cuda/kde3d.py).
// records: (L, E, kRecord) double scratch; mask: (E, P) bool; z_block:
// (E,) int32.  The adjoint reads the records K5 wrote for the same inputs
// and writes d_samp (L, E, S, 4), d_pix (L, E, P, 3), d_event (L, E, 3),
// double (kde3d.cuh: SampleGrad, PixelGrad, EventGrad).

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

extern "C" int chimera_kde3d_adjoint_f32(
    const float* z, const float* w, const float* ra, const float* dec,
    const float* ra_pix, const float* dec_pix, const unsigned char* mask,
    const float* grids, const int* z_block, const double* records,
    const float* d_out, double* d_samp, double* d_pix, double* d_event, int L,
    int E, int S, int P, int G, void* stream) {
  return launch_adjoint<float>(z, w, ra, dec, ra_pix, dec_pix, mask, grids,
                               z_block, records, d_out, d_samp, d_pix,
                               d_event, L, E, S, P, G, stream);
}

extern "C" int chimera_kde3d_adjoint_f64(
    const double* z, const double* w, const double* ra, const double* dec,
    const double* ra_pix, const double* dec_pix, const unsigned char* mask,
    const double* grids, const int* z_block, const double* records,
    const double* d_out, double* d_samp, double* d_pix, double* d_event, int L,
    int E, int S, int P, int G, void* stream) {
  return launch_adjoint<double>(z, w, ra, dec, ra_pix, dec_pix, mask, grids,
                                z_block, records, d_out, d_samp, d_pix,
                                d_event, L, E, S, P, G, stream);
}
