// Serial host emulation of K5 (chimera_tpu_torch/csrc/kde3d.cu), the 3-D
// lattice KDE of the 'full' likelihood, from the same device functions
// (kde3d.cuh): the prologue per (lambda, event) and the main kernel per
// (lambda, event, pixel), each phase run for every one of the kernel's
// kThreads ranks in turn, with the kernel's barriers between phases.  Same
// C interface as the kernel's, without the stream; the host_kde3d_unpruned_
// entries walk every sample (the oracle of the pruned walk), and
// host_kde3d_tally reads what the last call's pruned walk did;
// host_kde3d_adjoint_ is K5b (kde3d_adjoint_kernel) with the same C
// interface as its kernel's, host_kde3d_adjoint_unpruned_ the same with
// every block tested (the walk of K5b's first kernel, the reference of its
// kept_range); host_kde3d_pixel_walk_ runs one (sample, pixel) either way.
// Built by tests/test_torch_full.py.
#include <algorithm>
#include <cstring>
#include <vector>

#include "kde3d.cuh"

namespace {

using namespace kde3d;

// what the last call did: (lambda, real pixel) rows of the recurrence on
// the pruned walk and on the unpruned one; of the pruned rows' (sample,
// block) pairs, those skipped, those walked whose refresh the flush keeps
// and those it zeroes, and those skipped whose refresh the flush would
// have kept (the skip's proof says none); chains, and chains with no set
// bit; blocks outside the band (their masks 0 untested)
enum Tally {
  kPrunedRows, kUnprunedRows, kSkipped, kWalkedKept, kWalkedFlushed,
  kSkippedKept, kChains, kEmptyChains, kBandSkipped, kTally
};
long long tally[kTally];

template <typename T>
void prologue(const T* z, const T* w, const T* ra, const T* dec,
              const T* grids, int E, int S, int G, int bw_mode,
              double bw_value, double* records, size_t le) {
  std::vector<double> part(6 * kThreads);
  const int e = int(le % E);
  const T* zr = z + le * S;
  const T* wr = w + le * S;
  const T* rar = ra + size_t(e) * S;
  const T* der = dec + size_t(e) * S;
  for (int r = 0; r < kThreads; ++r) weight_part(wr, S, r, kThreads, part.data());
  double tot[5];
  tot[0] = ordered_sum(part.data(), kThreads);
  for (int r = 0; r < kThreads; ++r)
    mean_parts(zr, wr, rar, der, S, tot[0], r, kThreads, part.data());
  for (int k = 0; k < 4; ++k)
    tot[1 + k] = ordered_sum(part.data() + k * kThreads, kThreads);
  for (int r = 0; r < kThreads; ++r)
    cov_parts(zr, wr, rar, der, S, tot[0], tot + 2, r, kThreads, part.data());
  double m2[6];
  for (int k = 0; k < 6; ++k)
    m2[k] = ordered_sum(part.data() + k * kThreads, kThreads);
  const T* grid = grids + size_t(e) * G;
  const double step = (double(grid[G - 1]) - double(grid[0])) / (G > 1 ? G - 1 : 1);
  finish_record(tot[0], tot[1], tot + 2, m2, bw_mode, bw_value, step,
                records + le * kRecord);
}

// the pruned walk's pairs, against the flush they stand for
template <typename T>
void count_pairs(const double* rec, const ET<T>* et, const unsigned* masks,
                 int S, double zg0, int K, int J) {
  for (int j = 0; j < J; ++j) {
    const T zl0 = block_start<T>(rec, zg0, j, K);
    for (int s = 0; s < S; ++s) {
      const ET<T> p = et[slot(s)];
      const T u0 = zl0 + p.y;
      const bool kept = p.x * exp_t(T(-0.5) * u0 * u0) >= smallest_normal<T>();
      if (masks[(s / 32) * J + j] >> (s % 32) & 1u)
        ++tally[kept ? kWalkedKept : kWalkedFlushed];
      else
        ++tally[kept ? kSkippedKept : kSkipped];
    }
  }
}

template <typename T, int KMAX>
void recurrence(const double* rec, const ET<T>* et, const T* radii, int S,
                double zg0, int G, int K, bool prune, T* out) {
  const int J = (G + K - 1) / K;
  const bool pruned = prune && (long long)J * ((S + 31) / 32) <= kMaskWords;
  std::vector<unsigned> masks(kMaskWords);
  std::vector<int> keys(2 * kThreads);
  int* order = keys.data() + kThreads;
  ++tally[pruned ? kPrunedRows : kUnprunedRows];
  if (pruned) {
    T* red = reinterpret_cast<T*>(masks.data());
    for (int r = 0; r < kThreads; ++r) sample_extent(et, radii, S, red, r, kThreads);
    for (int r = 0; r < kThreads; ++r) extent_fold(red, keys.data(), J, r, kThreads);
    for (int r = 0; r < kThreads; ++r)
      live_band(rec, red, zg0, K, J, keys.data(), r, kThreads);
    tally[kBandSkipped] += J - (keys[1] - keys[0] + 1);
    for (int r = 0; r < kThreads; ++r)
      live_masks<T>(rec, et, radii, S, zg0, K, J, keys.data(), masks.data(), r,
                    kThreads);
    count_pairs<T>(rec, et, masks.data(), S, zg0, K, J);
    if (J < kThreads) {
      for (int r = 0; r < kThreads; ++r)
        chain_keys(masks.data(), S, J, keys.data(), r, kThreads);
      for (int r = 0; r < kThreads; ++r) chain_order(keys.data(), J, order, r, kThreads);
    }
  }
  std::vector<T> part(kThreads * kMaxBlock);
  std::vector<T> accs(kThreads * KMAX);
  std::vector<int> chain(kThreads);
  for (int r = 0; r < kThreads; ++r) {
    T acc[KMAX];
    chain[r] = recurrence_sweep<T, KMAX>(
        rec, et, pruned ? masks.data() : nullptr, order, S, zg0, G, K, out,
        acc, r, kThreads);
    std::memcpy(&accs[r * KMAX], acc, sizeof(acc));
  }
  const int Q = J < kThreads ? kThreads / J : 1;
  for (int r = 0; r < kThreads; ++r) {
    if (chain[r] < 0) continue;
    std::memcpy(&part[chain[r] * KMAX], &accs[r * KMAX], KMAX * sizeof(T));
    if (pruned) {
      const int c = chain[r], j = c % J, q = c / J;
      const int s0 = chain_start(q, Q, S), s1 = chain_start(q + 1, Q, S);
      int n = 0;
      for (int s = s0; s < s1; ++s) n += masks[(s / 32) * J + j] >> (s % 32) & 1u;
      ++tally[kChains];
      tally[kEmptyChains] += n == 0;
    }
  }
  for (int r = 0; r < kThreads; ++r)
    recurrence_fold<T, KMAX>(rec, part.data(), G, K, out, r, kThreads);
}

template <typename T>
int run(const T* z, const T* w, const T* ra, const T* dec, const T* ra_pix,
        const T* dec_pix, const unsigned char* mask, const T* grids,
        const int* z_block, double* records, T* out, int L, int E, int S,
        int P, int G, int bw_mode, double bw_value, bool prune) {
  if (L <= 0 || E <= 0 || S <= 0 || P <= 0 || G <= 0) return 1;
  std::memset(tally, 0, sizeof(tally));
  for (size_t le = 0; le < size_t(L) * E; ++le)
    prologue(z, w, ra, dec, grids, E, S, G, bw_mode, bw_value, records, le);
  const int S32 = 32 * ((S + 31) / 32);
  std::vector<ET<T>> et(slots(S));
  std::vector<T> radii(S32);
  for (size_t blk = 0; blk < size_t(L) * E * P; ++blk) {
    const int p = int(blk % P);
    const size_t le = blk / P;
    const int e = int(le % E);
    T* o = out + blk * G;
    const double* rec = records + le * kRecord;
    const int k_req = z_block[e];
    const bool valid = rec[kOk] != 0.0 && k_req >= 0 && k_req <= kMaxBlock;
    if (!mask[size_t(e) * P + p] || !valid) {
      const T fill = mask[size_t(e) * P + p] ? T(nan("")) : T(0);
      for (int g = 0; g < G; ++g) o[g] = fill;
      continue;
    }
    for (int r = 0; r < kThreads; ++r) {
      sample_factors(rec, z + le * S, w + le * S, ra + size_t(e) * S,
                     dec + size_t(e) * S, S, ra_pix[size_t(e) * P + p],
                     dec_pix[size_t(e) * P + p], et.data(), r, kThreads);
      skip_radii(et.data(), radii.data(), S, r, kThreads);
    }
    const T* grid = grids + size_t(e) * G;
    const int K = k_req < G ? k_req : G;
    const double zg0 = double(grid[0]);
    const ET<T>* et_ = et.data();
    const T* r_ = radii.data();
    if (K == 0)
      for (int r = 0; r < kThreads; ++r)
        dense_sweep(rec, et_, S, grid, G, o, r, kThreads);
    else if (K <= 8)
      recurrence<T, 8>(rec, et_, r_, S, zg0, G, K, prune, o);
    else if (K <= 16)
      recurrence<T, 16>(rec, et_, r_, S, zg0, G, K, prune, o);
    else
      recurrence<T, kMaxBlock>(rec, et_, r_, S, zg0, G, K, prune, o);
  }
  return 0;
}

// K5b (kde3d.cu, kde3d_adjoint_kernel) per (lambda, event) on the records
// K5 wrote, each phase for every rank in turn: the grid, then per chunk of
// pixels the rows, the live pixels and their centres, and each warp's
// samples (the ranks w 32 + lane, lane 0..31) a pixel at a time, the lanes
// in turn with the warp's union of ranges and its shuffle tree emulated;
// then the event's sums.  walk 1 takes each (sample, pixel)'s kept_range,
// walk 0 tests every block (the walk of K5b's first kernel, the reference).
template <typename T>
int run_adjoint(const T* z, const T* w, const T* ra, const T* dec,
                const T* ra_pix, const T* dec_pix, const unsigned char* mask,
                const T* grids, const int* z_block, const double* records,
                const T* d_out, double* d_samp, double* d_pix,
                double* d_event, int L, int E, int S, int P, int G, int walk) {
  if (L <= 0 || E <= 0 || S <= 0 || P <= 0 || G <= 0) return 1;
  constexpr int W = kAdjointWarps;
  const int pc = adjoint_chunk(P, G, sizeof(T));
  std::vector<double> epart(2 * kThreads), centres(kPixelGrads * pc),
      part(kPixelGrads * W * pc);
  std::vector<T> rows(size_t(pc) * row_stride(G)), zl(row_stride(G)),
      zeta(row_stride(G)), starts(row_stride(G));
  std::vector<int> live(pc), flags(pc);
  int count = 0;
  for (size_t le = 0; le < size_t(L) * E; ++le) {
    const int e = int(le % E);
    const double* rec = records + le * kRecord;
    double* ds = d_samp + le * S * kSampleGrads;
    double* dp = d_pix + le * P * kPixelGrads;
    double* dv = d_event + le * kEventGrads;
    const int k_req = z_block[e];
    if (rec[kOk] == 0.0 || k_req < 0 || k_req > kMaxBlock) {
      for (int r = 0; r < kThreads; ++r) adjoint_dead(ds, dp, dv, S, P, r, kThreads);
      continue;
    }
    const int K = k_req < G ? k_req : G, J = K > 0 ? (G + K - 1) / K : 0;
    const T* grid = grids + size_t(e) * G;
    const T* zs = z + le * S;
    const T* ws = w + le * S;
    const T* ras = ra + size_t(e) * S;
    const T* decs = dec + size_t(e) * S;
    for (int r = 0; r < kThreads; ++r)
      adjoint_grid(rec, grid, G, K, zl.data(), zeta.data(), starts.data(), r,
                   kThreads);
    const Whitening wh = whitening(rec);
    const double zl_start = grid_start(rec, double(grid[0]));
    const double step_h = rec[kStepH];
    const double inv_w = K > 0 ? 1.0 / (double(K) * step_h) : 0.0;
    std::fill(epart.begin(), epart.end(), 0.0);
    bool started = false;
    for (int p0 = 0; p0 < P; p0 += pc) {
      const int np = P - p0 < pc ? P - p0 : pc;
      std::fill(flags.begin(), flags.end(), 0);
      for (int r = 0; r < kThreads; ++r)
        stage_rows(d_out + (le * P + p0) * G, mask + size_t(e) * P + p0, np, G,
                   rows.data(), flags.data(), r, kThreads);
      live_pixels(flags.data(), np, live.data(), &count, 0);
      for (int i = 0; i < np * kPixelGrads; ++i)
        if (!flags[i / kPixelGrads]) dp[p0 * kPixelGrads + i] = 0.0;
      const int n = count;
      for (int i = 0; i < n; ++i)
        pixel_centre(rec, ra_pix[size_t(e) * P + p0 + live[i]],
                     dec_pix[size_t(e) * P + p0 + live[i]],
                     centres.data() + kPixelGrads * i);
      std::fill(part.begin(), part.end(), 0.0);
      if (n == 0) continue;
      for (int base = 0; base < S; base += kThreads) {
        for (int warp = 0; warp < W; ++warp) {
          int s[kWarpSize], lo[kWarpSize], hi[kWarpSize];
          SampleFactors f[kWarpSize];
          double acc[kWarpSize][kSampleGrads];
          for (int lane = 0; lane < kWarpSize; ++lane) {
            const int pos = base + warp * kWarpSize + lane;
            s[lane] = pos < S ? pos : -1;
            f[lane] = SampleFactors{0.0, 0.0, 0.0, 0.0};
            for (int k = 0; k < kSampleGrads; ++k)
              acc[lane][k] = started && s[lane] >= 0 ? ds[s[lane] * kSampleGrads + k] : 0.0;
            if (s[lane] >= 0) f[lane] = sample_of(rec, zs, ws, ras, decs, s[lane], S);
          }
          for (int i = 0; i < n; ++i) {
            const double* c = centres.data() + kPixelGrads * i;
            double q1[kWarpSize], q2[kWarpSize], sky[kWarpSize];
            T ef[kWarpSize], t[kWarpSize];
            int wlo = J, whi = -1;
            for (int lane = 0; lane < kWarpSize; ++lane) {
              lo[lane] = J;
              hi[lane] = -1;
              if (s[lane] < 0) continue;
              sample_pixel(wh, f[lane], c, q1[lane], q2[lane], sky[lane],
                           ef[lane], t[lane]);
              if (K > 0 && walk)
                kept_range(ef[lane], t[lane], starts.data(), zl_start, step_h,
                           inv_w, J, lo[lane], hi[lane]);
              else if (K > 0) {
                lo[lane] = 0;
                hi[lane] = J - 1;
              }
              wlo = lo[lane] < wlo ? lo[lane] : wlo;
              whi = hi[lane] > whi ? hi[lane] : whi;
            }
            double v[kPixelGrads][kWarpSize] = {};
            for (int lane = 0; lane < kWarpSize; ++lane) {
              if (s[lane] < 0) continue;
              T sg, su, sz;
              pixel_sums(ef[lane], t[lane], zl.data(), zeta.data(),
                         starts.data(),
                         rows.data() + size_t(live[i]) * row_stride(G), G, K,
                         lo[lane], hi[lane], wlo, whi, sg, su, sz);
              const int r = warp * kWarpSize + lane;
              pixel_tail(wh.norm, f[lane].wn, q1[lane], q2[lane], sky[lane], sg,
                         su, sz, acc[lane], epart[r], epart[kThreads + r],
                         v[0][lane], v[1][lane], v[2][lane]);
            }
            // warp_sum: lane 0's value after the shuffle tree
            for (int k = 0; k < kPixelGrads; ++k) {
              for (int o = kWarpSize / 2; o > 0; o >>= 1)
                for (int lane = 0; lane + o < kWarpSize; ++lane) v[k][lane] += v[k][lane + o];
              part[(kPixelGrads * i + k) * W + warp] += v[k][0];
            }
          }
          for (int lane = 0; lane < kWarpSize; ++lane)
            if (s[lane] >= 0)
              for (int k = 0; k < kSampleGrads; ++k)
                ds[s[lane] * kSampleGrads + k] = acc[lane][k];
        }
      }
      started = true;
      for (int m = 0; m < n * kPixelGrads; ++m) {
        double sum = 0.0;
        for (int v = 0; v < W; ++v) sum += part[W * m + v];
        dp[(p0 + live[m / kPixelGrads]) * kPixelGrads + m % kPixelGrads] = sum;
      }
    }
    if (!started)
      for (int i = 0; i < S * kSampleGrads; ++i) ds[i] = 0.0;
    for (int r = 0; r < kThreads; ++r) adjoint_event(epart.data(), dp, dv, P, r, kThreads);
  }
  return 0;
}

// One (sample, pixel)'s sums (sg, su, sz) by pixel_sums over the kept
// blocks of kept_range (walk 1; its [lo, hi] into range) or of every block
// (walk 0), for e and t given: the edge cases of the radius's range.
template <typename T>
void pixel_walk(T e, T t, const T* zl, const T* zeta, const T* dg,
                double zl_start, double step_h, int G, int K, int walk,
                T* out, int* range) {
  const int J = K > 0 ? (G + K - 1) / K : 0;
  std::vector<T> starts(J > 0 ? J : 1);
  for (int j = 0; j < J; ++j) starts[j] = start_of<T>(zl_start, step_h, j, K);
  int lo = 0, hi = J - 1;
  if (walk && K > 0)
    kept_range(e, t, starts.data(), zl_start, step_h,
               1.0 / (double(K) * step_h), J, lo, hi);
  range[0] = lo;
  range[1] = hi;
  pixel_sums(e, t, zl, zeta, starts.data(), dg, G, K, lo, hi, lo, hi, out[0],
             out[1], out[2]);
}

}  // namespace

#define KDE3D_ADJOINT_ENTRY(NAME, T, WALK)                                    \
  extern "C" int NAME(const T* z, const T* w, const T* ra, const T* dec,     \
                      const T* ra_pix, const T* dec_pix,                     \
                      const unsigned char* mask, const T* grids,             \
                      const int* z_block, const double* records,             \
                      const T* d_out, double* d_samp, double* d_pix,         \
                      double* d_event, int L, int E, int S, int P, int G) {  \
    return run_adjoint<T>(z, w, ra, dec, ra_pix, dec_pix, mask, grids,       \
                          z_block, records, d_out, d_samp, d_pix, d_event,  \
                          L, E, S, P, G, WALK);                              \
  }

KDE3D_ADJOINT_ENTRY(host_kde3d_adjoint_f32, float, 1)
KDE3D_ADJOINT_ENTRY(host_kde3d_adjoint_f64, double, 1)
// every block tested (the walk of K5b's first kernel)
KDE3D_ADJOINT_ENTRY(host_kde3d_adjoint_unpruned_f32, float, 0)
KDE3D_ADJOINT_ENTRY(host_kde3d_adjoint_unpruned_f64, double, 0)

#define KDE3D_WALK_ENTRY(NAME, T)                                             \
  extern "C" void NAME(T e, T t, const T* zl, const T* zeta, const T* dg,    \
                       double zl_start, double step_h, int G, int K,         \
                       int walk, T* out, int* range) {                       \
    pixel_walk<T>(e, t, zl, zeta, dg, zl_start, step_h, G, K, walk, out,     \
                  range);                                                    \
  }

KDE3D_WALK_ENTRY(host_kde3d_pixel_walk_f32, float)
KDE3D_WALK_ENTRY(host_kde3d_pixel_walk_f64, double)

#define KDE3D_ENTRY(NAME, T, PRUNE)                                           \
  extern "C" int NAME(const T* z, const T* w, const T* ra, const T* dec,     \
                      const T* ra_pix, const T* dec_pix,                     \
                      const unsigned char* mask, const T* grids,             \
                      const int* z_block, double* records, T* out, int L,    \
                      int E, int S, int P, int G, int bw_mode,               \
                      double bw_value) {                                     \
    return run<T>(z, w, ra, dec, ra_pix, dec_pix, mask, grids, z_block,      \
                  records, out, L, E, S, P, G, bw_mode, bw_value, PRUNE);    \
  }

KDE3D_ENTRY(host_kde3d_f32, float, true)
KDE3D_ENTRY(host_kde3d_f64, double, true)
KDE3D_ENTRY(host_kde3d_unpruned_f32, float, false)
KDE3D_ENTRY(host_kde3d_unpruned_f64, double, false)

extern "C" void host_kde3d_tally(long long* out) {
  std::memcpy(out, tally, sizeof(tally));
}

// K5b's shared memory and pixels a chunk (kde3d.cuh: adjoint_layout,
// adjoint_chunk), for the wrapper's copies; the offsets of the arrays read
// in 16-byte loads (rows, zl, zeta, starts) into out[0..3]
extern "C" long long host_kde3d_adjoint_smem(int G, int pc, int t_size,
                                             long long* out) {
  const AdjointLayout a = adjoint_layout(G, pc, size_t(t_size));
  out[0] = (long long)a.rows;
  out[1] = (long long)a.zl;
  out[2] = (long long)a.zeta;
  out[3] = (long long)a.starts;
  return (long long)a.total;
}

extern "C" int host_kde3d_adjoint_chunk(int P, int G, int t_size) {
  return adjoint_chunk(P, G, size_t(t_size));
}

// K5's skip radius (kde3d.cuh: skip_radius) of a sky factor e
extern "C" float host_kde3d_skip_radius_f32(float e) { return skip_radius(e); }
extern "C" double host_kde3d_skip_radius_f64(double e) { return skip_radius(e); }
