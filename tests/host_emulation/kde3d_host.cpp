// Serial host emulation of K5 (chimera_tpu_torch/csrc/kde3d.cu), the 3-D
// lattice KDE of the 'full' likelihood, from the same device functions
// (kde3d.cuh): the prologue per (lambda, event) and the main kernel per
// (lambda, event, pixel), each phase run for every one of the kernel's
// kThreads ranks in turn, with the kernel's barriers between phases.  Same
// C interface as the kernel's, without the stream; the host_kde3d_unpruned_
// entries walk every sample (the oracle of the pruned walk), and
// host_kde3d_tally reads what the last call's pruned walk did;
// host_kde3d_adjoint_ is K5b (kde3d_adjoint_kernel) with the same C
// interface as its kernel's.  Built by tests/test_torch_full.py.
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

// K5b (kde3d.cu, kde3d_adjoint_kernel) per (lambda, event), each phase
// for every rank in turn, on the records K5 wrote: the real pixels in
// order (a pixel whose cotangent row is all 0 skipped), then the event's
// sums.
template <typename T>
int run_adjoint(const T* z, const T* w, const T* ra, const T* dec,
                const T* ra_pix, const T* dec_pix, const unsigned char* mask,
                const T* grids, const int* z_block, const double* records,
                const T* d_out, double* d_samp, double* d_pix,
                double* d_event, int L, int E, int S, int P, int G) {
  if (L <= 0 || E <= 0 || S <= 0 || P <= 0 || G <= 0) return 1;
  std::vector<double> part(kPixelGrads * kThreads), l00_part(2 * kThreads);
  std::vector<T> zl(G), zeta(G), dg(G);
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
    const int K = k_req < G ? k_req : G;
    const T* grid = grids + size_t(e) * G;
    for (int r = 0; r < kThreads; ++r)
      adjoint_start(rec, grid, G, zl.data(), zeta.data(), ds, l00_part.data(),
                    S, r, kThreads);
    for (int p = 0; p < P; ++p) {
      double* dpp = dp + p * kPixelGrads;
      if (!mask[size_t(e) * P + p]) {
        for (int k = 0; k < kPixelGrads; ++k) dpp[k] = 0.0;
        continue;
      }
      for (int r = 0; r < kThreads; ++r)
        stage_cotangent(d_out + (le * P + p) * G, G, dg.data(), part.data(), r,
                        kThreads);
      if (!any_part(part.data(), kThreads)) {
        for (int k = 0; k < kPixelGrads; ++k) dpp[k] = 0.0;
        continue;
      }
      for (int r = 0; r < kThreads; ++r)
        adjoint_pixel(rec, z + le * S, w + le * S, ra + size_t(e) * S,
                      dec + size_t(e) * S, S, ra_pix[size_t(e) * P + p],
                      dec_pix[size_t(e) * P + p], zl.data(), zeta.data(),
                      dg.data(), double(grid[0]), G, K, ds, part.data(),
                      l00_part.data(), r, kThreads);
      for (int k = 0; k < kPixelGrads; ++k)
        dpp[k] = ordered_sum(part.data() + k * kThreads, kThreads);
    }
    for (int r = 0; r < kThreads; ++r)
      adjoint_event(l00_part.data(), dp, dv, P, r, kThreads);
  }
  return 0;
}

}  // namespace

#define KDE3D_ADJOINT_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const T* z, const T* w, const T* ra, const T* dec,     \
                      const T* ra_pix, const T* dec_pix,                     \
                      const unsigned char* mask, const T* grids,             \
                      const int* z_block, const double* records,             \
                      const T* d_out, double* d_samp, double* d_pix,         \
                      double* d_event, int L, int E, int S, int P, int G) {  \
    return run_adjoint<T>(z, w, ra, dec, ra_pix, dec_pix, mask, grids,       \
                          z_block, records, d_out, d_samp, d_pix, d_event,  \
                          L, E, S, P, G);                                    \
  }

KDE3D_ADJOINT_ENTRY(host_kde3d_adjoint_f32, float)
KDE3D_ADJOINT_ENTRY(host_kde3d_adjoint_f64, double)

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
