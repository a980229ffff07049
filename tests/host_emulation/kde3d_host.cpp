// Serial host emulation of K5 (chimera_tpu_torch/csrc/kde3d.cu), the 3-D
// lattice KDE of the 'full' likelihood, from the same device functions
// (kde3d.cuh): the prologue per (lambda, event) and the main kernel per
// (lambda, event, pixel), each phase run for every one of the kernel's
// kThreads ranks in turn, with the kernel's barriers between phases.  Same
// C interface as the kernel's, without the stream.  Built by
// tests/test_torch_full.py.
#include <vector>

#include "kde3d.cuh"

namespace {

using namespace kde3d;

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

template <typename T, int KMAX>
void recurrence(const double* rec, const T* es, const T* ts, int S, double zg0,
                int G, int K, T* part, T* out) {
  for (int r = 0; r < kThreads; ++r)
    recurrence_sweep<T, KMAX>(rec, es, ts, S, zg0, G, K, part, out, r, kThreads);
  for (int r = 0; r < kThreads; ++r)
    recurrence_fold<T, KMAX>(rec, part, G, K, out, r, kThreads);
}

template <typename T>
int run(const T* z, const T* w, const T* ra, const T* dec, const T* ra_pix,
        const T* dec_pix, const unsigned char* mask, const T* grids,
        const int* z_block, double* records, T* out, int L, int E, int S,
        int P, int G, int bw_mode, double bw_value) {
  if (L <= 0 || E <= 0 || S <= 0 || P <= 0 || G <= 0) return 1;
  for (size_t le = 0; le < size_t(L) * E; ++le)
    prologue(z, w, ra, dec, grids, E, S, G, bw_mode, bw_value, records, le);
  std::vector<T> es(S), ts(S), part(kThreads * kMaxBlock);
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
    for (int r = 0; r < kThreads; ++r)
      sample_factors(rec, z + le * S, w + le * S, ra + size_t(e) * S,
                     dec + size_t(e) * S, S, ra_pix[size_t(e) * P + p],
                     dec_pix[size_t(e) * P + p], es.data(), ts.data(), r,
                     kThreads);
    const T* grid = grids + size_t(e) * G;
    const int K = k_req < G ? k_req : G;
    if (K == 0)
      for (int r = 0; r < kThreads; ++r)
        dense_sweep(rec, es.data(), ts.data(), S, grid, G, o, r, kThreads);
    else if (K <= 8)
      recurrence<T, 8>(rec, es.data(), ts.data(), S, double(grid[0]), G, K,
                       part.data(), o);
    else if (K <= 16)
      recurrence<T, 16>(rec, es.data(), ts.data(), S, double(grid[0]), G, K,
                        part.data(), o);
    else
      recurrence<T, kMaxBlock>(rec, es.data(), ts.data(), S, double(grid[0]),
                               G, K, part.data(), o);
  }
  return 0;
}

}  // namespace

extern "C" int host_kde3d_f32(const float* z, const float* w, const float* ra,
                              const float* dec, const float* ra_pix,
                              const float* dec_pix, const unsigned char* mask,
                              const float* grids, const int* z_block,
                              double* records, float* out, int L, int E, int S,
                              int P, int G, int bw_mode, double bw_value) {
  return run<float>(z, w, ra, dec, ra_pix, dec_pix, mask, grids, z_block,
                    records, out, L, E, S, P, G, bw_mode, bw_value);
}

extern "C" int host_kde3d_f64(const double* z, const double* w,
                              const double* ra, const double* dec,
                              const double* ra_pix, const double* dec_pix,
                              const unsigned char* mask, const double* grids,
                              const int* z_block, double* records, double* out,
                              int L, int E, int S, int P, int G, int bw_mode,
                              double bw_value) {
  return run<double>(z, w, ra, dec, ra_pix, dec_pix, mask, grids, z_block,
                     records, out, L, E, S, P, G, bw_mode, bw_value);
}
