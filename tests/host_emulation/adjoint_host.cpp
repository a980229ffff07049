// Serial host emulation of the adjoint kernel K3
// (chimera_tpu_torch/csrc/fused_kde_adjoint.cu) from the same device
// functions (adjoint.cuh, population.cuh): per (lambda, event) the phases of
// the kernel, one sample after the other, with the block sums as plain
// loops.  Same C interface as the kernel's, without the scratch buffer and
// the stream.  Built by tests/test_torch_host_emulation.py.
#include <vector>

#include "adjoint.cuh"

namespace {

template <typename T, int KERNEL>
void run(const T* m1, const T* m2, const T* dl, const T* invp, const T* grids,
         const double* series, const T* params, const T* ct_den,
         const T* ct_stats, double* d_series, T* d_params, int L, int E, int S,
         int G, int cd, int wd, int bw_mode, double bw_value) {
  using N = Dual<T, kDirs>;
  const int Q = cd + 2 + wd, P = Q + kMassScalars;
  for (int l = 0; l < L; ++l) {
    std::vector<double> total(P, 0.0);
    std::vector<T> ser(Q);
    for (int i = 0; i < Q; ++i) ser[i] = T(series[(size_t)l * Q + i]);
    const T* prm = params + (size_t)l * kMassScalars;
    MassModel<N> dual_mass;
    SampleAdjoint<T>::seed_mass(dual_mass, prm);
    const Model<T, T> model(ser.data(), prm, cd, wd);
    const SampleAdjoint<T> sample(ser.data(), cd, wd);
    for (int e = 0; e < E; ++e) {
      std::vector<T> z(S), w(S), dz(S), dw(S);
      const size_t row = (size_t)e * S;
      T sum_w = 0, sum_w2 = 0, sum_z = 0;
      for (int s = 0; s < S; ++s) {
        z[s] = model.z_from_dgw(dl[row + s]);
        const T inv1pz = T(1) / (T(1) + z[s]);
        w[s] = model.p_m1m2(m1[row + s] * inv1pz, m2[row + s] * inv1pz)
               * invp[row + s];
        sum_w += w[s];
        sum_w2 += w[s] * w[s];
        sum_z += z[s];
      }
      const T z_mean = sum_z / T(S);
      T ss = 0;
      for (int s = 0; s < S; ++s) ss += (z[s] - z_mean) * (z[s] - z_mean);
      const RowAdjoint<T> stats(sum_w, sum_w2, z_mean, ss / T(S), S, bw_mode,
                                (T)bw_value);
      const T inv_h = T(1) / stats.h;
      const size_t out_row = (size_t)l * E + e;
      T kde0 = 0, kde1 = 0;
      for (int s = 0; s < S; ++s) {
        T a0 = 0, a1 = 0, a2 = 0;
        for (int g = 0; g < G; ++g)
          kde_pair<T, KERNEL>((grids[(size_t)e * G + g] - z[s]) * inv_h,
                              ct_den[out_row * G + g] * (inv_h / T(S)), a0, a1,
                              a2);
        T wb;
        kde_sample<T, KERNEL>(a0, a1, a2, w[s], inv_h, dw[s], dz[s], wb);
        kde0 += w[s] * dw[s];
        kde1 += wb;
      }
      T cz, d_sw, d_sw2;
      stats.backward(ct_stats + out_row * 8, -inv_h * (kde0 + kde1), cz, d_sw,
                     d_sw2);
      T g_cheb[kMaxDeg] = {0}, g_win[kMaxDeg] = {0}, g_mass[kMassScalars] = {0};
      T g_lo = 0, g_hi = 0;
      for (int s = 0; s < S; ++s)
        sample.add(dual_mass, m1[row + s], m2[row + s], dl[row + s],
                   invp[row + s], dz[s] + cz * (z[s] - z_mean),
                   dw[s] + d_sw + T(2) * w[s] * d_sw2, g_cheb, g_lo, g_hi,
                   g_win, g_mass);
      for (int i = 0; i < cd; ++i) total[i] += g_cheb[i];
      total[cd] += g_lo;
      total[cd + 1] += g_hi;
      for (int i = 0; i < wd; ++i) total[cd + 2 + i] += g_win[i];
      for (int i = 0; i < kMassScalars; ++i) total[Q + i] += g_mass[i];
    }
    for (int i = 0; i < Q; ++i) d_series[(size_t)l * Q + i] = total[i];
    for (int i = 0; i < kMassScalars; ++i)
      d_params[(size_t)l * kMassScalars + i] = T(total[Q + i]);
  }
}

template <typename T>
void dispatch(const T* m1, const T* m2, const T* dl, const T* invp,
              const T* grids, const double* series, const T* params,
              const T* ct_den, const T* ct_stats, double* d_series,
              T* d_params, int L, int E, int S, int G, int cd, int wd,
              int kernel, int bw_mode, double bw_value) {
  if (kernel == 0)
    run<T, 0>(m1, m2, dl, invp, grids, series, params, ct_den, ct_stats,
              d_series, d_params, L, E, S, G, cd, wd, bw_mode, bw_value);
  else
    run<T, 1>(m1, m2, dl, invp, grids, series, params, ct_den, ct_stats,
              d_series, d_params, L, E, S, G, cd, wd, bw_mode, bw_value);
}

}  // namespace

extern "C" void host_fused_kde_adjoint_f32(
    const float* m1, const float* m2, const float* dl, const float* invp,
    const float* grids, const double* series, const float* params,
    const float* ct_den, const float* ct_stats, double* d_series,
    float* d_params, int L, int E, int S, int G, int cd, int wd, int kernel,
    int bw_mode, double bw_value) {
  dispatch<float>(m1, m2, dl, invp, grids, series, params, ct_den, ct_stats,
                  d_series, d_params, L, E, S, G, cd, wd, kernel, bw_mode,
                  bw_value);
}

extern "C" void host_fused_kde_adjoint_f64(
    const double* m1, const double* m2, const double* dl, const double* invp,
    const double* grids, const double* series, const double* params,
    const double* ct_den, const double* ct_stats, double* d_series,
    double* d_params, int L, int E, int S, int G, int cd, int wd, int kernel,
    int bw_mode, double bw_value) {
  dispatch<double>(m1, m2, dl, invp, grids, series, params, ct_den, ct_stats,
                   d_series, d_params, L, E, S, G, cd, wd, kernel, bw_mode,
                   bw_value);
}
