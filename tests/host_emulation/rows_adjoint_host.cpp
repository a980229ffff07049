// Serial host emulation of the rows contraction K2
// (chimera_tpu_torch/csrc/rows_contract.cu) and of its adjoint K2b
// (rows_contract_adjoint.cu) from the same device functions (adjoint.cuh's
// rows_contract_event, write_record and rows_adjoint_event,
// population.cuh): per (lambda, event) the kernels' sweep of the event's
// rows with a block of one thread; for K2b per lambda the prologue's record
// first and the events' gradients summed in event order in double.  Same
// C interfaces as the kernels', without the scratch buffer and the stream;
// besides, K2 and K2b with the full loops (the pruned loops' oracle), the
// kernels' z(dL) and a tally of the tiles the loops skip.  Built once a
// mass model (CHIMERA_MASS_KIND, population.cuh) by the host-emulation
// tests.
#include <vector>

#include "host_block.h"
#include "adjoint.cuh"

namespace {

// the tiles that the pruned passes tested and skipped (host_tile_tally)
long long g_tally[2] = {0, 0};

template <typename T, int KERNEL, bool PRUNE>
void run_kernel(const RowsAdjointArgs<T>& a, double* d_series, T* d_params) {
  using T2 = typename Pair<T>::type;
  const int cd = a.cheb_deg, wd = a.window_deg;
  const int Q = cd + 2 + wd, P = Q + kMassScalars;
  std::vector<double> store(record_bytes<T, double>(cd, wd) / sizeof(double) + 2);
  unsigned char* rec_bytes = reinterpret_cast<unsigned char*>(store.data());
  std::vector<T2> zw(a.chunk), gc(a.G), zt((a.chunk + kTileS - 1) / kTileS),
      gt((a.G + kGridTile - 1) / kGridTile);
  std::vector<T> grid(a.G), f1(a.G), f2(a.G), df1(a.G), df2(a.G),
      dz(a.chunk), dw(a.chunk), kx(a.chunk), kg(a.chunk);
  const RowsSmem<T> sm{zw.data(), gc.data(), zt.data(), gt.data(),
                       grid.data(), f1.data(), f2.data(), df1.data(),
                       df2.data(), dz.data(), dw.data()
#if CHIMERA_MASS_KIND == 4
                       , kx.data(), kg.data()
#endif
  };
  for (int l = 0; l < a.L; ++l) {
    write_record<T, double>(a.series + (size_t)l * Q,
                            a.params + (size_t)l * kMassScalars, cd, wd,
                            rec_bytes, 0, 1);
    const Record<T, double> rec(rec_bytes, cd, wd);
    const Model<T, double> model(rec.series, rec.fields, cd, wd,
                                 rec.fields + kMassScalars);
    const SampleAdjoint<T, double> sample(model, rec.consts);
    std::vector<double> total(P, 0.0);
    for (int e = 0; e < a.E; ++e) {
      GradAcc<T, 1> g;
      g.zero();
      rows_adjoint_event<T, KERNEL, PRUNE>(HostBlock<T>{g_tally}, model,
                                           sample, a, l, e, sm, g);
      for (int i = 0; i < P; ++i) total[i] += double(column(g, rec.jac, i, cd, wd));
    }
    for (int i = 0; i < Q; ++i) d_series[(size_t)l * Q + i] = total[i];
    for (int i = 0; i < kMassScalars; ++i)
      d_params[(size_t)l * kMassScalars + i] = T(total[Q + i]);
  }
}

// K2: per (lambda, event) the kernel's sweep of the event's rows
// (rows_contract_event) with a block of one thread; PRUNE false: the full
// loop, the pruned loop's oracle.
template <typename T, int KERNEL, bool PRUNE>
void run_contract(const RowsArgs<T>& a) {
  using T2 = typename Pair<T>::type;
  const int Q = a.cheb_deg + 2 + a.window_deg;
  std::vector<T2> zw(a.chunk), zt((a.chunk + kTileS - 1) / kTileS);
  std::vector<T> grid(a.G), f1(a.G), f2(a.G), den(a.G);
  const RowsContractSmem<T> sm{zw.data(), zt.data(), grid.data(), f1.data(),
                               f2.data(), den.data()};
  for (int l = 0; l < a.L; ++l) {
    const Model<T, double> model(a.series + (size_t)l * Q,
                                 a.params + (size_t)l * kMassScalars,
                                 a.cheb_deg, a.window_deg);
    for (int e = 0; e < a.E; ++e)
      rows_contract_event<T, KERNEL, PRUNE>(HostBlock<T>{g_tally}, model, a,
                                            l, e, sm);
  }
}

template <typename T>
void contract(const T* m1, const T* m2, const T* dl, const T* invp,
              const T* grids, const double* series, const T* params,
              const T* hs, const T* s1, const T* s2, const T* f1, const T* f2,
              T* out, int L, int E, int C, int chunk, int G, int cd, int wd,
              int kernel, bool prune) {
  const RowsArgs<T> a{m1, m2, dl, invp, grids, series, params, hs, s1, s2,
                      f1, f2, out, L, E, C, chunk, G, cd, wd};
  if (kernel == 0 && prune) run_contract<T, 0, true>(a);
  else if (kernel == 0) run_contract<T, 0, false>(a);
  else run_contract<T, 1, false>(a);
}

// prune = false: the full loops, the pruned passes' oracle
template <typename T>
void run(const T* m1, const T* m2, const T* dl, const T* invp, const T* grids,
         const double* series, const T* params, const T* hs, const T* s1,
         const T* s2, const T* f1, const T* f2, const T* ct, double* d_series,
         T* d_params, T* d_hs, T* d_f1, T* d_f2, int L, int E, int C,
         int chunk, int G, int cd, int wd, int kernel, bool prune = true) {
  const RowsAdjointArgs<T> a{m1, m2, dl, invp, grids, series, params, hs, s1,
                             s2, f1, f2, ct, nullptr, d_hs, d_f1, d_f2, L, E,
                             C, chunk, G, cd, wd};
  if (kernel == 0 && prune) run_kernel<T, 0, true>(a, d_series, d_params);
  else if (kernel == 0) run_kernel<T, 0, false>(a, d_series, d_params);
  else run_kernel<T, 1, false>(a, d_series, d_params);
}

}  // namespace

extern "C" void host_rows_contract_adjoint_f32(
    const float* m1, const float* m2, const float* dl, const float* invp,
    const float* grids, const double* series, const float* params,
    const float* hs, const float* s1, const float* s2, const float* f1,
    const float* f2, const float* ct, double* partials, double* d_series,
    float* d_params, float* d_hs, float* d_f1, float* d_f2, int L, int E,
    int C, int chunk, int G, int cd, int wd, int kernel) {
  (void)partials;
  run<float>(m1, m2, dl, invp, grids, series, params, hs, s1, s2, f1, f2, ct,
             d_series, d_params, d_hs, d_f1, d_f2, L, E, C, chunk, G, cd, wd,
             kernel);
}

extern "C" void host_rows_contract_adjoint_f64(
    const double* m1, const double* m2, const double* dl, const double* invp,
    const double* grids, const double* series, const double* params,
    const double* hs, const double* s1, const double* s2, const double* f1,
    const double* f2, const double* ct, double* partials, double* d_series,
    double* d_params, double* d_hs, double* d_f1, double* d_f2, int L, int E,
    int C, int chunk, int G, int cd, int wd, int kernel) {
  (void)partials;
  run<double>(m1, m2, dl, invp, grids, series, params, hs, s1, s2, f1, f2, ct,
              d_series, d_params, d_hs, d_f1, d_f2, L, E, C, chunk, G, cd, wd,
              kernel);
}

// K2 (rows_contract.cu's C interface, without the stream), and K2 with the
// full loop, the pruned loop's oracle
#define ROWS_CONTRACT(T, NAME, PRUNE)                                        \
  extern "C" void NAME(                                                      \
      const T* m1, const T* m2, const T* dl, const T* invp, const T* grids,  \
      const double* series, const T* params, const T* hs, const T* s1,       \
      const T* s2, const T* f1, const T* f2, T* out, int L, int E, int C,    \
      int chunk, int G, int cd, int wd, int kernel) {                        \
    contract<T>(m1, m2, dl, invp, grids, series, params, hs, s1, s2, f1, f2, \
                out, L, E, C, chunk, G, cd, wd, kernel, PRUNE);              \
  }
ROWS_CONTRACT(float, host_rows_contract_f32, true)
ROWS_CONTRACT(double, host_rows_contract_f64, true)
ROWS_CONTRACT(float, host_rows_contract_unpruned_f32, false)
ROWS_CONTRACT(double, host_rows_contract_unpruned_f64, false)

// K2b with the full loops of both passes, the pruned passes' oracle
#define ROWS_UNPRUNED(T, NAME)                                               \
  extern "C" void NAME(                                                      \
      const T* m1, const T* m2, const T* dl, const T* invp, const T* grids,  \
      const double* series, const T* params, const T* hs, const T* s1,       \
      const T* s2, const T* f1, const T* f2, const T* ct, double* partials,  \
      double* d_series, T* d_params, T* d_hs, T* d_f1, T* d_f2, int L,       \
      int E, int C, int chunk, int G, int cd, int wd, int kernel) {          \
    (void)partials;                                                          \
    run<T>(m1, m2, dl, invp, grids, series, params, hs, s1, s2, f1, f2, ct,  \
           d_series, d_params, d_hs, d_f1, d_f2, L, E, C, chunk, G, cd, wd,  \
           kernel, false);                                                   \
  }
ROWS_UNPRUNED(float, host_rows_contract_adjoint_unpruned_f32)
ROWS_UNPRUNED(double, host_rows_contract_adjoint_unpruned_f64)

// z(dL) of n distances as K2b computes them (Model<T, double>::z_from_dgw),
// from one lambda's packed rows
#define ROWS_Z(T, NAME)                                                      \
  extern "C" void NAME(const double* series, const T* params, int cd, int wd, \
                       const T* dl, int n, T* z) {                           \
    const Model<T, double> model(series, params, cd, wd);                    \
    for (int i = 0; i < n; ++i) z[i] = model.z_from_dgw(dl[i]);              \
  }
ROWS_Z(float, host_rows_z_f32)
ROWS_Z(double, host_rows_z_f64)

// the tile widths of the pruned pair loops: kTileS, kTileG, kGridTile,
// kK4bTile
extern "C" void host_tile_widths(int* out) {
  out[0] = kTileS;
  out[1] = kTileG;
  out[2] = kGridTile;
  out[3] = kK4bTile;
  out[4] = kK4Tile;
}

// the tiles that the pruned passes tested and skipped since the last call:
// out[0] tested, out[1] skipped
extern "C" void host_tile_tally(long long* out) {
  out[0] = g_tally[0];
  out[1] = g_tally[1];
  g_tally[0] = g_tally[1] = 0;
}
