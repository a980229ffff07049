// The adjoints of the fused weights+KDE pass (K3, fused_kde_adjoint.cu) and
// of the rows contraction (K2b, rows_contract_adjoint.cu), each the
// derivative of the forward as the plain versions compute it
// (ops/cuda/fused.py::fused_weights_kde_plain, ops/cuda/rows.py::
// fused_rows_contract_plain), and the rows contraction itself (K2,
// rows_contract.cu), which shares K2b's layout and pruned pair loop:
//
//   prologue_kernel     per lambda, once a launch: the two Chebyshev series
//                       in the summation type, the mass model's scalars and
//                       derived fields and the Jacobian of the derived
//                       fields that carry a cotangent in the scalars (a
//                       record, copied by every block).
//   Dual<T, N>          forward-mode dual number with N directions: the
//                       prologue's engine for that Jacobian (MassModel<N>
//                       of population.cuh on it), and the host tests' oracle
//                       of the reverse sweep below.
//   kde_pair            one (grid point, sample) term of the KDE adjoint.
//   RowAdjoint          the chain through the safe-math row statistics.
//   SampleAdjoint       the chain of one sample's (dz, dw) through
//                       z(dL | cosmo) and w(m1, m2, z | mass): the mass model
//                       by a hand-written reverse sweep (mass_vjp) into the
//                       fields' cotangents, the two Chebyshev series summed
//                       in S as the forward sums them (population.cuh,
//                       Model), the cotangents of the two series' values
//                       left as points (t, a) to project.
//   project             the projections sum_s a_s T_k(t_s) of a row, 64
//                       coefficients per thread in registers, then reduced
//                       and scattered over the warp 32 at a time: lane j
//                       keeps the coefficients k = j (mod 32).  No
//                       per-thread array is indexed at run time.
//   adjoint_row         K3 for one (lambda, row) in every mode of the
//                       forward (kde.cuh, FusedMode);
//   rows_contract_event K2, the rows contraction, for one (lambda, event);
//   rows_adjoint_event  K2b for one (lambda, event);
//                       both written once for a `Block` (population.cuh,
//                       DeviceBlock; WarpBlock, a warp as a block of its
//                       own; a block of one thread in the host emulation,
//                       tests/host_emulation).
//   store_partials,     the fixed-order sums of the per-thread gradients:
//   reduce_events_kernel  over the block, with the derived fields chained
//                       to the scalars once, then over the blocks.

#pragma once

#include <type_traits>

#include "kde.cuh"

namespace {

// the dual numbers' directions: the mass scalars, z, the window series' value
constexpr int kDirs = kMassScalars + 2;
constexpr int kZDir = kMassScalars;
constexpr int kCdfDir = kMassScalars + 1;
// largest Chebyshev degree of either series (_ADJOINT_MAX_DEG in
// ops/cuda/fused.py): two chunks of 32 projected coefficients
constexpr int kMaxDeg = 64;
constexpr int kChunk = 32;
static_assert(kMaxDeg == 2 * kChunk, "project() runs two chunks");

template <typename T, int N>
struct Dual {
  T v;
  T d[N];

  Dual() = default;
  template <typename U,
            typename = typename std::enable_if<std::is_arithmetic<U>::value>::type>
  __device__ __forceinline__ Dual(U x) : v(T(x)) {
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] = T(0);
  }
};

// the value v with derivative 1 in direction dir
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> seed(T v, int dir) {
  Dual<T, N> r(v);
  r.d[dir] = T(1);
  return r;
}

#define DUAL_TN template <typename T, int N> __device__ __forceinline__

DUAL_TN Dual<T, N> operator+(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}

DUAL_TN Dual<T, N> operator-(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}

DUAL_TN Dual<T, N> operator-(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = -a.d[i];
  return r;
}

DUAL_TN Dual<T, N> operator*(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}

DUAL_TN Dual<T, N> operator/(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  const T inv = T(1) / b.v;
  r.v = a.v * inv;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) * inv;
  return r;
}

// r.v = v, r.d = dv * a.d: the chain rule of a function of one argument
DUAL_TN Dual<T, N> chain(const Dual<T, N>& a, T v, T dv) {
  Dual<T, N> r;
  r.v = v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = dv * a.d[i];
  return r;
}

DUAL_TN Dual<T, N> dexp(const Dual<T, N>& a) {
  const T e = dexp(a.v);
  return chain(a, e, e);
}
DUAL_TN Dual<T, N> dlog(const Dual<T, N>& a) {
  return chain(a, dlog(a.v), T(1) / a.v);
}
DUAL_TN Dual<T, N> dlog1p(const Dual<T, N>& a) {
  return chain(a, dlog1p(a.v), T(1) / (T(1) + a.v));
}
DUAL_TN Dual<T, N> dabs(const Dual<T, N>& a) {
  return chain(a, dabs(a.v), a.v > T(0) ? T(1) : (a.v < T(0) ? T(-1) : T(0)));
}
DUAL_TN bool finite(const Dual<T, N>& a) { return finite(a.v); }
DUAL_TN T scalar_of(const Dual<T, N>& a) { return a.v; }
DUAL_TN bool operator<(const Dual<T, N>& a, const Dual<T, N>& b) { return a.v < b.v; }
DUAL_TN bool operator<=(const Dual<T, N>& a, const Dual<T, N>& b) { return a.v <= b.v; }
DUAL_TN bool operator>(const Dual<T, N>& a, const Dual<T, N>& b) { return a.v > b.v; }
DUAL_TN bool operator>=(const Dual<T, N>& a, const Dual<T, N>& b) { return a.v >= b.v; }
DUAL_TN bool operator==(const Dual<T, N>& a, const Dual<T, N>& b) { return a.v == b.v; }

#undef DUAL_TN


// The cotangents of the mass model's fields that carry one: its scalars
// (MODEL_SCALARS of its class in ops/cuda/fused.py), then the derived fields
// of MassModel::carried(), which derive() fills; the other derived fields
// enter comparisons only.  MassConsts: per-lambda constants of the reverse
// sweep (SampleAdjoint::mass_vjp), written by the prologue after the
// fields: reciprocals of the fields it divides by, and the closed form's
// power at m_join (m_low without a window), padded so that a record is a
// multiple of 16 bytes.
#if CHIMERA_MASS_KIND == 0  // PowerLawPeak
enum MassGrad {
  kMLow, kMHigh, kAlpha, kBeta, kDeltaM, kLambdaPeak, kMuG, kSigmaG,
  kPeakNorm, kNormPM1, kMJoin, kCdfAtJoin, kPlNorm, kLogSigma, kMassGrads
};
template <typename T>
struct MassConsts {
  T inv_pl_norm, inv_peak_norm, inv_norm_p_m1;
  T inv_den2;       // 1 / (2 sigma_g^2)
  T inv_window;     // 1 / (m_join - m_low)
  T ap, inv_ap;     // 1 + beta and its reciprocal
  T inv_m_join, log_m_join, pow_join;  // m_join^(1 + beta)
  T pad[2];         // to 16 bytes in float and double
};
#elif CHIMERA_MASS_KIND == 1  // TruncatedPowerLaw
enum MassGrad { kMLow, kMHigh, kAlpha, kBeta, kNormPM1, kMassGrads };
template <typename T>
struct MassConsts {
  T inv_norm_p_m1;
  T ap, inv_ap;     // 1 + beta and its reciprocal
  T inv_m_low, log_m_low, pow_low;  // m_low^(1 + beta)
};
#elif CHIMERA_MASS_KIND == 2  // BrokenPowerLaw
enum MassGrad {
  kMLow, kMHigh, kAlpha1, kAlpha2, kBeta, kDeltaM, kBreakFraction, kNormPM1,
  kMJoin, kCdfAtJoin, kPl1AtBreak, kPl2AtBreak, kMassGrads
};
template <typename T>
struct MassConsts {
  T inv_pl2_at_break, inv_norm_p_m1, inv_window, ap, inv_ap;
  T inv_m_join, log_m_join, pow_join;
  T pad[2];
};
#elif CHIMERA_MASS_KIND == 3  // PowerLawTwoPeaks
enum MassGrad {
  kMLow, kMHigh, kAlpha, kBeta, kDeltaM, kLambdaPeak, kLambda1, kMu1G,
  kSigma1G, kMu2G, kSigma2G, kPeak1Norm, kPeak2Norm, kNormPM1, kMJoin,
  kCdfAtJoin, kPlNorm, kLogSigma1, kLogSigma2, kMassGrads
};
template <typename T>
struct MassConsts {
  T inv_pl_norm, inv_peak1_norm, inv_peak2_norm, inv_den2_1, inv_den2_2;
  T inv_norm_p_m1, inv_window, ap, inv_ap, inv_m_join, log_m_join, pow_join;
  T pad[2];
};
#else  // PowerLawSpline: the 8 scalars before num_knots, the knots' logs
enum MassGrad {
  kMLow, kMHigh, kAlpha, kBeta, kDeltaM, kNormPM1, kMJoin, kCdfAtJoin,
  kLogLo, kLogHi, kMassGrads
};
template <typename T>
struct MassConsts {
  T inv_norm_p_m1, inv_window, ap, inv_ap, inv_m_join, log_m_join, pow_join;
  T pad[2];
};
#endif
#if CHIMERA_MASS_KIND == 4
// the scalars with a cotangent slot of their own: num_knots has none, and
// the coefficients' cotangents are the knots' points (project_knots), a
// warp's reduce-scatter of each sample's two weights, not a register each
constexpr int kGradScalars = kCdfAtJoin + 1;
#else
constexpr int kGradScalars = kMassScalars;
#endif
static_assert(kMassGrads == kGradScalars + kCarried, "a cotangent a field");
constexpr int kDerived = kMassGrads - kGradScalars;  // carried and chained
constexpr int kMassFields = kMassScalars + kDerivedFields;
constexpr int kConsts = sizeof(MassConsts<float>) / sizeof(float);

template <typename T>
__device__ __forceinline__ void write_consts(const MassModel<T>& m,
                                             MassConsts<T>& k) {
#if CHIMERA_MASS_KIND == 1
  k.inv_norm_p_m1 = T(1) / m.norm_p_m1;
  k.ap = T(1) + m.beta;
  k.inv_ap = T(1) / k.ap;
  k.inv_m_low = T(1) / m.m_low;
  k.log_m_low = dlog(m.m_low);
  k.pow_low = dexp(k.ap * k.log_m_low);
#else
#if CHIMERA_MASS_KIND == 0
  k.inv_pl_norm = T(1) / m.pl_norm;
  k.inv_peak_norm = T(1) / m.peak_norm;
  k.inv_den2 = T(1) / (T(2) * (m.sigma_g * m.sigma_g));
#elif CHIMERA_MASS_KIND == 2
  k.inv_pl2_at_break = T(1) / m.pl2_at_break;
#elif CHIMERA_MASS_KIND == 3
  k.inv_pl_norm = T(1) / m.pl_norm;
  k.inv_peak1_norm = T(1) / m.peak1_norm;
  k.inv_peak2_norm = T(1) / m.peak2_norm;
  k.inv_den2_1 = T(1) / (T(2) * (m.sigma1_g * m.sigma1_g));
  k.inv_den2_2 = T(1) / (T(2) * (m.sigma2_g * m.sigma2_g));
#endif
  k.inv_norm_p_m1 = T(1) / m.norm_p_m1;
  k.inv_window = T(1) / (m.m_join - m.m_low);
  k.ap = T(1) + m.beta;
  k.inv_ap = T(1) / k.ap;
  k.inv_m_join = T(1) / m.m_join;
  k.log_m_join = dlog(m.m_join);
  k.pow_join = dexp(k.ap * k.log_m_join);
  k.pad[0] = k.pad[1] = T(0);
#endif
}

// the dual mass model of a lambda's scalars, direction i for scalar i
template <typename T>
__device__ __forceinline__ void seed_mass(MassModel<Dual<T, kDirs>>& mm,
                                          const T* s) {
  int i = 0;
  mm.scalars([&](Dual<T, kDirs>& x) {
    x = seed<T, kDirs>(s[i], i);
    ++i;
  });
  mm.derive();
}

// ---------------------------------------------------------------------------
// The per-lambda prologue
// ---------------------------------------------------------------------------

// A lambda's record: the series row (cheb_logh, dgw_lo, dgw_max, window) in
// S, padded to 16 bytes (series_bytes), then in T the mass fields (the
// scalars and MassModel::derived()), the Jacobian (kDerived, kMassScalars)
// of the carried fields in the scalars and the reverse sweep's MassConsts:
// PowerLawPeak's 12 + 4 + 24 + 12 = 52 values, a multiple of 16 bytes in
// every model.
constexpr int kRecordValues = kMassFields + kDerived * kMassScalars + kConsts;
static_assert(kRecordValues % 4 == 0, "a record is a multiple of 16 bytes");
template <typename T, typename S>
__host__ __device__ constexpr size_t record_bytes(int cd, int wd) {
  return series_bytes<S>(cd, wd) + kRecordValues * sizeof(T);
}

template <typename T, typename S>
struct Record {
  const S* series;
  const T* fields;  // kMassFields
  const T* jac;     // (kDerived, kMassScalars)
  const MassConsts<T>* consts;
  __device__ __forceinline__ Record(const unsigned char* p, int cd, int wd)
      : series(reinterpret_cast<const S*>(p)),
        fields(reinterpret_cast<const T*>(p + series_bytes<S>(cd, wd))),
        jac(fields + kMassFields),
        consts(reinterpret_cast<const MassConsts<T>*>(
            jac + kDerived * kMassScalars)) {}
};

// Write a lambda's record from its packed rows (series in double, the 12 mass
// scalars); the threads rank, rank + stride, ... share the series, rank 0
// runs the dual derive() for the derived fields and their Jacobian.
template <typename T, typename S>
__device__ __forceinline__ void write_record(const double* series,
                                             const T* params, int cd, int wd,
                                             unsigned char* rec, int rank,
                                             int stride) {
  S* ser = reinterpret_cast<S*>(rec);
  for (int i = rank; i < cd + 2 + wd; i += stride) ser[i] = S(series[i]);
  if (rank != 0) return;
  T* f = reinterpret_cast<T*>(rec + series_bytes<S>(cd, wd));
  MassModel<Dual<T, kDirs>> mm;
  seed_mass(mm, params);
  for (int i = 0; i < kMassScalars; ++i) f[i] = params[i];
  int j = kMassScalars;
  mm.derived([&](const Dual<T, kDirs>& x) { f[j++] = x.v; });
  j = kMassFields;
  mm.carried([&](const Dual<T, kDirs>& x) {
    for (int i = 0; i < kMassScalars; ++i) f[j + i] = x.d[i];
    j += kMassScalars;
  });
  MassModel<T> m;
  m.load(params);
  m.derive();
  write_consts(m, *reinterpret_cast<MassConsts<T>*>(
      f + kMassFields + kDerived * kMassScalars));
}

// One block per lambda: its record at records + l * record_bytes.
template <typename T, typename S>
__global__ void prologue_kernel(const double* __restrict__ series,
                                const T* __restrict__ params, int cd, int wd,
                                unsigned char* __restrict__ records) {
  const int l = blockIdx.x;
  write_record<T, S>(series + (size_t)l * (cd + 2 + wd),
                     params + (size_t)l * kMassScalars, cd, wd,
                     records + (size_t)l * record_bytes<T, S>(cd, wd),
                     threadIdx.x, blockDim.x);
}

// A block's copy of its lambda's record into shared memory (16-byte words;
// the caller synchronizes).
__device__ __forceinline__ void copy_record(const unsigned char* rec,
                                            unsigned char* dst, size_t bytes) {
  const int4* s = reinterpret_cast<const int4*>(rec);
  int4* d = reinterpret_cast<int4*>(dst);
  for (size_t i = threadIdx.x; i < bytes / 16; i += blockDim.x) d[i] = s[i];
}

// The records sit in the kernels' `partials` scratch after its n partial
// rows of P doubles, on a 16-byte boundary: the wrapper allocates
// records_offset(n) doubles and L records more (nothing is allocated on the
// device side).
__host__ __device__ constexpr size_t records_offset(size_t n_partials) {
  return (n_partials + 1) / 2 * 2;
}

#ifdef __CUDACC__
// The prologue on the stream: the first launch of the adjoints' entry
// points, counted with their kernel.
template <typename T, typename S>
cudaError_t write_records(const double* series, const T* params, int L,
                          int cd, int wd, unsigned char* records,
                          cudaStream_t stream) {
  prologue_kernel<T, S><<<L, 32, 0, stream>>>(series, params, cd, wd,
                                              records);
  return cudaGetLastError();
}
#endif

// ---------------------------------------------------------------------------
// The KDE adjoint's terms and the row statistics
// ---------------------------------------------------------------------------

// the packed rows' columns: cheb_logh, dgw_lo, dgw_max, window, mass scalars
constexpr int kMaxP = 2 * kMaxDeg + 2 + kMassScalars;
// store_partials' columns: those and the derived fields' cotangents
constexpr int kRedCols = kMaxP + kDerived;
constexpr int kSamplesPerThread = 4;
// grid points a tile of K3b's and K3d's pruned phase B and K2b's pruned
// pass 2
constexpr int kGridTile = 32;

// the tiles' bounds that a row's phase B keeps in shared memory: ceil(G /
// kGridTile) pairs where it is pruned (K3b, K3d; Epanechnikov), none else
__host__ __device__ constexpr int grid_tiles(int mode, int kernel, int G) {
  return (mode == kEffectiveGrid || mode == kExternalBounds) && kernel == 0
             ? (G + kGridTile - 1) / kGridTile : 0;
}

// One (grid point, sample) term of the KDE adjoint
// (chimera_tpu/ops/pallas/fused.py:877-892), u = (g - z) / h and c1 the
// density cotangent over the density's scale.  The kernel-shape constants
// are left to kde_sample: a0 sums c1 K(u), a1 sums -c1 K'(u), a2 sums
// -c1 K'(u) u, each over its constant; with FRAC, a3 sums -c1 K'(u) frac,
// frac = dg/dub of a linear grid g = lo + (ub - lo) frac.  Epanechnikov's
// 0.75 max(0, 1 - u^2) takes half the slope at |u| = 1, as jnp.maximum does
// in the Pallas references (and MAX_FORM_KERNELS in ops/kde.py): its
// weight is 1 inside the support, 1/2 on its edge and 0 outside, formed as
// saturate(q 2^e + 1/2) in one instruction.  That is exact because q = 1 - u^2
// of a u in T is 0 or at least ulp(1) / 2 in size (u within an ulp of 1
// or farther): 2^e = 2^26 (float), 2^55 (double) sends every q != 0 to 0
// or 1.
template <typename T>
__device__ __forceinline__ T support_weight(T q) {
  if constexpr (sizeof(T) == 4) {
    return __saturatef(fmaf(q, 67108864.0f, 0.5f));
  } else {
    return fmin(fmax(fma(q, 36028797018963968.0, 0.5), 0.0), 1.0);
  }
}

template <typename T, int KERNEL, bool FRAC = false>
__device__ __forceinline__ void kde_pair(T u, T c1, T frac, T& a0, T& a1,
                                         T& a2, T& a3) {
  if (KERNEL == 0) {
    const T q = T(1) - u * u;
    const T m = c1 * support_weight(q);
    const T mu = m * u;
    a0 += m * q;
    a1 += mu;
    a2 += mu * u;
    if (FRAC) a3 += mu * frac;
  } else {
    const T m = c1 * dexp(T(-0.5) * u * u);
    const T mu = m * u;
    a0 += m;
    a1 += mu;
    a2 += mu * u;
    if (FRAC) a3 += mu * frac;
  }
}

// K'(u) = -kernel_slope() * u * (shape factor): 1.5 (Epanechnikov),
// 1/sqrt(2 pi) (Gaussian)
template <typename T, int KERNEL>
__device__ __forceinline__ T kernel_slope() {
  return KERNEL == 0 ? T(1.5) : T(0.39894228040143267794);
}

// How phase B walks the grid for a thread's samples (slot_pair_sums):
// every (grid point, slot) pair; K3b's Epanechnikov tiles kept by a warp
// ballot per tile and slot; or, per slot, the run of tiles from the first
// to the last that any lane of the warp with a sample keeps (K3d).
enum PairWalk { kFullLoop, kBallotWalk, kRunWalk };

// Phase B's pair sums of a thread's kSamplesPerThread samples zv (slot j:
// the row's sample s0 + j kSize + rank, of n) over the G (grid point, c1)
// pairs gc, in grid order (kde_pair; frac = i inv_gm1 of grid point i).
// kBallotWalk walks the grid in tiles of kGridTile points (their bounds in
// gt) and slot j skips a tile where the corners prove, for every lane of
// the warp with a sample, u > 1 or u < -1 (outside_support; a ballot, so
// the decision is the warp's), when prune.  kRunWalk takes the slots one
// by one: a lane with a sample finds the first tile from either end of the
// grid that the corner test does not prove outside (every tile before the
// first and after the last is proven: no order of the grid is assumed),
// the warp takes the least first and the largest last (warp_span), and
// the slot's sums run over that run of tiles, the whole grid where not
// prune, nothing where no lane holds a sample.  Each sample keeps its
// grid order either way, so the skipped pairs' exact zeros aside every
// sum keeps the full loop's bits.
template <typename T, int KERNEL, bool FRAC, int WALK, typename Block>
__device__ __forceinline__ void slot_pair_sums(
    const Block& blk, const T (&zv)[kSamplesPerThread], int s0, int n,
    const typename Pair<T>::type* gc, const typename Pair<T>::type* gt, int G,
    T inv_h, bool prune, T inv_gm1, T (&a0)[kSamplesPerThread],
    T (&a1)[kSamplesPerThread], T (&a2)[kSamplesPerThread],
    T (&a3)[kSamplesPerThread]) {
  using T2 = typename Pair<T>::type;
  if constexpr (WALK == kFullLoop) {
#pragma unroll 2
    for (int i = 0; i < G; ++i) {
      const T2 p = gc[i];
      const T frac = T(i) * inv_gm1;
#pragma unroll
      for (int j = 0; j < kSamplesPerThread; ++j)
        kde_pair<T, KERNEL, FRAC>((p.x - zv[j]) * inv_h, p.y, frac, a0[j],
                                  a1[j], a2[j], a3[j]);
    }
  } else if constexpr (WALK == kBallotWalk) {
    for (int t = 0; t * kGridTile < G; ++t) {
      const T2 b = gt[t];
      bool keep[kSamplesPerThread], any = false;
#pragma unroll
      for (int j = 0; j < kSamplesPerThread; ++j) {
        const int idx = s0 + j * Block::kSize + blk.rank();
        const bool out = idx >= n
            || (prune && outside_support((b.x - zv[j]) * inv_h,
                                         (b.y - zv[j]) * inv_h));
        keep[j] = blk.ballot(!out) != 0u;
        if (idx < n) blk.tile(!keep[j]);
        any = any || keep[j];
      }
      if (!any) continue;
      const int i1 = (t + 1) * kGridTile < G ? (t + 1) * kGridTile : G;
      for (int i = t * kGridTile; i < i1; ++i) {
        const T2 p = gc[i];
        const T frac = T(i) * inv_gm1;
#pragma unroll
        for (int j = 0; j < kSamplesPerThread; ++j)
          if (keep[j])
            kde_pair<T, KERNEL, FRAC>((p.x - zv[j]) * inv_h, p.y, frac,
                                      a0[j], a1[j], a2[j], a3[j]);
      }
    }
  } else {
    const int n_tiles = (G + kGridTile - 1) / kGridTile;
#pragma unroll
    for (int j = 0; j < kSamplesPerThread; ++j) {
      const int idx = s0 + j * Block::kSize + blk.rank();
      int first = n_tiles, last = -1;  // the slot's run of tiles
      if (idx < n) {
        first = 0;
        last = n_tiles - 1;
        const auto outside = [&](int t) {
          return outside_support((gt[t].x - zv[j]) * inv_h,
                                 (gt[t].y - zv[j]) * inv_h);
        };
        while (prune && first <= last && outside(first)) ++first;
        while (prune && first < last && outside(last)) --last;
        if (first > last) {
          first = n_tiles;
          last = -1;
        }
      }
      blk.warp_span(first, last);
      if (idx < n)
        for (int t = 0; t < n_tiles; ++t) blk.tile(t < first || t > last);
      const int i1 = (last + 1) * kGridTile < G ? (last + 1) * kGridTile : G;
#pragma unroll 2
      for (int i = first * kGridTile; i < i1; ++i) {
        const T2 p = gc[i];
        kde_pair<T, KERNEL, FRAC>((p.x - zv[j]) * inv_h, p.y, T(i) * inv_gm1,
                                  a0[j], a1[j], a2[j], a3[j]);
      }
    }
  }
}

// From a sample's pair sums: dw = sum_g c1 K(u), dz = -(w / h) sum_g c1 K'(u)
// and wb = w sum_g c1 K'(u) u (its share of the bandwidth's adjoint).
template <typename T, int KERNEL>
__device__ __forceinline__ void kde_sample(T a0, T a1, T a2, T w, T inv_h,
                                           T& dw, T& dz, T& wb) {
  const T kpc = kernel_slope<T, KERNEL>();
  dw = kernel_norm<T, KERNEL>() * a0;
  dz = inv_h * w * (kpc * a1);
  wb = -w * (kpc * a2);
}

// The row statistics in their safe-math form
// (fused_weights_kde_plain; chimera_tpu/ops/pallas/fused.py:789-822) and the
// chain from their cotangents back to the per-sample ones:
//   dz_s += cz (z_s - z_mean),   dw_s += d_sw + 2 w_s d_sw2.
// The clamps take jnp.clip's and jnp.maximum's slopes: half at a bound.
template <typename T>
struct RowAdjoint {
  T z_mean, z_var, z_sig, sum_w, sum_w2, neff_raw, neff, bwf, h;
  T n_samples, var_floor;
  int bw_mode;

  // sl: the row's (logical) sample count
  __device__ __forceinline__ RowAdjoint(T sum_w_, T sum_w2_, T z_mean_,
                                        T z_var_, T sl, int bw_mode_,
                                        T bw_value) {
    sum_w = sum_w_;
    sum_w2 = sum_w2_;
    z_mean = z_mean_;
    z_var = z_var_;
    n_samples = sl;
    bw_mode = bw_mode_;
    var_floor = dsqrt(sizeof(T) == 4 ? T(FLT_MIN) : T(DBL_MIN));
    z_sig = dsqrt(dmax(z_var, var_floor));
    neff_raw = sum_w * sum_w / (sum_w2 > T(0) ? sum_w2 : T(1));
    neff = clip(neff_raw, T(1), n_samples);
    bwf = bw_factor(neff, bw_mode, bw_value);
    h = bwf * z_sig;
  }

  // the slope of max(x, lo) and of min(x, hi): 1 inside, half at the bound
  static __device__ __forceinline__ T above(T x, T lo) {
    return x > lo ? T(1) : (x == lo ? T(0.5) : T(0));
  }

  // ct: the stats cotangents in the order of STAT_NAMES (lo and ub are not
  // read); d_h_kde: the bandwidth's cotangent from the KDE; d_sw_extra: sum
  // w's from a unit-mass density; d_sig_extra: sigma's from the bounds of an
  // effective grid
  __device__ __forceinline__ void backward(const T* ct, T d_h_kde,
                                           T d_sw_extra, T d_sig_extra,
                                           T& cz, T& d_sw, T& d_sw2) const {
    const T d_h = ct[4] + d_h_kde;
    const T d_zsig = d_h * bwf + d_sig_extra;
    T d_neff = ct[3];
    if (bw_mode != 2) d_neff += d_h * z_sig * (T(-0.2) * bwf / neff);
    const T d_raw = d_neff * (above(neff_raw, T(1))
                              * above(n_samples, dmax(neff_raw, T(1))));
    const T den = sum_w2 > T(0) ? sum_w2 : T(1);
    d_sw = ct[5] + ct[2] / n_samples + d_raw * T(2) * sum_w / den + d_sw_extra;
    d_sw2 = ct[6];
    if (sum_w2 > T(0)) d_sw2 -= d_raw * sum_w * sum_w / (den * den);
    const T d_zvar = d_zsig * above(z_var, var_floor) * T(0.5) / z_sig;
    cz = d_zvar * T(2) / n_samples;
  }
};

// ---------------------------------------------------------------------------
// Per-thread gradients and the projections
// ---------------------------------------------------------------------------

// A thread's gradients of the packed rows (ops/cuda/fused.py, pack_params)
// in a warp of kLanes lanes: of each Chebyshev series the coefficients
// k = lane + kLanes i that the warp's projections leave in this lane (2 of
// 64 on the card, all of them in the host's warp of one lane); the distance
// bounds' and the mass fields' cotangents (MassGrad) summed over its own
// samples.
template <typename T, int kLanes>
struct GradAcc {
  static constexpr int kPer = kMaxDeg / kLanes;
  T cheb[kPer], win[kPer];
  T lo, hi;
  T mass[kMassGrads];
#if CHIMERA_MASS_KIND == 4
  T knot[kChunk / kLanes];  // the knots' values k = lane + kLanes i
#endif

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kPer; ++i) cheb[i] = win[i] = T(0);
#pragma unroll
    for (int i = 0; i < kMassGrads; ++i) mass[i] = T(0);
    lo = hi = T(0);
#if CHIMERA_MASS_KIND == 4
#pragma unroll
    for (int i = 0; i < kChunk / kLanes; ++i) knot[i] = T(0);
#endif
  }
};

// Column i of the packed rows' gradient held by a warp of one lane (the
// host emulation): cheb_logh, dgw_lo, dgw_max, window, then the mass
// scalars with the derived fields chained to them through the prologue's
// Jacobian jac (kDerived, 12).
template <typename T>
__device__ __forceinline__ T column(const GradAcc<T, 1>& g, const T* jac,
                                    int i, int cd, int wd) {
  if (i < cd) return g.cheb[i];
  if (i == cd) return g.lo;
  if (i == cd + 1) return g.hi;
  if (i < cd + 2 + wd) return g.win[i - cd - 2];
  const int s = i - cd - 2 - wd;
#if CHIMERA_MASS_KIND == 4
  // num_knots has no cotangent; coefficient j is knot j + 1
  T t = s < kGradScalars ? g.mass[s]
        : s == kGradScalars ? T(0) : g.knot[s - kGradScalars];
#else
  T t = g.mass[s];
#endif
  for (int d = 0; d < kDerived; ++d)
    t += g.mass[kGradScalars + d] * jac[d * kMassScalars + s];
  return t;
}

// acc[k / 32][k % 32] += a T_k(t) for k < n: the adjoint of a Chebyshev sum
// in its coefficients (ops/chebyshev.py, _ChebEval.backward), by the
// recurrence T_{k+1} = 2 t T_k - T_{k-1}, in registers.
template <typename T>
__device__ __forceinline__ void cheb_accumulate(T (&acc)[2][kChunk], int n,
                                                T t, T a) {
  const T t2 = T(2) * t;
  T tk = T(1), tk1 = t;  // T_k, T_{k+1}
#pragma unroll
  for (int k = 0; k < 2 * kChunk; ++k) {
    if (k < n) acc[k / kChunk][k % kChunk] += a * tk;
    const T next = t2 * tk1 - tk;
    tk = tk1;
    tk1 = next;
  }
}

// One stage of a warp's reduce-scatter of 2 OFF values a lane: the lane
// keeps the half of v[0, 2 OFF) whose index has its bit OFF (rs_keep) and
// adds its partner's (lane ^ OFF) copy of that half, which the partner
// sends (rs_send).  After the stages 16, 8, 4, 2, 1 lane j holds in v[0]
// the sum over the warp's lanes of their v[j]: the sum over 32 lanes in a
// fixed tree, the same bits in every run.
template <int OFF, typename T>
__device__ __forceinline__ T rs_keep(const T (&v)[kChunk], int i, int lane) {
  return (lane & OFF) ? v[i + OFF] : v[i];
}
template <int OFF, typename T>
__device__ __forceinline__ T rs_send(const T (&v)[kChunk], int i, int lane) {
  return (lane & OFF) ? v[i] : v[i + OFF];
}
template <int OFF, typename T>
__device__ __forceinline__ void rs_stage(T (&v)[kChunk], int lane) {
#pragma unroll
  for (int i = 0; i < OFF; ++i)
    v[i] = rs_keep<OFF>(v, i, lane)
           + __shfl_xor_sync(0xffffffffu, rs_send<OFF>(v, i, lane), OFF);
}

// The chunk's sums over the warp: lane j ends with the total of v[j] in
// v[0] (kLanes = 32); a warp of one lane keeps v as it is.
template <int kLanes, typename T>
__device__ __forceinline__ void warp_scatter(T (&v)[kChunk], int lane) {
  static_assert(kLanes == 1 || kLanes == 32, "a warp of 32 lanes or of one");
  if (kLanes == 32) {
    rs_stage<16>(v, lane);
    rs_stage<8>(v, lane);
    rs_stage<4>(v, lane);
    rs_stage<2>(v, lane);
    rs_stage<1>(v, lane);
  }
}

// Adds a row's projections sum_s a_s T_k(t_s), k < n, to the lanes'
// coefficients (GradAcc's cheb or win): this thread's points are pts(s) of
// its slots s = rank, rank + kSize, ... < cnt (those with a = 0 add
// nothing and are skipped), and (te, ae) where extra.  Each thread sums its
// own points in registers, in slot order; then the warp's reduce-scatter,
// one chunk of 32 coefficients at a time.  Every thread of the block takes
// part (the warp's exchange).
template <typename T, typename Block, typename Points, int kPer>
__device__ __forceinline__ void project(const Block& blk, const Points& pts,
                                        int cnt, bool extra, T te, T ae,
                                        int n, T (&coef)[kPer]) {
  T acc[2][kChunk];
#pragma unroll
  for (int i = 0; i < kChunk; ++i) acc[0][i] = acc[1][i] = T(0);
  for (int s = blk.rank(); s < cnt; s += Block::kSize) {
    T t, a;
    pts(s, t, a);
    if (a != T(0)) cheb_accumulate(acc, n, t, a);
  }
  if (extra) cheb_accumulate(acc, n, te, ae);
  constexpr int kOut = kChunk / Block::kLanes;
  warp_scatter<Block::kLanes>(acc[0], blk.lane());
#pragma unroll
  for (int j = 0; j < kOut; ++j) coef[j] += acc[0][j];
  if (n > kChunk) {  // n is uniform over the block
    warp_scatter<Block::kLanes>(acc[1], blk.lane());
#pragma unroll
    for (int j = 0; j < kOut; ++j) coef[kOut + j] += acc[1][j];
  }
}

#if CHIMERA_MASS_KIND == 4
// acc[k] += g max(0, 1 - |x - k|) for the knots k in [1, n] (the
// coefficients; the edge knots 0 and n + 1 are pinned): a sample's point x
// = i - 1 + t in knot units gives (1 - t) g to knot i - 1 and t g to knot
// i, the adjoint of the interpolation in the knots' values.
template <typename T>
__device__ __forceinline__ void knot_accumulate(T (&acc)[kChunk], int n, T x,
                                                T g) {
#pragma unroll
  for (int k = 1; k < kChunk; ++k) {
    const T h = T(1) - dabs(x - T(k));
    if (k <= n && h > T(0)) acc[k] += g * h;
  }
}

// project()'s twin for the knots' points (x, g) of this thread's slots:
// summed in registers in slot order, then the warp's reduce-scatter of the
// one chunk of 32 knots; lane j keeps knot j (GradAcc::knot).
template <typename T, typename Block, typename Points, int kOut>
__device__ __forceinline__ void project_knots(const Block& blk,
                                              const Points& pts, int cnt,
                                              int n, T (&coef)[kOut]) {
  T acc[kChunk];
#pragma unroll
  for (int i = 0; i < kChunk; ++i) acc[i] = T(0);
  for (int s = blk.rank(); s < cnt; s += Block::kSize) {
    T x, g;
    pts(s, x, g);
    if (g != T(0)) knot_accumulate(acc, n, x, g);
  }
  static_assert(kOut == kChunk / Block::kLanes, "a knot a lane");
  warp_scatter<Block::kLanes>(acc, blk.lane());
#pragma unroll
  for (int j = 0; j < kOut; ++j) coef[j] += acc[j];
}
#endif

// ---------------------------------------------------------------------------
// The mass model's reverse sweep
// ---------------------------------------------------------------------------

// tpl_unnorm(m, a, lo, hi) = m^a on [lo, hi] with what its cotangents need
// (population.cuh, the same operations); lo and hi enter comparisons only.
// The reverse sweep keeps few values live: what a vjp can recompute from
// its arguments, it recomputes.
template <typename T>
struct TplUnnorm {
  bool on;
  T lx, y;
  __device__ __forceinline__ TplUnnorm(T m, T a, T lo, T hi) {
    on = lo <= m && m <= hi;
    lx = on ? dlog(dmax(m, T(1e-30))) : T(0);
    y = on ? dexp(a * lx) : T(0);
  }
  // adds the cotangents of m and a, given gy, the value's
  __device__ __forceinline__ void vjp(T m, T a, T gy, T& gm, T& ga) const {
    if (!on) return;
    const T g = gy * y;
    ga += g * lx;
    if (m > T(1e-30)) gm += g * a / m;
  }
};

// smoothing(m, dm, m_low), the LVK low-mass window, and its cotangents
template <typename T>
struct Smoothing {
  bool inside;
  T x, y;
  __device__ __forceinline__ Smoothing(T m, T dm, T m_low) {
    inside = !(m < m_low) && !(m >= m_low + dm);
    x = T(0);
    if (!inside) {
      y = m < m_low ? T(0) : T(1);
      return;
    }
    const T eps = T(1e-99);
    x = dm / (m - m_low + eps) + dm / (m - m_low - dm + eps);
    y = dexp(-(dmax(x, T(0)) + dlog1p(dexp(-dabs(x)))));
  }
  // adds the cotangents of m, dm and m_low, given gy
  __device__ __forceinline__ void vjp(T m, T dm, T m_low, T gy, T& gm,
                                      T& gdm, T& gml) const {
    if (!inside) return;
    const T eps = T(1e-99);
    const T d1 = m - m_low + eps, d2 = m - m_low - dm + eps;
    const T q1 = dm / d1, q2 = dm / d2;
    const T ex = dexp(-dabs(x));
    const T gsp = -gy * y;  // the softplus's
    const T sign = x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0));
    const T gx = (x > T(0) ? gsp : T(0)) - gsp / (T(1) + ex) * ex * sign;
    const T g1 = -gx * q1 / d1, g2 = -gx * q2 / d2;
    gdm += gx / d1 + gx / d2 - g2;
    gm += g1 + g2;
    gml -= g1 + g2;
  }
};

// A truncated Gaussian peak of the primary and its cotangents: pu the
// unnormalized exponential, value = pu inv_norm on [m_low, hi], 0 off it.
template <typename T>
struct PeakTerm {
  bool on;
  T dx, q, pu, value;
  __device__ __forceinline__ PeakTerm(T m, T m_low, T hi, T mu, T log_sigma,
                                      T inv_den2, T inv_norm) {
    on = m_low <= m && m <= hi;
    dx = q = pu = value = T(0);
    if (on) {
      dx = m - mu;
      q = dx * dx * inv_den2;
      pu = dexp(T(-0.91893853320467274178) - log_sigma - q);
      value = pu * inv_norm;
    }
  }
  // given gv, the value's cotangent, adds those of m, mu, sigma, the norm
  // and log sigma
  __device__ __forceinline__ void vjp(T gv, T inv_den2, T inv_norm, T sigma,
                                      T& gm, T& gmu, T& gsig, T& gnorm,
                                      T& glog) const {
    if (!on) return;
    const T gpeak = gv * inv_norm;
    gnorm -= gpeak * value;
    const T garg = gpeak * pu;  // the exponent's
    glog -= garg;
    const T gq = garg * inv_den2;
    const T gdx = -gq * T(2) * dx;
    gsig += gq * q * T(4) * sigma;
    gm += gdx;
    gmu -= gdx;
  }
};

// primary(m) of the build's mass model (MassModel::primary) and its
// cotangents (into gm and the fields' g), the divisions by the fields as
// products with the per-lambda reciprocals of MassConsts: the gradient
// moves by rounding only.
#if CHIMERA_MASS_KIND == 0
// ((1 - lambda_peak) pl + lambda_peak peak) smoothing(m)
template <typename T>
struct Primary {
  TplUnnorm<T> pl_t;
  Smoothing<T> sm;
  bool in_peak;
  T pl, dx, q, pu, peak, pdf, y;
  __device__ __forceinline__ Primary(const MassModel<T>& mm,
                                     const MassConsts<T>& k, T m)
      : pl_t(m, -mm.alpha, mm.m_low, mm.m_high),
        sm(m, mm.delta_m, mm.m_low) {
    pl = pl_t.y * k.inv_pl_norm;
    in_peak = mm.m_low <= m && m <= mm.peak_hi;
    dx = q = pu = peak = T(0);
    if (in_peak) {
      dx = m - mm.mu_g;
      q = dx * dx * k.inv_den2;
      pu = dexp(T(-0.91893853320467274178) - mm.log_sigma - q);
      peak = pu * k.inv_peak_norm;
    }
    pdf = (T(1) - mm.lambda_peak) * pl + mm.lambda_peak * peak;
    y = pdf * sm.y;
  }
  __device__ __forceinline__ void vjp(const MassModel<T>& mm,
                                      const MassConsts<T>& k, T m, T gy,
                                      T& gm, T* g) const {
    const T gpdf = gy * sm.y;
    sm.vjp(m, mm.delta_m, mm.m_low, gy * pdf, gm, g[kDeltaM], g[kMLow]);
    g[kLambdaPeak] += gpdf * (peak - pl);
    const T gpl = gpdf * (T(1) - mm.lambda_peak) * k.inv_pl_norm;
    g[kPlNorm] -= gpl * pl;
    T ga = T(0);
    pl_t.vjp(m, -mm.alpha, gpl, gm, ga);
    g[kAlpha] -= ga;
    if (in_peak) {
      const T gpeak = gpdf * mm.lambda_peak * k.inv_peak_norm;
      g[kPeakNorm] -= gpeak * peak;
      const T garg = gpeak * pu;  // the exponent's
      g[kLogSigma] -= garg;
      const T gq = garg * k.inv_den2;
      const T gdx = -gq * T(2) * dx;
      g[kSigmaG] += gq * q * T(4) * mm.sigma_g;
      gm += gdx;
      g[kMuG] -= gdx;
    }
  }
};
#elif CHIMERA_MASS_KIND == 1
// m^-alpha on [m_low, m_high]
template <typename T>
struct Primary {
  TplUnnorm<T> pl_t;
  T y;
  __device__ __forceinline__ Primary(const MassModel<T>& mm,
                                     const MassConsts<T>&, T m)
      : pl_t(m, -mm.alpha, mm.m_low, mm.m_high) {
    y = pl_t.y;
  }
  __device__ __forceinline__ void vjp(const MassModel<T>& mm,
                                      const MassConsts<T>&, T m, T gy, T& gm,
                                      T* g) const {
    T ga = T(0);
    pl_t.vjp(m, -mm.alpha, gy, gm, ga);
    g[kAlpha] -= ga;
  }
};
#elif CHIMERA_MASS_KIND == 2
// (pl1 + pl2 pl1_at_break / pl2_at_break) smoothing(m)
template <typename T>
struct Primary {
  TplUnnorm<T> t1, t2;
  Smoothing<T> sm;
  T q, pdf, y;
  __device__ __forceinline__ Primary(const MassModel<T>& mm,
                                     const MassConsts<T>& k, T m)
      : t1(m, -mm.alpha_1, mm.m_low, mm.m_break),
        t2(m, -mm.alpha_2, mm.m_break, mm.m_high),
        sm(m, mm.delta_m, mm.m_low) {
    q = t2.y * mm.pl1_at_break * k.inv_pl2_at_break;
    pdf = t1.y + q;
    y = pdf * sm.y;
  }
  __device__ __forceinline__ void vjp(const MassModel<T>& mm,
                                      const MassConsts<T>& k, T m, T gy,
                                      T& gm, T* g) const {
    const T gpdf = gy * sm.y;
    sm.vjp(m, mm.delta_m, mm.m_low, gy * pdf, gm, g[kDeltaM], g[kMLow]);
    T ga = T(0);
    t1.vjp(m, -mm.alpha_1, gpdf, gm, ga);
    g[kAlpha1] -= ga;
    const T gr = gpdf * k.inv_pl2_at_break;  // of t2.y pl1_at_break
    g[kPl2AtBreak] -= gpdf * q * k.inv_pl2_at_break;
    g[kPl1AtBreak] += gr * t2.y;
    ga = T(0);
    t2.vjp(m, -mm.alpha_2, gr * mm.pl1_at_break, gm, ga);
    g[kAlpha2] -= ga;
  }
};
#elif CHIMERA_MASS_KIND == 3
// ((1 - lp) pl + lp l1 g1 + lp (1 - l1) g2) smoothing(m)
template <typename T>
struct Primary {
  TplUnnorm<T> pl_t;
  Smoothing<T> sm;
  PeakTerm<T> p1, p2;
  T pl, pdf, y;
  __device__ __forceinline__ Primary(const MassModel<T>& mm,
                                     const MassConsts<T>& k, T m)
      : pl_t(m, -mm.alpha, mm.m_low, mm.m_high),
        sm(m, mm.delta_m, mm.m_low),
        p1(m, mm.m_low, mm.peak1_hi, mm.mu1_g, mm.log_sigma1, k.inv_den2_1,
           k.inv_peak1_norm),
        p2(m, mm.m_low, mm.peak2_hi, mm.mu2_g, mm.log_sigma2, k.inv_den2_2,
           k.inv_peak2_norm) {
    pl = pl_t.y * k.inv_pl_norm;
    pdf = (T(1) - mm.lambda_peak) * pl + mm.lambda_peak * mm.lambda1 * p1.value
          + mm.lambda_peak * (T(1) - mm.lambda1) * p2.value;
    y = pdf * sm.y;
  }
  __device__ __forceinline__ void vjp(const MassModel<T>& mm,
                                      const MassConsts<T>& k, T m, T gy,
                                      T& gm, T* g) const {
    const T gpdf = gy * sm.y;
    const T lp = mm.lambda_peak, l1 = mm.lambda1;
    sm.vjp(m, mm.delta_m, mm.m_low, gy * pdf, gm, g[kDeltaM], g[kMLow]);
    g[kLambdaPeak] += gpdf * (l1 * p1.value + (T(1) - l1) * p2.value - pl);
    g[kLambda1] += gpdf * lp * (p1.value - p2.value);
    const T gpl = gpdf * (T(1) - lp) * k.inv_pl_norm;
    g[kPlNorm] -= gpl * pl;
    T ga = T(0);
    pl_t.vjp(m, -mm.alpha, gpl, gm, ga);
    g[kAlpha] -= ga;
    p1.vjp(gpdf * lp * l1, k.inv_den2_1, k.inv_peak1_norm, mm.sigma1_g, gm,
           g[kMu1G], g[kSigma1G], g[kPeak1Norm], g[kLogSigma1]);
    p2.vjp(gpdf * lp * (T(1) - l1), k.inv_den2_2, k.inv_peak2_norm,
           mm.sigma2_g, gm, g[kMu2G], g[kSigma2G], g[kPeak2Norm],
           g[kLogSigma2]);
  }
};
#else
// tpl_unnorm(m, -alpha) smoothing(m) exp(f(log m)), f the knots' linear
// interpolation (MassModel::perturbation); its vjp also gives the
// coefficients' point (kx = i - 1 + t in knot units, kg the cotangent of f)
template <typename T>
struct Primary {
  TplUnnorm<T> pl_t;
  Smoothing<T> sm;
  int i;  // the knots' interval, 0 outside them
  T x, ef, y;
  __device__ __forceinline__ Primary(const MassModel<T>& mm,
                                     const MassConsts<T>&, T m)
      : pl_t(m, -mm.alpha, mm.m_low, mm.m_high),
        sm(m, mm.delta_m, mm.m_low) {
    x = dlog(dmax(m, T(1e-30)));
    i = mm.interval(x);
    ef = dexp(mm.perturbation(m));
    y = pl_t.y * sm.y * ef;
  }
  __device__ __forceinline__ void vjp(const MassModel<T>& mm,
                                      const MassConsts<T>&, T m, T gy,
                                      T& gm, T* g, T& kx, T& kg) const {
    const T gpdf = gy * ef;
    sm.vjp(m, mm.delta_m, mm.m_low, gpdf * pl_t.y, gm, g[kDeltaM], g[kMLow]);
    T ga = T(0);
    pl_t.vjp(m, -mm.alpha, gpdf * sm.y, gm, ga);
    g[kAlpha] -= ga;
    if (i == 0) return;  // f = 0 off the knots
    const int div = mm.num_knots + 1;
    const T lo = mm.knot(i - 1, div), hi = mm.knot(i, div);
    const T span = hi - lo, t = (x - lo) / span;
    const T gf = gy * y;
    kx = T(i - 1) + t;
    kg = gf;
    // f = f0 + t (f1 - f0): its slope in x, and in the interval's ends
    const T gs = gf * (mm.knot_value(i) - mm.knot_value(i - 1)) / span;
    const T glo = gs * (t - T(1)), ghi = -gs * t;
    // knot j = log_lo (1 - j / div) + log_hi j / div, the last log_hi
    const T s0 = T(i - 1) / T(div);
    g[kLogLo] += glo * (T(1) - s0);
    g[kLogHi] += glo * s0;
    if (i < div) {
      const T s1 = T(i) / T(div);
      g[kLogLo] += ghi * (T(1) - s1);
      g[kLogHi] += ghi * s1;
    } else {
      g[kLogHi] += ghi;
    }
    if (m > T(1e-30)) gm += gs / m;
  }
};
#endif

// p_m1m2 of one sample in the dual mass model (the reverse sweep's oracle
// in the host tests): p and its derivatives in the 12 scalars, in z and in
// the window series' value, given the window's value and slope at t_win
// (cdf_val, cdf_slope) where m1 lies in the window.
template <typename T>
__device__ __forceinline__ Dual<T, kDirs> joint_dual(
    const MassModel<Dual<T, kDirs>>& mm, T m1det, T m2det, T z, T cdf_val,
    T cdf_slope) {
  using N = Dual<T, kDirs>;
  N inv1pz(T(1) / (T(1) + z));
  inv1pz.d[kZDir] = -inv1pz.v * inv1pz.v;
  const N m1 = N(m1det) * inv1pz;
  const N m2 = N(m2det) * inv1pz;
  const N m1c = clip(m1, mm.m_low, mm.m_high);
  N cdf;
  if constexpr (!kWindowCdf) {
    cdf = mm.cdf_closed(m1c);
  } else if (m1c <= mm.m_join) {
    const N x = clip(m1c, mm.m_low, mm.m_join);
    const N tw = (N(2) * x - (mm.m_low + mm.m_join)) / (mm.m_join - mm.m_low);
    cdf = chain(tw, cdf_val, cdf_slope);
    cdf.d[kCdfDir] = T(1);
  } else {
    cdf = mm.cdf_above_join(m1c);
  }
  return mm.joint(m1, m2, cdf);
}

// A point to project: a distance series' (t, a) and the window's (tw, b);
// b = 0 outside the window.
template <typename T>
struct SamplePoints {
  T t, a, tw, b;
#if CHIMERA_MASS_KIND == 4
  T kx, kg;  // the knots' point (Primary::vjp); kg = 0: none
#endif
};

// the rows of phase D's stash a sample: (t, a), (tw, b), and the knots'
// (kx, kg) of PowerLawSpline
#if CHIMERA_MASS_KIND == 4
constexpr int kStashRows = 6;
#else
constexpr int kStashRows = 4;
#endif

// One sample's chain from (dz, dw) to the packed rows, the two Chebyshev
// series summed in S as the forward's Model<T, S> sums them.
template <typename T, typename S>
struct SampleAdjoint {
  const S* cheb_logh;
  const S* window;
  const MassConsts<T>* consts;
  int cheb_deg, window_deg;
  S dgw_lo, dgw_max, log_lo, log_hi;

  // the lambda's forward model (its series and their bounds, the same
  // values) and its reverse sweep's constants k
  __device__ __forceinline__ SampleAdjoint(const Model<T, S>& m,
                                           const MassConsts<T>* k) {
    consts = k;
    cheb_logh = m.cheb_logh;
    window = m.window;
    cheb_deg = m.cheb_deg;
    window_deg = m.window_deg;
    dgw_lo = m.dgw_lo;
    dgw_max = m.dgw_max;
    log_lo = m.log_lo;
    log_hi = m.log_hi;
  }

  // z = d exp(c(t)) at dL (Model::z_from_dgw) with what its chain needs,
  // t and the series' slope ds rounded to T once summed in S
  struct ZPoint {
    T d, z, t, ds;
  };
  __device__ __forceinline__ ZPoint z_at(T dl) const {
    ZPoint p;
    p.d = clip(dl, T(dgw_lo), T(dgw_max));
    const S t = (S(2) * S(dlog(p.d)) - (log_lo + log_hi)) / (log_hi - log_lo);
    S ds;
    p.z = p.d * dexp(T(clenshaw_d(cheb_logh, cheb_deg, t, ds)));
    p.t = T(t);
    p.ds = T(ds);
    return p;
  }

  // the chain of dz, the cotangent of z at dL, to the distance bounds (lo,
  // hi); returns a, the cotangent of the series' value c(t), to project
  __device__ __forceinline__ T chain_z(const ZPoint& p, T dl, T dz, T& lo,
                                       T& hi) const {
    const T span = T(log_hi - log_lo);
    const T t = p.t;
    const T a = dz * p.z;
    const T dt = a * p.ds;
    lo += dt * (t - T(1)) / span / T(dgw_lo);
    hi -= dt * (t + T(1)) / span / T(dgw_max);
    const T dd = (a + dt * (T(2) / span)) / p.d;  // the cotangent of d
    if (dl < T(dgw_lo)) lo += dd;
    else if (dl > T(dgw_max)) hi += dd;
    return a;
  }

  // The reverse sweep of p_m1m2 at (m1det, m2det) / (1 + z) (population.cuh,
  // MassModel::joint with Model::conditional_cdf), each branch and clip
  // taking the slope the dual takes: ties of clip go to the bound, and a
  // p21 zeroed by the m1_floor test or the finite guard carries none.  A
  // model without a window series (TruncatedPowerLaw) takes the closed
  // form at every m1c, from m_low, and no window on m2.
  // Given gw, the cotangent of p, it adds the mass fields' cotangents to gm
  // and returns z's; the window's point (t_win, its value's cotangent b)
  // goes to tw, b (b = 0 outside the window), and PowerLawSpline's knots'
  // point to kx, kg (kg = 0: none).
  __device__ __forceinline__ T mass_vjp(const MassModel<T>& mm, T m1det,
                                        T m2det, T z, T gw, T* gm, T& tw,
                                        T& b
#if CHIMERA_MASS_KIND == 4
                                        , T& kx, T& kg
#endif
                                        ) const {
    const MassConsts<T>& k = *consts;
    const T ip = T(1) / (T(1) + z);
    const T m1 = m1det * ip, m2 = m2det * ip;
    const T s1 = dmax(m1, mm.m_low);
    const T m1c = dmin(s1, mm.m_high);
#if CHIMERA_MASS_KIND != 1
    const bool in_window = m1c <= mm.m_join;
#endif
    T cdf, dsw = T(0), tws = T(0);
    bool x_join = false, x_m1c = false;
    // above the join: tpl_cdf(beta, m_join, m1c) = (m1c^ap - m_join^ap) / ap
    T mp = T(0), la = T(0), pa = T(0), c = T(0);
    tw = b = T(0);
#if CHIMERA_MASS_KIND == 4
    kx = kg = T(0);
#endif
#if CHIMERA_MASS_KIND == 1
    // tpl_cdf(beta, m_low, m1c) = (m1c^ap - m_low^ap) / ap
    mp = dmax(m1c, T(1e-30));
    la = dlog(mp);
    if (mm.beta == T(-1)) {
      c = k.log_m_low - la;
    } else {
      pa = dexp(k.ap * la);
      c = (pa - k.pow_low) * k.inv_ap;
    }
    cdf = c;
#else
    if (in_window) {
      const T s2 = dmax(m1c, mm.m_low);
      const T x = dmin(s2, mm.m_join);
      x_join = !(s2 < mm.m_join);
      x_m1c = !x_join && m1c > mm.m_low;
      // the window's t as Model::conditional_cdf forms it, in S
      const S lo = S(mm.m_low), hi = S(mm.m_join);
      const S ts = (S(2) * S(x) - (lo + hi)) / (hi - lo);
      tws = T(ts);
      S ds;
      cdf = T(clenshaw_d(window, window_deg, ts, ds));
      dsw = T(ds);
      tw = tws;
    } else {
      mp = dmax(m1c, T(1e-30));
      la = dlog(mp);
      if (mm.beta == T(-1)) {
        c = k.log_m_join - la;
      } else {
        pa = dexp(k.ap * la);
        c = (pa - k.pow_join) * k.inv_ap;
      }
      cdf = mm.cdf_at_join + c;
    }
#endif
    // joint: p1 p21, p21 = secondary / cdf
    const TplUnnorm<T> tu(m2, mm.beta, mm.m_low, m1);
#if CHIMERA_MASS_KIND == 1
    const T sec = tu.y;
#else
    const Smoothing<T> sm2(m2, mm.delta_m, mm.m_low);
    const T sec = tu.y * sm2.y;
#endif
    const bool ok = cdf > T(0);
    const T inv_cdf = T(1) / (ok ? cdf : T(1));
    const T p21 = sec * inv_cdf;
    if (!(ok && m1 > mm.m1_floor) || !finite(p21)) return T(0);
    const Primary<T> prim(mm, k, m1);
    const T p1 = prim.y * k.inv_norm_p_m1;
    const T gp1 = gw * p21 * k.inv_norm_p_m1, gp21 = gw * p1;
    const T gsec = gp21 * inv_cdf, gcdf = -gsec * p21;
    gm[kNormPM1] -= gp1 * p1;
    T gm1 = T(0), gm2 = T(0), gm1c = T(0);
#if CHIMERA_MASS_KIND == 4
    prim.vjp(mm, k, m1, gp1, gm1, gm, kx, kg);
#else
    prim.vjp(mm, k, m1, gp1, gm1, gm);
#endif
#if CHIMERA_MASS_KIND == 1
    tu.vjp(m2, mm.beta, gsec, gm2, gm[kBeta]);
    {
      T gmp;
      if (mm.beta == T(-1)) {
        gm[kMLow] += gcdf * k.inv_m_low;
        gmp = -gcdf / mp;
      } else {
        const T ga = gcdf * k.inv_ap;  // the cotangent of pa; pow_low's -ga
        gm[kBeta] += ga * (pa * la - k.pow_low * k.log_m_low) - ga * c;
        gmp = ga * pa * k.ap / mp;
        gm[kMLow] -= ga * k.pow_low * k.ap * k.inv_m_low;
      }
      if (m1c > T(1e-30)) gm1c += gmp;
    }
    (void)x_join;
    (void)x_m1c;
    (void)dsw;
    (void)tws;
#else
    tu.vjp(m2, mm.beta, gsec * sm2.y, gm2, gm[kBeta]);
    sm2.vjp(m2, mm.delta_m, mm.m_low, gsec * tu.y, gm2, gm[kDeltaM],
            gm[kMLow]);
    if (in_window) {
      b = gcdf;
      const T gnum = gcdf * dsw * k.inv_window;  // t = num / den
      const T gden = -gnum * tws;
      gm[kMLow] -= gnum + gden;
      gm[kMJoin] += gden - gnum;
      const T gx = T(2) * gnum;
      if (x_join) gm[kMJoin] += gx;
      else if (x_m1c) gm1c += gx;
      else gm[kMLow] += gx;
    } else {
      gm[kCdfAtJoin] += gcdf;
      T gmp;
      if (mm.beta == T(-1)) {
        gm[kMJoin] += gcdf * k.inv_m_join;
        gmp = -gcdf / mp;
      } else {
        const T ga = gcdf * k.inv_ap;  // the cotangent of pa; pow_join's -ga
        gm[kBeta] += ga * (pa * la - k.pow_join * k.log_m_join) - ga * c;
        gmp = ga * pa * k.ap / mp;
        gm[kMJoin] -= ga * k.pow_join * k.ap * k.inv_m_join;
      }
      if (m1c > T(1e-30)) gm1c += gmp;
    }
#endif
    if (!(s1 < mm.m_high)) gm[kMHigh] += gm1c;
    else if (m1 > mm.m_low) gm1 += gm1c;
    else gm[kMLow] += gm1c;
    return -(gm1 * m1det + gm2 * m2det) * ip * ip;
  }

  // dz, dw: the cotangents of this sample's z and w; the points to project
  template <typename Acc>
  __device__ __forceinline__ SamplePoints<T> add(const MassModel<T>& mm,
                                                 T m1det, T m2det, T dl,
                                                 T inv_prior, T dz, T dw,
                                                 Acc& g) const {
    const ZPoint zp = z_at(dl);
    SamplePoints<T> p;
    const T gz = mass_vjp(mm, m1det, m2det, zp.z, dw * inv_prior, g.mass,
                          p.tw, p.b
#if CHIMERA_MASS_KIND == 4
                          , p.kx, p.kg
#endif
                          );
    p.t = zp.t;
    p.a = chain_z(zp, dl, dz + gz, g.lo, g.hi);
    return p;
  }

  // a z with no weight attached (the logical rows' fillers at dl_fill)
  template <typename Acc>
  __device__ __forceinline__ SamplePoints<T> add_z(T dl, T dz, Acc& g) const {
    const ZPoint zp = z_at(dl);
    SamplePoints<T> p;
    p.t = zp.t;
    p.a = chain_z(zp, dl, dz, g.lo, g.hi);
    p.tw = p.b = T(0);
#if CHIMERA_MASS_KIND == 4
    p.kx = p.kg = T(0);
#endif
    return p;
  }
};

// ---------------------------------------------------------------------------
// K3: the adjoint of the fused pass for one (lambda, row)
// ---------------------------------------------------------------------------

template <typename T>
struct AdjointArgs {
  const T* m1;
  const T* m2;
  const T* dl;
  const T* invp;
  const T* grids;             // (B, G), kAnalysisGrid
  const T* ext;               // (L, B, 2), kExternalBounds
  const long long* n_real;    // (B,) or null: logical rows when given
  const T* dl_fill;           // (B,) with n_real
  const double* series;       // (L, cheb_deg + 2 + window_deg)
  const T* params;            // (L, kMassScalars)
  const T* ct_den;            // (L, B, G), not in kStatsOnly
  const T* ct_stats;          // (L, B, 8), STAT_NAMES
  double* partials;           // (L, blocks, P): per block, the packed rows' gradients
  T* d_ext;                   // (L, B, 2), kExternalBounds
  int L, B, S, G, cheb_deg, window_deg, logical_s, bw_mode, unit_scale;
  T bw_value, cut_grid;
};

// The block's shared arrays: z, w, dz, dw of the row's samples, the G
// (grid point, scaled density cotangent) pairs, and the stash of phase D's
// points to project for `cap` samples at a time, four arrays of cap values
// from st on (t, a of the distance series, tw, b of the window): the row's
// z, w, dz, dw themselves (st = z, cap = S) or arrays of their own.
template <typename T>
struct AdjointSmem {
  T* z;
  T* w;
  T* dz;
  T* dw;
  typename Pair<T>::type* gc;
  T* st;
  int cap;
  typename Pair<T>::type* gt;  // pruned phase B: (g_lo, g_hi) a tile
};

// K3 for the (lambda l, row b) of the forward in MODE (kde.cuh, FusedMode),
// adding its gradients of the packed rows to this thread's `g` and, in
// kExternalBounds, writing d_ext[l, b].  The semantics are
// _adjoint_kernel's (chimera_tpu/ops/pallas/fused.py:713-966):
//
//   phase A  recompute z_s, w_s of the real samples; the row statistics in
//            their safe-math form (variance floored at sqrt(tiny), N_eff
//            clamped to [1, S_l]); a logical row adds its S_l - n fillers at
//            zf = z(dl_fill) analytically, as K1 does (kde.cuh, row_stats).
//   phase B  (not kStatsOnly) the KDE adjoint, kSamplesPerThread samples a
//            thread in registers against the (g, c1) pairs, c1 = cd / (h S_l)
//            ('norms') or cd / (h sum w) ('unit', 0 on a row under sqrt(tiny)
//            total weight):
//              dw_s = sum_g c1 K(u),  dz_s = -(w_s / h) sum_g c1 K'(u),
//              dh   = -(1 / h) sum_s w_s (dw_s + sum_g c1 K'(u) u),
//            and on a linear grid g = lo + (ub - lo) frac the bounds'
//            cotangents dlo = sum_g dg (1 - frac), dub = sum_g dg frac with
//            dg = (c1 / h) sum_s w_s K'(u) (fused.py:929-937).
//   phase C  the chains of lo = max(z_min - c sigma, 1e-8 where not
//            positive) and ub = z_max + c sigma (kEffectiveGrid,
//            kStatsOnly): z_min's cotangent to its samples, split over ties,
//            or to zf where the fillers hold the minimum (all tied values
//            are the same function of lambda); kExternalBounds passes the
//            bounds' cotangents to d_ext (fused.py:939-945).  Then the row
//            statistics (RowAdjoint), with sum w's extra term of 'unit'.
//   phase D  per real sample the chain through z and w (SampleAdjoint); the
//            fillers' zf once, by rank 0; the projections of the two series'
//            cotangents onto their coefficients (project), sm.cap samples
//            at a time.
//
// With PRUNE (the default; the host emulation's oracle takes it off),
// the Epanechnikov phase B of K3b (kEffectiveGrid) and K3d
// (kExternalBounds) walks the row's linear grid in tiles of kGridTile
// points (bounds in sm.gt over every point, spoiled by a non-finite point
// or c1) and, for each of a thread's kSamplesPerThread slots, skips a tile
// where every lane of the warp holds a sample (or none) whose corners give
// u > 1, or u < -1, at both ends within max_u (outside_support, kde.cuh):
// K3b by a ballot per tile and slot, K3d by each slot's run of tiles
// (slot_pair_sums; the warp stays converged either way).  There the
// support weight is 0 (|u| > 1 strictly: at |u| = 1 it is 1/2), m = c1 * 0
// is +-0 and so are m q, m u, m u^2 and m u frac (q, u and frac finite),
// which leave a0-a3 as they were.  K3d, both kernels, also skips a slot
// that no lane of the warp holds a sample for (a logical row holds ~S_l /
// npix of its S slots).  Each sample keeps its thread, its slot and its
// grid order, so every sum and the block sums of kde[] keep the full
// loop's bits.  The samples are sorted by dL (likelihood.py), so a warp's
// 32 samples of a slot lie in a sliver of the row's z range.  K3b's tiles
// of 16 or 8 points kept fewer terms but cost more tests: they took longer
// on an H100 (PERF.md).  K3 and the Gaussian K3b keep the full loop.
template <typename T, typename S, int KERNEL, int MODE, bool PRUNE = true,
          typename Block, typename Acc>
__device__ __forceinline__ void adjoint_row(
    const Block& blk, const Model<T, S>& model,
    const SampleAdjoint<T, S>& sample, const AdjointArgs<T>& a, int l, int b,
    const AdjointSmem<T>& sm, Acc& g) {
  using T2 = typename Pair<T>::type;
  constexpr bool kRange = MODE == kEffectiveGrid || MODE == kStatsOnly;
  constexpr bool kKde = MODE != kStatsOnly;
  constexpr bool kLinear = MODE == kEffectiveGrid || MODE == kExternalBounds;

  // ---- phase A: source frame, weights, row statistics ---------------------
  const bool logical = a.n_real != nullptr;
  int n = a.S;
  T zf = T(0);
  if (logical) {
    const long long nr = a.n_real[b];
    n = nr < 0 ? 0 : (nr > a.S ? a.S : (int)nr);
    zf = model.z_from_dgw(a.dl_fill[b]);
  }
  const T sl = T(logical ? a.logical_s : a.S);
  const size_t row = (size_t)b * a.S;
  T acc[3] = {T(0), T(0), T(0)};  // sum w, sum w^2, sum z
  T z_lo = largest<T>(), z_hi = -largest<T>();
  for (int s = blk.rank(); s < n; s += Block::kSize) {
    const T z = model.z_from_dgw(a.dl[row + s]);
    const T inv1pz = T(1) / (T(1) + z);
    const T w = model.p_m1m2(a.m1[row + s] * inv1pz, a.m2[row + s] * inv1pz)
                * a.invp[row + s];
    sm.z[s] = z;
    sm.w[s] = w;
    acc[0] += w;
    acc[1] += w * w;
    acc[2] += z;
    if (kRange) {
      z_lo = dmin(z_lo, z);
      z_hi = dmax(z_hi, z);
    }
  }
  blk.template sum<3>(acc);
  if (kRange) blk.minmax(z_lo, z_hi);
  const T f_log = sl - T(n);  // logical fillers (0 on a plain row)
  const T z_mean = (acc[2] + f_log * zf) / sl;
  T ss[1] = {T(0)};
  for (int s = blk.rank(); s < n; s += Block::kSize) {
    const T d = sm.z[s] - z_mean;
    ss[0] += d * d;
  }
  blk.template sum<1>(ss);
  const T dzf = zf - z_mean;
  const RowAdjoint<T> st(acc[0], acc[1], z_mean,
                         (ss[0] + f_log * dzf * dzf) / sl, sl, a.bw_mode,
                         a.bw_value);
  const T inv_h = T(1) / st.h;

  // the z range (the fillers' zf in it on a logical row) and the bounds
  const bool min_zf = kRange && logical && zf <= z_lo;
  const bool max_zf = kRange && logical && zf >= z_hi;
  T lo = T(0), ub = T(0);
  bool lo_pos = false;
  if (kRange) {
    const T lr = (min_zf ? zf : z_lo) - a.cut_grid * st.z_sig;
    lo_pos = lr > T(0);
    lo = lo_pos ? lr : T(1e-8);
    ub = (max_zf ? zf : z_hi) + a.cut_grid * st.z_sig;
  } else if (MODE == kExternalBounds) {
    lo = a.ext[((size_t)l * a.B + b) * 2];
    ub = a.ext[((size_t)l * a.B + b) * 2 + 1];
  }

  // ---- phase B: the KDE adjoint, streamed over the grid -------------------
  const size_t out_row = (size_t)l * a.B + b;
  T denom = sl;
  bool row_ok = true;
  if (a.unit_scale) {
    row_ok = acc[0] > dsqrt(sizeof(T) == 4 ? T(FLT_MIN) : T(DBL_MIN));
    denom = row_ok ? acc[0] : T(1);
  }
  // sum w dw, sum wb, sum w a1, sum w a3
  T kde[4] = {T(0), T(0), T(0), T(0)};
  if (kKde) {
    const T* cd = a.ct_den + out_row * a.G;
    const T c_scale = row_ok ? inv_h / denom : T(0);
    const T delta = (ub - lo) / T(a.G - 1);
    for (int i = blk.rank(); i < a.G; i += Block::kSize) {
      T2 p;
      p.x = MODE == kAnalysisGrid ? a.grids[(size_t)b * a.G + i]
                                  : lo + delta * T(i);
      p.y = cd[i] * c_scale;
      sm.gc[i] = p;
    }
    blk.sync();
    const T inv_gm1 = kLinear ? T(1) / T(a.G - 1) : T(0);
    constexpr bool kPrune = PRUNE && KERNEL == 0 && kLinear;
    constexpr int kWalk = PRUNE && MODE == kExternalBounds ? kRunWalk
                          : kPrune ? kBallotWalk : kFullLoop;
    if constexpr (kPrune)
      tile_bounds<T, kGridTile, false>(blk, sm.gc, a.G, sm.gt);
    const bool prune = kPrune && inv_h > T(0);
    for (int s0 = 0; s0 < n; s0 += Block::kSize * kSamplesPerThread) {
      T zv[kSamplesPerThread], a0[kSamplesPerThread], a1[kSamplesPerThread],
          a2[kSamplesPerThread], a3[kSamplesPerThread];
#pragma unroll
      for (int j = 0; j < kSamplesPerThread; ++j) {
        const int idx = s0 + j * Block::kSize + blk.rank();
        zv[j] = sm.z[idx < n ? idx : n - 1];
        a0[j] = a1[j] = a2[j] = a3[j] = T(0);
      }
      slot_pair_sums<T, KERNEL, kLinear, kWalk>(blk, zv, s0, n, sm.gc, sm.gt,
                                                 a.G, inv_h, prune, inv_gm1,
                                                 a0, a1, a2, a3);
#pragma unroll
      for (int j = 0; j < kSamplesPerThread; ++j) {
        const int idx = s0 + j * Block::kSize + blk.rank();
        if (idx < n) {
          const T w = sm.w[idx];
          T dw, dz, wb;
          kde_sample<T, KERNEL>(a0[j], a1[j], a2[j], w, inv_h, dw, dz, wb);
          sm.dw[idx] = dw;
          sm.dz[idx] = dz;
          kde[0] += w * dw;
          kde[1] += wb;
          if (kLinear) {
            kde[2] += w * a1[j];
            kde[3] += w * a3[j];
          }
        }
      }
    }
    blk.template sum<4>(kde);
  }

  // ---- phase C: the grid's bounds, the z range, the row statistics --------
  const T* ct = a.ct_stats + out_row * 8;
  T dlo = T(0), dub = T(0);  // the linear grid's bounds, from the KDE
  if (kLinear) {
    const T kpc = kernel_slope<T, KERNEL>();
    dub = -kpc * inv_h * kde[3];
    dlo = -kpc * inv_h * (kde[2] - kde[3]);
  }
  T ct_lo = T(0), ct_ub = T(0);
  if (MODE == kExternalBounds) {
    if (blk.rank() == 0) {
      a.d_ext[out_row * 2] = ct[0] + dlo;
      a.d_ext[out_row * 2 + 1] = ct[1] + dub;
    }
  } else if (kRange) {
    ct_lo = ct[0] + dlo;
    ct_ub = ct[1] + dub;
  }
  const T d_zmin = lo_pos ? ct_lo : T(0);
  const T d_zmax = ct_ub;
  T cz, d_sw, d_sw2;
  st.backward(ct, -inv_h * (kde[0] + kde[1]),
              a.unit_scale && row_ok ? -kde[0] / denom : T(0),
              kRange ? a.cut_grid * (ct_ub - d_zmin) : T(0), cz, d_sw, d_sw2);
  // z_min's and z_max's cotangents per tied sample
  T share[2] = {T(0), T(0)};
  if (kRange) {
    T cnt[2] = {T(0), T(0)};
    for (int s = blk.rank(); s < n; s += Block::kSize) {
      cnt[0] += sm.z[s] == z_lo ? T(1) : T(0);
      cnt[1] += sm.z[s] == z_hi ? T(1) : T(0);
    }
    blk.template sum<2>(cnt);
    if (!min_zf && cnt[0] > T(0)) share[0] = d_zmin / cnt[0];
    if (!max_zf && cnt[1] > T(0)) share[1] = d_zmax / cnt[1];
  }

  // ---- phase D: per sample, through z and w to the packed rows ------------
  // (a tile of sm.cap samples at a time; stash slot j of sample t0 + j is
  // the sample's own thread's, the sample's slot itself where cap = S)
  int t0 = 0;
  do {
    const int cnt = n - t0 < sm.cap ? n - t0 : sm.cap;
    for (int j = blk.rank(); j < cnt; j += Block::kSize) {
      const int s = t0 + j;
      const T z = sm.z[s], w = sm.w[s];
      T dz = cz * (z - z_mean);
      if (kKde) dz = sm.dz[s] + dz;
      if (kRange) {
        if (z == z_lo) dz += share[0];
        if (z == z_hi) dz += share[1];
      }
      const T dw = kKde ? sm.dw[s] + d_sw + T(2) * w * d_sw2
                        : d_sw + T(2) * w * d_sw2;
      const SamplePoints<T> p = sample.add(model.mass, a.m1[row + s],
                                           a.m2[row + s], a.dl[row + s],
                                           a.invp[row + s], dz, dw, g);
      sm.st[j] = p.t;
      sm.st[sm.cap + j] = p.a;
      sm.st[2 * sm.cap + j] = p.tw;
      sm.st[3 * sm.cap + j] = p.b;
#if CHIMERA_MASS_KIND == 4
      sm.st[4 * sm.cap + j] = p.kx;
      sm.st[5 * sm.cap + j] = p.kg;
#endif
    }
    SamplePoints<T> fill{T(0), T(0), T(0), T(0)};
    bool has_fill = false;
    if (logical && t0 == 0 && blk.rank() == 0) {
      T d_zf = f_log * cz * dzf;
      if (min_zf) d_zf += d_zmin;
      if (max_zf) d_zf += d_zmax;
      has_fill = d_zf != T(0);
      if (has_fill) fill = sample.add_z(a.dl_fill[b], d_zf, g);
    }
    project(blk, [&](int j, T& t, T& c) {
              t = sm.st[j];
              c = sm.st[sm.cap + j];
            }, cnt, has_fill, fill.t, fill.a, model.cheb_deg, g.cheb);
    project(blk, [&](int j, T& t, T& c) {
              t = sm.st[2 * sm.cap + j];
              c = sm.st[3 * sm.cap + j];
            }, cnt, false, T(0), T(0), model.window_deg, g.win);
#if CHIMERA_MASS_KIND == 4
    project_knots(blk, [&](int j, T& x, T& c) {
                    x = sm.st[4 * sm.cap + j];
                    c = sm.st[5 * sm.cap + j];
                  }, cnt, model.mass.num_knots, g.knot);
#endif
    t0 += sm.cap;
  } while (t0 < n);
  blk.sync();  // the slots are the next row's
}

// K3c on logical rows (stats_rows_kernel in fused_kde_adjoint.cu): blocks
// of one warp, a warp a row, kWarpRows rows a block in row order.
constexpr int kWarpRows = 4;

// K3c on logical rows: z and w of S samples and a stash of kStash samples'
// kStashRows values
constexpr int kStash = 128;
template <typename T, typename S>
__host__ __device__ __forceinline__ size_t warp_rows_smem(int cd, int wd,
                                                          int n_samples) {
  return record_bytes<T, S>(cd, wd)
         + (2 * (size_t)n_samples + kStashRows * kStash) * sizeof(T);
}

// Whether K3c takes the warp-a-row kernel: logical rows do (warp_rows_smem
// is at most the block kernel's record and 4 S values, which the wrapper
// checks against the limit, where S >= 2 kStash, and a few KB where S is
// smaller); plain rows (the events of the dark cut_grid path, S real
// samples each) keep a block a row.
template <typename T>
__host__ __device__ __forceinline__ bool warp_rows(const AdjointArgs<T>& a) {
  return a.n_real != nullptr;
}

// ---------------------------------------------------------------------------
// K2: the rows contraction for one (lambda, event)
// ---------------------------------------------------------------------------

template <typename T>
struct RowsArgs {
  const T* m1;
  const T* m2;
  const T* dl;
  const T* invp;
  const T* grids;             // (E, G)
  const double* series;       // (L, cheb_deg + 2 + window_deg)
  const T* params;            // (L, kMassScalars)
  const T* hs;                // (L, R, 2): 1/h, scale
  const T* s1;                // (R, G)
  const T* s2;
  const T* f1;                // (L, E, G)
  const T* f2;
  T* out;                     // (L, R, 2): r
  int L, E, C, chunk, G, cheb_deg, window_deg;
};

template <typename T>
struct RowsContractSmem {
  typename Pair<T>::type* zw;  // (z, w) of the row's samples
  typename Pair<T>::type* zt;  // (z_lo, z_hi) of each kTileS samples (PRUNE)
  T* grid;                     // the event's grid, f1 and f2 rows
  T* f1;
  T* f2;
  T* den;                      // the row's densities (PRUNE)
};

// K2 for (lambda l, event e): r of the event's C rows in row order
// (_rows_reference, chimera_tpu/ops/pallas/fused.py:613-640).  Per row r
// with (1/h, scale) = hs[l, r]:
//
//   phase A  z_s = z_from_dgw(cosmo_l, dL_rs), w_s = p_m1m2(...) inv_prior,
//            one slot a thread;
//   phase B  den_g = sum_s w_s K((g - z_s) / h) and, grid points over
//            threads (kGridPerThread a thread), r1 = scale kc sum_g den_g
//            s1[r, g] f1[g], r2 likewise, the block summing the threads'
//            partials.
//
// A row of scale 0 (a dead pixel) is written as exact zeros without phase
// A, a row without weight (the padding rows that round each event up to C
// among them) after it: the TPU kernel computes exact zeros there.  With
// PRUNE (the default for the Epanechnikov kernel; the host emulation's
// oracle takes it off) phase B takes the densities from contract_pruned
// (kde.cuh: 32-sample tiles of the row against runs of 32 grid points, the
// tiles whose every term is exactly zero skipped, the argument there) into
// sm.den, and the contraction then runs in the full loop's layout and
// order, so that r keeps the full loop's bits.  The Gaussian kernel, whose
// terms are never exactly zero, keeps the full loop.
template <typename T, int KERNEL, bool PRUNE = KERNEL == 0, typename Block>
__device__ __forceinline__ void rows_contract_event(
    const Block& blk, const Model<T, double>& model, const RowsArgs<T>& a,
    int l, int e, const RowsContractSmem<T>& sm) {
  static_assert(!PRUNE || KERNEL == 0, "only Epanechnikov terms are pruned");
  using T2 = typename Pair<T>::type;
  const int G = a.G;
  const size_t R = (size_t)a.E * a.C;
  const size_t ev = (size_t)l * a.E + e;
  for (int i = blk.rank(); i < G; i += Block::kSize) {
    sm.grid[i] = a.grids[(size_t)e * G + i];
    sm.f1[i] = a.f1[ev * G + i];
    sm.f2[i] = a.f2[ev * G + i];
  }
  blk.sync();
  const T kconst = kernel_norm<T, KERNEL>();

  for (int c = 0; c < a.C; ++c) {
    const size_t row = (size_t)e * a.C + c;
    const size_t hrow = (size_t)l * R + row;
    const T inv_h = a.hs[hrow * 2];
    const T scale = a.hs[hrow * 2 + 1];
    T* o = a.out + hrow * 2;
    if (scale == T(0)) {  // dead pixel: block-uniform branch
      if (blk.rank() == 0) o[0] = o[1] = T(0);
      continue;
    }

    // ---- phase A: the row's source frame and weights ---------------------
    const size_t base = row * a.chunk;
    const T* m1 = a.m1 + base;
    const T* m2 = a.m2 + base;
    const T* dl = a.dl + base;
    const T* invp = a.invp + base;
    bool live = false;
    for (int s = blk.rank(); s < a.chunk; s += Block::kSize) {
      const T z = model.z_from_dgw(dl[s]);
      const T inv1pz = T(1) / (T(1) + z);
      const T w = model.p_m1m2(m1[s] * inv1pz, m2[s] * inv1pz) * invp[s];
      T2 p;
      p.x = z;
      p.y = w;
      sm.zw[s] = p;
      live = live || w != T(0);
    }
    if (!blk.any(live)) {  // no weight anywhere: r = 0 exactly
      if (blk.rank() == 0) o[0] = o[1] = T(0);
      continue;
    }

    // ---- phase B: KDE on the event grid, contracted against s1, s2 -------
    if (PRUNE) {  // the densities into sm.den
      tile_bounds<T, kTileS, true>(blk, sm.zw, a.chunk, sm.zt);
      contract_pruned<T, kTileS, kTileG>(
          blk, sm.zw, sm.zt, a.chunk, G, inv_h,
          [&sm](int i) { return sm.grid[i]; },
          [&sm](int i, T sum) { sm.den[i] = sum; });
      blk.sync();
    }
    const T* s1r = a.s1 + row * G;
    const T* s2r = a.s2 + row * G;
    T r[2] = {T(0), T(0)};
    for (int g0 = 0; g0 < G; g0 += Block::kSize * kGridPerThread) {
      T gv[kGridPerThread], sum[kGridPerThread];
#pragma unroll
      for (int k = 0; k < kGridPerThread; ++k) {
        const int idx = g0 + k * Block::kSize + blk.rank();
        gv[k] = sm.grid[idx < G ? idx : G - 1];
        sum[k] = PRUNE && idx < G ? sm.den[idx] : T(0);
      }
      if (!PRUNE) {
#pragma unroll 4
        for (int s = 0; s < a.chunk; ++s) {
          const T2 p = sm.zw[s];
#pragma unroll
          for (int k = 0; k < kGridPerThread; ++k)
            sum[k] += p.y * kernel_shape<T, KERNEL>((gv[k] - p.x) * inv_h);
        }
      }
#pragma unroll
      for (int k = 0; k < kGridPerThread; ++k) {
        const int idx = g0 + k * Block::kSize + blk.rank();
        if (idx < G) {
          r[0] += sum[k] * s1r[idx] * sm.f1[idx];
          r[1] += sum[k] * s2r[idx] * sm.f2[idx];
        }
      }
    }
    blk.template sum<2>(r);  // ends in a barrier: zw and den are free again
    if (blk.rank() == 0) {
      o[0] = r[0] * kconst * scale;
      o[1] = r[1] * kconst * scale;
    }
  }
}

// ---------------------------------------------------------------------------
// K2b: the adjoint of the rows contraction for one (lambda, event)
// ---------------------------------------------------------------------------

template <typename T>
struct RowsAdjointArgs {
  const T* m1;
  const T* m2;
  const T* dl;
  const T* invp;
  const T* grids;             // (E, G)
  const double* series;       // (L, cheb_deg + 2 + window_deg)
  const T* params;            // (L, kMassScalars)
  const T* hs;                // (L, R, 2): 1/h, scale
  const T* s1;                // (R, G)
  const T* s2;
  const T* f1;                // (L, E, G)
  const T* f2;
  const T* ct;                // (L, R, 2): the cotangents of r
  double* partials;           // (L, E, P)
  T* d_hs;                    // (L, R, 2)
  T* d_f1;                    // (L, E, G)
  T* d_f2;
  int L, E, C, chunk, G, cheb_deg, window_deg;
};

template <typename T>
struct RowsSmem {
  typename Pair<T>::type* zw;  // (z, w) of the row's samples
  typename Pair<T>::type* gc;  // (grid point, c_g)
  typename Pair<T>::type* zt;  // (z_lo, z_hi) of each kTileS samples (pass 1)
  typename Pair<T>::type* gt;  // (g_lo, g_hi) of each kGridTile points (pass 2)
  T* grid;
  T* f1;
  T* f2;
  T* df1;                      // the event's d_f1, d_f2 over its rows
  T* df2;
  T* dz;                       // the row's samples' cotangents
  T* dw;
#if CHIMERA_MASS_KIND == 4
  T* kx;                       // the knots' points of the row's samples
  T* kg;
#endif
};

// K2b for (lambda l, event e): the vector-Jacobian product of
// _rows_reference (chimera_tpu/ops/pallas/fused.py:613-640) over the
// event's C rows, in row order.  Per row r, with a_g = ct1 s1[r, g] f1[g] +
// ct2 s2[r, g] f2[g] and den_g = sum_s w_s K((g - z_s) / h):
//
//   d_scale  = sum_g den_g a_g,  d_f1[g] += scale ct1 s1[r, g] den_g (f2 too)
//            (pass 1, grid points over threads, as K2's forward);
//   c_g = scale a_g:  dw_s = sum_g c_g K(u),  dz_s = -(w_s / h) sum_g c_g K'(u),
//            d(1/h) = h sum_s w_s sum_g c_g K'(u) u
//            (pass 2, samples over threads);
//   then per sample with weight the chain through z and w (SampleAdjoint).
//
// A row that K2 writes as an exact zero (scale 0, no weight, or no
// cotangent) gives exact zero cotangents without either pass.
//
// With PRUNE (the default for the Epanechnikov kernel; the host emulation's
// oracle takes it off) both passes skip tiles of pairs whose terms are
// exactly zero, and every output keeps the bits of the full loops.  Pass 1
// takes its densities from contract_pruned (kde.cuh, which states the
// argument) into gc, then runs its epilogue in the full loop's layout, so
// that d_scale's per-thread sums keep their order.  Pass 2 keeps a sample a
// thread; each thread skips the kGridTile-point tiles (bounds in gt, over
// every point, spoiled by a non-finite point or c_g) whose corners give
// u > 1, or u < -1, at both ends within max_u: there the support weight of
// kde_pair is 0 (|u| > 1 strictly: at |u| = 1 it is 1/2), m = c_g * 0 is +-0
// and so are m q, m u and m u^2 (q and u finite), which leave a0, a1, a2 as
// they were.  A non-finite z or NaN 1/h fails the test.  The Gaussian
// kernel keeps the full loops: none of its terms is exactly zero.
template <typename T, int KERNEL, bool PRUNE = KERNEL == 0, typename Block,
          typename Acc>
__device__ __forceinline__ void rows_adjoint_event(
    const Block& blk, const Model<T, double>& model,
    const SampleAdjoint<T, double>& sample, const RowsAdjointArgs<T>& a,
    int l, int e, const RowsSmem<T>& sm, Acc& g) {
  static_assert(!PRUNE || KERNEL == 0, "only Epanechnikov terms are pruned");
  using T2 = typename Pair<T>::type;
  const int G = a.G;
  const size_t R = (size_t)a.E * a.C;
  const size_t ev = (size_t)l * a.E + e;
  for (int i = blk.rank(); i < G; i += Block::kSize) {
    sm.grid[i] = a.grids[(size_t)e * G + i];
    sm.f1[i] = a.f1[ev * G + i];
    sm.f2[i] = a.f2[ev * G + i];
    sm.df1[i] = sm.df2[i] = T(0);
  }
  blk.sync();
  const T kc = kernel_norm<T, KERNEL>();

  for (int c = 0; c < a.C; ++c) {
    const size_t row = (size_t)e * a.C + c;
    const size_t hrow = (size_t)l * R + row;
    const T inv_h = a.hs[hrow * 2];
    const T scale = a.hs[hrow * 2 + 1];
    const T ct1 = a.ct[hrow * 2], ct2 = a.ct[hrow * 2 + 1];
    T* dh = a.d_hs + hrow * 2;
    if (scale == T(0) || (ct1 == T(0) && ct2 == T(0))) {  // block-uniform
      if (blk.rank() == 0) dh[0] = dh[1] = T(0);
      continue;
    }

    // ---- phase A: the row's source frame and weights ---------------------
    const size_t base = row * a.chunk;
    bool live = false;
    for (int s = blk.rank(); s < a.chunk; s += Block::kSize) {
      const T z = model.z_from_dgw(a.dl[base + s]);
      const T inv1pz = T(1) / (T(1) + z);
      const T w = model.p_m1m2(a.m1[base + s] * inv1pz,
                               a.m2[base + s] * inv1pz) * a.invp[base + s];
      T2 p;
      p.x = z;
      p.y = w;
      sm.zw[s] = p;
      live = live || w != T(0);
    }
    if (!blk.any(live)) {  // zero weight everywhere: r = 0 exactly
      if (blk.rank() == 0) dh[0] = dh[1] = T(0);
      continue;
    }

    // ---- pass 1: densities on the grid, d_scale, d_f1, d_f2 ---------------
    const T* s1r = a.s1 + row * G;
    const T* s2r = a.s2 + row * G;
    T part[1] = {T(0)};
    if (PRUNE) {  // the densities into gc's second entries
      tile_bounds<T, kTileS, true>(blk, sm.zw, a.chunk, sm.zt);
      contract_pruned<T, kTileS, kTileG>(
          blk, sm.zw, sm.zt, a.chunk, G, inv_h,
          [&sm](int i) { return sm.grid[i]; },
          [&sm](int i, T sum) { sm.gc[i].y = sum; });
      blk.sync();
    }
    for (int g0 = 0; g0 < G; g0 += Block::kSize * kGridPerThread) {
      T gv[kGridPerThread], sum[kGridPerThread];
#pragma unroll
      for (int k = 0; k < kGridPerThread; ++k) {
        const int idx = g0 + k * Block::kSize + blk.rank();
        gv[k] = sm.grid[idx < G ? idx : G - 1];
        sum[k] = PRUNE && idx < G ? sm.gc[idx].y : T(0);
      }
      if (!PRUNE) {
#pragma unroll 4
        for (int s = 0; s < a.chunk; ++s) {
          const T2 p = sm.zw[s];
#pragma unroll
          for (int k = 0; k < kGridPerThread; ++k)
            sum[k] += p.y * kernel_shape<T, KERNEL>((gv[k] - p.x) * inv_h);
        }
      }
#pragma unroll
      for (int k = 0; k < kGridPerThread; ++k) {
        const int idx = g0 + k * Block::kSize + blk.rank();
        if (idx < G) {
          const T den = sum[k] * kc;
          const T t1 = ct1 * s1r[idx], t2 = ct2 * s2r[idx];
          const T ag = t1 * sm.f1[idx] + t2 * sm.f2[idx];
          part[0] += den * ag;
          sm.df1[idx] += scale * t1 * den;
          sm.df2[idx] += scale * t2 * den;
          T2 q;
          q.x = gv[k];
          q.y = scale * ag;
          sm.gc[idx] = q;
        }
      }
    }
    blk.template sum<1>(part);  // ends in a barrier: gc is complete
    if (PRUNE) tile_bounds<T, kGridTile, false>(blk, sm.gc, G, sm.gt);

    // ---- pass 2: per sample, dw, dz and the 1/h adjoint --------------------
    T wb_sum[1] = {T(0)};
    const bool prune = PRUNE && inv_h > T(0);
    const int tile = PRUNE ? kGridTile : G;  // the full loop: one tile
    for (int s = blk.rank(); s < a.chunk; s += Block::kSize) {
      const T2 zw = sm.zw[s];
      T dw = T(0), dz = T(0);
      if (a.invp[base + s] != T(0)) {  // the fillers carry no weight
        T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
        for (int t = 0; t * tile < G; ++t) {
          if (PRUNE) {
            const T2 b = sm.gt[t];
            const T u_lo = (b.x - zw.x) * inv_h, u_hi = (b.y - zw.x) * inv_h;
            const bool skip = prune
                && ((u_lo > T(1) && u_hi <= max_u<T>())
                    || (u_hi < T(-1) && u_lo >= -max_u<T>()));
            blk.tile(skip);
            if (skip) continue;
          }
          const int i1 = (t + 1) * tile < G ? (t + 1) * tile : G;
          for (int i = t * tile; i < i1; ++i) {
            const T2 p = sm.gc[i];
            kde_pair<T, KERNEL>((p.x - zw.x) * inv_h, p.y, T(0), a0, a1, a2, a3);
          }
        }
        T wb;
        kde_sample<T, KERNEL>(a0, a1, a2, zw.y, inv_h, dw, dz, wb);
        wb_sum[0] += wb;
      }
      sm.dw[s] = dw;
      sm.dz[s] = dz;
    }
    blk.template sum<1>(wb_sum);
    if (blk.rank() == 0) {
      dh[0] = wb_sum[0] / inv_h;
      dh[1] = part[0];
    }

    // ---- phase D: per sample, through z and w to the packed rows ----------
    // (the slots' zw and dz, dw become the points to project)
    for (int s = blk.rank(); s < a.chunk; s += Block::kSize) {
      SamplePoints<T> p{T(0), T(0), T(0), T(0)};
      if (a.invp[base + s] != T(0))
        p = sample.add(model.mass, a.m1[base + s], a.m2[base + s],
                       a.dl[base + s], a.invp[base + s], sm.dz[s], sm.dw[s],
                       g);
      sm.dz[s] = p.t;
      sm.dw[s] = p.a;
      sm.zw[s].x = p.tw;
      sm.zw[s].y = p.b;
#if CHIMERA_MASS_KIND == 4
      sm.kx[s] = p.kx;
      sm.kg[s] = p.kg;
#endif
    }
    project(blk, [&](int s, T& t, T& c) { t = sm.dz[s]; c = sm.dw[s]; },
            a.chunk, false, T(0), T(0), model.cheb_deg, g.cheb);
    project(blk, [&](int s, T& t, T& c) { t = sm.zw[s].x; c = sm.zw[s].y; },
            a.chunk, false, T(0), T(0), model.window_deg, g.win);
#if CHIMERA_MASS_KIND == 4
    project_knots(blk, [&](int s, T& x, T& c) { x = sm.kx[s]; c = sm.kg[s]; },
                  a.chunk, model.mass.num_knots, g.knot);
#endif
    blk.sync();  // zw and gc are rewritten by the next row
  }
  for (int i = blk.rank(); i < G; i += Block::kSize) {
    a.d_f1[ev * G + i] = sm.df1[i];
    a.d_f2[ev * G + i] = sm.df2[i];
  }
}

// The block's per-thread gradients summed in a fixed order into out[0, P)
// (P = cd + 2 + wd + kMassScalars columns of the packed rows): the
// coefficients as the warps' projections left them (k = lane + 32 i), the
// distance bounds and the mass fields (MassGrad) summed over each warp, then
// the warps in order; the derived fields' cotangents chained to the 12
// scalars through the prologue's Jacobian jac (kDerived, 12), once.  A
// block of W warps.
template <int W, typename T>
__device__ __forceinline__ void store_partials(const GradAcc<T, 32>& g,
                                               const T* jac, int cd, int wd,
                                               double* out,
                                               T (*red)[kRedCols]) {
  const int P = cd + 2 + wd + kMassScalars;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < GradAcc<T, 32>::kPer; ++i) {
    const int k = lane + 32 * i;
    if (k < cd) red[warp][k] = g.cheb[i];
    if (k < wd) red[warp][cd + 2 + k] = g.win[i];
  }
  T v = warp_sum(g.lo);
  if (lane == 0) red[warp][cd] = v;
  v = warp_sum(g.hi);
  if (lane == 0) red[warp][cd + 1] = v;
#if CHIMERA_MASS_KIND == 4
#pragma unroll
  for (int f = 0; f < kMassGrads; ++f) {
    v = warp_sum(g.mass[f]);
    if (lane == 0)
      red[warp][f < kGradScalars ? cd + 2 + wd + f : P + f - kGradScalars] = v;
  }
  // num_knots' column 0; coefficient j, knot j + 1, from its lane
  if (lane == 0) red[warp][cd + 2 + wd + kGradScalars] = T(0);
  if (lane >= 1 && lane <= kMaxKnots)
    red[warp][cd + 2 + wd + kGradScalars + lane] = g.knot[0];
#else
#pragma unroll
  for (int f = 0; f < kMassGrads; ++f) {
    v = warp_sum(g.mass[f]);
    if (lane == 0) red[warp][cd + 2 + wd + f] = v;
  }
#endif
  __syncthreads();
  for (int i = threadIdx.x; i < P + kDerived; i += 32 * W) {
    T t = T(0);
    for (int w = 0; w < W; ++w) t += red[w][i];
    red[W][i] = t;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < P; i += 32 * W) {
    T t = red[W][i];
    const int s = i - (P - kMassScalars);
    if (s >= 0)
      for (int d = 0; d < kDerived; ++d)
        t += red[W][P + d] * jac[d * kMassScalars + s];
    out[i] = double(t);
  }
}

// Sum the partials (L, N, P) over their N rows (or events) in order and
// split the row into d_series (L, Q) and d_params (L, 12).  One block per
// lambda, one thread per column: no atomics, so equal inputs give equal bits
// and an HMC chain repeats under a fixed generator.
template <typename T>
__global__ void reduce_events_kernel(const double* __restrict__ partials,
                                     double* __restrict__ d_series,
                                     T* __restrict__ d_params, int N, int Q) {
  const int P = Q + kMassScalars;
  const int l = blockIdx.x;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const double* col = partials + (size_t)l * N * P + i;
    double t = 0.0;
#pragma unroll 8
    for (int e = 0; e < N; ++e) t += col[(size_t)e * P];
    if (i < Q) d_series[(size_t)l * Q + i] = t;
    else d_params[(size_t)l * kMassScalars + (i - Q)] = T(t);
  }
}

}  // namespace
