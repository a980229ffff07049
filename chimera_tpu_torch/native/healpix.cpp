// Host-side HEALPix (RING + NESTED): an independent C++ implementation, the
// cross-check oracle of the port's tensor HEALPix
// (chimera_tpu_torch/ops/healpix.py) on the CPU and on the card (the
// port's copy of chimera_tpu/native/healpix.cpp, with the pixel boundaries
// added).
//
// Algorithms follow the standard HEALPix tessellation geometry
// (Gorski et al. 2005). Exposed as a C ABI over contiguous arrays.
// The omp pragmas parallelize over elements where it is built with OpenMP;
// the port builds it serial (chimera_tpu_torch/native/__init__.py).

#include <cmath>
#include <cstdint>
#include <algorithm>

namespace {

constexpr double kTwoThird = 2.0 / 3.0;
constexpr double kHalfPi = 1.5707963267948966;

const int kJrll[12] = {2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4};
const int kJpll[12] = {1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7};

inline int64_t isqrt64(int64_t v) {
  int64_t s = static_cast<int64_t>(std::sqrt(static_cast<double>(v)));
  while ((s + 1) * (s + 1) <= v) ++s;
  while (s * s > v) --s;
  return s;
}

inline int ilog2(int64_t nside) {
  int r = 0;
  while ((int64_t{1} << (r + 1)) <= nside) ++r;
  return r;
}

inline uint64_t spread_bits(uint64_t x) {
  x &= 0xFFFFFFFFull;
  x = (x | (x << 16)) & 0x0000FFFF0000FFFFull;
  x = (x | (x << 8)) & 0x00FF00FF00FF00FFull;
  x = (x | (x << 4)) & 0x0F0F0F0F0F0F0F0Full;
  x = (x | (x << 2)) & 0x3333333333333333ull;
  x = (x | (x << 1)) & 0x5555555555555555ull;
  return x;
}

inline uint64_t compress_bits(uint64_t x) {
  x &= 0x5555555555555555ull;
  x = (x | (x >> 1)) & 0x3333333333333333ull;
  x = (x | (x >> 2)) & 0x0F0F0F0F0F0F0F0Full;
  x = (x | (x >> 4)) & 0x00FF00FF00FF00FFull;
  x = (x | (x >> 8)) & 0x0000FFFF0000FFFFull;
  x = (x | (x >> 16)) & 0x00000000FFFFFFFFull;
  return x;
}

inline int64_t xyf2nest(int64_t nside, int64_t ix, int64_t iy, int face) {
  return face * nside * nside +
         static_cast<int64_t>(spread_bits(ix) | (spread_bits(iy) << 1));
}

inline void nest2xyf(int64_t nside, int64_t pix, int64_t* ix, int64_t* iy,
                     int* face) {
  int64_t npface = nside * nside;
  *face = static_cast<int>(pix / npface);
  uint64_t rem = static_cast<uint64_t>(pix % npface);
  *ix = static_cast<int64_t>(compress_bits(rem));
  *iy = static_cast<int64_t>(compress_bits(rem >> 1));
}

int64_t ang2pix_ring_1(int64_t nside, double theta, double phi) {
  double z = std::cos(theta);
  double za = std::fabs(z);
  double tt = std::fmod(phi / kHalfPi, 4.0);
  if (tt < 0) tt += 4.0;
  int64_t npix = 12 * nside * nside;
  int64_t ncap = 2 * nside * (nside - 1);
  if (za <= kTwoThird) {
    double temp1 = nside * (0.5 + tt);
    double temp2 = nside * z * 0.75;
    int64_t jp = static_cast<int64_t>(std::floor(temp1 - temp2));
    int64_t jm = static_cast<int64_t>(std::floor(temp1 + temp2));
    int64_t ir = nside + 1 + jp - jm;
    int64_t kshift = 1 - (ir & 1);
    int64_t t1 = jp + jm - nside + kshift + 1;
    int64_t ip = (t1 >> 1) % (4 * nside);
    return ncap + (ir - 1) * 4 * nside + ip;
  }
  double tp = tt - std::floor(tt);
  double tmp = nside * std::sqrt(3.0 * (1.0 - za));
  int64_t jp = static_cast<int64_t>(std::floor(tp * tmp));
  int64_t jm = static_cast<int64_t>(std::floor((1.0 - tp) * tmp));
  int64_t ir = jp + jm + 1;
  int64_t ip = static_cast<int64_t>(std::floor(tt * ir));
  ip %= 4 * ir;
  if (ip < 0) ip += 4 * ir;
  if (z > 0) return 2 * ir * (ir - 1) + ip;
  return npix - 2 * ir * (ir + 1) + ip;
}

int64_t ang2pix_nest_1(int64_t nside, double theta, double phi) {
  double z = std::cos(theta);
  double za = std::fabs(z);
  double tt = std::fmod(phi / kHalfPi, 4.0);
  if (tt < 0) tt += 4.0;
  int order = ilog2(nside);
  int64_t ix, iy;
  int face;
  if (za <= kTwoThird) {
    double temp1 = nside * (0.5 + tt);
    double temp2 = nside * z * 0.75;
    int64_t jp = static_cast<int64_t>(std::floor(temp1 - temp2));
    int64_t jm = static_cast<int64_t>(std::floor(temp1 + temp2));
    int64_t ifp = jp >> order;
    int64_t ifm = jm >> order;
    if (ifp == ifm)
      face = (ifp == 4) ? 4 : static_cast<int>(ifp) + 4;
    else if (ifp < ifm)
      face = static_cast<int>(ifp);
    else
      face = static_cast<int>(ifm) + 8;
    ix = jm & (nside - 1);
    iy = nside - (jp & (nside - 1)) - 1;
  } else {
    int ntt = std::min(3, static_cast<int>(tt));
    double tp = tt - ntt;
    double tmp = nside * std::sqrt(3.0 * (1.0 - za));
    int64_t jp = static_cast<int64_t>(tp * tmp);
    int64_t jm = static_cast<int64_t>((1.0 - tp) * tmp);
    jp = std::min(jp, nside - 1);
    jm = std::min(jm, nside - 1);
    if (z >= 0) {
      face = ntt;
      ix = nside - jm - 1;
      iy = nside - jp - 1;
    } else {
      face = ntt + 8;
      ix = jp;
      iy = jm;
    }
  }
  return xyf2nest(nside, ix, iy, face);
}

void pix2ang_ring_1(int64_t nside, int64_t pix, double* theta, double* phi) {
  int64_t npix = 12 * nside * nside;
  int64_t ncap = 2 * nside * (nside - 1);
  double fact2 = 4.0 / npix;
  if (pix < ncap) {
    int64_t iring = (1 + isqrt64(1 + 2 * pix)) >> 1;
    int64_t iphi = (pix + 1) - 2 * iring * (iring - 1);
    *theta = std::acos(1.0 - iring * iring * fact2);
    *phi = (iphi - 0.5) * kHalfPi / iring;
  } else if (pix < npix - ncap) {
    double fact1 = 2.0 / (3.0 * nside);
    int64_t ip = pix - ncap;
    int64_t iring = ip / (4 * nside) + nside;
    int64_t iphi = ip % (4 * nside) + 1;
    double fodd = ((iring + nside) & 1) ? 1.0 : 0.5;
    *theta = std::acos((2 * nside - iring) * fact1);
    *phi = (iphi - fodd) * M_PI / (2.0 * nside);
  } else {
    int64_t ip = npix - pix;
    int64_t iring = (1 + isqrt64(2 * ip - 1)) >> 1;
    int64_t iphi = 4 * iring + 1 - (ip - 2 * iring * (iring - 1));
    *theta = std::acos(-1.0 + iring * iring * fact2);
    *phi = (iphi - 0.5) * kHalfPi / iring;
  }
}

void pix2ang_nest_1(int64_t nside, int64_t pix, double* theta, double* phi) {
  int64_t npix = 12 * nside * nside;
  double fact2 = 4.0 / npix;
  double fact1 = 2.0 / (3.0 * nside);
  int64_t ix, iy;
  int face;
  nest2xyf(nside, pix, &ix, &iy, &face);
  int64_t jr = kJrll[face] * nside - ix - iy - 1;
  int64_t nr, kshift;
  double z;
  if (jr < nside) {
    nr = jr;
    z = 1.0 - nr * nr * fact2;
    kshift = 0;
  } else if (jr > 3 * nside) {
    nr = 4 * nside - jr;
    z = nr * nr * fact2 - 1.0;
    kshift = 0;
  } else {
    nr = nside;
    z = (2 * nside - jr) * fact1;
    kshift = (jr - nside) & 1;
  }
  int64_t jp = (kJpll[face] * nr + ix - iy + 1 + kshift) / 2;
  if (jp > 4 * nr) jp -= 4 * nr;
  if (jp < 1) jp += 4 * nr;
  *theta = std::acos(z);
  *phi = (jp - (kshift + 1) * 0.5) * kHalfPi / nr;
}

// (z, phi) of fractional in-face coordinates (x, y in [0, 1]): the inverse
// HEALPix projection (Gorski et al. 2005, eqs. 19-22).
void xyf2loc(double x, double y, int face, double* z, double* phi) {
  double jr = kJrll[face] - x - y;
  double nr;
  if (jr < 1.0) {
    nr = jr;
    *z = 1.0 - nr * nr / 3.0;
  } else if (jr > 3.0) {
    nr = 4.0 - jr;
    *z = nr * nr / 3.0 - 1.0;
  } else {
    nr = 1.0;
    *z = (2.0 - jr) * 2.0 / 3.0;
  }
  if (nr < 1e-12) nr = 1e-12;  // the pole: phi degenerate
  double p = (kJpll[face] + (x - y) / nr) * (M_PI / 4.0);
  p = std::fmod(p, 2.0 * M_PI);
  if (p < 0) p += 2.0 * M_PI;
  *phi = p;
}

}  // namespace

extern "C" {

void chimera_ang2pix(int64_t nside, const double* theta, const double* phi,
                     int64_t* pix, int64_t n, int nest) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    pix[i] = nest ? ang2pix_nest_1(nside, theta[i], phi[i])
                  : ang2pix_ring_1(nside, theta[i], phi[i]);
  }
}

void chimera_pix2ang(int64_t nside, const int64_t* pix, double* theta,
                     double* phi, int64_t n, int nest) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    if (nest)
      pix2ang_nest_1(nside, pix[i], &theta[i], &phi[i]);
    else
      pix2ang_ring_1(nside, pix[i], &theta[i], &phi[i]);
  }
}

// Boundary points of NESTED pixels: 4 * step (theta, phi) per pixel,
// counterclockwise from the northernmost corner, step points an edge.
void chimera_boundaries(int64_t nside, const int64_t* pix, int64_t step,
                        double* theta, double* phi, int64_t n) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    int64_t ix, iy;
    int face;
    nest2xyf(nside, pix[i], &ix, &iy, &face);
    for (int64_t e = 0; e < 4; ++e) {
      for (int64_t k = 0; k < step; ++k) {
        double t = static_cast<double>(k) / step;
        double fx = e == 0 ? 1.0 - t : e == 1 ? 0.0 : e == 2 ? t : 1.0;
        double fy = e == 0 ? 1.0 : e == 1 ? 1.0 - t : e == 2 ? 0.0 : t;
        double z;
        int64_t o = i * 4 * step + e * step + k;
        xyf2loc((ix + fx) / nside, (iy + fy) / nside, face, &z, &phi[o]);
        theta[o] = std::acos(std::min(1.0, std::max(-1.0, z)));
      }
    }
  }
}

}  // extern "C"
