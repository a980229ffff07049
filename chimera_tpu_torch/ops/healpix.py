"""HEALPix in the RING and NESTED schemes: ang2pix, pix2ang, the scheme
conversions, pixel boundaries and the RA/Dec layer (counterpart of
``chimera_tpu/ops/healpix.py``).

Branch-free integer arithmetic over whole tensors, in the standard HEALPix
geometry (Gorski et al. 2005) with healpy's conventions: theta in [0, pi]
from the north pole, phi in [0, 2 pi).  Pixel indices are int64 and angles
float64 whatever the input dtype: a float32 ang2pix moves samples that lie
near a pixel edge into the neighbouring pixel.  NESTED indices interleave
the bits of (ix, iy) within a base face by integer shifts and masks, exact
on int64 tensors of every device; no index goes through a float.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64


# face layout of the twelve base pixels (Gorski et al. 2005)
_JRLL = (2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4)
_JPLL = (1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7)


def nside2npix(nside: int) -> int:
    return 12 * nside * nside


def npix2nside(npix: int) -> int:
    nside = int(round((npix / 12) ** 0.5))
    if 12 * nside * nside != npix:
        raise ValueError(f"{npix} is not a valid HEALPix npix")
    return nside


def _face_table(table, face: torch.Tensor) -> torch.Tensor:
    return torch.tensor(table, dtype=torch.int64, device=face.device)[face]


def _floor_int(x: torch.Tensor) -> torch.Tensor:
    return torch.floor(x).to(torch.int64)


def _isqrt(x: torch.Tensor) -> torch.Tensor:
    """Exact integer sqrt of non-negative int64 (float seed, two fixes)."""
    s = _floor_int(torch.sqrt(x.to(F64)))
    s = torch.where((s + 1) * (s + 1) <= x, s + 1, s)
    return torch.where(s * s > x, s - 1, s)


def _spread_bits(x: torch.Tensor) -> torch.Tensor:
    """Interleave zeros between the low 32 bits of int64 ``x`` (one half of
    a Morton code)."""
    x = x & 0xFFFFFFFF
    x = (x | (x << 16)) & 0x0000FFFF0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F0F0F0F0F
    x = (x | (x << 2)) & 0x3333333333333333
    return (x | (x << 1)) & 0x5555555555555555


def _compress_bits(x: torch.Tensor) -> torch.Tensor:
    """The inverse of ``_spread_bits``: the even bits of int64 ``x``."""
    x = x & 0x5555555555555555
    x = (x | (x >> 1)) & 0x3333333333333333
    x = (x | (x >> 2)) & 0x0F0F0F0F0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF00FF00FF
    x = (x | (x >> 8)) & 0x0000FFFF0000FFFF
    return (x | (x >> 16)) & 0x00000000FFFFFFFF


def _xyf2nest(nside: int, ix: torch.Tensor, iy: torch.Tensor,
              face: torch.Tensor) -> torch.Tensor:
    return face * (nside * nside) + (_spread_bits(ix) | (_spread_bits(iy) << 1))


def _nest2xyf(nside: int, pix: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    pix = pix.to(torch.int64)
    npface = nside * nside
    face = torch.div(pix, npface, rounding_mode="floor")
    rem = pix - face * npface
    return _compress_bits(rem), _compress_bits(rem >> 1), face


def ang2pix_ring(nside: int, theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """RING pixel index of (theta, phi)."""
    theta, phi = theta.to(F64), phi.to(F64)
    z = torch.cos(theta)
    za = torch.abs(z)
    tt = torch.remainder(phi / (0.5 * math.pi), 4.0)
    ncap = 2 * nside * (nside - 1)
    npix = nside2npix(nside)

    # equatorial belt (|z| <= 2/3)
    temp1 = nside * (0.5 + tt)
    temp2 = nside * (z * 0.75)
    jp = _floor_int(temp1 - temp2)
    jm = _floor_int(temp1 + temp2)
    ir = nside + 1 + jp - jm
    kshift = 1 - (ir & 1)
    t1 = jp + jm - nside + kshift + 1
    ip = torch.remainder(t1 >> 1, 4 * nside)
    pix_eq = ncap + (ir - 1) * (4 * nside) + ip

    # polar caps
    tp = tt - torch.floor(tt)
    tmp = nside * torch.sqrt(3.0 * (1.0 - za))
    jp_c = _floor_int(tp * tmp)
    jm_c = _floor_int((1.0 - tp) * tmp)
    ir_c = jp_c + jm_c + 1
    ip_c = torch.remainder(_floor_int(tt * ir_c), 4 * ir_c)
    pix_north = 2 * ir_c * (ir_c - 1) + ip_c
    pix_south = npix - 2 * ir_c * (ir_c + 1) + ip_c
    pix_cap = torch.where(z > 0, pix_north, pix_south)
    return torch.where(za <= 2.0 / 3.0, pix_eq, pix_cap)


def ang2pix_nest(nside: int, theta: torch.Tensor, phi: torch.Tensor
                 ) -> torch.Tensor:
    """NESTED pixel index of (theta, phi); ``nside`` a power of 2."""
    theta, phi = theta.to(F64), phi.to(F64)
    z = torch.cos(theta)
    za = torch.abs(z)
    tt = torch.remainder(phi / (0.5 * math.pi), 4.0)

    # equatorial belt
    temp1 = nside * (0.5 + tt)
    temp2 = nside * (z * 0.75)
    jp = _floor_int(temp1 - temp2)
    jm = _floor_int(temp1 + temp2)
    shift = max(nside.bit_length() - 1, 0)
    ifp, ifm = jp >> shift, jm >> shift
    face_eq = torch.where(
        ifp == ifm, torch.where(ifp == 4, 4, ifp + 4),
        torch.where(ifp < ifm, ifp, ifm + 8))
    ix_eq = jm & (nside - 1)
    iy_eq = nside - (jp & (nside - 1)) - 1

    # polar caps
    ntt = torch.clamp_max(_floor_int(tt), 3)
    tp = tt - ntt
    tmp = nside * torch.sqrt(3.0 * (1.0 - za))
    jp_c = torch.clamp_max(_floor_int(tp * tmp), nside - 1)
    jm_c = torch.clamp_max(_floor_int((1.0 - tp) * tmp), nside - 1)
    north = z >= 0
    face_cap = torch.where(north, ntt, ntt + 8)
    ix_cap = torch.where(north, nside - jm_c - 1, jp_c)
    iy_cap = torch.where(north, nside - jp_c - 1, jm_c)

    eq = za <= 2.0 / 3.0
    return _xyf2nest(nside, torch.where(eq, ix_eq, ix_cap),
                     torch.where(eq, iy_eq, iy_cap),
                     torch.where(eq, face_eq, face_cap))


def ang2pix(nside: int, theta: torch.Tensor, phi: torch.Tensor,
            nest: bool = False) -> torch.Tensor:
    return (ang2pix_nest if nest else ang2pix_ring)(nside, theta, phi)


def pix2ang_ring(nside: int, pix: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(theta, phi) of RING pixel centres."""
    pix = pix.to(torch.int64)
    npix = nside2npix(nside)
    ncap = 2 * nside * (nside - 1)
    fact2 = 4.0 / npix
    fact1 = 2.0 / (3.0 * nside)
    half_pi = 0.5 * math.pi

    # north cap
    iring_n = (1 + _isqrt(1 + 2 * pix)) >> 1
    iphi_n = (pix + 1) - 2 * iring_n * (iring_n - 1)
    z_n = 1.0 - (iring_n * iring_n).to(F64) * fact2
    phi_n = (iphi_n.to(F64) - 0.5) * half_pi / torch.clamp_min(iring_n, 1).to(F64)

    # equatorial belt
    ip = pix - ncap
    iring_e = torch.div(ip, 4 * nside, rounding_mode="floor") + nside
    iphi_e = torch.remainder(ip, 4 * nside) + 1
    fodd = torch.where(((iring_e + nside) & 1) != 0, 1.0, 0.5).to(F64)
    z_e = (2 * nside - iring_e).to(F64) * fact1
    phi_e = (iphi_e.to(F64) - fodd) * math.pi / (2.0 * nside)

    # south cap
    ip_s = npix - pix
    iring_s = (1 + _isqrt(torch.clamp_min(2 * ip_s - 1, 0))) >> 1
    iphi_s = 4 * iring_s + 1 - (ip_s - 2 * iring_s * (iring_s - 1))
    z_s = -1.0 + (iring_s * iring_s).to(F64) * fact2
    phi_s = (iphi_s.to(F64) - 0.5) * half_pi / torch.clamp_min(iring_s, 1).to(F64)

    north = pix < ncap
    south = pix >= (npix - ncap)
    z = torch.where(north, z_n, torch.where(south, z_s, z_e))
    phi = torch.where(north, phi_n, torch.where(south, phi_s, phi_e))
    return torch.arccos(torch.clamp(z, -1.0, 1.0)), phi


def pix2ang_nest(nside: int, pix: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(theta, phi) of NESTED pixel centres."""
    npix = nside2npix(nside)
    fact2 = 4.0 / npix
    fact1 = 2.0 / (3.0 * nside)
    ix, iy, face = _nest2xyf(nside, pix)
    jr = _face_table(_JRLL, face) * nside - ix - iy - 1

    north = jr < nside
    south = jr > 3 * nside
    nr = torch.where(north, jr, torch.where(south, 4 * nside - jr, nside))
    nr2 = (nr * nr).to(F64)
    z = torch.where(north, 1.0 - nr2 * fact2,
                    torch.where(south, nr2 * fact2 - 1.0,
                                (2 * nside - jr).to(F64) * fact1))
    kshift = torch.where(north | south, 0, (jr - nside) & 1)

    jp = (_face_table(_JPLL, face) * nr + ix - iy + 1 + kshift) >> 1
    jp = torch.where(jp > 4 * nr, jp - 4 * nr, jp)
    jp = torch.where(jp < 1, jp + 4 * nr, jp)
    phi = (jp.to(F64) - (kshift + 1).to(F64) * 0.5) * (0.5 * math.pi) / nr.to(F64)
    return torch.arccos(torch.clamp(z, -1.0, 1.0)), phi


def pix2ang(nside: int, pix: torch.Tensor, nest: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor]:
    return (pix2ang_nest if nest else pix2ang_ring)(nside, pix)


# ---------------------------------------------------------------------------
# scheme conversion
# ---------------------------------------------------------------------------

def _ring2xyf(nside: int, pix: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    pix = pix.to(torch.int64)
    npix = nside2npix(nside)
    ncap = 2 * nside * (nside - 1)
    shift = max(nside.bit_length() - 1, 0)

    def fdiv(a, b):
        return torch.div(a, b, rounding_mode="floor")

    # north cap
    iring_n = (1 + _isqrt(1 + 2 * pix)) >> 1
    iphi_n = (pix + 1) - 2 * iring_n * (iring_n - 1)
    face_n = fdiv(iphi_n - 1, torch.clamp_min(iring_n, 1))

    # equatorial belt
    ip = pix - ncap
    iring_e = fdiv(ip, 4 * nside) + nside
    iphi_e = torch.remainder(ip, 4 * nside) + 1
    ks_e = (iring_e + nside) & 1
    ire = iring_e - nside + 1
    irm = 2 * nside + 2 - ire
    ifm = (iphi_e - (ire >> 1) + nside - 1) >> shift
    ifp = (iphi_e - (irm >> 1) + nside - 1) >> shift
    face_e = torch.where(ifp == ifm, (ifp & 3) + 4,
                         torch.where(ifp < ifm, ifp, ifm + 8))

    # south cap
    ip_s = npix - pix
    iring_s = (1 + _isqrt(torch.clamp_min(2 * ip_s - 1, 0))) >> 1
    iphi_s = 4 * iring_s + 1 - (ip_s - 2 * iring_s * (iring_s - 1))
    face_s = 8 + fdiv(iphi_s - 1, torch.clamp_min(iring_s, 1))

    north = pix < ncap
    south = pix >= (npix - ncap)

    def pick(n, s, e):
        return torch.where(north, n, torch.where(south, s, e))

    zero = torch.zeros_like(pix)
    ring = pick(iring_n, 4 * nside - iring_s, iring_e)
    iphi = pick(iphi_n, iphi_s, iphi_e)
    nr = pick(iring_n, iring_s, torch.full_like(pix, nside))
    kshift = pick(zero, zero, ks_e)
    face = pick(face_n, face_s, face_e)

    irt = ring - _face_table(_JRLL, face) * nside + 1
    ipt = 2 * iphi - _face_table(_JPLL, face) * nr - kshift - 1
    ipt = torch.where(ipt >= 2 * nside, ipt - 8 * nside, ipt)
    return (ipt - irt) >> 1, (-ipt - irt) >> 1, face


def _xyf2ring(nside: int, ix: torch.Tensor, iy: torch.Tensor,
              face: torch.Tensor) -> torch.Tensor:
    npix = nside2npix(nside)
    ncap = 2 * nside * (nside - 1)
    jr = _face_table(_JRLL, face) * nside - ix - iy - 1

    north = jr < nside
    south = jr > 3 * nside
    nr = torch.where(north, jr, torch.where(south, 4 * nside - jr, nside))
    n_before = torch.where(
        north, 2 * nr * (nr - 1),
        torch.where(south, npix - 2 * (nr + 1) * nr,
                    ncap + (jr - nside) * 4 * nside))
    kshift = torch.where(north | south, 0, (jr - nside) & 1)

    jp = (_face_table(_JPLL, face) * nr + ix - iy + 1 + kshift) >> 1
    jp = torch.where(jp > 4 * nr, jp - 4 * nr, jp)
    jp = torch.where(jp < 1, jp + 4 * nr, jp)
    return n_before + jp - 1


def nest2ring(nside: int, pix: torch.Tensor) -> torch.Tensor:
    return _xyf2ring(nside, *_nest2xyf(nside, pix))


def ring2nest(nside: int, pix: torch.Tensor) -> torch.Tensor:
    return _xyf2nest(nside, *_ring2xyf(nside, pix))


# ---------------------------------------------------------------------------
# RA/Dec layer
# ---------------------------------------------------------------------------

def th_phi_from_ra_dec(ra: torch.Tensor, dec: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    return 0.5 * math.pi - dec, ra


def ra_dec_from_th_phi(theta: torch.Tensor, phi: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    return phi, 0.5 * math.pi - theta


def find_pix_ra_dec(ra: torch.Tensor, dec: torch.Tensor, nside: int,
                    nest: bool = False) -> torch.Tensor:
    """Pixel of each (RA, Dec), radians, from the float64 angles."""
    theta, phi = th_phi_from_ra_dec(ra.to(F64), dec.to(F64))
    return ang2pix(nside, theta, phi, nest=nest)


def find_ra_dec(pix: torch.Tensor, nside: int, nest: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(RA, Dec) of pixel centres, radians."""
    return ra_dec_from_th_phi(*pix2ang(nside, pix, nest=nest))


def angular_separation(ra, dec, ra0, dec0) -> torch.Tensor:
    """Great-circle separation of (ra, dec) and (ra0, dec0), radians."""
    cos_angle = (torch.sin(dec) * torch.sin(dec0)
                 + torch.cos(dec) * torch.cos(dec0) * torch.cos(ra - ra0))
    return torch.arccos(torch.clamp(cos_angle, -1.0, 1.0))


def galactic_to_equatorial(l: torch.Tensor, b: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Galactic (l, b) -> equatorial (RA, Dec), radians, with atan2 for the
    quadrant."""
    l_ncp = math.radians(122.93192)
    dec_ngp = math.radians(27.128336)
    ra_ngp = math.radians(192.859508)
    y = torch.cos(b) * torch.sin(l_ncp - l)
    x = (math.cos(dec_ngp) * torch.sin(b)
         - math.sin(dec_ngp) * torch.cos(b) * torch.cos(l_ncp - l))
    ra = torch.atan2(y, x) + ra_ngp
    dec = torch.arcsin(math.sin(dec_ngp) * torch.sin(b)
                       + math.cos(dec_ngp) * torch.cos(b) * torch.cos(l_ncp - l))
    return torch.remainder(ra, 2.0 * math.pi), dec


def convert_pixelization(pixels: torch.Tensor, nside_in: int, nside_out: int,
                         nest_in: bool = False, nest_out: bool = False
                         ) -> torch.Tensor:
    """Re-index pixels to another (nside, scheme) through their centres."""
    theta, phi = pix2ang(nside_in, pixels, nest=nest_in)
    return ang2pix(nside_out, theta, phi, nest=nest_out)


# ---------------------------------------------------------------------------
# pixel boundaries
# ---------------------------------------------------------------------------

def _xyf2loc(x: torch.Tensor, y: torch.Tensor, face: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fractional in-face coordinates (x, y in [0, 1]) -> (z, phi): the
    inverse HEALPix projection, continuous across a face."""
    jr = _face_table(_JRLL, face).to(x.dtype) - x - y
    nr_s = 4.0 - jr
    z = torch.where(jr < 1.0, 1.0 - jr * jr / 3.0,
                    torch.where(jr > 3.0, nr_s * nr_s / 3.0 - 1.0,
                                (2.0 - jr) * 2.0 / 3.0))
    nr = torch.where(jr < 1.0, jr, torch.where(jr > 3.0, nr_s, 1.0))
    nr = torch.clamp_min(nr, 1e-12)  # the pole: phi degenerate
    phi = (_face_table(_JPLL, face).to(x.dtype) + (x - y) / nr) * (math.pi / 4.0)
    return z, torch.remainder(phi, 2.0 * math.pi)


def boundaries(nside: int, pix, step: int = 1, nest: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Boundary points of each pixel, (theta, phi) of shape (..., 4 step),
    counterclockwise from the northernmost corner (healpy's order); ``step``
    points on each edge."""
    pix = torch.as_tensor(pix, dtype=torch.int64)
    if not nest:
        pix = ring2nest(nside, pix)
    ix, iy, face = _nest2xyf(nside, pix)
    t = torch.arange(step, dtype=F64, device=pix.device) / step
    one = torch.ones_like(t)
    # N -> W (y = 1), W -> S (x = 0), S -> E (y = 0), E -> N (x = 1)
    fx = torch.cat([1.0 - t, 0.0 * t, t, one])
    fy = torch.cat([one, 1.0 - t, 0.0 * t, t])
    x = (ix[..., None].to(F64) + fx) / nside
    y = (iy[..., None].to(F64) + fy) / nside
    z, phi = _xyf2loc(x, y, face[..., None])
    return torch.arccos(torch.clamp(z, -1.0, 1.0)), phi
