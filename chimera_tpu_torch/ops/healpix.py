"""HEALPix in the RING scheme: ang2pix, pix2ang and the RA/Dec layer
(counterpart of the RING part of ``chimera_tpu/ops/healpix.py``).

Branch-free integer arithmetic over whole tensors, in the standard HEALPix
geometry (Gorski et al. 2005) with healpy's conventions: theta in [0, pi]
from the north pole, phi in [0, 2 pi).  Pixel indices are int64 and angles
float64 whatever the input dtype: a float32 ang2pix moves samples that lie
near a pixel edge into the neighbouring pixel.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64


def nside2npix(nside: int) -> int:
    return 12 * nside * nside


def _floor_int(x: torch.Tensor) -> torch.Tensor:
    return torch.floor(x).to(torch.int64)


def _isqrt(x: torch.Tensor) -> torch.Tensor:
    """Exact integer sqrt of non-negative int64 (float seed, two fixes)."""
    s = _floor_int(torch.sqrt(x.to(F64)))
    s = torch.where((s + 1) * (s + 1) <= x, s + 1, s)
    return torch.where(s * s > x, s - 1, s)


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


def th_phi_from_ra_dec(ra: torch.Tensor, dec: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    return 0.5 * math.pi - dec, ra


def ra_dec_from_th_phi(theta: torch.Tensor, phi: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    return phi, 0.5 * math.pi - theta


def find_pix_ra_dec(ra: torch.Tensor, dec: torch.Tensor, nside: int) -> torch.Tensor:
    """RING pixel of each (RA, Dec), radians."""
    theta, phi = th_phi_from_ra_dec(ra.to(F64), dec.to(F64))
    return ang2pix_ring(nside, theta, phi)


def find_ra_dec(pix: torch.Tensor, nside: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(RA, Dec) of RING pixel centres, radians."""
    return ra_dec_from_th_phi(*pix2ang_ring(nside, pix))


def angular_separation(ra, dec, ra0, dec0) -> torch.Tensor:
    """Great-circle separation of (ra, dec) and (ra0, dec0), radians."""
    cos_angle = (torch.sin(dec) * torch.sin(dec0)
                 + torch.cos(dec) * torch.cos(dec0) * torch.cos(ra - ra0))
    return torch.arccos(torch.clamp(cos_angle, -1.0, 1.0))
