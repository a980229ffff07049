"""Magnitude <-> luminosity conversions, distance moduli and the Schechter
luminosity fraction (counterpart of ``chimera_tpu/utils/mags.py``), on
tensors of any device; both directions cover every band and an unknown
band raises."""

from __future__ import annotations

import torch

# solar absolute magnitudes per band
M_SUN = {"bol": 4.83, "B": 4.72, "W1": 3.24, "K": 3.27}


def _msun(band: str) -> float:
    try:
        return M_SUN[band]
    except KeyError:
        raise ValueError(f"unsupported band {band!r}; one of {list(M_SUN)}")


def _t(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    return x if x.is_floating_point() else x.to(torch.float64)


def mag2lum(M, band: str = "K") -> torch.Tensor:
    """Absolute magnitude -> luminosity in solar units."""
    return torch.pow(10.0, 0.4 * (_msun(band) - _t(M)))


def lum2mag(L, band: str = "K") -> torch.Tensor:
    """Luminosity in solar units -> absolute magnitude."""
    return -2.5 * torch.log10(_t(L)) + _msun(band)


def absolute_magnitude(m, dl_gpc) -> torch.Tensor:
    """Apparent -> absolute magnitude by the distance modulus (dL in Gpc)."""
    return _t(m) - 5.0 * torch.log10(_t(dl_gpc) * 1e9 / 10.0)


def apparent_magnitude(M, dl_gpc) -> torch.Tensor:
    """Absolute -> apparent magnitude by the distance modulus (dL in Gpc)."""
    return _t(M) + 5.0 * torch.log10(_t(dl_gpc) * 1e9 / 10.0)


def schechter_luminosity_fraction(L_min, alpha: float = -1.07,
                                  weighted: bool = True) -> torch.Tensor:
    """Share of the (luminosity-weighted) Schechter density phi(x) ~
    x^alpha e^-x above ``L_min / L*``: the regularized upper incomplete
    gamma function Q(alpha + 2, L_min), or Q(alpha + 1, L_min) unweighted
    (which needs alpha > -1)."""
    x = _t(L_min)
    a = torch.full_like(x, alpha + 2.0 if weighted else alpha + 1.0)
    return 1.0 - torch.special.gammainc(a, x)
