"""Event localization areas and comoving volumes (counterpart of
``chimera_tpu/data/localization.py``), on the PE samples' device."""

from __future__ import annotations

import math

import torch

from chimera_tpu_torch.models import cosmology as cosmo_fns


def _rows(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    return x[None] if x.dim() == 1 else x


def localization_areas(theta, phi, percentile: float = 90.0,
                       unit: str = "deg2") -> torch.Tensor:
    """Sky areas at the ``percentile`` confidence of a Gaussian with the
    samples' covariance: theta, phi (Nev, Nsamples) -> (Nev,), in deg^2 or,
    with ``unit='rad2'``, sr."""
    theta, phi = _rows(theta), _rows(phi)
    var_t = torch.var(theta, dim=1, correction=0)
    var_p = torch.var(phi, dim=1, correction=0)
    mean_t = torch.mean(theta, dim=1)
    cov_tp = torch.mean((theta - mean_t[:, None])
                        * (phi - torch.mean(phi, dim=1)[:, None]), dim=1)
    one_sigma = (2.0 * math.pi * torch.abs(torch.sin(mean_t))
                 * torch.sqrt(torch.clamp_min(var_t * var_p - cov_tp**2, 0.0)))
    area_rad2 = -math.log(1.0 - percentile / 100.0) * one_sigma
    if unit == "deg2":
        return area_rad2 * (180.0 / math.pi) ** 2
    return area_rad2


def localization_volumes(theta, phi, dl, cosmo_min, cosmo_max,
                         percentile: float = 90.0) -> torch.Tensor:
    """Comoving volumes (Gpc^3) of the localization shells: the sky area
    times the comoving volume between the central ``percentile`` interval
    of the samples' dL, its near edge under ``cosmo_min`` (the prior corner
    of least comoving distance at fixed dL, high H0) and its far edge under
    ``cosmo_max`` (low H0).  The cosmologies are single (L = 1) models."""
    dl = _rows(dl)
    areas_rad2 = localization_areas(theta, phi, percentile, unit="rad2")
    lo_q = (100.0 - percentile) / 2.0
    q = torch.tensor([lo_q / 100.0, 1.0 - lo_q / 100.0], dtype=dl.dtype,
                     device=dl.device)
    dl_min, dl_max = torch.quantile(dl, q, dim=1)
    z_min = cosmo_fns.z_from_dgw(cosmo_min, dl_min[None])
    z_max = cosmo_fns.z_from_dgw(cosmo_max, dl_max[None])
    v_min = cosmo_fns.comoving_volume(cosmo_min, z_min)[0]
    v_max = cosmo_fns.comoving_volume(cosmo_max, z_max)[0]
    return areas_rad2 * (v_max - v_min) / (4.0 * math.pi)
