"""Catalog-free ("spectral siren") redshift prior: p_gal = p_bkg = dV_C/dz
(counterpart of ``chimera_tpu/catalog/empty.py``)."""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from chimera_tpu_torch.data.structs import ThetaSrc
from chimera_tpu_torch.models import cosmology as cosmo_fns


@dataclasses.dataclass(frozen=True)
class EmptyCatalog:
    """Homogeneous redshift prior for catalog-free standard sirens."""

    name: ClassVar[str] = "empty_catalog"

    def p_gal(self, cosmo, z: torch.Tensor) -> torch.Tensor:
        return cosmo_fns.differential_comoving_volume(cosmo, z)

    def p_bkg(self, cosmo, theta_or_z) -> torch.Tensor:
        if isinstance(theta_or_z, ThetaSrc):
            return cosmo_fns.differential_comoving_volume(
                cosmo, theta_or_z.z, theta_or_z.original_distances)
        return cosmo_fns.differential_comoving_volume(cosmo, theta_or_z)
