"""Pixelated galaxy-catalog redshift prior (counterpart of
``chimera_tpu/catalog/pixelated.py``):

    p_gal = fR(λ) p_cat + (1 - P_compl) p_bkg(λ)

per (event, pixel, z), zero on padded pixel slots.  ``p_cat`` is built once
at the fiducial cosmology (``catalog.build``); the trial cosmology enters
through fR and p_bkg.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from chimera_tpu_torch.catalog.completeness import (DVdzCompleteness,
                                                    HomogeneousCompleteness)

# the completeness models by class name, for ``from_state``
COMPLETENESS = {c.__name__: c for c in (DVdzCompleteness,
                                        HomogeneousCompleteness)}


@dataclasses.dataclass(frozen=True)
class PixelatedCatalog:
    """p_cat (Nev, P, Nz), P_compl (Nev, 1, Nz), pixel_mask (Nev, P) bool,
    n_gal (Nev,) int, and the completeness model (either of
    ``COMPLETENESS``)."""

    p_cat: torch.Tensor
    P_compl: torch.Tensor
    pixel_mask: torch.Tensor
    n_gal: torch.Tensor
    completeness: DVdzCompleteness | HomogeneousCompleteness

    name: ClassVar[str] = "pixelated_catalog"

    @classmethod
    def from_state(cls, state: dict, prefix: str, device, dtype
                   ) -> "PixelatedCatalog":
        from chimera_tpu_torch.convert import class_name

        kind = class_name(state, prefix + "completeness.")
        if kind not in COMPLETENESS:
            raise ValueError(f"unknown completeness model {kind}")

        def arr(key, dt):
            return torch.as_tensor(state[prefix + key], device=device).to(dt)

        return cls(p_cat=arr("p_cat", dtype), P_compl=arr("P_compl", dtype),
                   pixel_mask=arr("pixel_mask", torch.bool),
                   n_gal=arr("n_gal", torch.int64),
                   completeness=COMPLETENESS[kind].from_state(
                       state, prefix + "completeness.", device, dtype))

    def take_events(self, idx: torch.Tensor) -> "PixelatedCatalog":
        """The catalog of the events ``idx`` (an index may repeat): its
        event-indexed fields cut by name, never by shape (the completeness
        model's tables may be as long as the event axis).  The completeness
        stays whole: its tables are global in λ and z, not per event."""
        return dataclasses.replace(self, **{
            f: getattr(self, f).index_select(0, idx.to(self.p_cat.device))
            for f in ("p_cat", "P_compl", "pixel_mask", "n_gal")})

    def p_gal(self, cosmo, z: torch.Tensor) -> torch.Tensor:
        """z (1 or L, Nev, Nz) -> (L, Nev, P, Nz)."""
        fr = self.completeness.fR(cosmo)[:, None, None, None]
        p_bkg = self.completeness.p_bkg(cosmo, z)[:, :, None, :]
        mix = fr * self.p_cat + (1.0 - self.P_compl) * p_bkg
        return torch.where(self.pixel_mask[:, :, None], mix, 0.0)

    def p_bkg(self, cosmo, theta_or_z) -> torch.Tensor:
        return self.completeness.p_bkg(cosmo, theta_or_z)
