"""Event-parameter structs as dataclasses of tensors (counterpart of
``chimera_tpu/data/structs.py``).  Ragged (event x pixel) arrays are padded
to a common width and carry an explicit boolean ``pixel_mask``."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

PAD_VALUE = -100.0  # padded-slot sentinel of the pixel arrays

@dataclasses.dataclass(frozen=True)
class ThetaPEDet:
    """Detector-frame PE samples of a GW catalog, each (Nev, Nsamples),
    plus the pixelation of the dark-siren analysis: pixel arrays are padded
    to (Nev, P) with ``pixel_mask`` marking the real pixels."""

    m1det: torch.Tensor | None = None
    m2det: torch.Tensor | None = None
    dL: torch.Tensor | None = None
    phi: torch.Tensor | None = None
    theta: torch.Tensor | None = None
    ra: torch.Tensor | None = None
    dec: torch.Tensor | None = None
    pe_prior: torch.Tensor | None = None
    opt_nsides: torch.Tensor | None = None           # (Nev,)
    pixels_opt_nsides: torch.Tensor | None = None    # (Nev, P) padded
    ra_pix: torch.Tensor | None = None               # (Nev, P) padded
    dec_pix: torch.Tensor | None = None              # (Nev, P) padded
    gw_loc2d_pdf: torch.Tensor | None = None         # (Nev, P) padded
    pixels_pe_opt_nside: torch.Tensor | None = None  # (Nev, Ns)
    pixel_mask: torch.Tensor | None = None           # (Nev, P) bool

    def update(self, **kwargs: Any) -> "ThetaPEDet":
        return dataclasses.replace(self, **kwargs)

    @property
    def pixelated(self) -> bool:
        return self.pixels_opt_nsides is not None

    def with_derived(self) -> "ThetaPEDet":
        """Fill the unit pe_prior and, from the padding of ``ra_pix``, the
        pixel mask when absent."""
        out = self
        if out.pe_prior is None and out.dL is not None:
            out = out.update(pe_prior=torch.ones_like(out.dL))
        if out.pixel_mask is None and out.ra_pix is not None:
            out = out.update(pixel_mask=out.ra_pix != PAD_VALUE)
        return out


@dataclasses.dataclass(frozen=True)
class ThetaInjDet:
    """Detector-frame parameters of detected injections, each (N,)."""

    m1det: torch.Tensor | None = None
    m2det: torch.Tensor | None = None
    dL: torch.Tensor | None = None
    p_draw: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True)
class ThetaSrc:
    """Source-frame parameters with a leading λ axis.
    ``original_distances`` carries measured GW distances for the selection
    integrand."""

    m1src: torch.Tensor | None = None
    m2src: torch.Tensor | None = None
    z: torch.Tensor | None = None
    original_distances: torch.Tensor | None = None
