"""Event-parameter structs as dataclasses of tensors (counterpart of
``chimera_tpu/data/structs.py``; the pixelated-catalog fields arrive with
the dark-siren slice)."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ThetaPEDet:
    """Detector-frame PE samples of a GW catalog, each (Nev, Nsamples)."""

    m1det: torch.Tensor | None = None
    m2det: torch.Tensor | None = None
    dL: torch.Tensor | None = None
    phi: torch.Tensor | None = None
    theta: torch.Tensor | None = None
    ra: torch.Tensor | None = None
    dec: torch.Tensor | None = None
    pe_prior: torch.Tensor | None = None

    def update(self, **kwargs: Any) -> "ThetaPEDet":
        return dataclasses.replace(self, **kwargs)

    def with_derived(self) -> "ThetaPEDet":
        """Fill the unit pe_prior when absent."""
        if self.pe_prior is None and self.dL is not None:
            return self.update(pe_prior=torch.ones_like(self.dL))
        return self


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
