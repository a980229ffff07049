"""Galaxy-catalog completeness (counterpart of
``chimera_tpu/catalog/completeness.py``; ``DVdzCompleteness`` so far).

A completeness model gives the likelihood three things: ``P_compl`` on the
per-event z-grids, the cosmology-dependent normalization ``fR`` and the
homogeneous background prior ``p_bkg``.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from chimera_tpu_torch.config import default_dtype, resolve_device
from chimera_tpu_torch.data.structs import ThetaSrc
from chimera_tpu_torch.models import cosmology as cosmo_fns


@dataclasses.dataclass(frozen=True)
class DVdzCompleteness:
    """Step (or erf-smoothed step) completeness on ``z_range``:
    fR = V_C(z_range[1]) - V_C(z_range[0]) and p_bkg = dV_C/dz.  It holds no
    hyper-parameter, so it carries no λ axis; ``fR`` and ``p_bkg`` take a
    λ-batched cosmology."""

    z_range: torch.Tensor
    z_sig: torch.Tensor | None = None
    kind: str = "step"

    name: ClassVar[str] = "dVdz_completeness"

    @classmethod
    def create(cls, z_range=(0.073, 1.3), kind: str = "step", z_sig=None,
               device=None, dtype=None) -> "DVdzCompleteness":
        if kind not in ("step", "step_smooth"):
            raise ValueError("kind must be 'step' or 'step_smooth'")
        if kind == "step_smooth" and z_sig is None:
            raise ValueError("step_smooth requires z_sig")
        device = resolve_device(device)
        dtype = dtype or default_dtype(device)

        def t(v):
            return torch.as_tensor(v, dtype=dtype, device=device)

        return cls(z_range=t(z_range), z_sig=None if z_sig is None else t(z_sig),
                   kind=kind)

    @classmethod
    def from_state(cls, state: dict, prefix: str, device=None, dtype=None
                   ) -> "DVdzCompleteness":
        return cls.create(z_range=state[prefix + "z_range"],
                          kind=str(state[prefix + "kind"]),
                          z_sig=state.get(prefix + "z_sig"),
                          device=device, dtype=dtype)

    def P_compl(self, z_grids: torch.Tensor) -> torch.Tensor:
        lo, hi = self.z_range[0], self.z_range[1]
        if self.kind == "step":
            return ((z_grids > lo) & (z_grids < hi)).to(z_grids.dtype)
        s = self.z_sig * 2.0 ** 0.5
        rise = 0.5 * (1.0 + torch.special.erf((z_grids - lo) / s))
        fall = 0.5 * (1.0 + torch.special.erf((hi - z_grids) / s))
        return rise * fall

    def fR(self, cosmo) -> torch.Tensor:
        """(L,) comoving volume between the completeness edges."""
        vc = cosmo_fns.comoving_volume(cosmo, self.z_range[None])
        return vc[:, 1] - vc[:, 0]

    def p_bkg(self, cosmo, theta_or_z) -> torch.Tensor:
        if isinstance(theta_or_z, ThetaSrc):
            return cosmo_fns.differential_comoving_volume(
                cosmo, theta_or_z.z, theta_or_z.original_distances)
        return cosmo_fns.differential_comoving_volume(cosmo, theta_or_z)
