"""Merger-rate evolution psi(z) (counterpart of ``chimera_tpu/models/rate.py``)."""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from chimera_tpu_torch.pytree import lam, resolve_params, update_batch


@dataclasses.dataclass(frozen=True)
class MadauDickinsonRate:
    """Madau–Dickinson SFR-like rate normalized to psi(0) = 1."""

    gamma: torch.Tensor
    kappa: torch.Tensor
    zp: torch.Tensor

    name: ClassVar[str] = "madau_dickinson"
    hyper_defaults: ClassVar[dict] = dict(gamma=2.7, kappa=3.0, zp=2.0)
    config_keys: ClassVar[tuple[str, ...]] = ()

    @classmethod
    def create(cls, *, device=None, dtype=None, **kwargs) -> "MadauDickinsonRate":
        hyper, _ = resolve_params(cls, kwargs, device, dtype)
        return cls(**hyper)

    @classmethod
    def from_state(cls, state: dict, prefix: str = "", device=None,
                   dtype=None) -> "MadauDickinsonRate":
        from chimera_tpu_torch.convert import model_from_state

        return model_from_state(cls, state, prefix, device, dtype)

    update_batch = update_batch

    @property
    def L(self) -> int:
        return self.gamma.shape[0]

    def rate(self, z: torch.Tensor) -> torch.Tensor:
        gamma, kappa, zp = lam(self.gamma, z), lam(self.kappa, z), lam(self.zp, z)
        raw = torch.pow(1.0 + z, gamma) / (
            1.0 + torch.pow((1.0 + z) / (1.0 + zp), gamma + kappa))
        inv_norm = 1.0 + torch.pow(1.0 + zp, -gamma - kappa)
        return inv_norm * raw
