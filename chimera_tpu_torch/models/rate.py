"""Merger-rate evolution psi(z) (counterpart of ``chimera_tpu/models/rate.py``):
``BaseRateModel`` with the shared construction and λ batching, the power
law, its truncated form and the Madau–Dickinson rate, plain and truncated.
Rates enter the likelihood's glue only (p_cbc on the grids, N_exp), never a
kernel."""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from chimera_tpu_torch.pytree import lam, resolve_params, update_batch


@dataclasses.dataclass(frozen=True)
class BaseRateModel:
    """A rate model: hyper-parameters only, each (L,)."""

    name: ClassVar[str] = "base_rate"
    hyper_defaults: ClassVar[dict] = {}
    config_keys: ClassVar[tuple[str, ...]] = ()

    @classmethod
    def create(cls, *, device=None, dtype=None, **kwargs):
        hyper, _ = resolve_params(cls, kwargs, device, dtype)
        return cls(**hyper)

    @classmethod
    def from_state(cls, state: dict, prefix: str = "", device=None, dtype=None):
        from chimera_tpu_torch.convert import model_from_state

        return model_from_state(cls, state, prefix, device, dtype)

    update_batch = update_batch

    @property
    def L(self) -> int:
        return getattr(self, next(iter(self.hyper_defaults))).shape[0]

    def rate(self, z: torch.Tensor) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class PowerLawRate(BaseRateModel):
    """psi(z) = (1+z)^gamma."""

    gamma: torch.Tensor

    name: ClassVar[str] = "power_law"
    hyper_defaults: ClassVar[dict] = dict(gamma=1.7)

    def rate(self, z: torch.Tensor) -> torch.Tensor:
        return torch.pow(1.0 + z, lam(self.gamma, z))


@dataclasses.dataclass(frozen=True)
class TruncatedPowerLawRate(BaseRateModel):
    """The power law normalized on [0, zmax] and 0 from zmax on."""

    gamma: torch.Tensor
    zmax: torch.Tensor

    name: ClassVar[str] = "trunc_power_law"
    hyper_defaults: ClassVar[dict] = dict(gamma=1.9, zmax=1.3)

    def rate(self, z: torch.Tensor) -> torch.Tensor:
        gamma, zmax = lam(self.gamma, z), lam(self.zmax, z)
        pdf = torch.pow(1.0 + z, gamma)
        norm = (torch.pow(1.0 + zmax, gamma + 1.0) - 1.0) / (gamma + 1.0)
        return torch.where(z < zmax, pdf / norm, 0.0)


def _madau_dickinson(gamma, kappa, zp, z) -> torch.Tensor:
    """Madau–Dickinson SFR-like rate normalized to psi(0) = 1."""
    raw = torch.pow(1.0 + z, gamma) / (
        1.0 + torch.pow((1.0 + z) / (1.0 + zp), gamma + kappa))
    inv_norm = 1.0 + torch.pow(1.0 + zp, -gamma - kappa)
    return inv_norm * raw


@dataclasses.dataclass(frozen=True)
class MadauDickinsonRate(BaseRateModel):
    """Madau–Dickinson SFR-like rate normalized to psi(0) = 1."""

    gamma: torch.Tensor
    kappa: torch.Tensor
    zp: torch.Tensor

    name: ClassVar[str] = "madau_dickinson"
    hyper_defaults: ClassVar[dict] = dict(gamma=2.7, kappa=3.0, zp=2.0)

    def rate(self, z: torch.Tensor) -> torch.Tensor:
        return _madau_dickinson(lam(self.gamma, z), lam(self.kappa, z),
                                lam(self.zp, z), z)


@dataclasses.dataclass(frozen=True)
class TruncatedMadauDickinsonRate(BaseRateModel):
    """Madau–Dickinson, 0 from zmax on."""

    gamma: torch.Tensor
    kappa: torch.Tensor
    zp: torch.Tensor
    zmax: torch.Tensor

    name: ClassVar[str] = "trunc_madau_dickinson"
    hyper_defaults: ClassVar[dict] = dict(gamma=2.7, kappa=3.0, zp=2.0, zmax=1.3)

    def rate(self, z: torch.Tensor) -> torch.Tensor:
        psi = _madau_dickinson(lam(self.gamma, z), lam(self.kappa, z),
                               lam(self.zp, z), z)
        return torch.where(z < lam(self.zmax, z), psi, 0.0)


def merger_rate(rate_model: BaseRateModel, z: torch.Tensor) -> torch.Tensor:
    """psi(z | λ), the rate model's ``rate``."""
    return rate_model.rate(z)
