"""The spectral-siren hyper-likelihood (counterpart of
``chimera_tpu/likelihood.py`` for ``kind='1d'``, ``binning=False``,
``cut_grid=None``).

One engine: the λ batch goes through ``Population.update_batch``, the fused
weights+KDE function (the CUDA kernel for CUDA tensors, its plain PyTorch
version for CPU tensors), the numerator integral and the selection function.
``HyperLikelihood`` is an ``nn.Module`` whose buffers hold the PE samples,
the z-grids and (in its ``selection``) the injections; ``.to(device,
dtype)`` moves them and the population's tensors together.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from chimera_tpu_torch.data.structs import ThetaPEDet
from chimera_tpu_torch.models import cosmology as cosmo_fns
from chimera_tpu_torch.models.population import Population, p_cbc
from chimera_tpu_torch.ops.cuda.fused import fused_weights_kde
from chimera_tpu_torch.ops.integrate import trapz
from chimera_tpu_torch.pytree import tensor_map
from chimera_tpu_torch.selection import SelectionFunction

_PE_FIELDS = ("m1det", "m2det", "dL", "pe_prior")


def _validate_shapes(theta_gw: ThetaPEDet, z_grids: torch.Tensor) -> None:
    """Construction-time shape check, naming the offending axis."""
    if z_grids.dim() != 2:
        raise ValueError(f"z_grids must be (Nev, Nz); got shape {tuple(z_grids.shape)}")
    n_ev = theta_gw.dL.shape[0]
    if z_grids.shape[0] != n_ev:
        raise ValueError(
            f"z_grids has {z_grids.shape[0]} events but theta_gw has {n_ev} "
            f"(dL shape {tuple(theta_gw.dL.shape)})")


def _sort_samples_by_distance(theta_gw: ThetaPEDet) -> ThetaPEDet:
    """Sort each event's PE samples by dL, permuting every per-sample field
    alike: order-free for the likelihood, and it makes the sample axis
    z-ordered under every cosmology."""
    order = torch.argsort(theta_gw.dL, dim=-1, stable=True)
    updates = {}
    for f in dataclasses.fields(theta_gw):
        v = getattr(theta_gw, f.name)
        if v is not None and v.shape == theta_gw.dL.shape:
            updates[f.name] = torch.take_along_dim(v, order, dim=-1)
    return theta_gw.update(**updates)


def _jacobian(pop: Population, z: torch.Tensor) -> torch.Tensor:
    """|d(dGW)/dz| (1+z)^2 — detector->source measure; ``z`` has a leading
    λ axis."""
    return cosmo_fns.ddl_dz_at_z(pop.cosmo, z) * (1.0 + z) ** 2


class HyperLikelihood(nn.Module):
    """Spectral-siren hyper-likelihood over a λ batch.

    Build it with :meth:`create` (mirrors ``chimera_tpu``'s constructor
    surface) or :meth:`from_state` (from a built JAX object)."""

    def __init__(self, theta_gw: ThetaPEDet, z_grids: torch.Tensor,
                 population: Population, selection: SelectionFunction,
                 kernel: str, bw_method, pe_neff: float):
        super().__init__()
        for name in _PE_FIELDS:
            self.register_buffer(name, getattr(theta_gw, name))
        self.register_buffer("inv_pe_prior", 1.0 / theta_gw.pe_prior)
        self.register_buffer("z_grids", z_grids)
        self.population = population
        self.selection = selection
        self.kernel = kernel
        self.bw_method = bw_method
        self.pe_neff = float(pe_neff)

    @classmethod
    def create(cls, theta_gw: ThetaPEDet, z_grids, population: Population,
               selection: SelectionFunction, kind=None, kernel="epan",
               bw_method=None, cut_grid=2.0, binning=True, pe_neff=2.0
               ) -> "HyperLikelihood":
        """PE data, z-grids and injections are moved to the population's
        device and dtype; samples are sorted by distance."""
        if kind not in (None, "1d"):
            raise NotImplementedError(
                f"kind={kind!r} is ported with the dark-siren slice and the "
                "other variants (ROADMAP.md §1 items 8 and 11)")
        if binning:
            raise NotImplementedError(
                "binning=True is ROADMAP.md §1 item 12 (K4); pass binning=False")
        if cut_grid is not None:
            raise NotImplementedError(
                "effective-grid KDEs (cut_grid) are ROADMAP.md §1 item 12 "
                "(K1 mode b); pass cut_grid=None")
        if selection is None:
            raise ValueError("a SelectionFunction is required")
        ref = population.cosmo.H0
        theta_gw = theta_gw.with_derived()
        theta_gw = theta_gw.update(**{
            f: torch.as_tensor(getattr(theta_gw, f), dtype=ref.dtype,
                               device=ref.device) for f in _PE_FIELDS})
        z_grids = torch.as_tensor(z_grids, dtype=ref.dtype, device=ref.device)
        _validate_shapes(theta_gw, z_grids)
        hl = cls(_sort_samples_by_distance(theta_gw), z_grids, population,
                 selection, kernel, bw_method, pe_neff)
        hl.selection.to(device=ref.device, dtype=ref.dtype)
        return hl

    @classmethod
    def from_state(cls, state: dict, device=None, dtype=None) -> "HyperLikelihood":
        """Rebuild from ``convert.state_from_reference(jax_hyperlikelihood)``:
        the same PE data, z-grids, injections, population (its built
        tables included) and configuration."""
        pop = Population.from_state(state, "population.", device, dtype)
        ref = pop.cosmo.H0

        def arr(key):
            return torch.as_tensor(state[key], dtype=ref.dtype, device=ref.device)

        theta = ThetaPEDet(**{f: arr(f"theta_gw.{f}") for f in _PE_FIELDS})
        sel = SelectionFunction.from_state(state, "selection.", ref.device,
                                           ref.dtype)
        bw = state.get("bw_method")
        cut = state.get("cut_grid")
        return cls.create(theta, arr("z_grids"), pop, sel,
                          kind=str(state["kind"]), kernel=str(state["kernel"]),
                          bw_method=None if bw is None else bw.item(),
                          cut_grid=None if cut is None else float(cut),
                          binning=bool(state["binning"]),
                          pe_neff=float(state["pe_neff"]))

    def _apply(self, fn, *args, **kwargs):
        # .to()/.cuda()/.double() also move the population's tensors
        super()._apply(fn, *args, **kwargs)
        self.population = tensor_map(self.population, fn)
        return self

    # -- evaluation ---------------------------------------------------------

    @property
    def n_events(self) -> int:
        return self.z_grids.shape[0]

    def batch_numerators(self, pop_b: Population) -> torch.Tensor:
        """Per-event numerator integrals for a λ batch — (L, Nev): the fused
        weights+KDE densities, gated by N_eff, times p_cbc over the detector
        jacobian, integrated over the z-grids."""
        den, stats = fused_weights_kde(
            self.m1det, self.m2det, self.dL, self.inv_pe_prior,
            pop_b.cosmo, pop_b.mass, self.z_grids,
            kernel=self.kernel, bw_method=self.bw_method)
        gate = stats["neff"] >= self.pe_neff
        p_gw = torch.where(gate[..., None], torch.nan_to_num(den), 0.0)
        zg = self.z_grids[None]
        integrand = p_gw * p_cbc(pop_b, zg) / _jacobian(pop_b, zg)
        return trapz(integrand, zg, dim=-1)

    def _finish(self, pop_b: Population, log_evs_sum: torch.Tensor,
                n_exp: torch.Tensor) -> torch.Tensor:
        """Combine summed log numerators with N_exp."""
        if not pop_b.scale_free:
            log_evs_sum = log_evs_sum + self.n_events * torch.log(
                pop_b.R0 * pop_b.Tobs)
            return log_evs_sum - n_exp
        return log_evs_sum - self.n_events * torch.log(n_exp)

    def log_like_batch(self, hyper_batch: dict) -> torch.Tensor:
        """Log hyper-likelihood for a batch of λ (dict of equal-length 1-D
        arrays) — (L,)."""
        pop_b = self.population.update_batch(hyper_batch)
        log_evs = torch.nan_to_num(torch.log(self.batch_numerators(pop_b)),
                                   nan=-torch.inf)
        return self._finish(pop_b, torch.sum(log_evs, dim=-1),
                            self.selection.n_exp(pop_b))

    def log_like(self, **hyper) -> torch.Tensor:
        """One hyper-parameter sample (a batch of 1)."""
        return self.log_like_batch({k: [v] for k, v in hyper.items()})[0]

    def compute_all(self, **hyper):
        """Debug decomposition at one λ: per-event log numerators, the log
        numerator, log N_exp and the log hyper-likelihood."""
        pop = self.population.update(**hyper)
        log_evs = torch.nan_to_num(torch.log(self.batch_numerators(pop)),
                                   nan=-torch.inf)[0]
        n_exp = self.selection.n_exp(pop)
        log_num = torch.sum(log_evs)
        log_hyper = self._finish(pop, log_num[None], n_exp)[0]
        if not pop.scale_free:
            log_num = log_num + self.n_events * torch.log(pop.R0 * pop.Tobs)[0]
        return log_evs, log_num, torch.log(n_exp)[0], log_hyper
