"""GW selection effects xi(λ) via importance-sampled injection Monte Carlo
(counterpart of ``chimera_tpu/selection.py``)."""

from __future__ import annotations

import torch
from torch import nn

from chimera_tpu_torch.data.structs import ThetaInjDet
from chimera_tpu_torch.models.population import Population, pop_rate_det
from chimera_tpu_torch.pytree import batch_sum


class SelectionFunction(nn.Module):
    """N_exp(λ) = Tobs xi(λ) from detected injections (held as buffers, so
    ``.to(device)`` moves them); ``n_inj`` is the number of *generated*
    injections and ``n_eff_min`` the effective-count threshold below which
    the estimate is zeroed."""

    def __init__(self, theta_inj: ThetaInjDet, n_inj: float,
                 n_eff_min: float | None = 5.0):
        super().__init__()
        for name in ("m1det", "m2det", "dL", "p_draw"):
            self.register_buffer(name, getattr(theta_inj, name))
        self.n_inj = float(n_inj)
        self.n_eff_min = n_eff_min

    @classmethod
    def create(cls, theta_inj: ThetaInjDet, n_inj: float,
               n_eff_min: float | None = 5.0) -> "SelectionFunction":
        return cls(theta_inj, n_inj, n_eff_min)

    @classmethod
    def from_state(cls, state: dict, prefix: str = "", device=None,
                   dtype=None) -> "SelectionFunction":
        """From a ``convert.state_from_reference`` dict; a missing
        ``n_eff_min`` is the reference's None (no gate)."""
        def arr(k):
            return torch.as_tensor(state[f"{prefix}theta_inj.{k}"],
                                   dtype=dtype, device=device)

        theta = ThetaInjDet(**{k: arr(k) for k in ("m1det", "m2det", "dL",
                                                   "p_draw")})
        n_eff_min = state.get(f"{prefix}n_eff_min")
        return cls(theta, float(state[f"{prefix}n_inj"]),
                   None if n_eff_min is None else float(n_eff_min))

    @property
    def theta_inj(self) -> ThetaInjDet:
        return ThetaInjDet(m1det=self.m1det, m2det=self.m2det, dL=self.dL,
                           p_draw=self.p_draw)

    def take_injections(self, start: int, stop: int) -> "SelectionFunction":
        """The selection over the detected injections [start, stop), the
        generated count unchanged: a shard's.  Rows past the last injection
        are padding at m1det = m2det = 0.01, dL = p_draw = 1, below every
        mass model's support, so their rate is exactly 0
        (``chimera_tpu/parallel/mesh.py::pad_injections``)."""
        n = self.dL.shape[0]
        fill = {"m1det": 0.01, "m2det": 0.01, "dL": 1.0, "p_draw": 1.0}
        cut = {}
        for name, value in fill.items():
            t = getattr(self, name)[min(start, n):min(stop, n)]
            pad = t.new_full((stop - start - t.shape[0],), value)
            cut[name] = torch.cat([t, pad])
        return SelectionFunction(ThetaInjDet(**cut), self.n_inj, self.n_eff_min)

    def partial_sums(self, pop: Population, place: tuple[int, int] | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """(sum dN/pdraw, sum (dN/pdraw)^2) per λ over the injections — the
        two sums a shard contributes to the global estimate; ``place``: the
        λ rows' place in a larger batch (``pytree.batch_sum``)."""
        dn = pop_rate_det(pop, self.theta_inj) / self.p_draw
        dn = torch.nan_to_num(dn)  # the reference's nansum
        return batch_sum(dn, place), batch_sum(dn * dn, place)

    def n_exp_from_sums(self, pop: Population, s1: torch.Tensor,
                        s2: torch.Tensor) -> torch.Tensor:
        xi = s1 / self.n_inj
        n_exp = pop.Tobs * xi
        if self.n_eff_min is not None:
            var = s2 / self.n_inj**2 - xi * xi / self.n_inj
            n_eff = xi * xi / var
            n_exp = torch.where(n_eff < self.n_eff_min, 0.0, n_exp)
        return n_exp

    def n_exp(self, pop: Population) -> torch.Tensor:
        """Expected number of detections per λ, (L,)."""
        return self.n_exp_from_sums(pop, *self.partial_sums(pop))

    def forward(self, pop: Population) -> torch.Tensor:
        return self.n_exp(pop)
