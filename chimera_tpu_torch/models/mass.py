"""Source-frame mass models (counterpart of ``chimera_tpu/models/mass.py``):
the primitives, ``BaseMassModel`` with the analytic-CDF engine,
``PowerLawPeak`` and the joint pdf ``p_m1m2``.

Every hyper-parameter and table carries a leading λ axis; arrays passed to
the pdfs have a leading axis of length 1 or L.  The formulas mirror the JAX
package's operation by operation (``_powx`` as exp(a log x), the eps of the
smoothing window, the divisor guard of ``p_m1m2``): the CUDA kernel
(``csrc/fused_kde.cu``) evaluates the same expressions per PE sample.
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

import torch

from chimera_tpu_torch.ops.chebyshev import cheb_nodes, chebeval, chebfit_from_values
from chimera_tpu_torch.ops.integrate import (
    cumtrapz,
    gauss_legendre_unit,
    logspace,
    trapz,
)
from chimera_tpu_torch.pytree import lam, resolve_params, update_batch

# ---------------------------------------------------------------------------
# Primitives (parameters already broadcast against the argument)
# ---------------------------------------------------------------------------


def _powx(x: torch.Tensor, a) -> torch.Tensor:
    """x**a for x > 0 as exp(a log x)."""
    return torch.exp(a * torch.log(x))


def tpl_unnorm(m, alpha, m_low, m_high) -> torch.Tensor:
    """Truncated power law m^alpha on [m_low, m_high] (not normalized)."""
    return torch.where((m_low <= m) & (m <= m_high),
                       _powx(torch.clamp_min(m, 1e-30), alpha), 0.0)


def tpl_cdf(alpha, m_low, m) -> torch.Tensor:
    """Unnormalized CDF of the truncated power law, analytic."""
    mp = torch.clamp_min(m, 1e-30)
    return torch.where(
        alpha == -1.0,
        torch.log(m_low) - torch.log(mp),
        (_powx(mp, 1.0 + alpha) - _powx(m_low, 1.0 + alpha)) / (1.0 + alpha))


def _logaddexp0(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) in the overflow-safe form of ``jnp.logaddexp(0, x)``."""
    return torch.where(torch.isnan(x), x,
                       torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x))))


def smoothing(m, delta_m, m_low) -> torch.Tensor:
    """LVK low-mass turn-on window; m >= m_low + delta_m takes S = 1."""
    eps = 1e-99  # 0 in float32, as in the JAX package
    log_s = torch.where(
        m < m_low, -math.inf,
        torch.where(m >= m_low + delta_m, 0.0,
                    -_logaddexp0(delta_m / (m - m_low + eps)
                                 + delta_m / (m - m_low - delta_m + eps))))
    return torch.exp(log_s)


def gaussian(x, mu, sigma) -> torch.Tensor:
    log_g = (-0.5 * math.log(2.0 * math.pi) - torch.log(sigma)
             - (x - mu) ** 2 / (2.0 * sigma**2))
    return torch.exp(log_g)


def truncated_gaussian_norm(mu, sigma, x_min, x_max) -> torch.Tensor:
    """Mass of N(mu, sigma) on [x_min, x_max]."""
    hi = (x_max - mu) / (sigma * math.sqrt(2.0))
    lo = (x_min - mu) / (sigma * math.sqrt(2.0))
    return 0.5 * torch.special.erf(hi) - 0.5 * torch.special.erf(lo)


def truncated_gaussian(x, mu, sigma, x_min, x_max, norm) -> torch.Tensor:
    return torch.where((x_min <= x) & (x <= x_max),
                       gaussian(x, mu, sigma) / norm, 0.0)


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BaseMassModel:
    """Paired mass model p(m1) p(m2 | m1) with the m2 | m1 conditional
    normalized through its CDF at m1: closed form above m_join = m_low +
    delta_m, a Chebyshev fit of the window-suppressed segment below."""

    m_low: torch.Tensor
    m_high: torch.Tensor
    m_grid: torch.Tensor | None = None
    cdf_m2_conditioned: torch.Tensor | None = None
    norm_p_m1: torch.Tensor | None = None
    m_join: torch.Tensor | None = None
    cdf_at_join: torch.Tensor | None = None
    cheb_cdf_window: torch.Tensor | None = None
    grid_res: int = 1000
    cdf_engine: str = "analytic"
    window_deg: int = 48

    name: ClassVar[str] = "base_mass"
    hyper_defaults: ClassVar[dict] = dict(m_low=5.1, m_high=87.0)
    config_keys: ClassVar[tuple[str, ...]] = ("grid_res", "cdf_engine",
                                              "window_deg")

    @classmethod
    def create(cls, *, device=None, dtype=None, **kwargs):
        hyper, config = resolve_params(cls, kwargs, device, dtype)
        if config["cdf_engine"] != "analytic":
            raise NotImplementedError(
                "only cdf_engine='analytic' is ported; the 'table' engine is "
                "ROADMAP.md §1 item 3")
        obj = cls(**hyper, **config)
        return obj._with_norm_consts()._with_tables()

    @classmethod
    def from_state(cls, state: dict, prefix: str = "", device=None, dtype=None):
        """Load hyper-parameters and built tables from a
        ``convert.state_from_reference`` dict (tables are not rebuilt)."""
        from chimera_tpu_torch.convert import model_from_state

        return model_from_state(cls, state, prefix, device, dtype)

    update_batch = update_batch

    @property
    def L(self) -> int:
        return self.m_low.shape[0]

    def _with_norm_consts(self):
        return self

    def _with_tables(self):
        """m2|m1 CDF table and p(m1) normalization on a per-λ log grid, then
        the analytic engine's window fit (mass.py:155-196)."""
        mg = logspace(torch.log10(self.m_low), torch.log10(self.m_high),
                      self.grid_res)                                  # (L, R)
        obj = dataclasses.replace(self, m_grid=mg)
        cdf = cumtrapz(obj.secondary_conditioned_pdf_unnorm(mg, lam(self.m_high, mg)), mg)
        norm = trapz(obj.primary_pdf_unnorm(mg), mg)
        obj = dataclasses.replace(obj, cdf_m2_conditioned=cdf, norm_p_m1=norm)
        return obj._with_analytic_cdf()

    def _with_analytic_cdf(self):
        """Window segment CDF at the fit nodes from per-node Gauss–Legendre
        quadrature: CDF(m) = (m - m_low) mean(pdf on [m_low, m])."""
        dtype, device = self.m_low.dtype, self.m_low.device
        m_join = torch.minimum(
            self.m_low + torch.clamp_min(self.delta_m, 1e-6), self.m_high)
        gl_x, gl_w = gauss_legendre_unit(96, dtype, device)
        nodes = cheb_nodes(self.window_deg, self.m_low, m_join)        # (L, K)
        span = nodes - self.m_low[:, None]
        m_eval = self.m_low[:, None, None] + span[:, :, None] * gl_x   # (L, K, Q)
        pdf = self.secondary_conditioned_pdf_unnorm(
            m_eval, lam(self.m_high, m_eval))
        cdf_nodes = span * torch.sum(gl_w * pdf, dim=-1)
        m_join_eval = self.m_low[:, None] + (m_join - self.m_low)[:, None] * gl_x
        cdf_at_join = (m_join - self.m_low) * torch.sum(
            gl_w * self.secondary_conditioned_pdf_unnorm(
                m_join_eval, lam(self.m_high, m_join_eval)), dim=-1)
        return dataclasses.replace(self, m_join=m_join, cdf_at_join=cdf_at_join,
                                   cheb_cdf_window=chebfit_from_values(cdf_nodes))

    def conditional_cdf_at(self, m1: torch.Tensor) -> torch.Tensor:
        """CDF of the m2|m1 conditional at m1 — its normalization."""
        m_low, m_join = lam(self.m_low, m1), lam(self.m_join, m1)
        m1c = torch.minimum(torch.maximum(m1, m_low), lam(self.m_high, m1))
        below = chebeval(self.cheb_cdf_window, m1c, self.m_low, self.m_join)
        above = lam(self.cdf_at_join, m1) + tpl_cdf(lam(self.beta, m1), m_join, m1c)
        return torch.where(m1c <= m_join, below, above)

    def primary_pdf_unnorm(self, m: torch.Tensor) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def secondary_conditioned_pdf_unnorm(self, m2, m1) -> torch.Tensor:
        """Smoothed power law m2^beta on [m_low, m1]; m1 broadcasts against m2."""
        pdf = tpl_unnorm(m2, lam(self.beta, m2), lam(self.m_low, m2), m1)
        return pdf * smoothing(m2, lam(self.delta_m, m2), lam(self.m_low, m2))


@dataclasses.dataclass(frozen=True)
class PowerLawPeak(BaseMassModel):
    """LVK power law + Gaussian peak (mass.py:287-316)."""

    lambda_peak: torch.Tensor = None
    alpha: torch.Tensor = None
    beta: torch.Tensor = None
    delta_m: torch.Tensor = None
    mu_g: torch.Tensor = None
    sigma_g: torch.Tensor = None
    peak_norm: torch.Tensor | None = None

    name: ClassVar[str] = "power_law_plus_peak"
    hyper_defaults: ClassVar[dict] = dict(
        BaseMassModel.hyper_defaults, lambda_peak=0.039, alpha=3.4, beta=1.1,
        delta_m=4.8, mu_g=34.0, sigma_g=3.6)

    def _with_norm_consts(self):
        return dataclasses.replace(self, peak_norm=truncated_gaussian_norm(
            self.mu_g, self.sigma_g, self.m_low, self.mu_g + 5.0 * self.sigma_g))

    def primary_pdf_unnorm(self, m: torch.Tensor) -> torch.Tensor:
        m_low, m_high, alpha = (lam(self.m_low, m), lam(self.m_high, m),
                                lam(self.alpha, m))
        mu, sigma = lam(self.mu_g, m), lam(self.sigma_g, m)
        lp = lam(self.lambda_peak, m)
        pl = tpl_unnorm(m, -alpha, m_low, m_high) / tpl_cdf(-alpha, m_low, m_high)
        peak = truncated_gaussian(m, mu, sigma, m_low, mu + 5.0 * sigma,
                                  lam(self.peak_norm, m))
        pdf = (1.0 - lp) * pl + lp * peak
        return pdf * smoothing(m, lam(self.delta_m, m), m_low)


# ---------------------------------------------------------------------------
# Joint pdf — the function evaluated per PE sample
# ---------------------------------------------------------------------------


def p_m1m2(mass: BaseMassModel, m1: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """Normalized joint pdf p(m1) p(m2 | m1).  The degenerate-conditional
    guard acts on the divisor (cdf <= 0 -> divide by 1, then zero the row),
    then rows at m1 <= m_low (1 + 1e-9) and non-finite rows are zeroed."""
    p1 = mass.primary_pdf_unnorm(m1) / lam(mass.norm_p_m1, m1)
    p21 = mass.secondary_conditioned_pdf_unnorm(m2, m1)
    cdf = mass.conditional_cdf_at(m1)
    ok = cdf > 0.0
    p21 = p21 / torch.where(ok, cdf, 1.0)
    p21 = torch.where(ok & (m1 > lam(mass.m_low, m1) * (1.0 + 1e-9)), p21, 0.0)
    p21 = torch.where(torch.isfinite(p21), p21, 0.0)
    return p1 * p21
