"""Source-frame mass models (counterpart of ``chimera_tpu/models/mass.py``):
the primitives, ``BaseMassModel`` with the analytic-CDF engine (closed form
plus a Chebyshev fit of the window segment) and the 'table' engine (the
reference's interpolation into the CDF table), the five models
``TruncatedPowerLaw``, ``BrokenPowerLaw``, ``PowerLawPeak``,
``PowerLawTwoPeaks`` and ``PowerLawSpline``, the joint pdf ``p_m1m2`` and
``pdf_joint_and_marginals``.

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
    linspace,
    logspace,
    trapz,
)
from chimera_tpu_torch.ops.interp import interp
from chimera_tpu_torch.pytree import (fit_in_float64, lam, resolve_params,
                                      update_batch)

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
    normalized through its CDF at m1: with ``cdf_engine='analytic'``
    closed form above m_join = m_low + delta_m and a Chebyshev fit of the
    window-suppressed segment below, whose coefficients are float64 in
    every dtype (see ``conditional_cdf_at``); with 'table', the CDF table
    on the per-λ log grid ``m_grid``, interpolated."""

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
    float64_fields: ClassVar[tuple[str, ...]] = ("cheb_cdf_window",)

    @classmethod
    def create(cls, *, device=None, dtype=None, **kwargs):
        hyper, config = resolve_params(cls, kwargs, device, dtype)
        if config["cdf_engine"] not in ("analytic", "table"):
            raise ValueError(f"unknown cdf_engine {config['cdf_engine']!r}")
        # tables fitted in float64, stored in the model's dtype but for
        # float64_fields
        return fit_in_float64(cls(**hyper, **config),
                              lambda m: m._with_norm_consts()._with_tables())

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
        return obj._with_analytic_cdf() if obj.cdf_engine == "analytic" else obj

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
        """CDF of the m2|m1 conditional at m1 — its normalization.

        The window series is summed in float64 whatever ``m1``'s dtype, as
        the dark-siren CUDA kernels do.  Just above m_low the CDF is tiny
        against the series' terms, and a float32 sum carries an absolute
        error of ~1e-7 of them: 6 % at m1 = m_low + 0.41, where an injection
        with a small p_draw weighs on N_exp.  The 'table' engine interpolates
        the CDF table, clamping like ``jnp.interp``."""
        if self.cdf_engine == "table":
            return interp(m1, self.m_grid, self.cdf_m2_conditioned)
        m_low, m_join = lam(self.m_low, m1), lam(self.m_join, m1)
        m1c = torch.minimum(torch.maximum(m1, m_low), lam(self.m_high, m1))
        f64 = torch.float64
        below = chebeval(self.cheb_cdf_window.to(f64), m1c.to(f64),
                         self.m_low.to(f64), self.m_join.to(f64)).to(m1.dtype)
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


@dataclasses.dataclass(frozen=True)
class TruncatedPowerLaw(BaseMassModel):
    """p(m1) ∝ m1^-alpha on [m_low, m_high], p(m2 | m1) ∝ m2^beta on
    [m_low, m1], no smoothing window: the analytic CDF is the closed form
    everywhere (mass.py:238-262)."""

    alpha: torch.Tensor = None
    beta: torch.Tensor = None

    name: ClassVar[str] = "truncated_power_law"
    hyper_defaults: ClassVar[dict] = dict(BaseMassModel.hyper_defaults,
                                          alpha=2.5, beta=1.1)

    def primary_pdf_unnorm(self, m: torch.Tensor) -> torch.Tensor:
        return tpl_unnorm(m, -lam(self.alpha, m), lam(self.m_low, m),
                          lam(self.m_high, m))

    def secondary_conditioned_pdf_unnorm(self, m2, m1) -> torch.Tensor:
        return tpl_unnorm(m2, lam(self.beta, m2), lam(self.m_low, m2), m1)

    def _with_analytic_cdf(self):
        return self  # closed form; nothing to fit

    def conditional_cdf_at(self, m1: torch.Tensor) -> torch.Tensor:
        if self.cdf_engine == "table":
            return interp(m1, self.m_grid, self.cdf_m2_conditioned)
        m_low = lam(self.m_low, m1)
        m1c = torch.minimum(torch.maximum(m1, m_low), lam(self.m_high, m1))
        return tpl_cdf(lam(self.beta, m1), m_low, m1c)


@dataclasses.dataclass(frozen=True)
class BrokenPowerLaw(BaseMassModel):
    """Broken power law with the low-mass window (mass.py:265-285): slope
    -alpha_1 below m_break = m_low + break_fraction (m_high - m_low),
    -alpha_2 above, continuous at the break."""

    alpha_1: torch.Tensor = None
    alpha_2: torch.Tensor = None
    beta: torch.Tensor = None
    delta_m: torch.Tensor = None
    break_fraction: torch.Tensor = None

    name: ClassVar[str] = "broken_power_law"
    hyper_defaults: ClassVar[dict] = dict(
        BaseMassModel.hyper_defaults, alpha_1=1.6, alpha_2=5.6, beta=1.1,
        delta_m=4.8, break_fraction=0.43)

    def primary_pdf_unnorm(self, m: torch.Tensor) -> torch.Tensor:
        m_low, m_high = lam(self.m_low, m), lam(self.m_high, m)
        a1, a2 = lam(self.alpha_1, m), lam(self.alpha_2, m)
        m_break = m_low + lam(self.break_fraction, m) * (m_high - m_low)
        pl1_at_break = tpl_unnorm(m_break, -a1, m_low, m_break)
        pl2_at_break = tpl_unnorm(m_break, -a2, m_break, m_high)
        pdf = tpl_unnorm(m, -a1, m_low, m_break)
        pdf = pdf + tpl_unnorm(m, -a2, m_break, m_high) * pl1_at_break / pl2_at_break
        return pdf * smoothing(m, lam(self.delta_m, m), m_low)


@dataclasses.dataclass(frozen=True)
class PowerLawTwoPeaks(BaseMassModel):
    """Power law plus two Gaussian peaks (mass.py:319-365)."""

    lambda_peak: torch.Tensor = None
    lambda1: torch.Tensor = None
    alpha: torch.Tensor = None
    beta: torch.Tensor = None
    delta_m: torch.Tensor = None
    mu1_g: torch.Tensor = None
    sigma1_g: torch.Tensor = None
    mu2_g: torch.Tensor = None
    sigma2_g: torch.Tensor = None
    peak1_norm: torch.Tensor | None = None
    peak2_norm: torch.Tensor | None = None

    name: ClassVar[str] = "power_law_plus_double_peak"
    hyper_defaults: ClassVar[dict] = dict(
        BaseMassModel.hyper_defaults, lambda_peak=0.05, lambda1=0.5, alpha=3.4,
        beta=1.1, delta_m=4.8, mu1_g=34.0, sigma1_g=3.6, mu2_g=68.0,
        sigma2_g=3.0)

    def _with_norm_consts(self):
        return dataclasses.replace(
            self,
            peak1_norm=truncated_gaussian_norm(
                self.mu1_g, self.sigma1_g, self.m_low,
                self.mu1_g + 5.0 * self.sigma1_g),
            peak2_norm=truncated_gaussian_norm(
                self.mu2_g, self.sigma2_g, self.m_low,
                self.mu2_g + 5.0 * self.sigma2_g))

    def primary_pdf_unnorm(self, m: torch.Tensor) -> torch.Tensor:
        m_low, m_high, alpha = (lam(self.m_low, m), lam(self.m_high, m),
                                lam(self.alpha, m))
        mu1, sig1 = lam(self.mu1_g, m), lam(self.sigma1_g, m)
        mu2, sig2 = lam(self.mu2_g, m), lam(self.sigma2_g, m)
        lp, l1 = lam(self.lambda_peak, m), lam(self.lambda1, m)
        pl = tpl_unnorm(m, -alpha, m_low, m_high) / tpl_cdf(-alpha, m_low, m_high)
        g1 = truncated_gaussian(m, mu1, sig1, m_low, mu1 + 5.0 * sig1,
                                lam(self.peak1_norm, m))
        g2 = truncated_gaussian(m, mu2, sig2, m_low, mu2 + 5.0 * sig2,
                                lam(self.peak2_norm, m))
        pdf = (1.0 - lp) * pl + lp * l1 * g1 + lp * (1.0 - l1) * g2
        return pdf * smoothing(m, lam(self.delta_m, m), m_low)


@dataclasses.dataclass(frozen=True)
class PowerLawSpline(BaseMassModel):
    """Power law times the low-mass window times exp(f(log m)), f the
    piecewise-linear interpolation of ``spline_coeffs`` (L, num_knots) on
    num_knots + 2 knots uniform in log m over [log m_low, log m_high], the
    two edge knots pinned at 0 (mass.py:368-416)."""

    alpha: torch.Tensor = None
    beta: torch.Tensor = None
    delta_m: torch.Tensor = None
    spline_coeffs: torch.Tensor = None
    num_knots: int = 10

    name: ClassVar[str] = "power_law_plus_spline"
    hyper_defaults: ClassVar[dict] = dict(
        BaseMassModel.hyper_defaults, alpha=3.4, beta=1.1, delta_m=4.8,
        spline_coeffs=None)
    config_keys: ClassVar[tuple[str, ...]] = BaseMassModel.config_keys + (
        "num_knots",)
    # hyper-parameters with an axis of their own after the λ axis
    vector_hypers: ClassVar[tuple[str, ...]] = ("spline_coeffs",)

    @classmethod
    def create(cls, *, device=None, dtype=None, **kwargs):
        num_knots = int(kwargs.get("num_knots", cls.num_knots))
        if kwargs.get("spline_coeffs") is None:
            kwargs["spline_coeffs"] = [0.0] * num_knots
        model = super().create(device=device, dtype=dtype, **kwargs)
        if model.spline_coeffs.shape[1] != num_knots:
            raise ValueError(f"spline_coeffs must have num_knots = {num_knots} "
                             f"entries, not {model.spline_coeffs.shape[1]}")
        return model

    def knots(self) -> torch.Tensor:
        """(L, num_knots + 2) knots in log m."""
        return linspace(torch.log(self.m_low), torch.log(self.m_high),
                        self.num_knots + 2)

    def perturbation(self, m: torch.Tensor) -> torch.Tensor:
        zero = torch.zeros_like(self.spline_coeffs[:, :1])
        full = torch.cat([zero, self.spline_coeffs, zero], dim=1)
        return interp(torch.log(torch.clamp_min(m, 1e-30)), self.knots(), full)

    def primary_pdf_unnorm(self, m: torch.Tensor) -> torch.Tensor:
        m_low = lam(self.m_low, m)
        pdf = tpl_unnorm(m, -lam(self.alpha, m), m_low, lam(self.m_high, m))
        pdf = pdf * smoothing(m, lam(self.delta_m, m), m_low)
        return pdf * torch.exp(self.perturbation(m))


# the mass models by class name (Population.from_state, convert)
MASS_MODELS = {m.__name__: m for m in (TruncatedPowerLaw, BrokenPowerLaw,
                                       PowerLawPeak, PowerLawTwoPeaks,
                                       PowerLawSpline)}


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


def pdf_joint_and_marginals(mass: BaseMassModel, res: tuple[int, int] = (5000, 2500)
                            ) -> dict:
    """Joint and marginal pdfs of every λ on a dense (m1, m2) grid, a plot
    helper (``chimera_tpu/models/mass.py::pdf_joint_and_marginals``):
    m1 (L, R1) and m2 (L, R2) uniform over [m_low, m_high], the meshes and
    the joint (L, R2, R1) as ``jnp.meshgrid`` lays them out, and each
    marginal normalized by the trapezoid rule."""
    m1 = linspace(mass.m_low, mass.m_high, res[0])
    m2 = linspace(mass.m_low, mass.m_high, res[1])
    m1m = m1[:, None, :].expand(-1, res[1], -1)
    m2m = m2[:, :, None].expand(-1, -1, res[0])
    pj = p_m1m2(mass, m1m, m2m)
    p1 = trapz(pj, m2[:, :, None], dim=1)
    p1 = p1 / trapz(p1, m1)[:, None]
    p2 = trapz(pj, m1[:, None, :], dim=2)
    p2 = p2 / trapz(p2, m2)[:, None]
    return {"m1": m1, "m2": m2, "m1mesh": m1m, "m2mesh": m2m,
            "p_joint": pj, "p_m1_marg": p1, "p_m2_marg": p2}
