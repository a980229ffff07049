"""Mock GW catalogs and injection sets drawn from the population model
(counterpart of ``chimera_tpu/data/mock.py``).

Randomness flows through an explicit ``torch.Generator`` (on the device the
population lives on); the streams differ from the JAX package's PRNG, so
tests compare the two mocks as distributions only.  Draws are made in the
population's dtype — build the population in float64 for mocks.
"""

from __future__ import annotations

import math

import torch

from chimera_tpu_torch.data.structs import ThetaInjDet, ThetaPEDet
from chimera_tpu_torch.models import cosmology as cosmo_fns
from chimera_tpu_torch.models.population import Population
from chimera_tpu_torch.ops.integrate import cumtrapz
from chimera_tpu_torch.ops.interp import interp


def _uniform(gen, shape, ref: torch.Tensor) -> torch.Tensor:
    return torch.rand(shape, generator=gen, dtype=ref.dtype, device=ref.device)


def _normal(gen, shape, ref: torch.Tensor) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=ref.dtype, device=ref.device)


def _inverse_cdf_sample(gen, pdf_vals, grid, n: int) -> torch.Tensor:
    """n draws from a tabulated 1-D pdf by inverse-CDF interpolation."""
    cdf = cumtrapz(pdf_vals, grid)
    return interp(_uniform(gen, (n,), grid), cdf / cdf[-1], grid)


def sample_source_frame(gen, pop: Population, n: int, z_grid_res: int = 4000,
                        z_max: float | None = None) -> dict:
    """Draw (z, m1, m2) from a single (L = 1) population; ``z_max`` truncates
    the redshift draw to the detectable neighbourhood."""
    if pop.L != 1:
        raise ValueError("mock draws take a single population (L = 1)")
    ref = pop.cosmo.H0
    if z_max is None:
        z_max = min(float(pop.cosmo.z_max), 2.5)
    zz = torch.linspace(1e-4, z_max, z_grid_res, dtype=ref.dtype, device=ref.device)
    p_z = (cosmo_fns.differential_comoving_volume(pop.cosmo, zz[None])
           * pop.rate.rate(zz[None]) / (1.0 + zz))[0]
    z = _inverse_cdf_sample(gen, p_z, zz, n)

    mass = pop.mass
    mg, cdf_tab = mass.m_grid[0], mass.cdf_m2_conditioned[0]
    m1 = _inverse_cdf_sample(gen, mass.primary_pdf_unnorm(mass.m_grid)[0], mg, n)
    # m2 | m1 through the conditional CDF table
    target = _uniform(gen, (n,), ref) * interp(m1, mg, cdf_tab)
    m2 = interp(target, cdf_tab, mg)
    return {"z": z, "m1": m1, "m2": m2}


def _snr_proxy(m1det, m2det, dgw, dgw_ref: float = 5.0) -> torch.Tensor:
    """Toy optimal SNR ~ Mc_det^(5/6) / dGW: an equal-mass 30+30 Msun binary
    at dgw_ref Gpc has SNR 8."""
    mc = (m1det * m2det) ** 0.6 / (m1det + m2det) ** 0.2
    mc_ref = (30.0 * 30.0) ** 0.6 / 60.0 ** 0.2
    return 8.0 * (mc / mc_ref) ** (5.0 / 6.0) * (dgw_ref / dgw)


def make_mock_catalog(gen, pop: Population, n_events: int = 100,
                      n_samples: int = 1000, snr_threshold: float = 12.0,
                      sigma_dl: float = 0.1, sigma_m: float = 0.05,
                      sigma_sky_rad: float = 0.05, oversample: int = 300,
                      return_truths: bool = False):
    """A detected GW catalog with PE-sample clouds: events pass the SNR proxy
    with unit Gaussian noise (Malmquist selection); PE samples are log-normal
    clouds around the true detector-frame values with widths scaled by
    12/SNR; the PE prior is flat."""
    ref = pop.cosmo.H0
    n_draw = n_events * oversample
    src = sample_source_frame(gen, pop, n_draw)
    dgw = cosmo_fns.dl_at_z(pop.cosmo, src["z"][None])[0]
    m1d = src["m1"] * (1.0 + src["z"])
    m2d = src["m2"] * (1.0 + src["z"])
    snr_obs = _snr_proxy(m1d, m2d, dgw) + _normal(gen, (n_draw,), ref)
    passed = snr_obs > snr_threshold
    n_det = int(passed.sum())
    if n_det < n_events:
        raise ValueError(
            f"only {n_det} of {n_draw} mock draws pass SNR > {snr_threshold}; "
            "raise `oversample` or lower the threshold")
    detected = torch.nonzero(passed)[:n_events, 0]

    m1d, m2d, dgw = m1d[detected], m2d[detected], dgw[detected]
    snr = torch.clamp_min(snr_obs[detected], snr_threshold)
    s_dl = sigma_dl * (12.0 / snr)[:, None]
    s_m = sigma_m * (12.0 / snr)[:, None]

    eps = _normal(gen, (n_events, n_samples, 3), ref)
    dl_pe = dgw[:, None] * torch.exp(s_dl * eps[..., 0] - 0.5 * s_dl**2)
    m1_pe = m1d[:, None] * torch.exp(s_m * eps[..., 1] - 0.5 * s_m**2)
    m2_pe = m2d[:, None] * torch.exp(s_m * eps[..., 2] - 0.5 * s_m**2)
    m1_pe, m2_pe = torch.maximum(m1_pe, m2_pe), torch.minimum(m1_pe, m2_pe)

    # sky: random event centres, Gaussian PE scatter around them
    ra_c = 2.0 * math.pi * _uniform(gen, (n_events, 1), ref)
    dec_c = torch.arcsin(2.0 * _uniform(gen, (n_events, 1), ref) - 1.0)
    ra = ra_c + sigma_sky_rad * _normal(gen, (n_events, n_samples), ref) \
        / torch.clamp_min(torch.cos(dec_c), 0.1)
    dec = dec_c + sigma_sky_rad * _normal(gen, (n_events, n_samples), ref)
    ra = torch.remainder(ra, 2.0 * math.pi)
    dec = torch.clamp(dec, -0.5 * math.pi + 1e-6, 0.5 * math.pi - 1e-6)

    theta = ThetaPEDet(m1det=m1_pe, m2det=m2_pe, dL=dl_pe, ra=ra, dec=dec,
                       theta=0.5 * math.pi - dec, phi=ra,
                       pe_prior=torch.ones_like(dl_pe))
    if not return_truths:
        return theta
    truths = {"z": src["z"][detected], "m1": src["m1"][detected],
              "m2": src["m2"][detected], "dgw": dgw, "ra": ra_c[:, 0],
              "dec": dec_c[:, 0]}
    return theta, truths


def make_mock_galaxies(gen, pop: Population, truths: dict,
                       n_background: int = 50_000, z_max: float = 1.5,
                       z_scatter: float = 0.001) -> dict:
    """A galaxy catalog of the events' hosts plus an isotropic background:
    hosts sit at the events' true (ra, dec) and z with a fractional z
    scatter, background galaxies follow p(z) ∝ dV_C/dz up to ``z_max``.
    Returns {'ra', 'dec', 'z'} (radians) on the population's device."""
    ref = pop.cosmo.H0
    zz = torch.linspace(1e-4, z_max, 2000, dtype=ref.dtype, device=ref.device)
    pdf = cosmo_fns.differential_comoving_volume(pop.cosmo, zz[None])[0]
    z_bkg = _inverse_cdf_sample(gen, pdf, zz, n_background)
    ra_bkg = 2.0 * math.pi * _uniform(gen, (n_background,), ref)
    dec_bkg = torch.arcsin(2.0 * _uniform(gen, (n_background,), ref) - 1.0)
    z_host = truths["z"] * (1.0 + z_scatter * _normal(gen, truths["z"].shape, ref))
    return {"ra": torch.cat([truths["ra"], ra_bkg]),
            "dec": torch.cat([truths["dec"], dec_bkg]),
            "z": torch.cat([z_host, z_bkg])}


def make_mock_injections(gen, pop: Population, n_generated: int = 200_000,
                         snr_threshold: float = 12.0,
                         m_range: tuple = (2.0, 200.0),
                         dgw_max: float | None = None
                         ) -> tuple[ThetaInjDet, int]:
    """Injections with analytic draw probabilities: log-uniform m1det and
    m2det on ``m_range`` (ordered by swap), dGW uniform in Euclidean volume
    to ``dgw_max`` (default 16 Gpc, ~2x the proxy's horizon), detected by the
    catalog's SNR proxy.  Returns (detected injections, N_generated)."""
    ref = pop.cosmo.H0
    if dgw_max is None:
        dgw_max = 16.0
    lo, hi = math.log(m_range[0]), math.log(m_range[1])
    ma = torch.exp(lo + (hi - lo) * _uniform(gen, (n_generated,), ref))
    mb = torch.exp(lo + (hi - lo) * _uniform(gen, (n_generated,), ref))
    m1d, m2d = torch.maximum(ma, mb), torch.minimum(ma, mb)
    dgw = dgw_max * _uniform(gen, (n_generated,), ref) ** (1.0 / 3.0)

    # ordered pair density 2 / (m1 m2 log^2(hi/lo)), times 3 d^2 / dmax^3
    log_span = hi - lo
    p_draw = 2.0 / (m1d * m2d * log_span**2) * (3.0 * dgw**2 / dgw_max**3)

    snr = _snr_proxy(m1d, m2d, dgw) + _normal(gen, (n_generated,), ref)
    keep = snr > snr_threshold
    theta_inj = ThetaInjDet(m1det=m1d[keep], m2det=m2d[keep], dL=dgw[keep],
                            p_draw=p_draw[keep])
    return theta_inj, n_generated
