"""Every population model and engine of the port against the JAX package,
float64 on the CPU: the four mass models beside PowerLawPeak
(``TruncatedPowerLaw``, ``BrokenPowerLaw``, ``PowerLawTwoPeaks``,
``PowerLawSpline``), ``MGFLRW``, the three rates beside Madau–Dickinson,
the 'table' engines (``interp_method='table'``, ``cdf_engine='table'``),
``chebfit_from_table``, ``merger_rate``, ``n_cbc_1yr``,
``pdf_joint_and_marginals`` and ``angular_distance``.

The JAX side is its vmap/XLA engine.  The models carry the JAX objects'
tables (``convert.state_from_reference``) where a likelihood is compared,
and build their own where a model is.  Data: the port's spectral mock (8
events x 128 samples, drawn on the CPU) and 8 events of the repo's
dark-siren precision mock (``tests/data/f32_parity_dark.npz``), as the JAX
package's structures, with the population swapped; the series are of degree 16 so
that ``jax.grad``'s compile of the unrolled Clenshaw sums stays short."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from chimera_tpu import HyperLikelihood as JHL
from chimera_tpu import pytree
from chimera_tpu.likelihood import log_hyperlikelihood_batch
from chimera_tpu.models import cosmology as jcosmo
from chimera_tpu.models import mass as jmass
from chimera_tpu.models import population as jpop
from chimera_tpu.models import rate as jrate
from chimera_tpu.ops import chebyshev as jcheb
from chimera_tpu_torch import HyperLikelihood, convert
from chimera_tpu_torch.models import (Population, cosmology, mass, n_cbc_1yr,
                                      pdf_joint_and_marginals, rate)
from chimera_tpu_torch.ops.chebyshev import chebfit_from_table
from chimera_tpu_torch.ops.interp import interp

F64 = torch.float64
SPLINE = [0.3, -0.2, 0.5, 0.1, -0.4, 0.2]
# each mass model's non-default configuration and the hyper-parameters the
# gradient test differentiates (its own)
MASS = {
    "TruncatedPowerLaw": ({}, ("alpha", "beta", "m_low")),
    "BrokenPowerLaw": ({}, ("alpha_1", "alpha_2", "break_fraction", "delta_m")),
    "PowerLawPeak": ({}, ("mu_g", "sigma_g", "lambda_peak")),
    "PowerLawTwoPeaks": ({}, ("lambda1", "mu2_g", "sigma1_g", "sigma2_g")),
    "PowerLawSpline": (dict(spline_coeffs=SPLINE, num_knots=6),
                       ("alpha", "delta_m", "spline_coeffs")),
}
RATES = {"PowerLawRate": ("gamma",), "TruncatedPowerLawRate": ("gamma", "zmax"),
         "MadauDickinsonRate": ("gamma",),
         "TruncatedMadauDickinsonRate": ("gamma", "kappa", "zmax")}
SMALL = dict(window_deg=16, grid_res=300)
COSMO_SMALL = dict(cheb_deg=16, z_grid_res=500)


def _jax_mass(name, engine="analytic", **kw):
    cfg = dict(MASS[name][0], cdf_engine=engine, **kw)
    if name == "PowerLawSpline":
        cfg["spline_coeffs"] = jnp.asarray(cfg["spline_coeffs"])
    return getattr(jmass, name).create(**cfg)


def _jax_cosmo(name, engine="chebyshev"):
    kw = dict(Xi0=1.5, n=2.0) if name == "MGFLRW" else {}
    return getattr(jcosmo, name).create(H0=70.0, Om0=0.25, interp_method=engine,
                                        **COSMO_SMALL, **kw)


def _port(jax_obj, cls):
    return cls.from_state(convert.state_from_reference(jax_obj), device="cpu",
                          dtype=F64)


def _rel(got, expect):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    expect = np.asarray(expect)
    assert np.all(np.isfinite(expect))
    return float(np.max(np.abs(got - expect)) / np.max(np.abs(expect)))


@pytest.fixture(scope="module")
def mass_points():
    rng = np.random.default_rng(3)
    m1 = np.concatenate([rng.uniform(3.0, 100.0, 3000), [5.1, 9.9, 87.0, 60.0]])
    return m1, m1 * np.concatenate([rng.uniform(0.05, 1.0, 3000), [1.0] * 4])


# ---------------------------------------------------------------------------
# the models on their own
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["analytic", "table"])
@pytest.mark.parametrize("name", list(MASS))
def test_mass_models_match_jax(mass_points, name, engine):
    """p_m1m2 of the port's own build and of ``from_state`` (the JAX
    tables carried) within 1e-12 of the JAX package's; the CDF and the
    marginals of ``pdf_joint_and_marginals`` on a small grid."""
    m1, m2 = mass_points
    jm = _jax_mass(name, engine, **SMALL)
    expect = np.asarray(jmass.p_m1m2(jm, jnp.asarray(m1), jnp.asarray(m2)))
    cls = getattr(mass, name)
    own = cls.create(**MASS[name][0], cdf_engine=engine, **SMALL, device="cpu",
                     dtype=F64)
    for model in (own, _port(jm, cls)):
        got = mass.p_m1m2(model, torch.tensor(m1)[None], torch.tensor(m2)[None])[0]
        assert _rel(got, expect) <= 1e-12
        cdf = model.conditional_cdf_at(torch.tensor(m1)[None])[0]
        assert _rel(cdf, jm.conditional_cdf_at(jnp.asarray(m1))) <= 1e-12
    if name == "PowerLawSpline":
        assert own.spline_coeffs.shape == (1, 6)
    if name == "TruncatedPowerLaw" or engine == "table":
        assert own.cheb_cdf_window is None
    marg = jmass.pdf_joint_and_marginals(jm, res=(300, 200))
    got = pdf_joint_and_marginals(own, res=(300, 200))
    for key in ("p_joint", "p_m1_marg", "p_m2_marg", "m1mesh"):
        assert _rel(got[key][0], marg[key]) <= 1e-11, key


@pytest.mark.parametrize("engine", ["chebyshev", "table"])
@pytest.mark.parametrize("name", ["FLRW", "MGFLRW"])
def test_cosmologies_match_jax(name, engine):
    """z_from_dgw (beyond both ends too), dl_at_z, ddl_dz_at_z, the
    de-modified volume element and angular_distance within 1e-12 of the
    JAX package's, with the port's own tables and the carried ones."""
    jc = _jax_cosmo(name, engine)
    kw = dict(Xi0=1.5, n=2.0) if name == "MGFLRW" else {}
    cls = getattr(cosmology, name)
    own = cls.create(H0=70.0, Om0=0.25, interp_method=engine, **COSMO_SMALL,
                     **kw, device="cpu", dtype=F64)
    d = np.concatenate([[1e-9], np.linspace(0.01, 60.0, 400), [1e4]])
    z = np.linspace(0.001, 5.0, 300)
    dist = np.linspace(0.5, 20.0, 300)
    for model in (own, _port(jc, cls)):
        t = lambda a: torch.tensor(a)[None]  # noqa: E731
        assert _rel(cosmology.z_from_dgw(model, t(d))[0],
                    jcosmo.z_from_dgw(jc, jnp.asarray(d))) <= 1e-12
        assert _rel(cosmology.dl_at_z(model, t(z))[0],
                    jcosmo.dl_at_z(jc, jnp.asarray(z))) <= 1e-12
        assert _rel(cosmology.ddl_dz_at_z(model, t(z), t(dist))[0],
                    jcosmo.ddl_dz_at_z(jc, jnp.asarray(z), jnp.asarray(dist))) <= 1e-12
        assert _rel(cosmology.differential_comoving_volume(model, t(z), t(dist))[0],
                    jcosmo.differential_comoving_volume(
                        jc, jnp.asarray(z), jnp.asarray(dist))) <= 1e-12
        assert _rel(cosmology.angular_distance(model, t(z))[0],
                    jcosmo.angular_distance(jc, jnp.asarray(z))) <= 1e-12
        assert _rel(cosmology.int_inv_e_at_z(model, t(z))[0],
                    jcosmo.int_inv_e_at_z(jc, jnp.asarray(z))) <= 1e-12


@pytest.mark.parametrize("name", list(RATES))
def test_rates_and_n_cbc_match_jax(name):
    """Each rate (``merger_rate``) on z beyond zmax, and ``n_cbc_1yr`` of a
    population with it, within 1e-12."""
    jr = getattr(jrate, name).create()
    tr = getattr(rate, name).create(device="cpu", dtype=F64)
    z = np.linspace(0.0, 3.0, 301)
    assert _rel(rate.merger_rate(tr, torch.tensor(z)[None])[0],
                jrate.merger_rate(jr, jnp.asarray(z))) <= 1e-12
    jc = _jax_cosmo("FLRW")
    jp = jpop.Population.create(jc, _jax_mass("PowerLawPeak", **SMALL), jr,
                                R0=20.0)
    tp = Population.from_state(convert.state_from_reference(jp), device="cpu",
                               dtype=F64)
    assert type(tp.rate) is type(tr)
    assert _rel(n_cbc_1yr(tp)[0], jpop.n_cbc_1yr(jp)) <= 1e-12


def test_chebfit_from_table_matches_jax():
    """A per-λ table and a shared one, float and tensor bounds."""
    x = np.linspace(0.0, 3.0, 500)
    y = np.exp(-x) * np.sin(3 * x)
    expect = jcheb.chebfit_from_table(jnp.asarray(x), jnp.asarray(y), 0.2, 2.5, 24)
    got = chebfit_from_table(torch.tensor(x), torch.tensor(y), 0.2, 2.5, 24)
    assert _rel(got, expect) <= 1e-13
    rows = chebfit_from_table(torch.tensor(x)[None].expand(2, -1),
                              torch.tensor(np.stack([y, 2 * y])),
                              torch.tensor([0.2, 0.2], dtype=F64),
                              torch.tensor([2.5, 2.5], dtype=F64), 24)
    assert _rel(rows[1], 2 * np.asarray(expect)) <= 1e-13


def test_update_batch_refuses_foreign_parameters():
    """A hyper-parameter that no model of the population owns raises: Xi0
    on FLRW, a spline coefficient on PowerLawPeak; MGFLRW and the spline
    take theirs, the coefficients as (L, num_knots) rows."""
    pop = Population.create(cosmology.FLRW.create(device="cpu", dtype=F64),
                            mass.PowerLawPeak.create(device="cpu", dtype=F64),
                            rate.PowerLawRate.create(device="cpu", dtype=F64))
    for key in ("Xi0", "spline_coeffs", "zmax"):
        with pytest.raises(ValueError, match="owns"):
            pop.update_batch({key: [1.0, 2.0]})
    pop = Population.create(
        cosmology.MGFLRW.create(device="cpu", dtype=F64),
        mass.PowerLawSpline.create(num_knots=3, device="cpu", dtype=F64),
        rate.TruncatedPowerLawRate.create(device="cpu", dtype=F64))
    upd = pop.update_batch({"Xi0": [1.0, 2.0], "zmax": [1.0, 1.5],
                            "spline_coeffs": [[0.1, 0.2, 0.3], [0.0, 0.0, 0.1]]})
    assert upd.mass.spline_coeffs.shape == (2, 3) and upd.L == 2
    assert upd.cosmo.Xi0.tolist() == [1.0, 2.0]


def test_table_interp_gradient_repeats_and_matches_jax():
    """``interp``'s backward on a table whose intervals hold many
    differentiated points (the 'table' engine's z_from_dgw of 4 096
    distances on a 500-point table): equal bits in two runs, and d sum
    z / d H0 within 1e-9 of ``jax.grad``."""
    d = np.sort(np.random.default_rng(1).uniform(0.1, 8.0, 4096))

    def jax_sum(h0):
        c = jcosmo.FLRW.create(H0=h0, Om0=0.25, interp_method="table",
                               z_grid_res=500)
        return jnp.sum(jcosmo.z_from_dgw(c, jnp.asarray(d)) ** 2)

    expect = float(jax.grad(jax_sum)(70.0))
    grads = []
    for _ in range(2):
        h0 = torch.tensor([70.0], dtype=F64, requires_grad=True)
        c = cosmology.FLRW.create(H0=h0, Om0=0.25, interp_method="table",
                                  z_grid_res=500, device="cpu", dtype=F64)
        out = torch.sum(cosmology.z_from_dgw(c, torch.tensor(d)[None]) ** 2)
        grads.append(torch.autograd.grad(out, h0)[0])
    assert torch.equal(grads[0], grads[1])
    assert abs(float(grads[0]) - expect) <= 1e-9 * abs(expect)
    # many points an interval: 4 096 distances, 500 nodes
    xp = torch.linspace(0.0, 1.0, 50, dtype=F64)
    fp = torch.sin(xp).requires_grad_()
    g = torch.autograd.grad(interp(torch.rand(4096, dtype=F64), xp, fp).sum(), fp)[0]
    assert torch.all(g[1:-1] > 0)


# ---------------------------------------------------------------------------
# the likelihood
# ---------------------------------------------------------------------------

def _jnp(t):
    return jnp.asarray(t.numpy())


def _jax_base(theta, z_grids, gal_cat, inj, n_gen) -> SimpleNamespace:
    """The JAX structures of a port mock's arrays: the PE samples, the
    grids, a population (FLRW, PowerLawPeak, Madau-Dickinson) with the
    catalog and the selection."""
    from chimera_tpu import SelectionFunction
    from chimera_tpu.data.structs import ThetaInjDet

    return SimpleNamespace(
        theta_gw=theta, z_grids=_jnp(z_grids),
        population=jpop.Population.create(
            _jax_cosmo("FLRW"), _jax_mass("PowerLawPeak", **SMALL),
            jrate.MadauDickinsonRate.create(), gal_cat=gal_cat),
        selection=SelectionFunction.create(
            ThetaInjDet(**{f: _jnp(getattr(inj, f)) for f in
                           ("m1det", "m2det", "dL", "p_draw")}), float(n_gen)))


@pytest.fixture(scope="module")
def spectral():
    """The port's spectral mock (8 events x 128 samples, 20 000 generated
    injections, 64-point grids) drawn on the CPU."""
    from chimera_tpu.catalog import EmptyCatalog
    from chimera_tpu.data.structs import ThetaPEDet

    cat, inj, n_gen, z_grids = chip_smoke.mock(8, 128, 20_000, 64, 300, 42,
                                               device=torch.device("cpu"))
    theta = ThetaPEDet(**{f: _jnp(getattr(cat, f)) for f in
                          ("m1det", "m2det", "dL", "pe_prior")})
    return _jax_base(theta, z_grids, EmptyCatalog(), inj, n_gen)


@pytest.fixture(scope="module")
def dark():
    """The first 8 events of the repo's dark-siren precision mock
    (``tests/data/f32_parity_dark.npz``: 512 samples, nside {8, 16})."""
    from chimera_tpu.catalog import DVdzCompleteness
    from chimera_tpu.catalog.pixelated import PixelatedCatalog
    from chimera_tpu.data.structs import ThetaPEDet

    cat, z_grids, gal_cat, inj, n_gen = chip_smoke.parity_dark_mock(
        torch.device("cpu"))

    def ev(t):
        return _jnp(t[:8])

    theta = ThetaPEDet(**{f: ev(getattr(cat, f)) for f in (
        "m1det", "m2det", "dL", "pe_prior", "ra", "dec", "opt_nsides",
        "pixels_opt_nsides", "ra_pix", "dec_pix", "gw_loc2d_pdf",
        "pixels_pe_opt_nside", "pixel_mask")})
    jgc = PixelatedCatalog(
        p_cat=ev(gal_cat.p_cat), P_compl=ev(gal_cat.P_compl),
        pixel_mask=ev(gal_cat.pixel_mask), n_gal=ev(gal_cat.n_gal),
        completeness=DVdzCompleteness.create(z_range=(0.0, 3.0), kind="step"))
    return _jax_base(theta, z_grids[:8], jgc, inj, n_gen)


def _population(base, cosmo="FLRW", cosmo_engine="chebyshev", mass_name="PowerLawPeak",
                mass_engine="analytic", rate_name="MadauDickinsonRate"):
    return pytree.replace(
        base.population, cosmo=_jax_cosmo(cosmo, cosmo_engine),
        mass=_jax_mass(mass_name, mass_engine, **SMALL),
        rate=getattr(jrate, rate_name).create())


# (data, kind, binning, cut_grid, population); the unbinned chebyshev +
# analytic cases take the port's fused plain versions, the 'table' ones
# and the binned ones the stage-by-stage path, 'full' the lattice KDE
CASES = {
    "tpl_1d": ("spectral", "1d", False, None,
               dict(mass_name="TruncatedPowerLaw", rate_name="PowerLawRate")),
    "bpl_mg_1d_cut": ("spectral", "1d", False, 2.0,
                      dict(cosmo="MGFLRW", mass_name="BrokenPowerLaw",
                           rate_name="TruncatedPowerLawRate")),
    "spline_1d": ("spectral", "1d", False, None, dict(mass_name="PowerLawSpline")),
    "twopeaks_marg": ("dark", "marginalized", False, None,
                      dict(mass_name="PowerLawTwoPeaks",
                           rate_name="TruncatedMadauDickinsonRate")),
    "table_1d": ("spectral", "1d", False, 2.0,
                 dict(cosmo_engine="table", mass_engine="table")),
    "table_1d_nocut": ("spectral", "1d", False, None, dict(cosmo_engine="table")),
    "table_marg": ("dark", "marginalized", False, 2.0,
                   dict(cosmo="MGFLRW", mass_engine="table")),
    "binned_bpl": ("spectral", "1d", True, 2.0, dict(mass_name="BrokenPowerLaw")),
    "binned_marg_tpl": ("dark", "marginalized", True, 2.0,
                        dict(mass_name="TruncatedPowerLaw")),
    "full_twopeaks": ("dark", "full", False, 2.0,
                      dict(mass_name="PowerLawTwoPeaks", cosmo="MGFLRW")),
}
BATCH = {"H0": np.array([62.0, 70.0, 79.0]), "Om0": np.array([0.22, 0.25, 0.31])}


def _jax_case(case, spectral, dark):
    data, kind, binning, cut, pop = CASES[case]
    base = spectral if data == "spectral" else dark
    return JHL.create(base.theta_gw, base.z_grids, _population(base, **pop),
                      base.selection, kind=None if data == "spectral" else kind,
                      binning=binning, cut_grid=cut, kde_engine="xla")


@pytest.mark.parametrize("case", list(CASES))
def test_log_like_batch_matches_jax(spectral, dark, case):
    """log L of a λ batch in (H0, Om0) within 1e-10 relative of the JAX
    package's vmap engine; each case's path as the port routes it."""
    jhl = _jax_case(case, spectral, dark)
    expect = np.asarray(jhl.log_like_batch({k: jnp.asarray(v) for k, v in BATCH.items()}))
    hl = HyperLikelihood.from_state(convert.state_from_reference(jhl), "cpu", F64)
    staged = CASES[case][2] or "table" in case
    assert hl.staged == staged
    assert _rel(hl.log_like_batch(BATCH), expect) <= 1e-10


GRAD_CASES = [(f"mass_{m}", m) for m in MASS] + [("mg", "MGFLRW"),
                                                 ("table", "table")]


@pytest.mark.parametrize("case,what", GRAD_CASES)
def test_gradient_matches_jax_grad(spectral, case, what):
    """d log L / dλ of the spectral mock (unbinned, cut_grid=2.0) in each
    mass model's own hyper-parameters, in (H0, Xi0, n) of MGFLRW, and in
    (H0, Om0) under both 'table' engines, two λ: within 1e-9 relative of
    each parameter's largest ``jax.grad``."""
    if what in MASS:
        pop, keys = dict(mass_name=what), MASS[what][1]
    elif what == "MGFLRW":
        pop, keys = dict(cosmo="MGFLRW"), ("H0", "Xi0", "n")
    else:
        pop, keys = dict(cosmo_engine="table", mass_engine="table"), ("H0", "Om0")
    jhl = JHL.create(spectral.theta_gw, spectral.z_grids,
                     _population(spectral, **pop), spectral.selection,
                     binning=False, cut_grid=2.0, kde_engine="xla")
    base = {"H0": 70.0, "Om0": 0.25, "Xi0": 1.1, "n": 1.5}
    vals = {k: np.array([0.97, 1.04]).reshape((2,) + (1,) * (k == "spline_coeffs"))
            * np.asarray(base[k] if k in base else getattr(jhl.population.mass, k))
            for k in keys}
    expect = jax.jit(jax.grad(lambda m, v: jnp.sum(log_hyperlikelihood_batch(m, v)),
                              argnums=1))(jhl, {k: jnp.asarray(v) for k, v in vals.items()})
    hl = HyperLikelihood.from_state(convert.state_from_reference(jhl), "cpu", F64)
    x = {k: torch.tensor(v, requires_grad=True) for k, v in vals.items()}
    got = torch.autograd.grad(hl.log_like_batch(x).sum(), list(x.values()))
    for k, g in zip(x, got):
        e = np.asarray(expect[k])
        assert np.all(np.isfinite(e)) and np.abs(e).max() > 0, k
        np.testing.assert_allclose(g.numpy(), e, rtol=0, atol=1e-9 * np.abs(e).max(),
                                   err_msg=k)
