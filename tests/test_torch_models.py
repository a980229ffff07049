"""Population models of the PyTorch port against the JAX package (float64,
CPU): the per-λ tables ``update_batch`` rebuilds, the per-sample functions
of the likelihood and the selection integrand, the z-grids, and the mock
generators (compared as distributions: the random streams differ)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from chimera_tpu.data.mock import make_mock_catalog as j_mock_catalog
from chimera_tpu.data.mock import make_mock_injections as j_mock_injections
from chimera_tpu.models import FLRW as JFLRW
from chimera_tpu.models import compute_z_grids as j_compute_z_grids
from chimera_tpu.models import cosmology as jcosmo
from chimera_tpu.models import p_cbc as j_p_cbc
from chimera_tpu.models import p_m1m2 as j_p_m1m2
from chimera_tpu.models import pop_rate_det as j_pop_rate_det
from chimera_tpu_torch.convert import state_from_reference
from chimera_tpu_torch.data import mock
from chimera_tpu_torch.data.structs import ThetaInjDet, ThetaPEDet
from chimera_tpu_torch.models import (FLRW, MadauDickinsonRate, Population,
                                      PowerLawPeak, compute_z_grids, p_cbc,
                                      p_m1m2, pop_rate_det)
from chimera_tpu_torch.models import cosmology as tcosmo

RTOL = 1e-10
F64 = torch.float64
BATCH = {"H0": [62.0, 70.0, 78.0], "Om0": [0.2, 0.25, 0.32],
         "alpha": [3.0, 3.4, 3.9], "mu_g": [32.0, 34.0, 36.0],
         "delta_m": [3.5, 4.8, 6.0]}


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def _close(got, expect, rtol=RTOL):
    expect = np.asarray(expect)
    np.testing.assert_allclose(got.numpy(), expect, rtol=rtol,
                               atol=rtol * np.max(np.abs(expect)))


def _port_population():
    return Population.create(FLRW.create(H0=70.0, Om0=0.25, device="cpu"),
                             PowerLawPeak.create(device="cpu"),
                             MadauDickinsonRate.create(device="cpu"))


@pytest.fixture(scope="module")
def batches(fiducial_population):
    """(JAX vmapped population, port update_batch population), L = 3."""
    jb = jax.jit(jax.vmap(lambda lam: fiducial_population.update(**lam)))(
        {k: jnp.asarray(v) for k, v in BATCH.items()})
    return jb, _port_population().update_batch(BATCH)


@pytest.mark.parametrize("part,name", [
    ("cosmo", "cheb_g"), ("cosmo", "cheb_logh"), ("cosmo", "dgw_lo"),
    ("cosmo", "dgw_max"), ("mass", "norm_p_m1"), ("mass", "cheb_cdf_window"),
    ("mass", "cdf_at_join"), ("mass", "peak_norm"), ("mass", "m_join"),
    ("mass", "cdf_m2_conditioned")])
def test_update_batch_tables(batches, fiducial_population, part, name):
    jb, tb = batches
    _close(getattr(getattr(tb, part), name),
           state_from_reference(jb)[f"{part}.{name}"])
    # and the single model built from scratch
    single = getattr(_port_population(), part)
    _close(getattr(single, name)[0],
           state_from_reference(fiducial_population)[f"{part}.{name}"])


def test_from_state_roundtrip(fiducial_population):
    state = state_from_reference(fiducial_population)
    pop = Population.from_state(state, device="cpu", dtype=F64)
    assert pop.L == 1 and pop.cosmo.cheb_logh.shape == (1, 64)
    _close(pop.mass.cheb_cdf_window[0], state["mass.cheb_cdf_window"], rtol=0)


def test_float32_conditional_cdf_just_above_m_low():
    """The window series is summed in float64: the float32 CDF keeps its
    float64 value to float32 accuracy where it is tiny against the series'
    terms (a float32 sum is off by 6 % at m_low + 0.41)."""
    m1 = torch.tensor([[5.51353, 6.0, 8.0, 30.0]], dtype=F64)
    expect = PowerLawPeak.create(device="cpu", dtype=F64).conditional_cdf_at(m1)
    got = PowerLawPeak.create(device="cpu", dtype=torch.float32
                              ).conditional_cdf_at(m1.float())
    assert got.dtype == torch.float32
    assert ((got.double() - expect).abs() / expect).max().item() <= 1e-5


def test_z_from_dgw_with_clamping(batches):
    jb, tb = batches
    dl = np.random.default_rng(3).uniform(0.05, 30.0, (5, 40))
    dl[0, :3] = [1e-8, 150.0, 1e3]          # below dgw_lo, above dgw_max
    _close(tcosmo.z_from_dgw(tb.cosmo, _t(dl)[None]),
           jax.vmap(lambda c: jcosmo.z_from_dgw(c, dl))(jb.cosmo))


def test_ddl_dz_and_dvdz(batches):
    jb, tb = batches
    z = np.random.default_rng(4).uniform(1e-3, 3.0, (4, 30))
    _close(tcosmo.ddl_dz_at_z(tb.cosmo, _t(z)[None]),
           jax.vmap(lambda c: jcosmo.ddl_dz_at_z(c, z))(jb.cosmo))
    _close(tcosmo.differential_comoving_volume(tb.cosmo, _t(z)[None]),
           jax.vmap(lambda c: jcosmo.differential_comoving_volume(c, z))(jb.cosmo))


def test_p_m1m2(batches):
    jb, tb = batches
    rng = np.random.default_rng(5)
    m1 = rng.uniform(3.0, 110.0, (6, 50))
    m2 = m1 * rng.uniform(0.05, 1.0, (6, 50))
    m1[0, :4] = [5.1, 5.1 * (1 + 1e-12), 6.0, 9.0]   # at and near m_low
    m2[0, :4] = [5.1, 5.1, 5.5, 9.0]
    _close(p_m1m2(tb.mass, _t(m1)[None], _t(m2)[None]),
           jax.vmap(lambda m: j_p_m1m2(m, m1, m2))(jb.mass))


def test_p_cbc(batches):
    jb, tb = batches
    zg = np.linspace(np.full(3, 0.01), np.array([0.5, 1.0, 2.0]), 64, axis=1)
    _close(p_cbc(tb, _t(zg)[None]), jax.vmap(lambda p: j_p_cbc(p, zg))(jb))


def test_pop_rate_det_on_injections(batches, mock_injections):
    jb, tb = batches
    inj, _ = mock_injections
    port_inj = ThetaInjDet(**{k: _t(getattr(inj, k))
                              for k in ("m1det", "m2det", "dL", "p_draw")})
    _close(pop_rate_det(tb, port_inj),
           jax.vmap(lambda p: j_pop_rate_det(p, inj))(jb))


_j_z_grids = jax.jit(lambda c, th, prior: j_compute_z_grids(
    c, th, cosmo_prior=prior, z_int_res=50))


@pytest.mark.parametrize("h0,om0", [(62.0, 0.2), (70.0, 0.25), (78.0, 0.32)])
def test_compute_z_grids(mock_catalog, h0, om0):
    cosmo = JFLRW.create(H0=h0, Om0=om0)
    expect = _j_z_grids(cosmo, mock_catalog, {"H0": [40.0, 120.0]})
    theta = ThetaPEDet(dL=_t(mock_catalog.dL))
    got = compute_z_grids(FLRW.create(H0=h0, Om0=om0, device="cpu"), theta,
                          cosmo_prior={"H0": [40.0, 120.0]}, z_int_res=50)
    _close(got, expect)


# ---------------------------------------------------------------------------
# mock data: shapes, selection and distributions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_mock():
    gen = torch.Generator().manual_seed(11)
    pop = _port_population()
    cat, truths = mock.make_mock_catalog(gen, pop, n_events=200, n_samples=32,
                                         return_truths=True)
    inj, n_gen = mock.make_mock_injections(gen, pop, n_generated=50_000)
    return cat, truths, inj, n_gen


def test_mock_catalog_shapes_and_selection(port_mock):
    cat, truths, _, _ = port_mock
    assert cat.dL.shape == cat.m1det.shape == cat.ra.shape == (200, 32)
    assert torch.all(cat.m1det >= cat.m2det)
    assert torch.all(cat.pe_prior == 1.0)
    assert torch.all(cat.dL > 0)
    snr_true = mock._snr_proxy(truths["m1"] * (1 + truths["z"]),
                               truths["m2"] * (1 + truths["z"]), truths["dgw"])
    # detected on snr_true + N(0, 1) > 12: none sits 5 sigma below the cut
    assert torch.all(snr_true > 7.0)
    assert torch.median(snr_true) > 12.0


def test_mock_catalog_matches_jax_distribution(port_mock, fiducial_population):
    _, truths, _, _ = port_mock
    _, jtruths = j_mock_catalog(jax.random.PRNGKey(11), fiducial_population,
                                n_events=200, n_samples=32, return_truths=True)
    for key in ("z", "m1", "m2"):
        p = stats.ks_2samp(truths[key].numpy(), np.asarray(jtruths[key])).pvalue
        assert p > 1e-3, (key, p)


def test_mock_injections_match_jax_distribution(port_mock, fiducial_population):
    _, _, inj, n_gen = port_mock
    jinj, jn = j_mock_injections(jax.random.PRNGKey(12), fiducial_population,
                                 n_generated=50_000)
    assert n_gen == jn == 50_000
    frac, jfrac = inj.dL.shape[0] / n_gen, jinj.dL.shape[0] / jn
    assert abs(frac - jfrac) < 5.0 * np.sqrt(jfrac / jn)
    assert torch.all(inj.m1det >= inj.m2det) and torch.all(inj.p_draw > 0)
    for key in ("dL", "m1det"):
        p = stats.ks_2samp(getattr(inj, key).numpy(),
                           np.asarray(getattr(jinj, key))).pvalue
        assert p > 1e-3, (key, p)
