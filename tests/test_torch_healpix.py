"""The port's RING HEALPix, 2-D Gaussian KDE and the completeness and
comoving-volume functions of the dark-siren slice, against the JAX package
on the same seeded inputs (float64, CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_tpu.catalog import DVdzCompleteness as JCompl
from chimera_tpu.models import FLRW as JFLRW
from chimera_tpu.models import cosmology as jcosmo
from chimera_tpu.ops import healpix as jhpx
from chimera_tpu.ops.kde import gaussian_kde_nd as j_kde_nd
from chimera_tpu_torch.catalog import DVdzCompleteness
from chimera_tpu_torch.convert import state_from_reference
from chimera_tpu_torch.models import FLRW
from chimera_tpu_torch.models import cosmology as tcosmo
from chimera_tpu_torch.ops import healpix as thpx
from chimera_tpu_torch.ops.kde import gaussian_kde_nd

F64 = torch.float64


@pytest.fixture(scope="module")
def sky():
    rng = np.random.default_rng(2026)
    return np.arccos(rng.uniform(-1.0, 1.0, 10_000)), rng.uniform(0.0, 2 * np.pi, 10_000)


@pytest.mark.parametrize("nside", [8, 16, 64])
def test_ang2pix_and_pix2ang_ring(sky, nside):
    theta, phi = sky
    expect = np.asarray(jhpx.ang2pix_ring(nside, jnp.asarray(theta), jnp.asarray(phi)))
    got = thpx.ang2pix_ring(nside, torch.as_tensor(theta), torch.as_tensor(phi))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), expect)
    pix = np.arange(12 * nside * nside)
    th_j, ph_j = jhpx.pix2ang_ring(nside, jnp.asarray(pix))
    th_t, ph_t = thpx.pix2ang_ring(nside, torch.as_tensor(pix))
    assert th_t.dtype == ph_t.dtype == F64
    np.testing.assert_allclose(th_t.numpy(), np.asarray(th_j), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ph_t.numpy(), np.asarray(ph_j), rtol=0, atol=1e-12)


def test_ra_dec_layer_and_separation(sky):
    theta, phi = sky
    ra, dec = phi, 0.5 * np.pi - theta
    expect = np.asarray(jhpx.find_pix_ra_dec(jnp.asarray(ra), jnp.asarray(dec), 16))
    # float32 inputs are indexed in float64 all the same
    got = thpx.find_pix_ra_dec(torch.as_tensor(ra, dtype=torch.float32).double(),
                               torch.as_tensor(dec), 16)
    np.testing.assert_array_equal(got.numpy(), expect)
    r_j, d_j = jhpx.find_ra_dec(jnp.asarray(expect), 16)
    r_t, d_t = thpx.find_ra_dec(got, 16)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=1e-12)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-12)
    sep_j = jhpx.angular_separation(jnp.asarray(ra), jnp.asarray(dec), r_j, d_j)
    sep_t = thpx.angular_separation(torch.as_tensor(ra), torch.as_tensor(dec), r_t, d_t)
    np.testing.assert_allclose(sep_t.numpy(), np.asarray(sep_j), atol=1e-12)


@pytest.mark.parametrize("weighted", [False, True])
def test_gaussian_kde_nd_batched(weighted):
    """Batched over 3 events; one event with all-zero weights takes the
    uniform fallback."""
    rng = np.random.default_rng(5)
    data = rng.normal(size=(3, 2, 300)) * np.array([0.05, 0.02])[None, :, None]
    pts = rng.normal(size=(3, 2, 12)) * 0.05
    w = rng.uniform(size=(3, 300)) if weighted else None
    if weighted:
        w[1] = 0.0
    got = gaussian_kde_nd(torch.as_tensor(data), torch.as_tensor(pts),
                          None if w is None else torch.as_tensor(w))
    for e in range(3):
        expect = j_kde_nd(jnp.asarray(data[e]), jnp.asarray(pts[e]),
                          None if w is None else jnp.asarray(w[e]))
        np.testing.assert_allclose(got[e].numpy(), np.asarray(expect), rtol=1e-10)


@pytest.fixture(scope="module")
def cosmo_pair():
    """A flat, an open and a closed cosmology, JAX vmapped and the port's."""
    batch = {"H0": [62.0, 70.0, 78.0], "Om0": [0.3, 0.25, 0.32],
             "Ok0": [0.0, 0.05, -0.04]}
    jb = jax.jit(jax.vmap(lambda lam: JFLRW.create(**lam)))(
        {k: jnp.asarray(v) for k, v in batch.items()})
    return jb, FLRW.from_state(state_from_reference(jb), "", "cpu", F64)


def test_comoving_volume_curvature_branches(cosmo_pair):
    jb, tb = cosmo_pair
    z = np.linspace(0.01, 2.5, 40)
    expect = jax.vmap(lambda c: jcosmo.comoving_volume(c, jnp.asarray(z)))(jb)
    got = tcosmo.comoving_volume(tb, torch.as_tensor(z)[None])
    # the curved branches cancel at low z: 1e-12 of each cosmology's largest
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=0,
                               atol=1e-12 * np.max(np.asarray(expect)))


@pytest.mark.parametrize("kind,z_sig", [("step", None), ("step_smooth", 0.05)])
def test_dvdz_completeness(cosmo_pair, kind, z_sig):
    jb, tb = cosmo_pair
    jc = JCompl.create(z_range=(0.1, 1.2), kind=kind, z_sig=z_sig)
    tc = DVdzCompleteness.create(z_range=(0.1, 1.2), kind=kind, z_sig=z_sig,
                                 device="cpu", dtype=F64)
    zg = np.linspace(0.0, 1.5, 60).reshape(3, 20)
    np.testing.assert_allclose(tc.P_compl(torch.as_tensor(zg)).numpy(),
                               np.asarray(jc.P_compl(jnp.asarray(zg))),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(tc.fR(tb).numpy(),
                               np.asarray(jax.vmap(jc.fR)(jb)), rtol=1e-12)
    expect = jax.vmap(lambda c: jc.p_bkg(c, jnp.asarray(zg)))(jb)
    np.testing.assert_allclose(tc.p_bkg(tb, torch.as_tensor(zg)[None]).numpy(),
                               np.asarray(expect), rtol=1e-12)


def test_models_build_on_the_card_by_default(monkeypatch):
    """With no device argument the models build on CUDA, and with no card
    they raise instead of returning CPU tensors."""
    from chimera_tpu_torch.models import MadauDickinsonRate, Population, PowerLawPeak

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: FLRW.create(H0=70.0), PowerLawPeak.create,
                  MadauDickinsonRate.create,
                  lambda: DVdzCompleteness.create(z_range=(0.0, 3.0))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    state = state_from_reference(JFLRW.create(H0=70.0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FLRW.from_state(state, "")
    # asking for the CPU still works
    pop = Population.create(FLRW.create(H0=70.0, device="cpu"),
                            PowerLawPeak.create(device="cpu"),
                            MadauDickinsonRate.create(device="cpu"))
    assert pop.cosmo.H0.device.type == "cpu" and pop.cosmo.H0.dtype == F64
