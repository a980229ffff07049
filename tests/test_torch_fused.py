"""The fused weights+KDE function of the PyTorch port.

On the CPU: its plain PyTorch version against the JAX package's
``_reference_impl`` (the Pallas kernel's semantics, fused.py:372) on the
JAX-built λ tables, float64, rel <= 1e-10; a dead (all-zero-weight) event;
the wrapper's CPU dispatch.  The kernel itself is tested on the card by
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_tpu import HyperLikelihood as JHL
from chimera_tpu import SelectionFunction as JSel
from chimera_tpu.likelihood import batch_numerators as j_batch_numerators
from chimera_tpu.models import compute_z_grids as j_compute_z_grids
from chimera_tpu.ops.pallas.fused import _FusedCfg, _reference_impl
from chimera_tpu_torch import HyperLikelihood
from chimera_tpu_torch.convert import state_from_reference
from chimera_tpu_torch.models import FLRW, PowerLawPeak
from chimera_tpu_torch.ops.cuda.fused import (fused_weights_kde,
                                              fused_weights_kde_plain)

RTOL = 1e-10
F64 = torch.float64
H0S = [62.0, 70.0, 78.0]


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


@pytest.fixture(scope="module")
def setup(fiducial_population, mock_catalog):
    """16 events x 256 samples x 64-point grids, the JAX λ batch (L = 3) and
    the same tables loaded into the port's models."""
    zg = j_compute_z_grids(fiducial_population.cosmo, mock_catalog,
                           cosmo_prior={"H0": [40.0, 120.0]}, z_int_res=64)
    pop_b = jax.jit(jax.vmap(lambda h: fiducial_population.update(H0=h)))(
        jnp.asarray(H0S))
    state = state_from_reference(pop_b)
    cosmo = FLRW.from_state(state, "cosmo.", "cpu", F64)
    mass = PowerLawPeak.from_state(state, "mass.", "cpu", F64)
    return mock_catalog, zg, pop_b, cosmo, mass


def _pe(theta):
    return [_t(a) for a in
            (theta.m1det, theta.m2det, theta.dL, 1.0 / np.asarray(theta.pe_prior))]


@pytest.mark.parametrize("kernel", ["epan", "gauss"])
@pytest.mark.parametrize("bw_method", [None, "silverman"])
def test_plain_matches_reference_impl(setup, kernel, bw_method):
    theta, zg, pop_b, cosmo, mass = setup
    cfg = _FusedCfg(kernel=kernel, bw_method=bw_method, cut_grid=None,
                    n_grid=zg.shape[1], den_scale="norms", interpret=True,
                    logical_s=None)
    den_j, st_j = _reference_impl(
        cfg, theta.m1det, theta.m2det, theta.dL, 1.0 / theta.pe_prior,
        pop_b.cosmo, pop_b.mass, zg, None, None)
    den, st = fused_weights_kde_plain(*_pe(theta), cosmo, mass, _t(zg),
                                      kernel=kernel, bw_method=bw_method)
    assert den.shape == (3, 16, 64)
    den_j = np.asarray(den_j)
    np.testing.assert_allclose(
        den.numpy(), den_j, rtol=RTOL,
        atol=RTOL * np.max(np.abs(den_j), axis=-1, keepdims=True).max())
    for k in ("lo", "ub", "norms", "neff", "bandwidth", "sum_w", "sum_w2"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(st_j[k]),
                                   rtol=RTOL, atol=0, err_msg=k)


def test_dead_event_gives_the_same_numerator(fiducial_population, mock_catalog,
                                             mock_injections):
    """An all-zero-weight event (infinite PE prior) has a zero numerator in
    both packages, and the live events are untouched."""
    prior = np.ones(mock_catalog.dL.shape)
    prior[5] = np.inf
    theta = mock_catalog.update(pe_prior=jnp.asarray(prior))
    zg = j_compute_z_grids(fiducial_population.cosmo, theta,
                           cosmo_prior={"H0": [40.0, 120.0]}, z_int_res=64)
    inj, n_inj = mock_injections
    jhl = JHL.create(theta, zg, fiducial_population, JSel.create(inj, n_inj),
                     binning=False, cut_grid=None, kde_engine="xla")
    pop_b = jax.vmap(lambda h: fiducial_population.update(H0=h))(jnp.asarray(H0S))
    expect = np.asarray(jax.jit(j_batch_numerators)(jhl, pop_b))
    hl = HyperLikelihood.from_state(state_from_reference(jhl), "cpu", F64)
    got = hl.batch_numerators(hl.population.update_batch({"H0": H0S})).numpy()
    assert np.all(expect[:, 5] == 0.0) and np.all(got[:, 5] == 0.0)
    np.testing.assert_allclose(got, expect, rtol=RTOL, atol=0)


def test_cpu_tensors_take_the_plain_version(setup):
    theta, zg, _, cosmo, mass = setup
    before = fused_weights_kde.launches
    den, st = fused_weights_kde(*_pe(theta), cosmo, mass, _t(zg))
    den_p, st_p = fused_weights_kde_plain(*_pe(theta), cosmo, mass, _t(zg))
    assert fused_weights_kde.launches == before == 0
    assert torch.equal(den, den_p) and torch.equal(st["neff"], st_p["neff"])
