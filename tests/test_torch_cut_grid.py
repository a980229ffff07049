"""The effective-grid modes of the fused pass and the unbinned
configurations they carry, against the JAX package on identical inputs:
the plain versions of K1b (each event's own effective grid, 'norms') and
K1d (given bounds on the logical per-pixel rows, 'unit') and of the event
stats pass against ``_reference_impl``, then ``log_like_batch`` for every
unbinned (kind, cut_grid) combination the port did not run before.

Data: conftest's session fixtures (the spectral ``mock_catalog``, 16 events
x 256 samples on ``mock_z_grids`` of 200 points; the dark
``dark_siren_setup``, 8 events x 256 samples, ~6 pixels per event,
100-point grids).  The JAX side runs its plain XLA engine
(``kde_engine='xla'``) and its kernel's reference implementation, in
float64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_tpu import HyperLikelihood as JHL
from chimera_tpu import SelectionFunction as JSel
from chimera_tpu import pytree
from chimera_tpu.catalog import EmptyCatalog
from chimera_tpu.data import pixelize as jpix
from chimera_tpu.likelihood import _sort_samples_by_distance
from chimera_tpu.ops.pallas.fused import _FusedCfg, _reference_impl
from chimera_tpu_torch import HyperLikelihood
from chimera_tpu_torch.convert import state_from_reference
from chimera_tpu_torch.models import FLRW, PowerLawPeak
from chimera_tpu_torch.ops.cuda.fused import (STAT_NAMES, fused_row_stats,
                                              fused_weights_kde)

F64 = torch.float64
H0S = np.linspace(55.0, 95.0, 9)
LAMBDA = jnp.asarray([60.0, 67.0, 74.0, 81.0])


def _t(a, dtype=F64):
    t = torch.as_tensor(np.array(a))
    return t if dtype is None else t.to(dtype)


def _rel(got, expect):
    got = got.detach().double().numpy()
    expect = np.asarray(expect)
    return np.max(np.abs(got - expect) / np.abs(expect))


def _batch(pop):
    """The JAX λ batch (L = 4) and the same tables in the port's models."""
    pop_b = jax.jit(jax.vmap(lambda h: pop.update(H0=h)))(LAMBDA)
    st = state_from_reference(pop_b)
    return (pop_b, FLRW.from_state(st, "cosmo.", "cpu", F64),
            PowerLawPeak.from_state(st, "mass.", "cpu", F64))


def _close(got, expect, rows=None, rtol=1e-10):
    got, expect = got.numpy(), np.asarray(expect)
    if rows is not None:
        got, expect = got[:, rows], expect[:, rows]
    np.testing.assert_allclose(got, expect, rtol=rtol,
                               atol=1e-12 * np.abs(expect).max())


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel,bw_method", [("epan", None), ("gauss", None),
                                              ("epan", "silverman")])
def test_k1b_plain_matches_reference_impl(fiducial_population, mock_catalog,
                                          kernel, bw_method):
    """K1b: 50 points over each (λ, event)'s [z_min - 2σ, z_max + 2σ],
    density times norms."""
    pop_b, cosmo, mass = _batch(fiducial_population)
    theta = mock_catalog
    pe = (theta.m1det, theta.m2det, theta.dL, 1.0 / theta.pe_prior)
    cfg = _FusedCfg(kernel=kernel, bw_method=bw_method, cut_grid=2.0, n_grid=50,
                    den_scale="norms", interpret=False, logical_s=None)
    den_e, st_e = _reference_impl(cfg, *pe, pop_b.cosmo, pop_b.mass, None,
                                  None, None)
    den, st = fused_weights_kde(*[_t(a) for a in pe], cosmo, mass,
                                kernel=kernel, bw_method=bw_method,
                                cut_grid=2.0, n_grid=50)
    assert den.shape == (4, theta.dL.shape[0], 50)
    _close(den, den_e)
    for k in STAT_NAMES:
        _close(st[k], st_e[k])


@pytest.mark.parametrize("kernel", ["epan", "gauss"])
def test_k1d_plain_matches_reference_impl(dark_siren_setup, fiducial_population,
                                          kernel):
    """K1d: the per-pixel logical rows of the dark fixture on the event's
    bounds from the event stats pass (itself held to the reference's
    stats-only pass without logical rows), unit mass."""
    theta = _sort_samples_by_distance(dark_siren_setup[0])
    pop_b, cosmo, mass = _batch(fiducial_population)
    pe = (theta.m1det, theta.m2det, theta.dL, 1.0 / theta.pe_prior)
    cfg1 = _FusedCfg(kernel=kernel, bw_method=None, cut_grid=2.0, n_grid=8,
                     den_scale="norms", interpret=False, logical_s=None,
                     stats_only=True)
    _, ev_e = _reference_impl(cfg1, *pe, pop_b.cosmo, pop_b.mass, None, None,
                              None)
    ev = fused_row_stats(*[_t(a) for a in pe], cosmo, mass, cut_grid=2.0)
    for k in STAT_NAMES:
        _close(ev[k], ev_e[k])

    c = jpix.compact_samples_by_pixel(theta)
    e, p, s_pp = c["dL"].shape
    flat = [c[k].reshape(e * p, s_pp) for k in ("m1det", "m2det", "dL",
                                                "inv_pe_prior")]
    n_real, dl_fill = c["n_real"].reshape(-1), jnp.repeat(c["dl_fill"], p)
    ext = jnp.stack([jnp.repeat(ev_e["lo"], p, axis=1),
                     jnp.repeat(ev_e["ub"], p, axis=1)], axis=-1)
    cfg = _FusedCfg(kernel=kernel, bw_method=None, cut_grid=None, n_grid=50,
                    den_scale="unit", interpret=False,
                    logical_s=theta.dL.shape[1])
    den_e, st_e = _reference_impl(cfg, *flat, pop_b.cosmo, pop_b.mass, None,
                                  n_real, dl_fill, ext)
    den, st = fused_weights_kde(
        *[_t(a) for a in flat], cosmo, mass, kernel=kernel, ext_bounds=_t(ext),
        n_grid=50, n_real=_t(n_real, torch.int64), dl_fill=_t(dl_fill),
        logical_s=theta.dL.shape[1], den_scale="unit")
    live = np.asarray(n_real) > 0
    assert not live.all()
    _close(den, den_e, live)
    assert torch.all(den[:, ~live] == 0)
    for k in STAT_NAMES:
        _close(st[k], st_e[k], live)


# ---------------------------------------------------------------------------
# the likelihood end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,cut_grid,catalog", [
    ("1d", 2.0, "empty"), ("approximate", 2.0, "pixelated"),
    ("approximate", None, "pixelated"), ("marginalized", 2.0, "pixelated"),
    ("marginalized", 2.0, "empty"), ("marginalized", None, "empty")])
def test_log_like_batch(fiducial_population, mock_catalog, mock_injections,
                        mock_z_grids, dark_siren_setup, kind, cut_grid, catalog):
    if kind == "1d":
        inj, n_gen = mock_injections
        theta, z_grids, pop, sel = (mock_catalog, mock_z_grids,
                                    fiducial_population, JSel.create(inj, n_gen))
    else:
        theta, z_grids, pop, sel, _ = dark_siren_setup
        if catalog == "empty":
            pop = pytree.replace(pop, gal_cat=EmptyCatalog())
    jhl = JHL.create(theta, z_grids, pop, sel, kind=kind, binning=False,
                     cut_grid=cut_grid, kde_engine="xla")
    expect = np.asarray(jhl.log_like_batch({"H0": jnp.asarray(H0S)}))
    assert np.all(np.isfinite(expect))
    hl = HyperLikelihood.from_state(state_from_reference(jhl), "cpu", F64)
    assert (hl.kind, hl.binning, hl.cut_grid) == (kind, False, cut_grid)
    assert _rel(hl.log_like_batch({"H0": H0S}), expect) <= 1e-10


def test_layouts_follow_the_path(dark_siren_setup):
    """'marginalized' builds only the layouts its path reads: the chunk rows
    of K2 without cut_grid, the per-pixel rectangle alone with it, the
    masked-dense pixel map when binned."""
    theta, z_grids, pop, sel, _ = dark_siren_setup
    hls = {}
    for key, kw in (("rows", dict(binning=False, cut_grid=None)),
                    ("cut", dict(binning=False, cut_grid=2.0)),
                    ("binned", dict(binning=True, cut_grid=2.0))):
        jhl = JHL.create(theta, z_grids, pop, sel, kind="marginalized",
                         kde_engine="xla", **kw)
        hls[key] = HyperLikelihood.from_state(state_from_reference(jhl), "cpu",
                                              F64)
    buffers = {k: {n for n, _ in hl.named_buffers()} for k, hl in hls.items()}
    assert {"pix_dL", "row_dL", "row_s1"} <= buffers["rows"]
    assert "pix_dL" in buffers["cut"] and "row_dL" not in buffers["cut"]
    assert "in_pix" in buffers["binned"] and "pix_dL" not in buffers["binned"]
