"""The dark-siren 'marginalized' slice of the PyTorch port against the JAX
package on identical inputs: the pixelization and its sample layouts, the
pixelated-catalog build, the kernels' plain versions (K1c stats pass, K2
rows contract, K1e contract pass) and ``log_like_batch`` end to end, on the
rows path and on the contract path (a layout without chunk rows).

Data: the session fixtures ``dark_siren_setup`` / ``dark_siren_extras``
(8 events x 256 PE samples, nside {8, 16}, ~6 pixels per event, 100-point
z-grids, 12k background galaxies).  The JAX side runs its plain XLA path
(``kde_engine='xla'``) and its kernels' reference implementations, in
float64 on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_tpu import HyperLikelihood as JHL
from chimera_tpu import pytree
from chimera_tpu.catalog.build import build_pixelated_catalog as j_build
from chimera_tpu.data import pixelize as jpix
from chimera_tpu.likelihood import (_marg_lambda_factors, _marg_static_factors,
                                    _sort_samples_by_distance)
from chimera_tpu.ops.pallas.fused import (_FusedCfg, _reference_impl,
                                          _rows_reference, _RowsCfg)
from chimera_tpu_torch import HyperLikelihood
from chimera_tpu_torch.catalog import DVdzCompleteness
from chimera_tpu_torch.catalog.build import build_pixelated_catalog
from chimera_tpu_torch.convert import state_from_reference
from chimera_tpu_torch.data import pixelize as tpix
from chimera_tpu_torch.data.structs import ThetaPEDet
from chimera_tpu_torch.models import FLRW, PowerLawPeak
from chimera_tpu_torch.ops.cuda.fused import (STAT_NAMES, fused_row_stats,
                                              fused_weights_kde)
from chimera_tpu_torch.ops.cuda.rows import fused_rows_contract

F64 = torch.float64
H0S = np.linspace(55.0, 95.0, 9)
MULTI = {"H0": [65.0, 75.0], "Om0": [0.2, 0.35], "mu_g": [33.0, 35.0]}
PIXEL_FIELDS = ("opt_nsides", "pixels_opt_nsides", "ra_pix", "dec_pix",
                "pixels_pe_opt_nside", "pixel_mask")
INT_FIELDS = ("opt_nsides", "pixels_opt_nsides", "pixels_pe_opt_nside",
              "pixel_mask")


def _t(a, dtype=F64):
    t = torch.as_tensor(np.array(a))
    return t if dtype is None else t.to(dtype)


def _rel(got, expect):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else got
    expect = np.asarray(expect)
    return np.max(np.abs(got - expect) / np.abs(expect))


@pytest.fixture(scope="module")
def jax_hl(dark_siren_setup):
    theta, z_grids, pop_pix, sel, _ = dark_siren_setup
    return JHL.create(theta, z_grids, pop_pix, sel, kind="marginalized",
                      binning=False, cut_grid=None, kde_engine="xla")


@pytest.fixture(scope="module")
def state(jax_hl):
    return state_from_reference(jax_hl)


@pytest.fixture(scope="module")
def batch4(jax_hl, state):
    """The JAX λ batch (L = 4) and the same tables in the port's models."""
    pop_b = jax.jit(jax.vmap(lambda h: jax_hl.population.update(H0=h)))(
        jnp.asarray([60.0, 67.0, 74.0, 81.0]))
    st = state_from_reference(pop_b)
    return (pop_b, FLRW.from_state(st, "cosmo.", "cpu", F64),
            PowerLawPeak.from_state(st, "mass.", "cpu", F64))


def _port_theta(theta):
    return ThetaPEDet(**{f: _t(getattr(theta, f), None) for f in
                         ("m1det", "m2det", "dL", "pe_prior", "ra", "dec",
                          *PIXEL_FIELDS, "gw_loc2d_pdf")})


# ---------------------------------------------------------------------------
# pixelization, layouts, catalog
# ---------------------------------------------------------------------------

def test_pixelize_gw_catalog(dark_siren_setup):
    theta = dark_siren_setup[0]
    got = tpix.pixelize_gw_catalog(
        ThetaPEDet(ra=_t(theta.ra), dec=_t(theta.dec), dL=_t(theta.dL)),
        nside_list=[8, 16], mean_npixels_event=6, sky_conf=0.9)
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(theta, f)), err_msg=f)
    for f in ("ra_pix", "dec_pix"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(theta, f)), rtol=0,
                                   atol=1e-12, err_msg=f)
    mask = np.asarray(theta.pixel_mask)
    loc = np.asarray(theta.gw_loc2d_pdf)
    assert np.all(got.gw_loc2d_pdf.numpy()[~mask] == loc[~mask])
    np.testing.assert_allclose(got.gw_loc2d_pdf.numpy()[mask], loc[mask], rtol=1e-10)


@pytest.mark.parametrize("n_s,pad", [(256, 128), (200, 256)])
def test_compact_and_chunk_rows(dark_siren_setup, n_s, pad):
    """Layouts equal to the JAX ones, also for S = 200 samples padded to a
    256-slot rectangle."""
    theta = _sort_samples_by_distance(dark_siren_setup[0])
    fields = ("m1det", "m2det", "dL", "pe_prior", "pixels_pe_opt_nside")
    theta = theta.update(**{f: getattr(theta, f)[:, :n_s] for f in fields})
    expect = jpix.compact_samples_by_pixel(theta, pad_multiple=pad)
    got = tpix.compact_samples_by_pixel(_port_theta(theta), pad_multiple=pad)
    assert got["dL"].shape[-1] == expect["dL"].shape[-1] >= n_s
    for k, v in expect.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    expect_rows = jpix.chunk_rows_from_compact(expect)
    got_rows = tpix.chunk_rows_from_compact(got)
    for k, v in expect_rows.items():
        np.testing.assert_array_equal(got_rows[k].numpy(), np.asarray(v), err_msg=k)


def test_build_pixelated_catalog(dark_siren_setup, dark_siren_extras, state):
    theta, z_grids, pop_pix, _, _ = dark_siren_setup
    galaxies, compl = dark_siren_extras
    expect = j_build(galaxies, theta, z_grids, pop_pix.cosmo, compl, z_err=0.01)
    cosmo = FLRW.from_state(state_from_reference(pop_pix.cosmo), "", "cpu", F64)
    got = build_pixelated_catalog(
        {k: _t(v) for k, v in galaxies.items()}, _port_theta(theta), _t(z_grids),
        cosmo, DVdzCompleteness.create(z_range=(0.0, 3.0), device="cpu", dtype=F64),
        z_err=0.01)
    p_cat = np.asarray(expect.p_cat)
    assert np.max(np.abs(got.p_cat.numpy() - p_cat)) <= 1e-10 * np.max(p_cat)
    np.testing.assert_array_equal(got.n_gal.numpy(), np.asarray(expect.n_gal))
    np.testing.assert_array_equal(got.P_compl.numpy(), np.asarray(expect.P_compl))
    np.testing.assert_array_equal(got.pixel_mask.numpy(),
                                  np.asarray(expect.pixel_mask))


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_s,pad", [(256, 128), (200, 256)])
@pytest.mark.parametrize("bw_method", [None, "silverman"])
def test_row_stats_plain_matches_reference_impl(jax_hl, batch4, n_s, pad,
                                                bw_method):
    """K1c: the stats-only pass with the logical-row correction, also with
    S = 200 real samples in 256-slot rows (fewer logical than present
    fillers)."""
    pop_b, cosmo, mass = batch4
    theta = jax_hl.theta_gw
    fields = ("m1det", "m2det", "dL", "pe_prior", "pixels_pe_opt_nside")
    theta = theta.update(**{f: getattr(theta, f)[:, :n_s] for f in fields})
    c = jpix.compact_samples_by_pixel(theta, pad_multiple=pad)
    e, p, s_pp = c["dL"].shape
    flat = [c[k].reshape(e * p, s_pp) for k in ("m1det", "m2det", "dL", "inv_pe_prior")]
    n_real, dl_fill = c["n_real"].reshape(-1), jnp.repeat(c["dl_fill"], p)
    cfg = _FusedCfg(kernel="epan", bw_method=bw_method, cut_grid=2.0, n_grid=8,
                    den_scale="unit", interpret=False, logical_s=n_s,
                    stats_only=True)
    _, expect = _reference_impl(cfg, *flat, pop_b.cosmo, pop_b.mass, None,
                                n_real, dl_fill)
    got = fused_row_stats(*[_t(a) for a in flat], cosmo, mass,
                          n_real=_t(n_real, torch.int64), dl_fill=_t(dl_fill),
                          logical_s=n_s, cut_grid=2.0, bw_method=bw_method)
    assert set(got) == set(STAT_NAMES) == set(expect)
    # empty pixel slots: zero weight in both; their z spread is rounding
    # noise under the variance floor, so the bandwidth is compared on the
    # real pixels only
    live = np.asarray(n_real) > 0
    assert not live.all()
    for k in STAT_NAMES:
        np.testing.assert_allclose(got[k].numpy()[:, live],
                                   np.asarray(expect[k])[:, live],
                                   rtol=1e-10, atol=0, err_msg=k)
    for k in ("sum_w", "sum_w2"):
        assert np.all(got[k].numpy()[:, ~live] == 0)
        assert np.all(np.asarray(expect[k])[:, ~live] == 0)


@pytest.mark.parametrize("kernel", ["epan", "gauss"])
def test_rows_contract_plain_matches_rows_reference(jax_hl, batch4, kernel):
    """K2 on the JAX layout, with the (1/h, scale) of the JAX stats pass and
    the JAX contraction factors."""
    pop_b, cosmo, mass = batch4
    c = jax_hl.compact
    rows = c["rows"]
    e, p, s_pp = c["dL"].shape
    flat = [c[k].reshape(e * p, s_pp) for k in ("m1det", "m2det", "dL", "inv_pe_prior")]
    cfg = _FusedCfg(kernel=kernel, bw_method=None, cut_grid=2.0, n_grid=8,
                    den_scale="unit", interpret=False, logical_s=256,
                    stats_only=True)
    _, st = _reference_impl(cfg, *flat, pop_b.cosmo, pop_b.mass, None,
                            c["n_real"].reshape(-1), jnp.repeat(c["dl_fill"], p))
    cc = rows["dL"].shape[1]
    gidx = (jnp.arange(e)[:, None] * p + rows["row_pix"]).reshape(-1)
    h, sum_w = st["bandwidth"], st["sum_w"]
    hs = jnp.stack([1.0 / h[:, gidx], jnp.where(sum_w > 0, 1.0 / (h * sum_w), 0.0)[:, gidx]],
                   axis=-1)
    s1, s2 = _marg_static_factors(jax_hl)
    f1, f2, _ = _marg_lambda_factors(jax_hl, pop_b)
    row_args = [rows[k].reshape(e * cc, -1) for k in ("m1det", "m2det", "dL",
                                                      "inv_pe_prior")]
    expect = _rows_reference(_RowsCfg(kernel=kernel, c_per_event=cc, interpret=False),
                             *row_args, pop_b.cosmo, pop_b.mass, jax_hl.z_grids,
                             hs, s1[gidx], s2[gidx], f1, f2)
    got = fused_rows_contract(*[_t(a) for a in row_args], cosmo, mass,
                              _t(jax_hl.z_grids), _t(hs), _t(s1[gidx]),
                              _t(s2[gidx]), _t(f1), _t(f2), kernel=kernel)
    expect = np.asarray(expect)
    assert np.count_nonzero(expect) > expect.size // 4
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-10,
                               atol=1e-12 * np.abs(expect).max())


@pytest.mark.parametrize("kernel", ["epan", "gauss"])
def test_contract_plain_matches_reference_impl(jax_hl, batch4, kernel):
    """K1e: the contract epilogue (``_reference_impl``'s ``npix`` branch) on
    the JAX per-pixel layout and contraction factors: r within 1e-10 (of
    each λ's largest |r|), exactly 0 on the dead pixel rows, and the stats
    of the rows with weight."""
    pop_b, cosmo, mass = batch4
    c = jax_hl.compact
    e, p, s_pp = c["dL"].shape
    flat = [c[k].reshape(e * p, s_pp) for k in ("m1det", "m2det", "dL", "inv_pe_prior")]
    n_real, dl_fill = c["n_real"].reshape(-1), jnp.repeat(c["dl_fill"], p)
    grids = jnp.repeat(jax_hl.z_grids, p, axis=0)
    s1, s2 = _marg_static_factors(jax_hl)
    f1, f2, _ = _marg_lambda_factors(jax_hl, pop_b)
    cfg = _FusedCfg(kernel=kernel, bw_method=None, cut_grid=None,
                    n_grid=grids.shape[1], den_scale="unit", interpret=False,
                    logical_s=256, npix=p)
    r_e, st_e = _reference_impl(cfg, *flat, pop_b.cosmo, pop_b.mass, grids,
                                n_real, dl_fill, None, s1, s2, f1, f2)
    r, st = fused_weights_kde(*[_t(a) for a in flat], cosmo, mass, _t(grids),
                              kernel=kernel, n_real=_t(n_real, torch.int64),
                              dl_fill=_t(dl_fill), logical_s=256,
                              den_scale="unit",
                              contract=tuple(_t(a) for a in (s1, s2, f1, f2)))
    r_e = np.asarray(r_e)
    live = np.asarray(n_real) > 0
    assert r.shape == r_e.shape == (4, e * p, 2) and not live.all()
    assert np.all(r.numpy()[:, ~live] == 0) and np.all(r_e[:, ~live] == 0)
    # r2 is 0 where the catalog is complete (P_compl = 1)
    scale = np.maximum(np.abs(r_e).max(axis=1, keepdims=True), 1e-300)
    assert np.abs(r_e[..., 0]).max() > 0
    assert np.max(np.abs(r.numpy() - r_e) / scale) <= 1e-10
    for k in ("norms", "neff", "bandwidth", "sum_w", "sum_w2"):
        np.testing.assert_allclose(st[k].numpy()[:, live],
                                   np.asarray(st_e[k])[:, live], rtol=1e-10,
                                   atol=0, err_msg=k)


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", ["H0", "multi"])
def test_log_like_batch(jax_hl, state, batch):
    """Port float64 within 1e-10 and float32 within 1e-5 of JAX float64."""
    hyper = {"H0": H0S} if batch == "H0" else MULTI
    expect = np.asarray(jax_hl.log_like_batch(
        {k: jnp.asarray(v) for k, v in hyper.items()}))
    assert np.all(np.isfinite(expect))
    hl = HyperLikelihood.from_state(state, "cpu", F64)
    assert hl.kind == "marginalized"
    assert _rel(hl.log_like_batch(hyper), expect) <= 1e-10
    got32 = HyperLikelihood.from_state(state, "cpu", torch.float32).log_like_batch(hyper)
    assert got32.dtype == torch.float32
    assert _rel(got32, expect) <= 1e-5


@pytest.mark.parametrize("batch", ["H0", "multi"])
def test_contract_path_log_like_batch(jax_hl, state, batch):
    """A JAX object whose layout has no chunk rows (its ``compact`` without
    'rows', which ``_fused_batch_marginalized`` sends to the contract pass)
    comes over as the port's contract path (one K1e pass): float64 within
    1e-10 of the JAX package's log L and of the port's rows path."""
    hyper = {"H0": H0S} if batch == "H0" else MULTI
    no_rows = pytree.replace(jax_hl, compact={
        k: v for k, v in jax_hl.compact.items() if k != "rows"})
    expect = np.asarray(no_rows.log_like_batch(
        {k: jnp.asarray(v) for k, v in hyper.items()}))
    assert np.all(np.isfinite(expect))
    st = state_from_reference(no_rows)
    assert not st["compact_rows"] and state["compact_rows"]
    hl = HyperLikelihood.from_state(st, "cpu", F64)
    assert not hl.chunk_rows and hasattr(hl, "pix_s1") and not hasattr(hl, "row_dL")
    got = hl.log_like_batch(hyper)
    assert _rel(got, expect) <= 1e-10
    rows = HyperLikelihood.from_state(state, "cpu", F64).log_like_batch(hyper)
    assert _rel(got, rows.numpy()) <= 1e-10


def test_compute_all(jax_hl, state):
    hl = HyperLikelihood.from_state(state, "cpu", F64)
    for got, expect in zip(hl.compute_all(H0=72.0), jax_hl.compute_all(H0=72.0)):
        assert _rel(got, expect) <= 1e-10


def test_padded_events_are_trimmed(dark_siren_setup):
    """A 7-event catalog: the JAX create pads the events to 8, the catalog
    arrays included; the state carries the 7 real events and the port
    matches the JAX result."""
    theta, z_grids, pop_pix, sel, _ = dark_siren_setup
    cut = theta.update(**{f.name: getattr(theta, f.name)[:7]
                          for f in dataclasses.fields(theta)
                          if getattr(theta, f.name) is not None})
    gc = pop_pix.gal_cat
    gc7 = pytree.replace(gc, **{f: getattr(gc, f)[:7] for f in
                                ("p_cat", "P_compl", "pixel_mask", "n_gal")})
    jhl = JHL.create(cut, z_grids[:7], pytree.replace(pop_pix, gal_cat=gc7), sel,
                     kind="marginalized", binning=False, cut_grid=None,
                     kde_engine="xla")
    assert jhl.n_events == 8 and jhl.population.gal_cat.p_cat.shape[0] == 8
    st = state_from_reference(jhl)
    for key in ("population.gal_cat.p_cat", "population.gal_cat.P_compl",
                "population.gal_cat.pixel_mask", "population.gal_cat.n_gal",
                "theta_gw.pixel_mask", "theta_gw.opt_nsides", "z_grids"):
        assert st[key].shape[0] == 7, key
    hl = HyperLikelihood.from_state(st, "cpu", F64)
    expect = jhl.log_like_batch({"H0": jnp.asarray(H0S)})
    assert _rel(hl.log_like_batch({"H0": H0S}), expect) <= 1e-10


def test_unported_dark_configurations_raise(state):
    """Kind 'full' raises without the samples' sky positions, whatever the
    binning and effective-grid settings, and runs with them;
    'approximate' and 'marginalized' run with the reference's defaults."""
    hl = HyperLikelihood.from_state(state, "cpu", F64)
    theta = ThetaPEDet(**{f: _t(state[f"theta_gw.{f}"], None) for f in
                          ("m1det", "m2det", "dL", *PIXEL_FIELDS, "gw_loc2d_pdf")})
    for kw in ({}, {"binning": False}, {"cut_grid": None}):
        with pytest.raises(ValueError, match="needs the samples' ra and dec"):
            HyperLikelihood.create(theta, hl.z_grids, hl.population, hl.selection,
                                   kind="full", **kw)
    sky = theta.update(ra=_t(state["theta_gw.ra"]), dec=_t(state["theta_gw.dec"]))
    runs = HyperLikelihood.create(sky, hl.z_grids, hl.population, hl.selection,
                                  kind="full")
    assert torch.all(torch.isfinite(runs.log_like_batch({"H0": H0S})))
    for kind in ("approximate", "marginalized"):
        runs = HyperLikelihood.create(theta, hl.z_grids, hl.population,
                                      hl.selection, kind=kind)
        assert torch.all(torch.isfinite(runs.log_like_batch({"H0": H0S})))
