"""The binned (stage-by-stage) path of the PyTorch port — the reference's
default configuration, ``binning=True, num_bins=200, cut_grid=2.0`` —
against the JAX package on identical inputs: the binning, the uniform-grid
interpolation, the 1-D KDE's parameters and contraction, the batched KDE's
plain version (K4) and the plain version of its adjoint (K4b),
``log_like_batch`` for every kind with and without effective grids, its
gradient, and the float32 bar of the configuration.

Data: conftest's session fixtures (the spectral ``mock_catalog``, 16 events
x 256 samples on ``mock_z_grids`` of 200 points; the dark
``dark_siren_setup``, 8 events x 256 samples, ~6 pixels per event,
100-point grids) and the repo's float32 precision mocks.  The JAX side runs
its plain XLA engine (``kde_engine='xla'``) in float64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from chimera_tpu import HyperLikelihood as JHL
from chimera_tpu import SelectionFunction as JSel
from chimera_tpu import pytree
from chimera_tpu.ops import kde as jkde
from chimera_tpu.ops.binning import binning1d as j_binning1d
from chimera_tpu.ops.interp import uniform_interp as j_uniform_interp
from chimera_tpu.ops.pallas.kde import kde1d_grid as pallas_kde1d_grid
from chimera_tpu_torch import HyperLikelihood
from chimera_tpu_torch.convert import state_from_reference
from chimera_tpu_torch.ops.binning import binning1d
from chimera_tpu_torch.ops.cuda.kde import (kde1d_grid_adjoint_plain,
                                            kde1d_grid_plain)
from chimera_tpu_torch.ops.interp import uniform_interp
from chimera_tpu_torch.ops.kde import (MAX_FORM_KERNELS, KERNELS, kde1d_core,
                                       kde1d_params)

F64, F32 = torch.float64, torch.float32
H0S = np.linspace(55.0, 95.0, 9)


def _t(a):
    return torch.as_tensor(np.array(a))


def _rel(got, expect):
    got = got.detach().double().numpy()
    expect = np.asarray(expect)
    return np.max(np.abs(got - expect) / np.abs(expect))


def _rows(seed=0, b=6, s=300, zero_span=True):
    """Sample rows with a dead row (zero weights) and a zero-span row (all
    samples at one z, with weight).  The variance of a zero-span row is
    rounding noise (or exactly 0) under the sqrt(tiny) floor, so its
    bandwidth is not compared."""
    rng = np.random.default_rng(seed)
    z = rng.normal(1.0, 0.2, (b, s)) * rng.uniform(0.5, 2.0, (b, 1))
    w = rng.uniform(size=(b, s)) * (rng.uniform(size=(b, s)) > 0.3)
    w[1] = 0.0
    if zero_span:
        z[2] = 0.73
    return z, w


# ---------------------------------------------------------------------------
# the operations of the stage-by-stage path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_bins", [200, 37])
def test_binning1d(num_bins):
    z, w = _rows()
    c_exp, n_exp = jax.vmap(lambda a, b: j_binning1d(a, b, num_bins,
                                                       method="scatter"))(z, w)
    centers, counts = binning1d(_t(z), _t(w), num_bins)
    np.testing.assert_allclose(centers.numpy(), np.asarray(c_exp), rtol=1e-14,
                               atol=0)
    np.testing.assert_allclose(counts.numpy(), np.asarray(n_exp), rtol=1e-12,
                               atol=1e-14)
    assert np.isclose(counts[2, 0].item(), w[2].sum(), rtol=1e-14)
    assert torch.all(counts[2, 1:] == 0)
    # a leading batch of batches bins row by row
    c2, n2 = binning1d(_t(z).reshape(2, 3, -1), _t(w).reshape(2, 3, -1), num_bins)
    assert torch.equal(c2.reshape(6, -1), centers)
    np.testing.assert_allclose(n2.reshape(6, -1).numpy(), counts.numpy(),
                               rtol=1e-14)


def test_uniform_interp():
    rng = np.random.default_rng(1)
    lo, hi = rng.uniform(0.1, 0.5, 5), rng.uniform(0.9, 1.5, 5)
    x = np.sort(rng.uniform(0.0, 2.0, (5, 70)), axis=1)
    x[:, 0], x[:, 1] = lo, hi           # both ends exactly
    fp = rng.uniform(size=(5, 40))
    expect = jax.vmap(j_uniform_interp)(x, lo, hi, fp)
    got = uniform_interp(_t(x), _t(lo), _t(hi), _t(fp))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-13,
                               atol=1e-15)
    assert torch.all(got[_t(x) > _t(hi)[:, None]] == 0)


@pytest.mark.parametrize("bw_method", [None, "silverman", 0.3])
@pytest.mark.parametrize("kernel", ["epan", "gauss"])
def test_kde1d_params_and_core(bw_method, kernel):
    z, w = _rows(2, zero_span=False)
    grid = np.linspace(0.0, 3.0, 90)[None] * np.linspace(0.8, 1.2, 6)[:, None]
    wn_e, h_e = jkde.kde1d_params(jnp.asarray(z), jnp.asarray(w), bw_method)
    dens_e = jax.vmap(lambda a, g, b, c: jkde.kde1d_core(a, g, b, c, kernel))(
        z, grid, wn_e, h_e)
    wn, h = kde1d_params(_t(z), _t(w), bw_method)
    np.testing.assert_allclose(wn.numpy(), np.asarray(wn_e), rtol=1e-14, atol=0)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_e), rtol=1e-13, atol=0)
    dens = kde1d_core(_t(z), _t(grid), wn, h, kernel)
    np.testing.assert_allclose(dens.numpy(), np.asarray(dens_e), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(dens_e)).max())
    assert np.all(np.asarray(dens_e)[1] == 0) and torch.all(dens[1] == 0)


@pytest.mark.parametrize("kernel", ["epan", "gauss"])
def test_kde1d_grid_plain_matches_the_pallas_kernel(kernel):
    """K4's plain version against the Pallas kernel in interpret mode, at
    tests/test_pallas_kde.py's small shape (7 rows x 200 samples x
    130-point grids)."""
    b, s, g = 7, 200, 130
    z = jax.random.normal(jax.random.PRNGKey(0), (b, s)) * 0.2 + 1.0
    w = jax.random.uniform(jax.random.PRNGKey(1), (b, s))
    grids = jnp.linspace(0.3, 1.8, g)[None, :] * jnp.linspace(0.8, 1.2, b)[:, None]
    wn, h = jkde.kde1d_params(z, w, None)
    expect = np.asarray(pallas_kde1d_grid(z, wn, grids, h, kernel=kernel,
                                          interpret=True))
    got = kde1d_grid_plain(_t(z), _t(wn), _t(grids), _t(h), kernel)
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-10,
                               atol=1e-12 * np.abs(expect).max())


def test_epanechnikov_slope_at_the_support_edge():
    """At |u| = 1 exactly the select form of ``kde1d_core`` keeps all of
    the slope -1.5 u and the max form of the Pallas kernels' references
    half of it, in both packages (``torch.clamp_min`` would keep all of it
    in the max form)."""
    u = np.array([-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0])
    for port, ref in ((KERNELS["epan"], jkde.epanechnikov_kernel),
                      (MAX_FORM_KERNELS["epan"],
                       lambda v: 0.75 * jnp.maximum(0.0, 1.0 - v * v))):
        x = _t(u).requires_grad_()
        got = torch.autograd.grad(port(x).sum(), x)[0]
        expect = np.asarray(jax.grad(lambda v: jnp.sum(ref(v)))(jnp.asarray(u)))
        np.testing.assert_array_equal(port(x).detach().numpy(),
                                      np.asarray(ref(jnp.asarray(u))))
        np.testing.assert_array_equal(got.numpy(), expect)
    assert expect[1] == 0.75 and expect[5] == -0.75


@pytest.mark.parametrize("kernel", ["epan", "gauss"])
def test_kde1d_grid_adjoint_plain_matches_jax_vjp(kernel):
    """K4b's plain version against ``jax.vjp`` of ``kde1d_core`` row by row,
    d_z, d_w, d_grids and d_h each within 1e-9 of its row's largest entry
    (d_h of the largest |d_h|), on 200 bin centres x 150 grid points: a row
    of zero weights, a zero-span row, and a row whose grid points sit at
    |u| = 1 exactly of some samples (z and grid on multiples of 1/8, h =
    1/4), where the select form takes all of the slope."""
    z, w = _rows(3, s=200)
    rng = np.random.default_rng(3)
    z[3] = rng.integers(4, 12, 200) / 8.0
    grid = np.linspace(0.0, 3.0, 150)[None] * np.linspace(0.8, 1.2, 6)[:, None]
    grid[3] = np.arange(150) / 8.0 - 4.0
    wn, h = (np.array(a) for a in jkde.kde1d_params(jnp.asarray(z),
                                                     jnp.asarray(w), None))
    h[3] = 0.25
    d_out = rng.normal(size=(6, 150))

    def vjp(z, g, w, h, d):
        out, pull = jax.vjp(lambda *a: jkde.kde1d_core(*a, kernel), z, g, w, h)
        return (out, *pull(d))

    out, ez, eg, ew, eh = jax.vmap(vjp)(*(jnp.asarray(a) for a in
                                          (z, grid, wn, h, d_out)))
    # the inputs a backward hands it require grad: it records no graph
    got = kde1d_grid_adjoint_plain(
        *(_t(a).requires_grad_() for a in (z, wn, grid, h, out)), _t(d_out),
        kernel)
    assert not any(g.requires_grad for g in got)
    ties = np.abs((grid[3][:, None] - z[3][None, :]) / 0.25) == 1.0
    assert ties.any() and np.all(np.asarray(out)[1] == 0)
    for g, e in zip(got, (ez, ew, eg, eh)):
        e = np.asarray(e).reshape(6, -1) if np.ndim(e) == 2 else np.asarray(e)[None]
        g = g.detach().numpy().reshape(e.shape)
        assert np.all(np.isfinite(g))
        scale = np.maximum(np.abs(e).max(axis=-1, keepdims=True), 1e-300)
        assert np.max(np.abs(g - e) / scale) <= 1e-9


# ---------------------------------------------------------------------------
# the likelihood end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def spectral(fiducial_population, mock_catalog, mock_injections, mock_z_grids):
    inj, n_gen = mock_injections
    return (mock_catalog, mock_z_grids, fiducial_population,
            JSel.create(inj, n_gen))


def _jax_hl(data, **kw):
    theta, z_grids, pop, sel = data[:4]
    return JHL.create(theta, z_grids, pop, sel, kde_engine="xla", **kw)


def test_reference_defaults(spectral):
    """A JAX object built with no configuration keyword (binning=True,
    num_bins=200, cut_grid=2.0) comes over with its configuration, and the
    port's own create with no keyword builds the same likelihood."""
    jhl = _jax_hl(spectral)
    assert jhl.binning and jhl.num_bins == 200 and jhl.cut_grid == 2.0
    expect = np.asarray(jhl.log_like_batch({"H0": jnp.asarray(H0S)}))
    assert np.all(np.isfinite(expect))
    hl = HyperLikelihood.from_state(state_from_reference(jhl), "cpu", F64)
    assert (hl.binning, hl.num_bins, hl.cut_grid) == (True, 200, 2.0)
    assert _rel(hl.log_like_batch({"H0": H0S}), expect) <= 1e-10
    plain = HyperLikelihood.create(_port_theta(hl), hl.z_grids, hl.population,
                                   hl.selection)
    assert (plain.binning, plain.num_bins, plain.cut_grid) == (True, 200, 2.0)
    assert _rel(plain.log_like_batch({"H0": H0S}), expect) <= 1e-10


def _port_theta(hl):
    from chimera_tpu_torch.data.structs import ThetaPEDet

    return ThetaPEDet(m1det=hl.m1det, m2det=hl.m2det, dL=hl.dL,
                      pe_prior=hl.pe_prior)


@pytest.mark.parametrize("kind,cut_grid,num_bins", [
    ("1d", None, 200), ("1d", 2.0, 64), ("approximate", 2.0, 200),
    ("approximate", None, 200), ("marginalized", 2.0, 200),
    ("marginalized", None, 200)])
def test_log_like_batch(spectral, dark_siren_setup, kind, cut_grid, num_bins):
    data = spectral if kind == "1d" else dark_siren_setup
    kw = {} if kind == "1d" else {"kind": kind}
    jhl = _jax_hl(data, binning=True, cut_grid=cut_grid, num_bins=num_bins, **kw)
    expect = np.asarray(jhl.log_like_batch({"H0": jnp.asarray(H0S)}))
    assert np.all(np.isfinite(expect))
    hl = HyperLikelihood.from_state(state_from_reference(jhl), "cpu", F64)
    assert (hl.kind, hl.binning, hl.num_bins, hl.cut_grid) == \
        (kind, True, num_bins, cut_grid)
    assert _rel(hl.log_like_batch({"H0": H0S}), expect) <= 1e-10


def test_marginalized_empty_catalog(dark_siren_setup):
    """'marginalized' on pixelated data with an empty catalog: p_cbc is
    lifted over the pixel axis."""
    theta, z_grids, pop_pix, sel, _ = dark_siren_setup
    from chimera_tpu.catalog import EmptyCatalog

    pop = pytree.replace(pop_pix, gal_cat=EmptyCatalog())
    jhl = _jax_hl((theta, z_grids, pop, sel), kind="marginalized")
    expect = np.asarray(jhl.log_like_batch({"H0": jnp.asarray(H0S)}))
    hl = HyperLikelihood.from_state(state_from_reference(jhl), "cpu", F64)
    assert _rel(hl.log_like_batch({"H0": H0S}), expect) <= 1e-10


def test_binned_gradient(spectral):
    """d log L / dH0 through the binned spectral path: autograd through the
    plain versions against ``jax.grad`` of the vmap engine."""
    jhl = _jax_hl(spectral)
    h0s = np.array([62.0, 70.0, 77.5])
    expect = np.asarray(jax.grad(lambda h: jnp.sum(
        jhl.log_like_batch({"H0": h})))(jnp.asarray(h0s)))
    hl = HyperLikelihood.from_state(state_from_reference(jhl), "cpu", F64)
    h = torch.tensor(h0s, dtype=F64, requires_grad=True)
    got = torch.autograd.grad(hl.log_like_batch({"H0": h}).sum(), h)[0]
    assert np.all(np.isfinite(expect)) and np.all(expect != 0)
    assert _rel(got, expect) <= 1e-9


@pytest.mark.parametrize("kind,cut_grid", [
    ("approximate", 2.0), ("approximate", None), ("marginalized", 2.0),
    ("marginalized", None)])
def test_binned_gradient_of_the_dark_kinds(dark_siren_setup, kind, cut_grid):
    """d log L / d(H0, mu_g) of binned 'approximate' and 'marginalized'
    (the masked-dense pixel layout), with and without effective grids:
    autograd through the plain versions against ``jax.grad`` of the vmap
    engine, within 1e-9."""
    jhl = _jax_hl(dark_siren_setup, kind=kind, binning=True, cut_grid=cut_grid)
    h0s, mus = np.array([62.0, 70.0, 77.5]), np.array([33.0, 34.0, 35.0])
    expect = jax.grad(lambda h, m: jnp.sum(jhl.log_like_batch(
        {"H0": h, "mu_g": m})), argnums=(0, 1))(jnp.asarray(h0s), jnp.asarray(mus))
    hl = HyperLikelihood.from_state(state_from_reference(jhl), "cpu", F64)
    assert (hl.kind, hl.binning, hl.cut_grid) == (kind, True, cut_grid)
    h, m = (torch.tensor(a, dtype=F64, requires_grad=True) for a in (h0s, mus))
    got = torch.autograd.grad(hl.log_like_batch({"H0": h, "mu_g": m}).sum(),
                              (h, m))
    for g, e in zip(got, expect):
        assert np.all(np.isfinite(e)) and np.all(np.asarray(e) != 0)
        assert _rel(g, e) <= 1e-9


@pytest.mark.parametrize("kind", ["1d", "marginalized"])
def test_binned_float32_bar(kind):
    """Port float32 against port float64 with the reference's defaults, held
    to chip_smoke.BINNED_F32_BAR: max(1e-6, 2 x the JAX package's own
    float32 gap on the repo's precision mocks), on the data of chip_smoke's
    phases 16 and 17 (the port-drawn 64 x 1024 x 300 spectral mock; the
    dark mock of tests/data/f32_parity_dark.npz)."""
    if kind == "1d":
        data = chip_smoke.mock(*chip_smoke.PRECISION_MOCK, device="cpu")
        make = chip_smoke.likelihood
    else:
        data = chip_smoke.parity_dark_mock(torch.device("cpu"))
        make = chip_smoke.dark_likelihood
    h0s = torch.as_tensor(np.linspace(58.0, 100.0, 7))
    ll64 = make(data, F64, binning=True, cut_grid=2.0).log_like_batch({"H0": h0s})
    ll32 = make(data, F32, binning=True, cut_grid=2.0).log_like_batch(
        {"H0": h0s.to(F32)})
    assert torch.all(torch.isfinite(ll64)) and ll32.dtype == F32
    rel = ((ll32.double() - ll64).abs() / ll64.abs()).max().item()
    assert rel <= chip_smoke.BINNED_F32_BAR[kind], rel
