"""Kind 'full' of the port (the 3-D (z, ra, dec) Gaussian KDE per event on
its pixels x z-grid lattice) against the JAX package, float64 on the CPU:

* ``ops/kde.py``: ``gaussian_kde_3d_lattice`` (the dense z sweep and the
  uniform-z recurrence at K = 8, 16, 32), ``gaussian_kde_nd_stream`` with
  and without ``in_log``, a dead (zero-weight) row;
* K5 (``csrc/kde3d.cu``) through its host emulation
  (``tests/host_emulation/kde3d_host.cpp``, the kernel's own device
  functions in ``csrc/kde3d.cuh``) against the plain version, and as the
  launch of the wrapper's CUDA branch on CPU tensors;
* ``likelihood.z_recurrence_plan`` against a numpy recomputation, on the
  narrow-outlier recipe of ``tests/test_ops.py::
  test_full_kind_buckets_match_dense`` at 256-point grids;
* ``log_like_batch`` of ``from_state`` (the JAX object's plan carried) and
  of the port's own ``create`` against the JAX package's, on the repo's
  dark-siren precision mock (``tests/data/f32_parity_dark.npz``: 16 events
  x 512 samples, <= 8 pixels, 200-point z-grids) with its pixelated
  catalog and with an empty one, and d log L / d(H0, Om0) against
  ``jax.grad``.

The JAX side is its XLA path: 'full' has no Pallas kernel to interpret.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from chimera_tpu_torch import HyperLikelihood, SelectionFunction, convert
from chimera_tpu_torch.catalog import EmptyCatalog
from chimera_tpu_torch.likelihood import z_recurrence_plan
from chimera_tpu_torch.ops import kde as tkde
from chimera_tpu_torch.ops.cuda import fused, kde3d, launch_counts

F64, F32 = torch.float64, torch.float32
HERE = Path(__file__).resolve().parent
H0S = np.array([60.0, 70.0, 80.0])


def _t(x, dtype=F64):
    return torch.as_tensor(np.asarray(x)).to(dtype)


def _lattice_data(rng, n_ev=3, s=500, p=5, g=128):
    """Events of correlated (z, ra, dec) samples around (0.5, 2.0, 0.3)
    (sigma 0.05, 0.03, 0.03), random weights, pixel centres near the sky
    mean, uniform 128-point z-grids over [0.3, 0.7]: whitened grid step
    ~0.15, so K = 32 keeps K h <= 5.5."""
    base = rng.normal(size=(n_ev, 3, s))
    mix = np.array([[1.0, 0.0, 0.0], [0.3, 1.0, 0.0], [-0.2, 0.4, 1.0]])
    data = np.einsum("ij,ejs->eis", mix, base) * np.array([0.05, 0.03, 0.03])[:, None] \
        + np.array([0.5, 2.0, 0.3])[:, None]
    w = rng.uniform(0.1, 1.0, size=(n_ev, s))
    ra_pix = 2.0 + 0.04 * rng.normal(size=(n_ev, p))
    dec_pix = 0.3 + 0.04 * rng.normal(size=(n_ev, p))
    grid = np.tile(np.linspace(0.3, 0.7, g), (n_ev, 1))
    return data, w, ra_pix, dec_pix, grid


def _close(got, expect, rel):
    got, expect = np.asarray(got), np.asarray(expect)
    assert np.all(np.isfinite(got)) and np.all(np.isfinite(expect))
    scale = np.abs(expect).max()
    np.testing.assert_allclose(got, expect, rtol=rel, atol=rel * scale)


@pytest.mark.parametrize("k_block", [0, 8, 16, 32])
def test_lattice_matches_reference(k_block):
    """The port's lattice KDE, batched over events (one call, per-event K
    as a tensor), against the JAX function event by event: dense sweep and
    recurrence, 500 samples in two chunks of 256 (the last padded), a
    128-point grid (whole blocks; the padded last block is the next
    test's, on 100 points)."""
    data, w, ra_pix, dec_pix, grid = _lattice_data(np.random.default_rng(3))
    got = tkde.gaussian_kde_3d_lattice(
        _t(data), _t(ra_pix), _t(dec_pix), _t(grid), _t(w), sample_chunk=256,
        z_block=torch.full((3,), k_block))
    for e in range(3):
        expect = jkde.gaussian_kde_3d_lattice(
            jnp.asarray(data[e]), jnp.asarray(ra_pix[e]), jnp.asarray(dec_pix[e]),
            jnp.asarray(grid[e]), weights=jnp.asarray(w[e]), sample_chunk=256,
            uniform_z=k_block > 0, z_block=k_block or 32)
        _close(got[e].numpy(), expect, 1e-10)


def test_lattice_mixed_blocks_and_dead_row():
    """One call with a different K per event (dense, 8, 32) on a grid of
    100 points (the recurrence's last block padded), the first event with
    every weight 0: the uniform fallback keeps it finite, as in the JAX
    package."""
    data, w, ra_pix, dec_pix, grid = _lattice_data(np.random.default_rng(4), g=100)
    grid = np.tile(np.linspace(0.35, 0.65, 100), (3, 1))
    w[0] = 0.0
    ks = [0, 8, 32]
    got = tkde.gaussian_kde_3d_lattice(_t(data), _t(ra_pix), _t(dec_pix),
                                       _t(grid), _t(w), z_block=torch.tensor(ks))
    for e, k in enumerate(ks):
        expect = jkde.gaussian_kde_3d_lattice(
            jnp.asarray(data[e]), jnp.asarray(ra_pix[e]), jnp.asarray(dec_pix[e]),
            jnp.asarray(grid[e]), weights=jnp.asarray(w[e]), uniform_z=k > 0,
            z_block=k or 32)
        _close(got[e].numpy(), expect, 1e-10)


@pytest.mark.parametrize("in_log", [False, True])
def test_kde_nd_stream_matches_reference(in_log):
    """``gaussian_kde_nd_stream`` (500 samples in chunks of 256, the last
    padded) against the JAX function, and the batched direct KDE against
    the streamed one."""
    data, w, _, _, _ = _lattice_data(np.random.default_rng(5))
    pts = data[:, :, :40] + 0.01
    got = tkde.gaussian_kde_nd_stream(_t(data), _t(pts), _t(w), in_log=in_log,
                                      sample_chunk=256)
    for e in range(3):
        expect = jkde.gaussian_kde_nd_stream(
            jnp.asarray(data[e]), jnp.asarray(pts[e]), jnp.asarray(w[e]),
            in_log=in_log, sample_chunk=256)
        _close(got[e].numpy(), expect, 1e-10)
    direct = tkde.gaussian_kde_nd_batch(_t(data), _t(pts), _t(w), in_log=in_log)
    _close(direct.numpy(), got.numpy(), 1e-10)


# ---------------------------------------------------------------------------
# K5's host emulation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def k5_host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host emulation")
    so = tmp_path_factory.mktemp("host_emulation") / "libkde3d_host.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-Wno-unknown-pragmas",
         f"-I{HERE / 'host_emulation'}", f"-I{Path(fused.__file__).parents[2] / 'csrc'}",
         "-o", str(so), str(HERE / "host_emulation" / "kde3d_host.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(so))


def _emulate_k5(monkeypatch, lib):
    """``lattice_kde3d`` takes its CUDA branch on CPU tensors, its launch
    the host emulation of the same C interface; the launch counter is
    restored with the patch."""
    monkeypatch.setattr(kde3d.lattice_kde3d, "launches",
                        kde3d.lattice_kde3d.launches)

    def launch(lib_name, symbol, dtype, device, args):
        assert (lib_name, symbol) == ("kde3d", "chimera_kde3d")
        fn = getattr(lib, "host_kde3d_" + ("f32" if dtype == F32 else "f64"))
        fn.restype = ctypes.c_int
        assert fn(*[ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
                    else ctypes.c_double(a) if isinstance(a, float) else a
                    for a in args]) == 0

    monkeypatch.setattr(fused, "on_card", lambda t: True)
    monkeypatch.setattr(fused, "launch", launch)


def _k5_inputs(dtype):
    """Two λ x three events of 500 samples, 5 pixels (the last of event 1
    fake, at a finite centre), 100-point grids; event 2 at K = 13 (not a
    tier: the 16-register path with a padded last block), event 0 dense,
    event 1 at K = 32; (λ 1, event 0) without weight."""
    data, w, ra_pix, dec_pix, grid = _lattice_data(np.random.default_rng(6), g=100)
    grid = np.tile(np.linspace(0.35, 0.65, 100), (3, 1))
    rng = np.random.default_rng(7)
    z = np.stack([data[:, 0], data[:, 0] + 0.002 * rng.normal(size=data[:, 0].shape)])
    w2 = np.stack([w, w * rng.uniform(0.5, 1.5, size=w.shape)])
    w2[1, 0] = 0.0
    mask = np.ones((3, 5), dtype=bool)
    mask[1, 4] = False
    return (_t(z, dtype), _t(w2, dtype), _t(data[:, 1], dtype), _t(data[:, 2], dtype),
            _t(ra_pix, dtype), _t(dec_pix, dtype), torch.as_tensor(mask),
            _t(grid, dtype), torch.tensor([0, 32, 13]))


@pytest.mark.parametrize("dtype", [F64, F32])
def test_k5_host_emulation_matches_plain(k5_host, monkeypatch, dtype):
    """K5's arithmetic (prologue in double, centred sky factors, dense sweep
    and recurrence in the kernel's thread layout) through the wrapper's
    CUDA branch, one launch: float64 within 1e-10 of each (λ, event, pixel)
    row's max of the plain version, float32 within 1e-4 of the float64
    plain version's; a fake pixel's row 0."""
    args = _k5_inputs(dtype)
    expect = kde3d.lattice_kde3d_plain(*(a.double() if a.is_floating_point()
                                         else a for a in args))
    _emulate_k5(monkeypatch, k5_host)
    before = launch_counts()
    got = kde3d.lattice_kde3d(*args)
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == \
        {k: int(k == "K5") for k in after}
    assert got.dtype == dtype and got.shape == expect.shape
    assert torch.all(got[:, 1, 4] == 0) and torch.all(torch.isfinite(got))
    rel = (got.double() - expect).abs() / expect.abs().amax(dim=-1, keepdim=True)
    assert rel.nan_to_num(0.0).max() <= (1e-10 if dtype == F64 else 1e-4)


def test_k5_refuses_a_block_length_it_does_not_take(k5_host, monkeypatch):
    """A K outside [0, 32] gives NaN rows on the card (the wrapper does not
    read K back from the device); a fake pixel's row stays 0."""
    args = list(_k5_inputs(F64))
    args[8] = torch.tensor([0, 33, 8])
    _emulate_k5(monkeypatch, k5_host)
    got = kde3d.lattice_kde3d(*args)
    assert torch.all(torch.isnan(got[:, 1, :4])) and torch.all(got[:, 1, 4] == 0)
    assert torch.all(torch.isfinite(got[:, 0])) and torch.all(torch.isfinite(got[:, 2]))


# ---------------------------------------------------------------------------
# the recurrence plan
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def outlier_fixture():
    """tests/test_ops.py::test_full_kind_buckets_match_dense's recipe, drawn
    by the port's generator: 16 events x 256 samples (sigma_sky 0.03 rad,
    oversample 300), event 3's dL spread shrunk 20x (a narrow outlier),
    nside 8, 4 pixels asked, 256-point grids (H0 prior [40, 120]); as numpy
    arrays (z at the fiducial cosmology, ra, dec, the grids), with the JAX
    'full' object built on the same arrays."""
    from chimera_tpu_torch.data.mock import make_mock_catalog
    from chimera_tpu_torch.data.pixelize import pixelize_gw_catalog
    from chimera_tpu_torch.models import compute_z_grids, theta_det_to_src

    pop = chip_smoke.population(F64, None, torch.device("cpu"))
    cat = make_mock_catalog(torch.Generator().manual_seed(9), pop, n_events=16,
                            n_samples=256, snr_threshold=12.0,
                            sigma_sky_rad=0.03, oversample=300)
    dl = cat.dL.clone()
    dl[3] = dl[3].mean() + 0.05 * (dl[3] - dl[3].mean())
    cat = pixelize_gw_catalog(cat.update(dL=dl), nside_list=[8],
                              mean_npixels_event=4, sky_conf=0.9)
    z_grids = compute_z_grids(pop.cosmo, cat, cosmo_prior={"H0": [40.0, 120.0]},
                              z_int_res=256)
    # the plan needs no injections
    jhl = _jax_full((cat, z_grids, None, None, None), True)
    z = theta_det_to_src(pop.cosmo, cat).z[0].numpy()
    return (z, cat.ra.numpy(), cat.dec.numpy(), z_grids.numpy()), jhl


def test_plan_matches_a_numpy_recomputation(outlier_fixture):
    """Each event's K: inv(cov)_00 as the inverse of the Schur complement
    of the sky block, the factor at n_eff = S, the tier below
    floor(5.5 / h) capped at 32; the outlier dense; never below the JAX
    object's K (which only demotes tiers to multiples of 8 events), and
    ``from_state`` carries the JAX object's K."""
    (z, ra, dec, zg), jhl = outlier_fixture
    k, outcome = z_recurrence_plan(z, ra, dec, zg, None)
    data = np.stack([z, ra, dec], axis=1)
    data = data - data.mean(axis=-1, keepdims=True)
    cov = np.einsum("eis,ejs->eij", data, data) / (z.shape[1] - 1)
    schur = cov[:, 0, 0] - np.einsum("ei,eij,ej->e", cov[:, 0, 1:],
                                     np.linalg.inv(cov[:, 1:, 1:]), cov[:, 0, 1:])
    factor = z.shape[1] ** (-1.0 / 7.0)
    h = (zg[:, -1] - zg[:, 0]) / (zg.shape[1] - 1) / (np.sqrt(schur) * factor)
    safe = np.floor(5.5 / h)
    expect = np.where(safe >= 32, 32, np.where(safe >= 16, 16,
                                               np.where(safe >= 8, 8, 0)))
    np.testing.assert_array_equal(k, expect)
    assert k[3] == 0 and (k > 0).sum() >= 8, (k, outcome)
    assert np.all(k * h <= 5.5 + 1e-9)
    k_jax = convert.state_from_reference(jhl)["z_block"]
    assert np.all(k_jax <= k) and np.any(k_jax > 0)


# ---------------------------------------------------------------------------
# log L on the dark precision mock
# ---------------------------------------------------------------------------

def _jax_full(port_data, empty: bool, **cosmo_config):
    """The JAX 'full' object on the port mock's arrays (binning=False:
    events and samples are already multiples of 8 and 128), without a
    selection function where the data has no injections; ``cosmo_config``
    goes to ``FLRW.create``."""
    from chimera_tpu import HyperLikelihood as JHL
    from chimera_tpu import SelectionFunction as JSel
    from chimera_tpu.catalog import DVdzCompleteness
    from chimera_tpu.catalog import EmptyCatalog as JEmpty
    from chimera_tpu.catalog.pixelated import PixelatedCatalog
    from chimera_tpu.data.structs import ThetaInjDet, ThetaPEDet
    from chimera_tpu.models import (FLRW, MadauDickinsonRate, Population,
                                    PowerLawPeak)

    cat, z_grids, gal_cat, inj, n_gen = port_data
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    theta = ThetaPEDet(**{f: j(getattr(cat, f)) for f in (
        "m1det", "m2det", "dL", "pe_prior", "ra", "dec", "opt_nsides",
        "pixels_opt_nsides", "ra_pix", "dec_pix", "gw_loc2d_pdf",
        "pixels_pe_opt_nside", "pixel_mask")})
    jgc = JEmpty() if empty else PixelatedCatalog(
        p_cat=j(gal_cat.p_cat), P_compl=j(gal_cat.P_compl),
        pixel_mask=j(gal_cat.pixel_mask), n_gal=j(gal_cat.n_gal),
        completeness=DVdzCompleteness.create(z_range=(0.0, 3.0), kind="step"))
    pop = Population.create(FLRW.create(H0=70.0, Om0=0.25, **cosmo_config),
                            PowerLawPeak.create(),
                            MadauDickinsonRate.create(), gal_cat=jgc)
    sel = None if inj is None else JSel.create(
        ThetaInjDet(**{f: j(getattr(inj, f)) for f in
                       ("m1det", "m2det", "dL", "p_draw")}), n_gen)
    return JHL.create(theta, j(z_grids), pop, sel, kind="full", binning=False)


@pytest.fixture(scope="module")
def dark_cases():
    """Per catalog (pixelated, empty): the JAX object and its log L at H0S."""
    port_data = chip_smoke.parity_dark_mock(torch.device("cpu"))
    out = {}
    for name in ("pixelated", "empty"):
        jhl = _jax_full(port_data, name == "empty")
        ll = np.asarray(jhl.log_like_batch({"H0": jnp.asarray(H0S)}))
        assert np.all(np.isfinite(ll))
        out[name] = (jhl, ll)
    return port_data, out


def _port_create(port_data, empty: bool):
    cat, z_grids, gal_cat, inj, n_gen = port_data
    pop = chip_smoke.population(F64, None if empty else gal_cat,
                                torch.device("cpu"))
    if empty:
        pop = type(pop).create(pop.cosmo, pop.mass, pop.rate, gal_cat=EmptyCatalog())
    return HyperLikelihood.create(cat, z_grids, pop,
                                  SelectionFunction.create(inj, n_gen),
                                  kind="full", kernel="epan")


@pytest.mark.parametrize("name", ["pixelated", "empty"])
def test_from_state_matches_reference(dark_cases, name):
    """The JAX object's plan (8 events at K = 8, 8 dense) carried by
    ``from_state``: log L within 1e-10, relative."""
    _, cases = dark_cases
    jhl, expect = cases[name]
    hl = HyperLikelihood.from_state(convert.state_from_reference(jhl), "cpu",
                                    F64)
    assert hl.kernel == "gauss" and hl.kind == "full"
    assert sorted(hl.z_block.tolist()) == [0] * 8 + [8] * 8
    got = hl.log_like_batch({"H0": torch.as_tensor(H0S)}).numpy()
    np.testing.assert_allclose(got, expect, rtol=1e-10, atol=0)


@pytest.mark.parametrize("name", ["pixelated", "empty"])
def test_create_matches_reference_create(dark_cases, name):
    """The port's own ``create`` (its plan, 'epan' asked and the Gaussian
    kernel taken) against the JAX package's ``create``: within 5e-9, the
    bar at which tests/test_ops.py holds the recurrence to the dense
    sweep."""
    port_data, cases = dark_cases
    hl = _port_create(port_data, name == "empty")
    assert hl.kernel == "gauss" and np.any(hl.z_block.numpy() > 0)
    got = hl.log_like_batch({"H0": torch.as_tensor(H0S)}).numpy()
    np.testing.assert_allclose(got, cases[name][1], rtol=5e-9, atol=0)


def test_gradient_matches_jax_grad(dark_cases):
    """d log L / d(H0, Om0) on the CPU (autograd through the plain
    version) against ``jax.grad`` of the JAX object, empty catalog, two λ:
    within 1e-9 relative of each parameter's largest.  The gradient's
    compile is most of this file's time whatever the data's size: its
    cosmology's Chebyshev series are unrolled, so they are of degree 16
    here (the same in the port, which ``from_state`` carries), and the JAX
    object is an argument of the jitted gradient, not a constant of it."""
    from chimera_tpu.likelihood import log_hyperlikelihood_batch

    port_data, _ = dark_cases
    jhl = _jax_full(port_data, True, cheb_deg=16)
    h0, om0 = np.array([65.0, 75.0]), np.array([0.25, 0.3])
    expect = jax.jit(jax.grad(lambda m, h, o: jnp.sum(log_hyperlikelihood_batch(
        m, {"H0": h, "Om0": o})), argnums=(1, 2)))(jhl, jnp.asarray(h0),
                                                  jnp.asarray(om0))
    hl = HyperLikelihood.from_state(convert.state_from_reference(jhl), "cpu", F64)
    h, o = _t(h0).requires_grad_(), _t(om0).requires_grad_()
    got = torch.autograd.grad(hl.log_like_batch({"H0": h, "Om0": o}).sum(), (h, o))
    for g, e in zip(got, expect):
        e = np.asarray(e)
        assert np.all(np.isfinite(e))
        np.testing.assert_allclose(g.numpy(), e, rtol=0, atol=1e-9 * np.abs(e).max())


def test_emulated_card_full_batch(k5_host, dark_cases, monkeypatch):
    """The pixelated case through ``lattice_kde3d``'s CUDA branch on CPU
    tensors with K5's host emulation as the launch: one K5 launch a batch,
    log L within 1e-10 of the plain version's; with tensors that require
    grad the card's branch raises (K5 has no adjoint kernel)."""
    port_data, _ = dark_cases
    hl = _port_create(port_data, False)
    h0 = torch.as_tensor(H0S)
    expect = hl.log_like_batch({"H0": h0})
    _emulate_k5(monkeypatch, k5_host)
    before = launch_counts()
    got = hl.log_like_batch({"H0": h0})
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == \
        {k: int(k == "K5") for k in after}
    np.testing.assert_allclose(got.numpy(), expect.numpy(), rtol=1e-10, atol=0)
    with pytest.raises(NotImplementedError, match="item 16"):
        hl.log_like_batch({"H0": h0.clone().requires_grad_()})


from chimera_tpu.ops import kde as jkde  # noqa: E402
