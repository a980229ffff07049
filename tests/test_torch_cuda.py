"""The hand-written CUDA kernels of the PyTorch port, on the card: K1a
(spectral) and its adjoint K3, K1c and K2 (dark siren: K1c on logical rows
a warp a row, K2's pair loop pruned, both repeating bit for bit), the
effective-grid modes K1b and K1d and the batched KDE K4 (the reference's
binned defaults), K3 in the modes of K1b, K1c and K1d and the
rows-contraction adjoint K2b (the dark-siren and effective-grid
gradients), the contract pass K1e and K4's adjoint K4b (the binned
gradient), the 3-D lattice KDE K5 of kind 'full' and the ensemble sampler
on it.

Every test here needs a CUDA card and nvcc (marker ``cuda``) and skips
without one.  The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Inputs are port-generated mock data (float64 on the CPU, moved to the card);
the reference is the kernel's plain PyTorch version on the same inputs."""

import copy

import pytest
import torch

from chimera_tpu_torch import HyperLikelihood, SelectionFunction
from chip_smoke import (contract_inputs, grad_compare, mode_inputs, row_rel,
                        rows_inputs)
from chimera_tpu_torch.data.mock import make_mock_catalog, make_mock_injections
from chimera_tpu_torch.models import (FLRW, MadauDickinsonRate, Population,
                                      PowerLawPeak, compute_z_grids)
from chimera_tpu_torch.ops.cuda import launch_counts
from chimera_tpu_torch.ops.cuda.fused import (fused_row_stats,
                                              fused_row_stats_plain,
                                              fused_weights_kde,
                                              fused_weights_kde_adjoint,
                                              fused_weights_kde_adjoint_plain,
                                              fused_weights_kde_plain,
                                              pack_params)
from chimera_tpu_torch.ops.cuda.rows import (fused_rows_contract,
                                             fused_rows_contract_adjoint,
                                             fused_rows_contract_adjoint_plain,
                                             fused_rows_contract_plain)

H0S = [62.0, 70.0, 78.0]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand-written CUDA kernels)")
    return torch.device("cuda", 0)


def _spectral_inputs(dead_event: bool):
    pop = Population.create(FLRW.create(device="cpu"),
                            PowerLawPeak.create(device="cpu"),
                            MadauDickinsonRate.create(device="cpu"))
    gen = torch.Generator().manual_seed(7)
    cat = make_mock_catalog(gen, pop, n_events=16, n_samples=256)
    inj, n_gen = make_mock_injections(gen, pop, n_generated=20_000)
    z_grids = compute_z_grids(pop.cosmo, cat, cosmo_prior={"H0": [40.0, 120.0]},
                              z_int_res=64)
    if dead_event:
        prior = cat.pe_prior.clone()
        prior[5] = torch.inf
        cat = cat.update(pe_prior=prior)
    return cat, z_grids, pop, SelectionFunction.create(inj, n_gen)


def _spectral_hl(dead_event: bool, **config):
    config = {"binning": False, "cut_grid": None, **config}
    return HyperLikelihood.create(*_spectral_inputs(dead_event), **config)


@pytest.fixture(scope="module")
def cpu_hl():
    """16 events x 256 samples x 64-point grids, 20k generated injections,
    float64 on the CPU; event 5 has zero weight (infinite PE prior)."""
    return _spectral_hl(dead_event=True)


@pytest.fixture(scope="module")
def live_cpu_hl():
    """The same mock with every event alive."""
    return _spectral_hl(dead_event=False)


def _kernel_args(hl):
    pop_b = hl.population.update_batch({"H0": H0S})
    return (hl.m1det, hl.m2det, hl.dL, hl.inv_pe_prior, pop_b.cosmo,
            pop_b.mass, hl.z_grids)


@pytest.mark.parametrize("dtype,den_tol,stat_tol",
                         [(torch.float64, 1e-10, 1e-10),
                          (torch.float32, 1e-4, 1e-5)])
@pytest.mark.parametrize("kernel,bw_method",
                         [("epan", None), ("gauss", None), ("epan", "silverman"),
                          ("epan", 0.3)])
def test_kernel_matches_plain(cuda, cpu_hl, dtype, den_tol, stat_tol, kernel,
                              bw_method):
    """den within den_tol of each row's maximum, stats within stat_tol
    relative (float32: the terms are non-negative, so only the order of the
    S-term sums differs); the dead event is left out."""
    args = _kernel_args(copy.deepcopy(cpu_hl).to(device=cuda, dtype=dtype))
    before = fused_weights_kde.launches
    den, st = fused_weights_kde(*args, kernel=kernel, bw_method=bw_method)
    den_p, st_p = fused_weights_kde_plain(*args, kernel=kernel,
                                          bw_method=bw_method)
    torch.cuda.synchronize()
    assert fused_weights_kde.launches == before + 1
    live = torch.ones(den.shape[1], dtype=torch.bool, device=cuda)
    live[5] = False
    row_max = den_p.abs().amax(dim=-1, keepdim=True)
    assert ((den - den_p).abs() / row_max)[:, live].max().item() <= den_tol
    for k in ("norms", "neff", "bandwidth", "sum_w", "sum_w2"):
        rel = ((st[k] - st_p[k]).abs() / st_p[k].abs())[:, live].max().item()
        assert rel <= stat_tol, (k, rel)
    assert torch.all(st["lo"] == 0) and torch.all(st["ub"] == 0)


def test_dead_event_is_gated(cuda, cpu_hl):
    """The kernel keeps the raw row statistics (NaN on the dead row); the
    N_eff gate still gives that event a zero numerator, and every other
    numerator matches the CPU path."""
    card = copy.deepcopy(cpu_hl).to(cuda)
    expect = cpu_hl.batch_numerators(cpu_hl.population.update_batch({"H0": H0S}))
    got = card.batch_numerators(card.population.update_batch({"H0": H0S})).cpu()
    assert torch.all(got[:, 5] == 0.0)
    torch.testing.assert_close(got, expect, rtol=1e-10, atol=0)


def test_log_like_batch_matches_cpu(cuda, cpu_hl):
    card = copy.deepcopy(cpu_hl).to(cuda)
    before = fused_weights_kde.launches
    got = card.log_like_batch({"H0": H0S}).cpu()
    assert fused_weights_kde.launches == before + 1
    torch.testing.assert_close(got, cpu_hl.log_like_batch({"H0": H0S}),
                               rtol=1e-10, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda, cpu_hl):
    args = list(_kernel_args(copy.deepcopy(cpu_hl).to(cuda)))
    with pytest.raises(TypeError):
        fused_weights_kde(*[a.half() if isinstance(a, torch.Tensor) else a
                            for a in args])
    with pytest.raises(ValueError, match="grids"):
        fused_weights_kde(*args[:6], args[6][:-1])
    too_many = 16_384  # 2 x S doubles beyond the 227 KB shared-memory limit
    big = [torch.ones((2, too_many), dtype=torch.float64, device=cuda)] * 4
    with pytest.raises(ValueError, match="shared memory"):
        fused_weights_kde(*big, args[4], args[5], args[6][:2])


# ---------------------------------------------------------------------------
# gradients: the adjoint kernel K3 and the samplers
# ---------------------------------------------------------------------------

LAMBDA = {"H0": [66.0, 70.0, 75.0], "Om0": [0.22, 0.25, 0.31],
          "mu_g": [32.0, 34.0, 35.5]}


def _adjoint_args(hl, seed=3):
    pop_b = hl.population.update_batch(LAMBDA)
    dt, dev = hl.dL.dtype, hl.dL.device
    series, params = pack_params(pop_b.cosmo, pop_b.mass, 3, dt)
    gen = torch.Generator().manual_seed(seed)
    e, g = hl.z_grids.shape
    ct_den = torch.randn((3, e, g), generator=gen, dtype=torch.float64)
    ct_stats = torch.randn((3, e, 8), generator=gen, dtype=torch.float64)
    return (hl.m1det, hl.m2det, hl.dL, hl.inv_pe_prior, hl.z_grids, series,
            params, ct_den.to(dev, dt), ct_stats.to(dev, dt), pop_b.cosmo,
            pop_b.mass)


def _grad(hl, device, dtype=torch.float64):
    x = torch.tensor([LAMBDA[k] for k in LAMBDA], dtype=dtype, device=device).T
    x = x.contiguous().requires_grad_()
    ll = hl.log_like_batch({k: x[:, i] for i, k in enumerate(LAMBDA)})
    return torch.autograd.grad(ll.sum(), x)[0].cpu()


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
@pytest.mark.parametrize("kernel,bw_method",
                         [("epan", None), ("gauss", None), ("epan", "silverman"),
                          ("gauss", 0.3)])
def test_adjoint_kernel_matches_plain(cuda, cpu_hl, dtype, tol, kernel, bw_method):
    """K3 against autograd through the plain version, random cotangents
    for den and every stat (the dead event's row too): each gradient row
    within tol of its largest entry; a second launch gives equal bits."""
    args = _adjoint_args(copy.deepcopy(cpu_hl).to(device=cuda, dtype=dtype))
    before = fused_weights_kde_adjoint.launches
    got = fused_weights_kde_adjoint(*args, kernel, bw_method)
    assert fused_weights_kde_adjoint.launches == before + 1
    again = fused_weights_kde_adjoint(*args, kernel, bw_method)
    expect = fused_weights_kde_adjoint_plain(*args, kernel, bw_method)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.float64 and got[1].dtype == dtype
    assert got[2] is None
    for g, a, e in zip(got[:2], again[:2], expect[:2]):
        assert torch.equal(g, a)
        assert torch.all(torch.isfinite(g))
        row_max = e.abs().amax(dim=1, keepdim=True)
        assert ((g - e).abs() / row_max).max().item() <= tol


def test_gradient_on_card_matches_cpu(cuda, live_cpu_hl):
    """d log L / d(H0, Om0, mu_g) on the card (K1a forward, K3 backward: one
    launch each) against plain autograd on the CPU."""
    card = copy.deepcopy(live_cpu_hl).to(cuda)
    k1a, k3 = fused_weights_kde.launches, fused_weights_kde_adjoint.launches
    got = _grad(card, cuda)
    assert (fused_weights_kde.launches, fused_weights_kde_adjoint.launches) \
        == (k1a + 1, k3 + 1)
    expect = _grad(live_cpu_hl, "cpu")
    assert torch.all(torch.isfinite(expect))
    torch.testing.assert_close(got, expect, rtol=1e-9, atol=0)
    got32 = _grad(copy.deepcopy(live_cpu_hl).to(cuda, torch.float32), cuda,
                  torch.float32).double()
    assert ((got32 - expect).abs() / expect.abs().amax(dim=0)).max() <= 1e-3


def test_gated_event_gradient_matches_cpu(cuda, cpu_hl):
    """The gated event puts 0 / 0 into the cosmology's gradient on the CPU
    (as in the JAX package); the card gives NaN in the same entries and the
    same numbers in the others."""
    expect = _grad(cpu_hl, "cpu")
    got = _grad(copy.deepcopy(cpu_hl).to(cuda), cuda)
    assert torch.isnan(expect[:, 0]).all() and torch.isfinite(expect[:, 2]).all()
    assert torch.equal(torch.isnan(got), torch.isnan(expect))
    torch.testing.assert_close(got[:, 2], expect[:, 2], rtol=1e-9, atol=0)


def test_adjoint_refusals(cuda, cpu_hl):
    card = copy.deepcopy(cpu_hl).to(cuda)
    args = list(_adjoint_args(card))
    with pytest.raises(ValueError, match="ct_den"):
        fused_weights_kde_adjoint(*args[:7], args[7][:, :, :-1], *args[8:])
    too_many = 8_192  # 4 x S doubles beyond the 227 KB shared-memory limit
    big = [torch.ones((2, too_many), dtype=torch.float64, device=cuda)] * 4
    with pytest.raises(ValueError, match="shared memory"):
        fused_weights_kde_adjoint(*big, args[4][:2], args[5], args[6],
                                  args[7][:, :2], args[8][:, :2], *args[9:])


def test_hmc_repeats_bit_for_bit(cuda, live_cpu_hl):
    """Two runs under the same generator seed give the same samples (the
    event reduction in K3 has a fixed order), each gradient evaluation one
    K1a and one K3 launch."""
    from chimera_tpu_torch.inference import sample_hyperposterior

    card = copy.deepcopy(live_cpu_hl).to(cuda, torch.float32)
    bounds = {"H0": (40.0, 120.0), "mu_g": (25.0, 45.0)}

    def run():
        k1a, k3 = fused_weights_kde.launches, fused_weights_kde_adjoint.launches
        samples, stats = sample_hyperposterior(
            torch.Generator(device=cuda).manual_seed(5), card, ["H0", "mu_g"],
            bounds, {"H0": 70.0, "mu_g": 34.0}, n_chains=4, n_warmup=6,
            n_samples=6, n_leapfrog=3)
        launched = (fused_weights_kde.launches - k1a,
                    fused_weights_kde_adjoint.launches - k3)
        return samples, launched

    first, launched = run()
    assert launched[0] == launched[1] >= 13
    second, _ = run()
    for k, lo_hi in bounds.items():
        assert first[k].shape == (6, 4) and first[k].device.type == "cuda"
        assert torch.all((first[k] > lo_hi[0]) & (first[k] < lo_hi[1]))
        assert torch.equal(first[k], second[k])


# ---------------------------------------------------------------------------
# the dark-siren kernels
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dark_inputs():
    """The inputs of a 'marginalized' likelihood on port-made data, float64
    on the CPU: 16
    events x 256 samples, nside {8, 16}, ~6 pixels per event, 64-point
    grids, 3000 background galaxies, 20k generated injections.  Every sample
    of event 3's first pixel has zero weight (infinite PE prior): a dead
    pixel."""
    from chimera_tpu_torch.catalog import DVdzCompleteness
    from chimera_tpu_torch.catalog.build import build_pixelated_catalog
    from chimera_tpu_torch.data.mock import make_mock_galaxies
    from chimera_tpu_torch.data.pixelize import pixelize_gw_catalog

    pop = Population.create(FLRW.create(device="cpu"),
                            PowerLawPeak.create(device="cpu"),
                            MadauDickinsonRate.create(device="cpu"))
    gen = torch.Generator().manual_seed(11)
    cat, truths = make_mock_catalog(gen, pop, n_events=16, n_samples=256,
                                    sigma_sky_rad=0.03, oversample=400,
                                    return_truths=True)
    cat = pixelize_gw_catalog(cat, nside_list=[8, 16], mean_npixels_event=6)
    prior = cat.pe_prior.clone()
    prior[3][cat.pixels_pe_opt_nside[3] == cat.pixels_opt_nsides[3, 0]] = torch.inf
    cat = cat.update(pe_prior=prior)
    z_grids = compute_z_grids(pop.cosmo, cat, cosmo_prior={"H0": [40.0, 120.0]},
                              z_int_res=64)
    gal = make_mock_galaxies(gen, pop, truths, n_background=3000)
    gc = build_pixelated_catalog(
        gal, cat, z_grids, pop.cosmo,
        DVdzCompleteness.create(z_range=(0.0, 3.0), device="cpu"))
    inj, n_gen = make_mock_injections(gen, pop, n_generated=20_000)
    pop = Population.create(pop.cosmo, pop.mass, pop.rate, gal_cat=gc)
    return cat, z_grids, pop, SelectionFunction.create(inj, n_gen)


@pytest.fixture(scope="module")
def dark_cpu_hl(dark_inputs):
    """The dark-siren flagship configuration on those inputs."""
    return HyperLikelihood.create(*dark_inputs, kind="marginalized",
                                  binning=False, cut_grid=None)


def _dark_args(hl, kernel):
    pop_b = hl.population.update_batch({"H0": H0S})
    stats_args = (hl.pix_m1det, hl.pix_m2det, hl.pix_dL, hl.pix_inv_pe_prior,
                  pop_b.cosmo, pop_b.mass, hl.pix_n_real, hl.pix_dl_fill,
                  hl.n_samples)
    f1, f2, _ = hl.lambda_factors(pop_b)
    hs = hl.row_scales(fused_row_stats_plain(*stats_args))
    rows_args = (hl.row_m1det, hl.row_m2det, hl.row_dL, hl.row_inv_pe_prior,
                 pop_b.cosmo, pop_b.mass, hl.z_grids, hs, hl.row_s1,
                 hl.row_s2, f1, f2, kernel)
    return stats_args, rows_args


@pytest.mark.parametrize("dtype,stat_tol,r_tol",
                         [(torch.float64, 1e-10, 1e-10),
                          (torch.float32, 1e-5, 1e-4)])
@pytest.mark.parametrize("kernel", ["epan", "gauss"])
def test_dark_kernels_match_plain(cuda, dark_cpu_hl, dtype, stat_tol, r_tol,
                                  kernel):
    """K1c stats relative on the pixel rows with weight (lo, ub relative to
    the largest ub), K2 r within r_tol of each λ's largest |r|, on the same
    inputs; one launch each."""
    stats_args, rows_args = _dark_args(
        copy.deepcopy(dark_cpu_hl).to(device=cuda, dtype=dtype), kernel)
    before = (fused_row_stats.launches, fused_rows_contract.launches)
    st, st_p = fused_row_stats(*stats_args), fused_row_stats_plain(*stats_args)
    r, r_p = fused_rows_contract(*rows_args), fused_rows_contract_plain(*rows_args)
    torch.cuda.synchronize()
    assert (fused_row_stats.launches, fused_rows_contract.launches) == \
        (before[0] + 1, before[1] + 1)
    live = st_p["sum_w"] > 0
    ub_max = st_p["ub"].abs().max()
    for k in ("lo", "ub", "norms", "neff", "bandwidth", "sum_w", "sum_w2"):
        ref = ub_max if k in ("lo", "ub") else st_p[k].abs()[live]
        rel = ((st[k] - st_p[k]).abs()[live] / ref).max().item()
        assert rel <= stat_tol, (k, rel)
    r_max = r_p.abs().amax(dim=(1, 2), keepdim=True)
    assert ((r - r_p).abs() / r_max).max().item() <= r_tol


def test_dead_pixel_row_is_exactly_zero(cuda, dark_cpu_hl):
    """The dead pixel: K1c gives zero weight sums (and the raw NaN
    bandwidth), the scale guard gives 0, and K2 writes exact zeros."""
    hl = copy.deepcopy(dark_cpu_hl).to(cuda)
    stats_args, _ = _dark_args(hl, "epan")
    st = fused_row_stats(*stats_args)
    dead = 3 * hl.n_pixels
    assert torch.all(st["sum_w"][:, dead] == 0)
    assert torch.all(torch.isnan(st["bandwidth"][:, dead]))
    pop_b = hl.population.update_batch({"H0": H0S})
    f1, f2, _ = hl.lambda_factors(pop_b)
    hs = hl.row_scales(st)
    rows = hl.row_pixel == dead
    assert rows.any() and torch.all(hs[:, rows, 1] == 0)
    r = fused_rows_contract(hl.row_m1det, hl.row_m2det, hl.row_dL,
                            hl.row_inv_pe_prior, pop_b.cosmo, pop_b.mass,
                            hl.z_grids, hs, hl.row_s1, hl.row_s2, f1, f2)
    assert torch.all(r[:, rows] == 0)
    assert torch.all(r[:, ~rows].abs().amax(dim=(1, 2)) > 0)


def test_dark_log_like_batch_matches_cpu(cuda, dark_cpu_hl):
    card = copy.deepcopy(dark_cpu_hl).to(cuda)
    before = (fused_row_stats.launches, fused_rows_contract.launches)
    got = card.log_like_batch({"H0": H0S}).cpu()
    assert (fused_row_stats.launches, fused_rows_contract.launches) == \
        (before[0] + 1, before[1] + 1)
    expect = dark_cpu_hl.log_like_batch({"H0": H0S})
    assert torch.all(torch.isfinite(expect))
    torch.testing.assert_close(got, expect, rtol=1e-10, atol=0)


@pytest.mark.parametrize("path", ["dark", "dark_cut", "spectral_cut"])
def test_dark_gradient_on_card_matches_cpu(cuda, dark_inputs, path):
    """d log L / d(H0, Om0, mu_g) on the card against plain autograd on the
    CPU, float64, 1e-9 relative: the dark flagship (K1c, K2, then K3 stats +
    logical rows and K2b), 'marginalized' with cut_grid (K1c, K1d, then K3
    ext and K3 stats) and 'approximate' with cut_grid (K1b, then K3 on the
    effective grids), each kernel launched once; float32 within 1e-2 of
    each parameter's largest slope (Epanechnikov's slope jumps at the
    support's edge)."""
    config = {"dark": ("marginalized", None), "dark_cut": ("marginalized", 2.0),
              "spectral_cut": ("approximate", 2.0)}[path]
    launched = {"dark": {"K1c": 1, "K2": 1, "K3c": 1, "K2b": 1},
                "dark_cut": {"K1c": 1, "K1d": 1, "K3c": 1, "K3d": 1},
                "spectral_cut": {"K1b": 1, "K3b": 1}}[path]
    hl = HyperLikelihood.create(*dark_inputs, kind=config[0], binning=False,
                                cut_grid=config[1])
    card = copy.deepcopy(hl).to(cuda)
    before = launch_counts()
    got = _grad(card, cuda)
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == \
        {k: launched.get(k, 0) for k in after}
    expect = _grad(hl, "cpu")
    assert torch.all(torch.isfinite(expect))
    torch.testing.assert_close(got, expect, rtol=1e-9, atol=0)
    got32 = _grad(copy.deepcopy(hl).to(cuda, torch.float32), cuda,
                  torch.float32).double()
    assert ((got32 - expect).abs() / expect.abs().amax(dim=0)).max() <= 1e-2


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
@pytest.mark.parametrize("mode,kernel,counter", [
    ("stats_logical", "epan", "launches_c"), ("stats", "epan", "launches_c"),
    ("auto", "epan", "launches_b"), ("auto", "gauss", "launches_b"),
    ("ext", "epan", "launches_d"), ("ext", "gauss", "launches_d")])
def test_adjoint_modes_match_plain(cuda, dark_cpu_hl, dtype, tol, mode, kernel,
                                   counter):
    """K3 in the modes of K1c (logical pixel rows with a dead pixel, and the
    events), K1b and K1d against autograd through the plain version, random
    cotangents for den and every stat: each gradient row (d_ext's too)
    within tol of its largest entry, one launch on the mode's counter, equal
    bits on a second launch."""
    hl = copy.deepcopy(dark_cpu_hl).to(device=cuda, dtype=dtype)
    args, kw = mode_inputs(hl, mode, LAMBDA, 4, kernel, n_grid=32)
    before = getattr(fused_weights_kde_adjoint, counter)
    got = fused_weights_kde_adjoint(*args, **kw)
    assert getattr(fused_weights_kde_adjoint, counter) == before + 1
    again = fused_weights_kde_adjoint(*args, **kw)
    expect = fused_weights_kde_adjoint_plain(*args, **kw)
    torch.cuda.synchronize()
    assert (got[2] is None) == (mode != "ext")
    for g, a, e in zip(got, again, expect):
        if g is not None:
            assert torch.equal(g, a) and torch.all(torch.isfinite(g))
            assert row_rel(g, e) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
@pytest.mark.parametrize("kernel", ["epan", "gauss"])
def test_rows_adjoint_matches_plain(cuda, dark_cpu_hl, dtype, tol, kernel):
    """K2b against autograd through ``fused_rows_contract_plain`` on the
    main path's inputs, random cotangents of r: d_series, d_params, d_hs,
    d_f1, d_f2 within tol of each row's largest entry; the dead pixel's rows
    and the padding rows get exact zeros; one launch, equal bits on a
    second."""
    hl = copy.deepcopy(dark_cpu_hl).to(device=cuda, dtype=dtype)
    args = rows_inputs(hl, {"H0": H0S}, 6, kernel)
    before = fused_rows_contract_adjoint.launches
    got = fused_rows_contract_adjoint(*args)
    assert fused_rows_contract_adjoint.launches == before + 1
    again = fused_rows_contract_adjoint(*args)
    expect = fused_rows_contract_adjoint_plain(*args)
    torch.cuda.synchronize()
    zero = (args[7][..., 1] == 0) | ~(hl.row_inv_pe_prior > 0).any(dim=1)
    assert zero.any() and torch.all(got[2][zero] == 0)
    for g, a, e in zip(got, again, expect):
        assert torch.equal(g, a) and torch.all(torch.isfinite(g))
        assert row_rel(g, e) <= tol


def test_dark_hmc_repeats_bit_for_bit(cuda, dark_cpu_hl):
    """HMC on the dark flagship configuration, float32: two runs under the
    same generator seed give the same samples; each gradient evaluation is
    one K2b and one K3 (stats + logical) launch."""
    from chimera_tpu_torch.inference import sample_hyperposterior

    card = copy.deepcopy(dark_cpu_hl).to(cuda, torch.float32)
    bounds = {"H0": (40.0, 120.0), "Om0": (0.05, 0.6)}

    def run():
        before = launch_counts()
        samples, _ = sample_hyperposterior(
            torch.Generator(device=cuda).manual_seed(5), card, ["H0", "Om0"],
            bounds, {"H0": 70.0, "Om0": 0.25}, n_chains=4, n_warmup=3,
            n_samples=3, n_leapfrog=3)
        after = launch_counts()
        return samples, after["K2b"] - before["K2b"], after["K3c"] - before["K3c"]

    first, k2b, k3c = run()
    assert k2b == k3c >= 7
    second, _, _ = run()
    for k, lo_hi in bounds.items():
        assert torch.all((first[k] > lo_hi[0]) & (first[k] < lo_hi[1]))
        assert torch.equal(first[k], second[k])


def test_catalog_build_repeats_bit_for_bit(cuda):
    """The pixelated catalog built twice on the card from the same data, in
    float64: the same bits, as each voxel's galaxies are summed in a fixed
    order (by atomics, the dark flagship's p_cat differed in the last bits
    at 6 % of its entries from one build to the next)."""
    from chimera_tpu_torch.catalog import DVdzCompleteness
    from chimera_tpu_torch.catalog.build import build_pixelated_catalog
    from chimera_tpu_torch.data.mock import make_mock_galaxies
    from chimera_tpu_torch.data.pixelize import pixelize_gw_catalog
    from chip_smoke import population

    pop = population(torch.float64, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(13)
    cat, truths = make_mock_catalog(gen, pop, n_events=64, n_samples=256,
                                    sigma_sky_rad=0.03, oversample=400,
                                    return_truths=True)
    cat = pixelize_gw_catalog(cat, nside_list=[8, 16], mean_npixels_event=6)
    z_grids = compute_z_grids(pop.cosmo, cat, cosmo_prior={"H0": [40.0, 120.0]},
                              z_int_res=200)
    gal = make_mock_galaxies(gen, pop, truths, n_background=50_000)
    compl = DVdzCompleteness.create(z_range=(0.0, 3.0), kind="step",
                                    device=cuda, dtype=torch.float64)
    first, second = (build_pixelated_catalog(gal, cat, z_grids, pop.cosmo, compl,
                                             z_err=0.01).p_cat for _ in range(2))
    assert torch.count_nonzero(first) > 0
    assert torch.equal(first.view(torch.int64), second.view(torch.int64))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int64 if t.element_size() == 8 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kernel", ["epan", "gauss"])
def test_dark_forward_repeats_bit_for_bit(cuda, dark_cpu_hl, dtype, kernel):
    """K1c on logical rows (a warp a row) and K2 (its Epanechnikov pair loop
    pruned) give the same bits on a second launch with the same inputs."""
    stats_args, rows_args = _dark_args(
        copy.deepcopy(dark_cpu_hl).to(device=cuda, dtype=dtype), kernel)
    first, second = (fused_row_stats(*stats_args) for _ in range(2))
    for k in first:
        assert torch.equal(_bits(first[k]), _bits(second[k])), k
    r1, r2 = (fused_rows_contract(*rows_args) for _ in range(2))
    assert r1.abs().amax() > 0 and torch.equal(_bits(r1), _bits(r2))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kernel", ["epan", "gauss"])
def test_dark_cut_gradient_repeats_bit_for_bit(cuda, dark_inputs, dtype, kernel):
    """The dark cut_grid path's value and gradient (K1c and K1d forward; K3d,
    its phase B on the slots that hold samples and pruned, and K3c
    backward) gives the same bits on a second call with the same inputs:
    every sum in a fixed order, no atomics."""
    hl = HyperLikelihood.create(*dark_inputs, kind="marginalized",
                                binning=False, cut_grid=2.0, kernel=kernel)
    card = copy.deepcopy(hl).to(cuda, dtype)

    def value_and_grad():
        x = torch.tensor([LAMBDA[k] for k in LAMBDA], dtype=dtype,
                         device=cuda).T.contiguous().requires_grad_()
        ll = card.log_like_batch({k: x[:, i] for i, k in enumerate(LAMBDA)})
        return ll.detach(), torch.autograd.grad(ll.sum(), x)[0]

    before = launch_counts()
    (ll1, g1), (ll2, g2) = value_and_grad(), value_and_grad()
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == \
        {k: 2 * {"K1c": 1, "K1d": 1, "K3c": 1, "K3d": 1}.get(k, 0) for k in after}
    assert torch.all(torch.isfinite(g1)) and g1.abs().amax() > 0
    assert torch.equal(_bits(ll1), _bits(ll2)) and torch.equal(_bits(g1), _bits(g2))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_logical_stats_over_many_waves(cuda, dark_cpu_hl, dtype):
    """K1c on 200 copies of the dark inputs' logical pixel rows (~20 000
    rows x 3 λ: several waves of blocks of 4 rows on the card) gives the
    same stats as the same rows split over two calls at a row that is not
    a block's first, and the same as K1c on the rows once, copy by copy;
    within 1e-10 (float64) or 1e-5 (float32) of the plain version."""
    hl = copy.deepcopy(dark_cpu_hl).to(device=cuda, dtype=dtype)
    pop_b = hl.population.update_batch({"H0": H0S})
    reps = 200
    rows = [t.repeat(reps, 1) for t in (hl.pix_m1det, hl.pix_m2det, hl.pix_dL,
                                        hl.pix_inv_pe_prior)]
    n_real, dl_fill = hl.pix_n_real.repeat(reps), hl.pix_dl_fill.repeat(reps)
    b = rows[0].shape[0]
    assert 3 * b // 4 > 132 * 32  # more blocks than one wave holds (32 an SM)

    def stats(sl):
        return fused_row_stats(*[t[sl] for t in rows], pop_b.cosmo, pop_b.mass,
                               n_real[sl], dl_fill[sl], hl.n_samples)

    whole = stats(slice(None))
    cut = 4 * (b // 8) + 1
    head, tail = stats(slice(0, cut)), stats(slice(cut, None))
    once = fused_row_stats(hl.pix_m1det, hl.pix_m2det, hl.pix_dL,
                           hl.pix_inv_pe_prior, pop_b.cosmo, pop_b.mass,
                           hl.pix_n_real, hl.pix_dl_fill, hl.n_samples)
    plain = fused_row_stats_plain(*rows, pop_b.cosmo, pop_b.mass, n_real,
                                  dl_fill, hl.n_samples)
    live = plain["sum_w"] > 0
    tol = 1e-10 if dtype == torch.float64 else 1e-5
    for k in whole:
        assert torch.equal(_bits(whole[k]), _bits(torch.cat([head[k], tail[k]], dim=1))), k
        assert torch.equal(_bits(whole[k]), _bits(once[k].repeat(1, reps))), k
        ref = plain["ub"].abs().max() if k in ("lo", "ub") else plain[k].abs()[live]
        assert ((whole[k] - plain[k]).abs()[live] / ref).max() <= tol, k


# ---------------------------------------------------------------------------
# K1b, K1d and K4: the reference's defaults and the effective-grid paths
# ---------------------------------------------------------------------------

def _launched(fn, expect: dict):
    """fn() and the check that it launched exactly ``expect``."""
    before = launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == \
        {k: expect.get(k, 0) for k in after}
    return out


def _check_rows(den, st, den_p, st_p, live, tol):
    row_max = den_p.abs().amax(dim=-1, keepdim=True).clamp_min(1e-300)
    assert ((den - den_p).abs() / row_max)[live].max().item() <= tol
    ub_max = st_p["ub"].abs().max()
    for k in ("lo", "ub", "norms", "neff", "bandwidth", "sum_w", "sum_w2"):
        ref = ub_max if k in ("lo", "ub") else st_p[k].abs()
        rel = ((st[k] - st_p[k]).abs() / ref)[live].max().item()
        assert rel <= tol, (k, rel)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
@pytest.mark.parametrize("kernel", ["epan", "gauss"])
def test_k4_matches_plain(cuda, dtype, tol, kernel):
    """K4 on 300 rows of 200 normalized weights (a dead row among them) on
    250- and 500-point grids (the two register tilings)."""
    from chimera_tpu_torch.ops.cuda.kde import kde1d_grid, kde1d_grid_plain

    gen = torch.Generator().manual_seed(4)
    z = 1.0 + 0.2 * torch.randn((300, 200), generator=gen, dtype=torch.float64)
    w = torch.rand((300, 200), generator=gen, dtype=torch.float64)
    w[7] = 0.0
    w = w / w.sum(dim=1, keepdim=True).clamp_min(1e-300)
    h = 0.02 + 0.08 * torch.rand(300, generator=gen, dtype=torch.float64)
    for g in (250, 500):
        grids = torch.linspace(0.3, 1.8, g, dtype=torch.float64)[None] \
            * (0.8 + 0.4 * torch.rand((300, 1), generator=gen, dtype=torch.float64))
        args = [t.to(device=cuda, dtype=dtype) for t in (z, w, grids, h)]
        out = _launched(lambda: kde1d_grid(*args, kernel=kernel), {"K4": 1})
        expect = kde1d_grid_plain(*args, kernel=kernel)
        row_max = expect.abs().amax(dim=1)
        live = row_max > 0
        assert not live[7] and live.sum() == 299
        assert ((out - expect).abs().amax(dim=1)[live] / row_max[live]).max() <= tol
        assert torch.all(out[7] == 0)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
@pytest.mark.parametrize("kernel", ["epan", "gauss"])
def test_k1b_matches_plain(cuda, cpu_hl, dtype, tol, kernel):
    """K1b: each (λ, event)'s own 32-point effective grid, 'norms'; the
    dead event is left out."""
    args = _kernel_args(copy.deepcopy(cpu_hl).to(device=cuda, dtype=dtype))[:6]
    kw = {"kernel": kernel, "cut_grid": 2.0, "n_grid": 32}
    den, st = _launched(lambda: fused_weights_kde(*args, **kw), {"K1b": 1})
    den_p, st_p = fused_weights_kde_plain(*args, **kw)
    live = torch.ones_like(st_p["sum_w"], dtype=torch.bool)
    live[:, 5] = False
    _check_rows(den, st, den_p, st_p, live, tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
@pytest.mark.parametrize("kernel", ["epan", "gauss"])
def test_k1d_matches_plain(cuda, dark_inputs, dtype, tol, kernel):
    """K1c on the event rows (no logical rows) and K1d on the per-pixel
    logical rows with those bounds, 'unit', on the pixel rows with weight
    (the dead pixel and the padding pixels are left out)."""
    hl = HyperLikelihood.create(*dark_inputs, kind="marginalized",
                                binning=False, cut_grid=2.0)
    hl = copy.deepcopy(hl).to(device=cuda, dtype=dtype)
    pop_b = hl.population.update_batch({"H0": H0S})
    ev_args = (hl.m1det, hl.m2det, hl.dL, hl.inv_pe_prior, pop_b.cosmo,
               pop_b.mass)
    ev = _launched(lambda: fused_row_stats(*ev_args, cut_grid=2.0), {"K1c": 1})
    ev_p = fused_row_stats_plain(*ev_args, cut_grid=2.0)
    for k in ("lo", "ub", "neff", "bandwidth", "sum_w"):
        rel = ((ev[k] - ev_p[k]).abs() / ev_p[k].abs()).max().item()
        assert rel <= tol, (k, rel)
    ext = torch.stack([ev_p["lo"], ev_p["ub"]], dim=-1).repeat_interleave(
        hl.n_pixels, dim=1)
    args = (hl.pix_m1det, hl.pix_m2det, hl.pix_dL, hl.pix_inv_pe_prior,
            pop_b.cosmo, pop_b.mass)
    kw = {"kernel": kernel, "ext_bounds": ext, "n_grid": 32,
          "n_real": hl.pix_n_real, "dl_fill": hl.pix_dl_fill,
          "logical_s": hl.n_samples, "den_scale": "unit"}
    den, st = _launched(lambda: fused_weights_kde(*args, **kw), {"K1d": 1})
    den_p, st_p = fused_weights_kde_plain(*args, **kw)
    live = st_p["sum_w"] > 0
    assert 0.3 < live.float().mean() < 1.0
    _check_rows(den, st, den_p, st_p, live, tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
@pytest.mark.parametrize("kernel", ["epan", "gauss"])
def test_k1d_empty_rows_match_plain(cuda, dark_inputs, dtype, tol, kernel):
    """K1d as the dark cut_grid path launches it (250 grid points: eight
    32-point runs of the pruned loop, a warp a logical row where
    Epanechnikov) on pixel rows among which some hold no sample: the rows
    with weight within ``tol`` of the plain version, the empty rows' stats
    those of no sample (sum_w 0) and their densities NaN (the kernel's raw
    formulas give them a NaN h), a second launch of the same bits."""
    hl = HyperLikelihood.create(*dark_inputs, kind="marginalized",
                                binning=False, cut_grid=2.0)
    hl = copy.deepcopy(hl).to(device=cuda, dtype=dtype)
    pop_b = hl.population.update_batch({"H0": H0S})
    ev = fused_row_stats_plain(hl.m1det, hl.m2det, hl.dL, hl.inv_pe_prior,
                               pop_b.cosmo, pop_b.mass, cut_grid=2.0)
    ext = torch.stack([ev["lo"], ev["ub"]], dim=-1).repeat_interleave(
        hl.n_pixels, dim=1)
    args = (hl.pix_m1det, hl.pix_m2det, hl.pix_dL, hl.pix_inv_pe_prior,
            pop_b.cosmo, pop_b.mass)
    kw = {"kernel": kernel, "ext_bounds": ext, "n_grid": 250,
          "n_real": hl.pix_n_real, "dl_fill": hl.pix_dl_fill,
          "logical_s": hl.n_samples, "den_scale": "unit"}
    den, st = _launched(lambda: fused_weights_kde(*args, **kw), {"K1d": 1})
    again, st2 = _launched(lambda: fused_weights_kde(*args, **kw), {"K1d": 1})
    den_p, st_p = fused_weights_kde_plain(*args, **kw)
    empty = hl.pix_n_real == 0
    assert 0 < int(empty.sum()) < len(empty)
    assert torch.isnan(den[:, empty]).all() and torch.all(st["sum_w"][:, empty] == 0)
    live = st_p["sum_w"] > 0
    assert not live[:, empty].any()
    _check_rows(den, st, den_p, st_p, live, tol)
    assert torch.isfinite(den[live]).all()
    assert torch.equal(_bits(den), _bits(again))
    assert all(torch.equal(_bits(st[k]), _bits(st2[k])) for k in st)


CONFIGS = [
    ("spectral", {"binning": True, "cut_grid": 2.0}, {"K4": 1}),
    ("spectral", {"binning": True, "cut_grid": None}, {"K4": 1}),
    ("spectral", {"binning": False, "cut_grid": 2.0}, {"K1b": 1}),
    ("marginalized", {"binning": True, "cut_grid": 2.0}, {"K4": 1}),
    ("marginalized", {"binning": False, "cut_grid": 2.0}, {"K1c": 1, "K1d": 1}),
    ("approximate", {"binning": True, "cut_grid": 2.0}, {"K4": 1}),
    ("approximate", {"binning": False, "cut_grid": 2.0}, {"K1b": 1}),
    ("approximate", {"binning": False, "cut_grid": None}, {"K1a": 1}),
]


@pytest.mark.parametrize("kind,config,launched", CONFIGS)
def test_configurations_match_cpu(cuda, dark_inputs, kind, config, launched):
    """Every new (kind, binning, cut_grid) path on the card: the launches of
    one batch exactly, and log L within 1e-10 of the CPU's in float64."""
    if kind == "spectral":
        cpu = _spectral_hl(dead_event=False, **config)
    else:
        cpu = HyperLikelihood.create(*dark_inputs, kind=kind, **config)
    card = copy.deepcopy(cpu).to(cuda)
    got = _launched(lambda: card.log_like_batch({"H0": H0S}), launched).cpu()
    expect = cpu.log_like_batch({"H0": H0S})
    assert torch.all(torch.isfinite(expect))
    torch.testing.assert_close(got, expect, rtol=1e-10, atol=0)


def test_reference_defaults_run_on_the_card(cuda):
    """``create(theta, z_grids, pop, sel)`` with no keyword: models built
    without a device live on the card in float32, the likelihood bins (K4
    once), and log L is the CPU's float64 one within 1e-5 (the bar of a
    float32 log L over 16 events)."""
    cat, z_grids, _, sel = _spectral_inputs(dead_event=False)
    card_pop = Population.create(FLRW.create(), PowerLawPeak.create(),
                                 MadauDickinsonRate.create())
    assert card_pop.cosmo.H0.device.type == "cuda"
    hl = HyperLikelihood.create(cat, z_grids, card_pop, sel)
    assert (hl.kind, hl.binning, hl.num_bins, hl.cut_grid) == ("1d", True, 200, 2.0)
    assert hl.dL.device.type == "cuda"
    got = _launched(lambda: hl.log_like_batch({"H0": H0S}), {"K4": 1}).cpu()
    cpu = HyperLikelihood.create(cat, z_grids, Population.create(
        FLRW.create(device="cpu"), PowerLawPeak.create(device="cpu"),
        MadauDickinsonRate.create(device="cpu")), sel)
    assert got.dtype == torch.float32
    expect = cpu.log_like_batch({"H0": H0S})
    assert ((got.double() - expect).abs() / expect.abs()).max() <= 1e-5


def test_new_kernels_refuse_grad(cuda, cpu_hl):
    """The binned path's gradient runs on the card: K4 forward, K4b
    backward (the JAX package has no kernel for it: ``jax.grad`` through
    its Pallas KDE raises), one launch each, within 1e-9 of autograd
    through the plain versions on the CPU in float64; K4 on an input that
    requires grad gives that input its cotangent.  (The kernel without a
    backward is now K1e: ``test_contract_gradient_raises_on_the_card``.)"""
    from chimera_tpu_torch.ops.cuda.kde import kde1d_grid, kde1d_grid_plain

    cpu = _spectral_hl(dead_event=False, binning=True, cut_grid=2.0)
    card = copy.deepcopy(cpu).to(cuda)
    got = _launched(lambda: _grad(card, cuda), {"K4": 1, "K4b": 1})
    expect = _grad(cpu, "cpu")
    assert torch.all(torch.isfinite(expect))
    torch.testing.assert_close(got, expect, rtol=1e-9, atol=0)
    z = (1.0 + 0.2 * torch.rand((4, 200), dtype=torch.float64, device=cuda)
         ).requires_grad_()
    w = torch.full((4, 200), 1.0 / 200, dtype=torch.float64, device=cuda)
    grids = torch.linspace(0.5, 1.5, 50, dtype=torch.float64, device=cuda
                           ).expand(4, 50).contiguous()
    h = torch.full((4,), 0.1, dtype=torch.float64, device=cuda)
    d_z = torch.autograd.grad(kde1d_grid(z, w, grids, h).sum(), z)[0]
    zc = z.detach().cpu().requires_grad_()
    expect = torch.autograd.grad(kde1d_grid_plain(
        zc, w.cpu(), grids.cpu(), h.cpu()).sum(), zc)[0]
    torch.testing.assert_close(d_z.cpu(), expect, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("kind,cut_grid", [
    ("approximate", 2.0), ("approximate", None), ("marginalized", 2.0),
    ("marginalized", None)])
def test_binned_gradient_on_card_matches_cpu(cuda, dark_inputs, kind, cut_grid):
    """d log L / d(H0, Om0, mu_g) of binned 'approximate' and 'marginalized'
    (the masked-dense pixel layout) on the card, with and without effective
    grids: one K4 and one K4b launch, float64 within 1e-9 of autograd on
    the CPU."""
    cpu = HyperLikelihood.create(*dark_inputs, kind=kind, binning=True,
                                 cut_grid=cut_grid)
    card = copy.deepcopy(cpu).to(cuda)
    got = _launched(lambda: _grad(card, cuda), {"K4": 1, "K4b": 1})
    expect = _grad(cpu, "cpu")
    assert torch.all(torch.isfinite(expect))
    torch.testing.assert_close(got, expect, rtol=1e-9, atol=0)


def _k4_rows(gen, g: int):
    """K4's inputs on 300 rows of 200 normalized weights: a row of zero
    weights (7) and a row whose grid points sit at |u| = 1 exactly of some
    samples (11: z and grid on multiples of 1/8, h = 1/4)."""
    f64 = torch.float64
    z = 1.0 + 0.2 * torch.randn((300, 200), generator=gen, dtype=f64)
    w = torch.rand((300, 200), generator=gen, dtype=f64)
    w[7] = 0.0
    w = w / w.sum(dim=1, keepdim=True).clamp_min(1e-300)
    h = 0.02 + 0.08 * torch.rand(300, generator=gen, dtype=f64)
    grids = torch.linspace(0.3, 1.8, g, dtype=f64)[None] \
        * (0.8 + 0.4 * torch.rand((300, 1), generator=gen, dtype=f64))
    z[11] = torch.randint(4, 12, (200,), generator=gen).to(f64) / 8.0
    grids[11] = torch.arange(g, dtype=f64) / 8.0 - 4.0
    h[11] = 0.25
    return z, w, grids, h


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9), (torch.float32, 1e-3)])
@pytest.mark.parametrize("kernel", ["epan", "gauss"])
def test_k4b_matches_plain(cuda, dtype, tol, kernel):
    """K4b against ``kde1d_grid_adjoint_plain`` on 250- and 500-point grids:
    d_z, d_w, d_grids within tol of each row's largest entry, d_h of the
    largest |d_h| (``chip_smoke.grad_compare``: in float32, where the
    float32 plain version itself is further off, against the float64 one on
    the same inputs); one launch, equal bits on a second; the row of zero
    weights gets finite cotangents, zero but for d_w."""
    from chimera_tpu_torch.ops.cuda.kde import (kde1d_grid, kde1d_grid_adjoint,
                                                kde1d_grid_adjoint_plain)

    gen = torch.Generator().manual_seed(5)
    for g in (250, 500):
        z, w, grids, h = (t.to(device=cuda, dtype=dtype) for t in _k4_rows(gen, g))
        out = kde1d_grid(z, w, grids, h, kernel=kernel)
        d_out = torch.randn((300, g), generator=gen, dtype=torch.float64
                            ).to(device=cuda, dtype=dtype)
        args = (z, w, grids, h, out, d_out, kernel)
        got = _launched(lambda: kde1d_grid_adjoint(*args), {"K4b": 1})
        grad_compare("K4b", kde1d_grid_adjoint, kde1d_grid_adjoint_plain,
                     args, {}, tol)
        assert all(torch.all(t[7] == 0) for t in (got[0], got[2], got[3]))


@pytest.fixture(scope="module")
def contract_cpu_hl(dark_inputs):
    """The dark flagship configuration on a layout without chunk rows: the
    contract path (K1e)."""
    return HyperLikelihood._create(
        *dark_inputs, kind="marginalized", kernel="epan", bw_method=None,
        cut_grid=None, binning=False, num_bins=200, pe_neff=2.0,
        chunk_rows=False)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
@pytest.mark.parametrize("kernel", ["epan", "gauss"])
def test_k1e_matches_plain(cuda, contract_cpu_hl, dtype, tol, kernel):
    """K1e on the logical pixel rows (a dead pixel among them) against its
    plain version: r1 and r2 within tol of their largest value over the
    rows of each λ, exact zeros on the rows without weight, the stats of
    the rows with weight within tol; one launch."""
    from chimera_tpu_torch.ops.cuda.fused import fused_weights_kde_plain

    hl = copy.deepcopy(contract_cpu_hl).to(device=cuda, dtype=dtype)
    args, kw = contract_inputs(hl, {"H0": H0S}, kernel)
    r, st = _launched(lambda: fused_weights_kde(*args, **kw), {"K1e": 1})
    r_p, st_p = fused_weights_kde_plain(*args, **kw)
    live = st_p["sum_w"] > 0
    assert not live.all() and torch.all(r[~live] == 0)
    assert row_rel(r, r_p) <= tol
    for k in ("norms", "neff", "bandwidth", "sum_w", "sum_w2"):
        rel = ((st[k] - st_p[k]).abs() / st_p[k].abs())[live].max().item()
        assert rel <= tol, (k, rel)


def test_contract_path_matches_cpu(cuda, contract_cpu_hl, dark_cpu_hl):
    """The contract path on the card: one K1e launch a batch and nothing
    else, log L within 1e-10 of the CPU's and of the rows path's in
    float64."""
    card = copy.deepcopy(contract_cpu_hl).to(cuda)
    got = _launched(lambda: card.log_like_batch({"H0": H0S}), {"K1e": 1}).cpu()
    expect = contract_cpu_hl.log_like_batch({"H0": H0S})
    assert torch.all(torch.isfinite(expect))
    torch.testing.assert_close(got, expect, rtol=1e-10, atol=0)
    torch.testing.assert_close(got, dark_cpu_hl.log_like_batch({"H0": H0S}),
                               rtol=1e-10, atol=0)


def test_contract_gradient_raises_on_the_card(cuda, contract_cpu_hl):
    """K1e has no adjoint kernel (the JAX package's backward of the contract
    epilogue is XLA's recompute, whose (L, B, G, S_pp) intermediate no card
    holds at the flagship): the contract path's gradient raises on CUDA
    tensors instead of coming back short, and runs on CPU tensors."""
    card = copy.deepcopy(contract_cpu_hl).to(cuda)
    h0 = torch.tensor(H0S, dtype=torch.float64, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="K1e's adjoint"):
        card.log_like_batch({"H0": h0})
    assert torch.all(torch.isfinite(_grad(contract_cpu_hl, "cpu")))


def test_binned_hmc_repeats_bit_for_bit(cuda):
    """HMC on the reference's defaults (binned, cut_grid=2.0), float32: two
    runs under the same generator seed give the same samples (the binning
    and the resampling accumulate in a fixed order); each gradient
    evaluation is one K4 and one K4b launch."""
    from chimera_tpu_torch.inference import sample_hyperposterior

    card = copy.deepcopy(_spectral_hl(dead_event=False, binning=True,
                                      cut_grid=2.0)).to(cuda, torch.float32)
    bounds = {"H0": (40.0, 120.0), "Om0": (0.05, 0.6)}

    def run():
        before = launch_counts()
        samples, _ = sample_hyperposterior(
            torch.Generator(device=cuda).manual_seed(5), card, ["H0", "Om0"],
            bounds, {"H0": 70.0, "Om0": 0.25}, n_chains=4, n_warmup=3,
            n_samples=3, n_leapfrog=3)
        after = launch_counts()
        return samples, after["K4"] - before["K4"], after["K4b"] - before["K4b"]

    first, k4, k4b = run()
    assert k4 == k4b >= 7
    second, _, _ = run()
    for k, lo_hi in bounds.items():
        assert torch.all((first[k] > lo_hi[0]) & (first[k] < lo_hi[1]))
        assert torch.equal(first[k], second[k])


# ---------------------------------------------------------------------------
# K5 (the 3-D lattice KDE of kind 'full') and the ensemble sampler
# ---------------------------------------------------------------------------

# every path of K5: the dense sweep, the 8-, 16- and 32-register
# recurrences, K = 13 (no tier: a padded last block of 64 points)
_K5_BLOCKS = [0, 8, 13, 16, 32]


@pytest.fixture(scope="module")
def full_cpu_hl(dark_inputs):
    """Kind 'full' (cut_grid=2.0) on the dark inputs' PE data, an empty
    catalog and 800-point grids, where the plan takes K = 32 for most
    events (16 for the rest); each event's block length then cycles through
    ``_K5_BLOCKS``, capped at the plan's (a longer block than the plan's
    can rise from below the flush to inf)."""
    cat, _, pop, sel = dark_inputs
    z_grids = compute_z_grids(pop.cosmo, cat, cosmo_prior={"H0": [40.0, 120.0]},
                              z_int_res=800)
    hl = HyperLikelihood.create(cat, z_grids, Population.create(
        pop.cosmo, pop.mass, pop.rate), sel, kind="full", cut_grid=2.0)
    cycle = torch.tensor(_K5_BLOCKS * 4, dtype=hl.z_block.dtype)[:hl.n_events]
    assert torch.all(hl.z_block >= 16)
    hl.z_block.copy_(torch.minimum(cycle, hl.z_block))
    return hl


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
def test_k5_matches_plain(cuda, full_cpu_hl, dtype, tol):
    """K5 on the inputs the 'full' path hands it, 3 λ: float64 within 1e-10
    of each (λ, event, pixel) row's max of the plain version, float32 within
    1e-4 of the float64 plain version on the same inputs; fake pixels 0;
    one launch; a dead pixel's samples (event 3) carry no weight."""
    from chip_smoke import captured, k5_compare

    card = copy.deepcopy(full_cpu_hl).to(cuda, dtype)
    args, kw = captured("lattice_kde3d", lambda: card.log_like_batch(
        {"H0": torch.tensor(H0S, dtype=dtype, device=cuda)}))
    rel, _, _, _ = _launched(lambda: k5_compare(args, kw, tol), {"K5": 1})
    assert rel <= tol


def test_full_log_like_batch_matches_cpu(cuda, full_cpu_hl):
    """Kind 'full' on the card, float64: one K5 launch a batch and nothing
    else, log L within 1e-10 of the CPU's; float32 within 1e-6 of it."""
    card = copy.deepcopy(full_cpu_hl).to(cuda)
    got = _launched(lambda: card.log_like_batch({"H0": H0S}), {"K5": 1}).cpu()
    expect = full_cpu_hl.log_like_batch({"H0": H0S})
    assert torch.all(torch.isfinite(expect))
    torch.testing.assert_close(got, expect, rtol=1e-10, atol=0)
    card32 = copy.deepcopy(full_cpu_hl).to(cuda, torch.float32)
    got32 = card32.log_like_batch({"H0": H0S}).cpu().double()
    assert ((got32 - expect).abs() / expect.abs()).max() <= 1e-6


def test_k5_repeats_bit_for_bit(cuda, full_cpu_hl):
    """Fixed-order sums, no atomics: two calls give the same bits."""
    from chip_smoke import captured
    from chimera_tpu_torch.ops.cuda.kde3d import lattice_kde3d

    card = copy.deepcopy(full_cpu_hl).to(cuda, torch.float32)
    args, kw = captured("lattice_kde3d", lambda: card.log_like_batch({"H0": H0S}))
    first, second = lattice_kde3d(*args, **kw), lattice_kde3d(*args, **kw)
    assert torch.equal(_bits(first), _bits(second))


def test_full_gradient_raises_on_the_card(cuda, full_cpu_hl):
    """K5 has no adjoint kernel: a 'full' batch that requires grad raises on
    CUDA tensors (ROADMAP.md §1 item 16) and differentiates on CPU
    tensors."""
    card = copy.deepcopy(full_cpu_hl).to(cuda)
    h0 = torch.tensor(H0S, dtype=torch.float64, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="item 16"):
        card.log_like_batch({"H0": h0})
    assert torch.all(torch.isfinite(_grad(full_cpu_hl, "cpu")))


def test_k5_rejects_what_the_kernel_does_not_take(cuda, full_cpu_hl):
    from chip_smoke import captured
    from chimera_tpu_torch.ops.cuda.kde3d import lattice_kde3d

    card = copy.deepcopy(full_cpu_hl).to(cuda)
    args, kw = captured("lattice_kde3d", lambda: card.log_like_batch({"H0": H0S}))
    bad = list(args)
    bad[2] = args[2].float()
    with pytest.raises(ValueError, match="ra must be"):
        lattice_kde3d(*bad, **kw)
    bad = list(args)
    bad[8] = args[8].double()
    with pytest.raises(ValueError, match="z_block"):
        lattice_kde3d(*bad, **kw)
    with pytest.raises(TypeError):
        lattice_kde3d(*(a.half() if a.is_floating_point() else a for a in args), **kw)


def test_ensemble_repeats_bit_for_bit(cuda, full_cpu_hl):
    """8 walkers in (H0, Om0) on kind 'full', float32, 2 steps: one K5 launch
    a half-step (and one at the start), every walker finite and in bounds,
    equal bits on a second run from the same generator seed."""
    from chimera_tpu_torch.inference import (init_state, initialize_walkers,
                                             make_vector_log_prob, run)

    card = copy.deepcopy(full_cpu_hl).to(cuda, torch.float32)
    bounds = {"H0": (40.0, 120.0), "Om0": (0.05, 0.6)}
    f = make_vector_log_prob(card, ["H0", "Om0"], bounds)

    def go():
        gen = torch.Generator(device=cuda).manual_seed(9)
        x0 = initialize_walkers(gen, {"H0": 70.0, "Om0": 0.25}, 8,
                                ["H0", "Om0"], bounds=bounds, dtype=torch.float32)
        return run(gen, init_state(x0, f), f, n_steps=2)

    _, first = _launched(go, {"K5": 5})
    _, second = go()
    assert torch.all(torch.isfinite(first["log_prob"]))
    for i, (lo, hi) in enumerate(bounds.values()):
        x = first["coords"][..., i]
        assert torch.all((x >= lo) & (x <= hi))
    assert torch.equal(first["coords"], second["coords"])
    assert torch.equal(first["log_prob"], second["log_prob"])
