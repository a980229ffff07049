"""The hand-written CUDA kernels of the PyTorch port, on the card: K1a
(spectral) and its adjoint K3, K1c and K2 (dark siren).

Every test here needs a CUDA card and nvcc (marker ``cuda``) and skips
without one.  The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Inputs are port-generated mock data (float64 on the CPU, moved to the card);
the reference is the kernel's plain PyTorch version on the same inputs."""

import copy

import pytest
import torch

from chimera_tpu_torch import HyperLikelihood, SelectionFunction
from chimera_tpu_torch.data.mock import make_mock_catalog, make_mock_injections
from chimera_tpu_torch.models import (FLRW, MadauDickinsonRate, Population,
                                      PowerLawPeak, compute_z_grids)
from chimera_tpu_torch.ops.cuda.fused import (fused_row_stats,
                                              fused_row_stats_plain,
                                              fused_weights_kde,
                                              fused_weights_kde_adjoint,
                                              fused_weights_kde_adjoint_plain,
                                              fused_weights_kde_plain,
                                              pack_params)
from chimera_tpu_torch.ops.cuda.rows import (fused_rows_contract,
                                             fused_rows_contract_plain)

H0S = [62.0, 70.0, 78.0]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand-written CUDA kernels)")
    return torch.device("cuda", 0)


def _spectral_hl(dead_event: bool):
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
    return HyperLikelihood.create(cat, z_grids, pop,
                                  SelectionFunction.create(inj, n_gen),
                                  binning=False, cut_grid=None)


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
    for g, a, e in zip(got, again, expect):
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
def dark_cpu_hl():
    """'marginalized' likelihood on port-made data, float64 on the CPU: 16
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
    return HyperLikelihood.create(cat, z_grids, pop,
                                  SelectionFunction.create(inj, n_gen),
                                  kind="marginalized", binning=False,
                                  cut_grid=None)


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


def test_dark_gradient_is_refused_on_the_card(cuda, dark_cpu_hl):
    """No adjoint kernel for the dark kind yet: a backward through K1c and
    K2 raises instead of dropping their part."""
    card = copy.deepcopy(dark_cpu_hl).to(cuda)
    h0 = torch.tensor(H0S, dtype=torch.float64, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        card.log_like_batch({"H0": h0})
    assert torch.all(torch.isfinite(card.log_like_batch({"H0": h0.detach()})))
