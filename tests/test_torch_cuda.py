"""The hand-written CUDA kernel of the PyTorch port, on the card.

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
from chimera_tpu_torch.ops.cuda.fused import (fused_weights_kde,
                                              fused_weights_kde_plain)

H0S = [62.0, 70.0, 78.0]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand-written fused_kde kernel)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def cpu_hl():
    """16 events x 256 samples x 64-point grids, 20k generated injections,
    float64 on the CPU; event 5 has zero weight (infinite PE prior)."""
    pop = Population.create(FLRW.create(), PowerLawPeak.create(),
                            MadauDickinsonRate.create())
    gen = torch.Generator().manual_seed(7)
    cat = make_mock_catalog(gen, pop, n_events=16, n_samples=256)
    inj, n_gen = make_mock_injections(gen, pop, n_generated=20_000)
    z_grids = compute_z_grids(pop.cosmo, cat, cosmo_prior={"H0": [40.0, 120.0]},
                              z_int_res=64)
    prior = cat.pe_prior.clone()
    prior[5] = torch.inf
    return HyperLikelihood.create(cat.update(pe_prior=prior), z_grids, pop,
                                  SelectionFunction.create(inj, n_gen),
                                  binning=False, cut_grid=None)


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
