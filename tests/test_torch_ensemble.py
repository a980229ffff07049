"""The port's affine-invariant ensemble sampler
(``chimera_tpu_torch/inference/ensemble.py``) against the JAX package's
(``chimera_tpu/inference/ensemble.py``): one stretch half-step on the JAX
step's own draws number for number, the analytic targets of
``tests/test_inference.py`` at their tolerances, and the walkers' log
density on a small port likelihood (one ``log_like_batch`` a half-step,
bounds, determinism under one generator seed)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_tpu.inference import ensemble as jens
from chimera_tpu_torch import HyperLikelihood, SelectionFunction
from chimera_tpu_torch.data.mock import make_mock_catalog, make_mock_injections
from chimera_tpu_torch.inference import (EnsembleState, init_state,
                                         initialize_walkers,
                                         make_vector_log_prob, run, step)
from chimera_tpu_torch.inference.ensemble import (StretchDraws, stretch_draws,
                                                  stretch_update)
from chimera_tpu_torch.models import (FLRW, MadauDickinsonRate, Population,
                                      PowerLawPeak, compute_z_grids)

F64 = torch.float64


def _t(x):
    return torch.as_tensor(np.array(x), dtype=F64)


def _gauss(mu, sig):
    mu, sig = _t(mu), _t(sig)
    return lambda x: -0.5 * torch.sum(((x - mu) / sig) ** 2, dim=-1)


def test_stretch_half_matches_reference_given_its_draws():
    """One red-blue half update fed the stretch uniforms, partner indices
    and acceptance uniforms that the JAX half-step draws from its key: the
    coords, log densities and acceptances of the JAX step to 1e-12."""
    mu, sig = np.array([1.0, -2.0, 0.5]), np.array([0.5, 2.0, 1.0])

    def jlogp(x):
        return -0.5 * jnp.sum(((x - mu) / sig) ** 2, axis=-1)

    rng = np.random.default_rng(11)
    for seed in range(4):
        active = rng.normal(size=(8, 3)) * 2.0
        other = rng.normal(size=(6, 3)) * 2.0
        key = jax.random.PRNGKey(seed)
        k_z, k_pick, k_acc = jax.random.split(key, 3)
        draws = StretchDraws(_t(jax.random.uniform(k_z, (8,))),
                             torch.as_tensor(np.array(
                                 jax.random.randint(k_pick, (8,), 0, 6))),
                             _t(jax.random.uniform(k_acc, (8,))))
        lp = jlogp(jnp.asarray(active))
        jc, jlp, jacc = jens._stretch_half(key, jnp.asarray(active),
                                           jnp.asarray(other), lp, jlogp, 2.0)
        c, logp, acc = stretch_update(_t(active), _t(other), _t(lp),
                                      _gauss(mu, sig), 2.0, draws)
        np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=1e-12)
        np.testing.assert_allclose(logp.numpy(), np.asarray(jlp), rtol=0,
                                   atol=1e-12)


def test_sampler_recovers_gaussian():
    """64 walkers on a 3-D Gaussian, 3000 steps thinned by 10 (the JAX
    test's target and tolerances): the moments after a burn-in of 100 kept
    states, the acceptance fraction inside (0.1, 0.9)."""
    mu, sig = np.array([1.0, -2.0, 0.5]), np.array([0.5, 2.0, 1.0])
    logp = _gauss(mu, sig)
    gen = torch.Generator().manual_seed(0)
    coords = _t(mu) + 0.1 * torch.randn((64, 3), generator=gen, dtype=F64)
    state = init_state(coords, logp)
    state, hist = run(gen, state, logp, n_steps=3000, thin=10)
    assert hist["coords"].shape == (300, 64, 3)
    samples = hist["coords"][100:].reshape(-1, 3).numpy()
    np.testing.assert_allclose(samples.mean(axis=0), mu, atol=0.12)
    np.testing.assert_allclose(samples.std(axis=0), sig, rtol=0.12)
    acc = float(state.n_accepted.double().mean()) / state.iteration
    assert 0.1 < acc < 0.9


def test_run_thins_and_repeats():
    """The kept states are the states after every ``thin`` steps; the same
    generator seed gives the same bits; ``n_steps`` must be a multiple of
    ``thin``."""
    logp = _gauss([0.0, 0.0], [1.0, 1.0])
    coords = torch.randn((16, 2), generator=torch.Generator().manual_seed(1),
                         dtype=F64)
    state = init_state(coords, logp)
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(2)
        final, hist = run(gen, state, logp, n_steps=6, thin=2)
        runs.append((final, hist))
    final, hist = runs[0]
    assert hist["coords"].shape == (3, 16, 2) and hist["log_prob"].shape == (3, 16)
    assert final.iteration == 6 and final.n_accepted.shape == (16,)
    assert torch.equal(hist["coords"][-1], final.coords)
    assert torch.equal(hist["log_prob"][-1], final.log_prob)
    assert torch.equal(runs[1][1]["coords"], hist["coords"])
    gen = torch.Generator().manual_seed(2)
    one = state
    for _ in range(2):
        one = step(gen, one, logp)
    assert torch.equal(one.coords, hist["coords"][0])
    with pytest.raises(ValueError, match="multiple of thin"):
        run(gen, state, logp, n_steps=5, thin=2)


def test_stretch_draws_are_in_range():
    gen = torch.Generator().manual_seed(3)
    d = stretch_draws(gen, 1000, 7, F64, torch.device("cpu"))
    assert d.partner.min() >= 0 and d.partner.max() == 6
    assert 0.0 <= float(d.u.min()) and float(d.u.max()) < 1.0
    assert d.accept_u.shape == (1000,)


@pytest.mark.parametrize("distribution", ["gaussian", "truncgauss", "uniform"])
def test_initialize_walkers_bounds(distribution):
    """The JAX test's ball (scale H0 5, Om0 0.05) inside (40, 120) x (0.05,
    0.95), each distribution; 'uniform' needs finite bounds."""
    gen = torch.Generator().manual_seed(4)
    bounds = {"H0": (40, 120), "Om0": (0.05, 0.95)}
    x = initialize_walkers(gen, {"H0": 70.0, "Om0": 0.1}, 256, ["H0", "Om0"],
                           scale={"H0": 30.0, "Om0": 0.05}, bounds=bounds,
                           distribution=distribution)
    assert x.shape == (256, 2) and x.dtype == F64
    for i, (lo, hi) in enumerate(bounds.values()):
        assert torch.all((x[:, i] >= lo) & (x[:, i] <= hi))
    if distribution == "uniform":
        assert float(x[:, 1].mean()) > 0.3
        with pytest.raises(ValueError, match="finite bounds"):
            initialize_walkers(gen, {"H0": 70.0}, 4, ["H0"], distribution="uniform")
    with pytest.raises(ValueError, match="distribution must be"):
        initialize_walkers(gen, {"H0": 70.0}, 4, ["H0"], distribution="ball")


@pytest.fixture(scope="module")
def small_hl():
    """A 16-event x 128-sample spectral mock drawn by the port on the CPU
    at H0 = 70, 100-point z-grids, 20 000 generated injections, binned
    with 100 bins (as ``tests/test_inference.py``'s)."""
    pop = Population.create(
        FLRW.create(H0=70.0, Om0=0.25, device="cpu", dtype=F64),
        PowerLawPeak.create(device="cpu", dtype=F64),
        MadauDickinsonRate.create(device="cpu", dtype=F64))
    gen = torch.Generator().manual_seed(7)
    cat = make_mock_catalog(gen, pop, n_events=16, n_samples=128,
                            snr_threshold=12.0, oversample=300)
    inj, n_gen = make_mock_injections(gen, pop, n_generated=20_000,
                                      snr_threshold=12.0)
    z_grids = compute_z_grids(pop.cosmo, cat, cosmo_prior={"H0": [40.0, 120.0]},
                              z_int_res=100)
    return HyperLikelihood.create(cat, z_grids, pop,
                                  SelectionFunction.create(inj, n_gen),
                                  num_bins=100)


def test_vector_log_prob_bounds(small_hl, monkeypatch):
    """Out-of-bounds walkers are -inf, the rest finite, from ONE
    ``log_like_batch`` of the clamped walkers, outside autograd; an extra
    prior sees the clamped values."""
    calls = []
    real = small_hl.log_like_batch
    monkeypatch.setattr(small_hl, "log_like_batch",
                        lambda lam: calls.append(lam["H0"].clone()) or real(lam))
    seen = []

    def prior(lam):
        seen.append(lam["H0"])
        return torch.zeros_like(lam["H0"])

    f = make_vector_log_prob(small_hl, ["H0"], bounds={"H0": (40.0, 120.0)},
                             extra_log_prior=prior)
    vals = f(torch.tensor([[70.0], [30.0], [130.0]], requires_grad=True))
    assert torch.isfinite(vals[0]) and vals[1] == -torch.inf and vals[2] == -torch.inf
    assert not vals.requires_grad
    assert len(calls) == 1 and calls[0].tolist() == [70.0, 40.0, 120.0]
    assert seen[0].tolist() == [70.0, 40.0, 120.0]


def test_ensemble_on_the_likelihood(small_hl, monkeypatch):
    """8 walkers in (H0, Om0), 3 steps: one ``log_like_batch`` of 4
    walkers a half-step (of 8 at the start), every walker finite and in
    bounds, equal bits on a second run from the same seed."""
    bounds = {"H0": (40.0, 120.0), "Om0": (0.05, 0.6)}
    sizes = []
    real = small_hl.log_like_batch
    monkeypatch.setattr(small_hl, "log_like_batch",
                        lambda lam: sizes.append(len(lam["H0"])) or real(lam))
    f = make_vector_log_prob(small_hl, ["H0", "Om0"], bounds)
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        x0 = initialize_walkers(gen, {"H0": 70.0, "Om0": 0.25}, 8,
                                ["H0", "Om0"], bounds=bounds)
        runs.append(run(gen, init_state(x0, f), f, n_steps=3))
    state, hist = runs[0]
    assert sizes == [8] + [4] * 6 + [8] + [4] * 6
    assert isinstance(state, EnsembleState)
    assert torch.all(torch.isfinite(hist["log_prob"]))
    for i, (lo, hi) in enumerate(bounds.values()):
        assert torch.all((hist["coords"][..., i] >= lo) & (hist["coords"][..., i] <= hi))
    assert torch.equal(runs[1][1]["coords"], hist["coords"])
    assert torch.equal(runs[1][1]["log_prob"], hist["log_prob"])
