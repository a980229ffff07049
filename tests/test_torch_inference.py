"""The samplers and diagnostics of the PyTorch port: the counterparts of
``tests/test_hmc.py`` and ``tests/test_chees.py``.  torch's random streams
differ from JAX's, so chains are compared as distributions (the JAX tests'
tolerances on analytic targets); ``Transform``, ``_da_update``, one
``_hmc_step`` fed the JAX step's own draws, ESS and R-hat are compared
number for number."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_tpu.inference import diagnostics as jdiag
from chimera_tpu.inference import hmc as jhmc
from chimera_tpu_torch import HyperLikelihood, SelectionFunction
from chimera_tpu_torch.data.mock import make_mock_catalog, make_mock_injections
from chimera_tpu_torch.inference import (AdaptState, HMCState, Transform,
                                         continue_hmc, effective_sample_size,
                                         make_transformed_log_prob, rhat,
                                         run_chees, run_hmc,
                                         sample_hyperposterior,
                                         sample_hyperposterior_chees)
from chimera_tpu_torch.inference.chees import _halton
from chimera_tpu_torch.inference.hmc import _da_update, _hmc_step
from chimera_tpu_torch.models import (FLRW, MadauDickinsonRate, Population,
                                      PowerLawPeak, compute_z_grids)

F64 = torch.float64
INF = float("inf")
LO = [0.0, -INF, 2.0, -INF]
HI = [1.0, INF, INF, 5.0]


def _t(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def _gaussian(mu, cov):
    """Batched log density (C, D) -> (C,) of N(mu, cov)."""
    prec = torch.linalg.inv(_t(cov))
    mu = _t(mu)

    def logp(ys):
        d = ys - mu
        return -0.5 * torch.einsum("ci,ij,cj->c", d, prec, d)

    return logp


# -- Transform and dual averaging, number for number ------------------------

def test_transform_roundtrip_and_jacobian():
    tr = Transform(_t(LO), _t(HI))
    x = _t([0.3, -1.7, 4.2, 1.0])
    y = tr.unconstrain(x)
    np.testing.assert_allclose(tr.constrain(y).numpy(), x.numpy(), rtol=1e-10)
    # log-Jacobian == log |det d constrain / dy| by autograd
    jac = torch.autograd.functional.jacobian(tr.constrain, y)
    expect = np.log(np.abs(np.linalg.det(jac.numpy())))
    np.testing.assert_allclose(float(tr.log_jacobian(y)), expect, rtol=1e-8)


def test_transform_matches_reference():
    tr = Transform(_t(LO), _t(HI))
    jtr = jhmc.Transform(jnp.array(LO), jnp.array(HI))
    rng = np.random.default_rng(0)
    ys = rng.normal(scale=2.0, size=(5, 4))
    xs = np.asarray(jax.vmap(jtr.constrain)(jnp.asarray(ys)))
    np.testing.assert_allclose(tr.constrain(_t(ys)).numpy(), xs, rtol=1e-10)
    np.testing.assert_allclose(tr.unconstrain(_t(xs)).numpy(),
                               np.asarray(jax.vmap(jtr.unconstrain)(jnp.asarray(xs))),
                               rtol=1e-10)
    np.testing.assert_allclose(tr.log_jacobian(_t(ys)).numpy(),
                               np.asarray(jax.vmap(jtr.log_jacobian)(jnp.asarray(ys))),
                               rtol=1e-10)
    # the gradient of the log-Jacobian stays finite in every branch
    y = _t(ys).requires_grad_()
    (g,) = torch.autograd.grad(tr.log_jacobian(y).sum(), y)
    assert torch.all(torch.isfinite(g))


def test_da_update_matches_reference():
    vals = [np.log(0.1), np.log(0.1), 0.0]
    adapt = AdaptState(*[_t(v) for v in vals], torch.zeros(2, dtype=F64),
                       torch.zeros(2, dtype=F64), _t(0.0))
    jadapt = jhmc.AdaptState(*[jnp.asarray(v) for v in vals], jnp.zeros(2),
                             jnp.zeros(2), jnp.array(0.0))
    for step, acc in enumerate([0.95, 0.4, 0.81, 0.1, 0.99]):
        adapt = _da_update(adapt, _t(acc), float(step), 0.8, np.log(1.0))
        jadapt = jhmc._da_update(jadapt, acc, float(step), 0.8, np.log(1.0))
        for k in ("log_eps", "log_eps_bar", "h_bar"):
            np.testing.assert_allclose(float(getattr(adapt, k)),
                                       float(getattr(jadapt, k)), rtol=1e-10)


def test_hmc_step_matches_reference_given_its_draws():
    """One HMC update fed the momenta, trajectory length and uniforms that
    the JAX step draws from its key."""
    cov = np.array([[1.0, 0.6], [0.6, 2.0]])
    mu = np.array([1.0, -2.0])
    prec = jnp.linalg.inv(jnp.asarray(cov))

    def jlogp(ys):
        d = ys - jnp.asarray(mu)
        return -0.5 * jnp.einsum("ci,ij,cj->c", d, prec, d)

    logp = _gaussian(mu, cov)
    rng = np.random.default_rng(5)
    y0 = rng.normal(size=(6, 2))
    inv_mass = np.array([0.7, 1.9])
    eps, n_steps = 0.23, 7
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        k_mom, k_len, k_acc = jax.random.split(key, 3)
        draws = (_t(jax.random.normal(k_mom, (6, 2))),
                 int(jax.random.randint(k_len, (), 1, n_steps + 1)),
                 _t(jax.random.uniform(k_acc, (6,))))
        jlp, jg = jhmc._batch_value_and_grad(jlogp)(jnp.asarray(y0))
        jstate, jacc = jhmc._hmc_step(key, jhmc.HMCState(jnp.asarray(y0), jlp, jg),
                                      eps, jnp.asarray(inv_mass), n_steps, jlogp,
                                      n_steps)
        y = _t(y0).requires_grad_()
        lp = logp(y)
        state = HMCState(y.detach(), lp.detach(),
                         torch.autograd.grad(lp.sum(), y)[0])
        new, acc = _hmc_step(None, state, _t(eps), _t(inv_mass), n_steps, logp,
                             draws=draws)
        np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=1e-10)
        for got, expect in zip(new, jstate):
            np.testing.assert_allclose(got.numpy(), np.asarray(expect),
                                       rtol=1e-10, atol=1e-12)
            assert not got.requires_grad


# -- analytic targets, at the JAX tests' tolerances --------------------------

def test_hmc_recovers_gaussian():
    """Anisotropic Gaussian: sample mean/cov match after adaptation."""
    cov = np.array([[1.0, 0.6], [0.6, 2.0]])
    mu = np.array([1.0, -2.0])
    gen = torch.Generator().manual_seed(0)
    ys, stats = run_hmc(gen, _gaussian(mu, cov), torch.zeros(8, 2, dtype=F64),
                        n_warmup=300, n_samples=700, n_leapfrog=8, batched=True)
    assert ys.shape == (700, 8, 2)
    flat = ys[100:].reshape(-1, 2).numpy()
    np.testing.assert_allclose(flat.mean(0), mu, atol=0.15)
    np.testing.assert_allclose(np.cov(flat.T), cov, atol=0.4)
    assert 0.5 < float(stats["accept"].mean()) <= 1.0
    assert stats["warmup_accept"].shape == (300,)


def test_hmc_bounded_target_chain_by_chain():
    """Beta(2,3)-like bounded target through the logit transform, with a
    per-chain density (``batched=False``)."""
    tr = Transform(_t([0.0]), _t([1.0]))

    def logp(y):                                           # (D,) -> ()
        x = tr.constrain(y)
        return torch.sum(torch.log(x) + 2.0 * torch.log(1.0 - x)) \
            + tr.log_jacobian(y)

    gen = torch.Generator().manual_seed(1)
    y0 = tr.unconstrain(torch.full((6, 1), 0.5, dtype=F64))
    ys, _ = run_hmc(gen, logp, y0, n_warmup=150, n_samples=300, n_leapfrog=8)
    xs = tr.constrain(ys)[50:].numpy().ravel()
    assert (xs > 0).all() and (xs < 1).all()
    np.testing.assert_allclose(xs.mean(), 2.0 / 5.0, atol=0.05)  # Beta(2,3)


def test_continue_hmc_is_deterministic():
    """Resuming twice from the same state under a re-seeded generator
    gives the same chain."""
    logp = _gaussian([0.0, 0.0], [[1.0, 0.3], [0.3, 0.5]])
    ys, stats = run_hmc(torch.Generator().manual_seed(0), logp,
                        torch.zeros(4, 2, dtype=F64), n_warmup=100,
                        n_samples=50, n_leapfrog=6, batched=True)
    state = stats["final_state"]
    np.testing.assert_allclose(state.y.numpy(), ys[-1].numpy())
    runs = [continue_hmc(torch.Generator().manual_seed(99), logp, state,
                         stats["step_size"], stats["inv_mass"], n_samples=50,
                         n_leapfrog=6, batched=True) for _ in range(2)]
    assert runs[0][0].shape == (50, 4, 2)
    assert torch.all(torch.isfinite(runs[0][1]["log_prob"]))
    assert torch.equal(runs[0][0], runs[1][0])
    other, _ = continue_hmc(torch.Generator().manual_seed(98), logp, state,
                            stats["step_size"], stats["inv_mass"], n_samples=50,
                            n_leapfrog=6, batched=True)
    assert not torch.equal(runs[0][0], other)


# -- diagnostics --------------------------------------------------------------

def _ar1(rng, n, c, rho):
    eps = rng.normal(size=(n, c))
    out = np.zeros((n, c))
    x = np.zeros(c)
    for i in range(n):
        x = rho * x + np.sqrt(1 - rho * rho) * eps[i]
        out[i] = x
    return out


@pytest.mark.parametrize("kind", ["iid", "ar1", "nonmixing", "two_dim"])
def test_diagnostics_match_reference(kind):
    """ESS and split-R-hat against the JAX functions on the same arrays
    (1e-10), with the JAX tests' own sanity bounds."""
    rng = np.random.default_rng(2)
    if kind == "iid":
        x = rng.normal(size=(1000, 8, 2))
    elif kind == "two_dim":
        x = rng.normal(size=(501, 3))
    else:
        x = _ar1(rng, 2000, 4, 0.9)
        if kind == "nonmixing":
            x = x + np.arange(4)[None, :] * 10.0
    ess = effective_sample_size(_t(x)).numpy()
    r = rhat(_t(x)).numpy()
    np.testing.assert_allclose(ess, np.asarray(jdiag.effective_sample_size(jnp.asarray(x))),
                               rtol=1e-10)
    np.testing.assert_allclose(r, np.asarray(jdiag.rhat(jnp.asarray(x))), rtol=1e-10)
    if kind == "iid":
        assert ess.shape == (2,)
        assert (ess > 0.5 * 8000).all() and (ess < 1.6 * 8000).all()
        np.testing.assert_allclose(r, 1.0, atol=0.02)
    elif kind == "ar1":
        assert ess[0] < 0.12 * 8000      # true factor (1 - rho) / (1 + rho)
    elif kind == "nonmixing":
        assert r[0] > 2.0


# -- ChEES ---------------------------------------------------------------------

def test_halton_matches_reference():
    from chimera_tpu.inference.chees import _halton as j_halton

    np.testing.assert_array_equal(_halton(37), j_halton(37))


def test_chees_recovers_gaussian():
    """Anisotropic correlated Gaussian: moments and an adapted trajectory."""
    cov = np.array([[1.0, 0.8], [0.8, 2.0]])
    mu = np.array([1.0, -2.0])
    gen = torch.Generator().manual_seed(0)
    ys, stats = run_chees(gen, _gaussian(mu, cov), torch.zeros(16, 2, dtype=F64),
                          n_warmup=400, n_samples=600, batched=True)
    flat = ys[100:].reshape(-1, 2).numpy()
    np.testing.assert_allclose(flat.mean(0), mu, atol=0.15)
    np.testing.assert_allclose(np.cov(flat.T), cov, atol=0.45)
    assert 0.4 < float(stats["accept"].mean()) <= 1.0
    assert np.isfinite(float(stats["trajectory_time"]))
    assert float(stats["trajectory_time"]) >= float(stats["step_size"])
    assert float(rhat(ys).max()) < 1.1
    assert stats["steps_total"] == round(stats["mean_leapfrog_steps"] * 600)
    assert len(stats["warmup_steps"]) == 400


def test_chees_ess_per_gradient_beats_fixed_hmc():
    """The point of ChEES: at least twice the ESS per gradient evaluation
    of fixed-length HMC on an ill-conditioned Gaussian (condition number
    100)."""
    logp = _gaussian([0.0, 0.0], [[1.0, 0.0], [0.0, 0.01]])
    c, n_s = 16, 600
    y0 = 0.1 * torch.randn(c, 2, generator=torch.Generator().manual_seed(3),
                           dtype=F64)
    ys_f, _ = run_hmc(torch.Generator().manual_seed(4), logp, y0, n_warmup=400,
                      n_samples=n_s, n_leapfrog=8, batched=True)
    ys_c, stats_c = run_chees(torch.Generator().manual_seed(4), logp, y0,
                              n_warmup=400, n_samples=n_s, batched=True)
    per_grad_f = float(effective_sample_size(ys_f).min()) / (n_s * 8 * c)
    per_grad_c = float(effective_sample_size(ys_c).min()) / (stats_c["steps_total"] * c)
    assert per_grad_c / per_grad_f > 2.0, (per_grad_c, per_grad_f)


# -- the hyper-posterior, end to end ------------------------------------------

@pytest.fixture(scope="module")
def small_hl():
    """A 16-event x 128-sample spectral mock drawn by the port on the CPU
    at H0 = 70, 100-point z-grids, 20 000 generated injections."""
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
                                  binning=False, cut_grid=None)


@pytest.mark.parametrize("sampler", ["hmc", "chees"])
def test_sample_hyperposterior_smoke(small_hl, sampler):
    """H0 only, 2 chains, 10 + 10 steps: finite, inside the bounds, moved;
    the same generator seed gives the same chain."""
    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        if sampler == "hmc":
            return sample_hyperposterior(
                gen, small_hl, ["H0"], {"H0": (40.0, 120.0)}, init={"H0": 75.0},
                n_chains=2, n_warmup=10, n_samples=10, n_leapfrog=3)
        return sample_hyperposterior_chees(
            gen, small_hl, ["H0"], {"H0": (40.0, 120.0)}, init={"H0": 75.0},
            n_chains=2, n_warmup=10, n_samples=10, max_steps=4)

    samples, stats = run(0)
    h0 = samples["H0"]
    assert h0.shape == (10, 2) and not h0.requires_grad
    assert torch.all(torch.isfinite(h0))
    assert torch.all((h0 > 40.0) & (h0 < 120.0))
    assert float(h0.std()) > 0.0
    assert torch.all(torch.isfinite(stats["log_prob"]))
    assert torch.equal(run(0)[0]["H0"], h0)


def test_single_chain_density_matches_the_batch(small_hl):
    """``make_transformed_log_prob`` (one chain) equals a row of the
    batched target, and NaN maps to -inf."""
    from chimera_tpu_torch.inference import make_transformed_log_prob_batch

    bounds = {"H0": (40.0, 120.0), "Om0": (0.05, 0.6)}
    one, tr = make_transformed_log_prob(small_hl, ["H0", "Om0"], bounds)
    many, _ = make_transformed_log_prob_batch(small_hl, ["H0", "Om0"], bounds)
    ys = tr.unconstrain(_t([[68.0, 0.3], [75.0, 0.2]]))
    np.testing.assert_allclose(torch.stack([one(y) for y in ys]).numpy(),
                               many(ys).numpy(), rtol=1e-12)
    prior = lambda lam: torch.where(lam["H0"] > 70.0, torch.nan, 0.0)  # noqa: E731
    gated, _ = make_transformed_log_prob_batch(small_hl, ["H0", "Om0"], bounds,
                                               extra_log_prior=prior)
    out = gated(ys)
    assert torch.isfinite(out[0]) and out[1] == -torch.inf


def test_cpu_gradient_launches_no_kernel(small_hl):
    """On CPU tensors the whole backward is autograd through the plain
    versions: the kernels' launch counts stay where they were."""
    from chimera_tpu_torch.ops.cuda.fused import (fused_weights_kde,
                                                  fused_weights_kde_adjoint)

    before = (fused_weights_kde.launches, fused_weights_kde_adjoint.launches)
    h0 = _t([68.0, 75.0]).requires_grad_()
    ll = small_hl.log_like_batch({"H0": h0})
    grad = torch.autograd.grad(ll.sum(), h0)[0]
    assert torch.all(torch.isfinite(grad)) and torch.all(grad != 0.0)
    assert (fused_weights_kde.launches,
            fused_weights_kde_adjoint.launches) == before
