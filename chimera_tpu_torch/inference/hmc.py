"""Hamiltonian Monte Carlo with window adaptation (counterpart of
``chimera_tpu/inference/hmc.py``).

- a logit/affine reparameterization of bounded hyper-parameters, so HMC
  runs in unconstrained space with exact log-Jacobian corrections;
- leapfrog HMC with a jittered trajectory length (Neal 2011), dual-averaging
  step-size adaptation to a target acceptance (Hoffman & Gelman 2014) and a
  diagonal mass matrix (Welford) adapted during warm-up;
- all chains evaluated in ONE batched call per leapfrog step
  (:func:`make_transformed_log_prob_batch`): the chain axis is the fused
  kernel's λ axis, and the per-chain gradients come from one backward of
  the summed density (the forward through K1a, the backward through the
  adjoint kernel K3 on CUDA tensors).

PyTorch idiom: an explicit ``torch.Generator`` takes the place of the PRNG
key, plain Python loops the place of ``lax.scan`` (the jittered trajectory
length is a Python int drawn once per step), and every tensor carried
between steps is detached, so no graph outlives its leapfrog step.  The
generator's stream differs from JAX's: chains agree with the JAX package's
as distributions, not number for number.

Two deliberate differences from the JAX samplers, where the likelihood
itself stays the reference's:

- every non-finite log density counts as -inf.  A λ whose injection N_eff
  falls below its gate has N_exp = 0 and log L = +inf in both packages
  (``selection.py``, ``likelihood.py::_finish``); the JAX samplers map only
  NaN to -inf, so a proposal there is accepted and the chain sticks;
- a proposal whose gradient is not finite is a divergent trajectory and is
  rejected.  A gated event gives d log L / d(H0, Om0) = 0 / 0 = NaN in both
  packages (``likelihood.py::log_like_batch``); that NaN also reaches the
  proposal's momentum and energy, which the JAX step rejects for being NaN:
  the check states the rule instead of leaning on that.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Bounded <-> unconstrained reparameterization
# ---------------------------------------------------------------------------


class Transform(NamedTuple):
    lo: torch.Tensor   # (D,) lower bounds (-inf for unbounded)
    hi: torch.Tensor   # (D,) upper bounds (+inf for unbounded)

    # Every branch of the selects below is evaluated for every dimension,
    # so a branch's inputs must be finite even where it is not selected:
    # inf * 0 would leak NaN through autograd.

    def _safe(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        lo = torch.where(torch.isfinite(self.lo), self.lo, 0.0)
        hi = torch.where(torch.isfinite(self.hi), self.hi, 1.0)
        span = torch.where(torch.isfinite(self.hi - self.lo), hi - lo, 1.0)
        return lo, hi, span

    def constrain(self, y: torch.Tensor) -> torch.Tensor:
        """Unconstrained y (..., D) -> bounded x (sigmoid for two-sided
        bounds)."""
        lo, hi, span = self._safe()
        two = lo + span * torch.sigmoid(y)
        lo_only = lo + torch.exp(y)
        hi_only = hi - torch.exp(y)
        has_lo, has_hi = torch.isfinite(self.lo), torch.isfinite(self.hi)
        return torch.where(has_lo & has_hi, two,
                           torch.where(has_lo, lo_only,
                                       torch.where(has_hi, hi_only, y)))

    def unconstrain(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi, span = self._safe()
        t = torch.clamp((x - lo) / span, 1e-12, 1 - 1e-12)
        two = torch.log(t) - torch.log1p(-t)
        lo_only = torch.log(torch.clamp_min(x - lo, 1e-300))
        hi_only = torch.log(torch.clamp_min(hi - x, 1e-300))
        has_lo, has_hi = torch.isfinite(self.lo), torch.isfinite(self.hi)
        return torch.where(has_lo & has_hi, two,
                           torch.where(has_lo, lo_only,
                                       torch.where(has_hi, hi_only, x)))

    def log_jacobian(self, y: torch.Tensor) -> torch.Tensor:
        """log |dx/dy| summed over the last axis."""
        _, _, span = self._safe()
        s = F.logsigmoid(y) + F.logsigmoid(-y) + torch.log(span)
        has_lo, has_hi = torch.isfinite(self.lo), torch.isfinite(self.hi)
        # one-sided: d(exp(y))/dy = exp(y)
        lj = torch.where(has_lo & has_hi, s,
                         torch.where(has_lo | has_hi, y, torch.zeros_like(y)))
        return torch.sum(lj, dim=-1)


def _transform(hl, param_names, bounds) -> Transform:
    ref = hl.population.cosmo.H0
    inf = math.inf
    lo = [bounds.get(p, (-inf, inf))[0] for p in param_names]
    hi = [bounds.get(p, (-inf, inf))[1] for p in param_names]
    return Transform(torch.tensor(lo, dtype=ref.dtype, device=ref.device),
                     torch.tensor(hi, dtype=ref.dtype, device=ref.device))


def _finite_or_neginf(lp: torch.Tensor) -> torch.Tensor:
    """A log density with every non-finite value (NaN, and the +inf of a
    gated N_exp) taken as -inf: no sampler moves there."""
    return torch.where(torch.isfinite(lp), lp, -torch.inf)


def make_transformed_log_prob(hl, param_names: list[str],
                              bounds: dict[str, tuple[float, float]],
                              extra_log_prior=None):
    """(log_density(y), transform): the unconstrained target of one chain.

    ``log_density`` maps a (D,) unconstrained vector to the
    hyper-likelihood at the constrained point plus the transform's
    log-Jacobian (flat priors inside the bounds)."""
    tr = _transform(hl, param_names, bounds)

    def log_density(y: torch.Tensor) -> torch.Tensor:
        x = tr.constrain(y)
        lam = {p: x[i] for i, p in enumerate(param_names)}
        lp = hl.log_like_batch({p: v[None] for p, v in lam.items()})[0]
        if extra_log_prior is not None:
            lp = lp + extra_log_prior(lam)
        return _finite_or_neginf(lp) + tr.log_jacobian(y)

    return log_density, tr


def make_transformed_log_prob_batch(hl, param_names: list[str],
                                    bounds: dict[str, tuple[float, float]],
                                    extra_log_prior=None):
    """Batched unconstrained target: (C, D) positions -> (C,) log densities.

    All chains evaluate in ONE ``log_like_batch`` call (the chain axis is
    the fused kernel's λ axis; on the card the backward of that pass is the
    adjoint kernel).  ``extra_log_prior`` maps the dict of (C,) parameter
    tensors to (C,) log priors."""
    tr = _transform(hl, param_names, bounds)

    def log_density_batch(ys: torch.Tensor) -> torch.Tensor:
        xs = tr.constrain(ys)                                  # (C, D)
        lam = {p: xs[:, i] for i, p in enumerate(param_names)}
        lp = hl.log_like_batch(lam)
        if extra_log_prior is not None:
            lp = lp + extra_log_prior(lam)
        return _finite_or_neginf(lp) + tr.log_jacobian(ys)

    return log_density_batch, tr


# ---------------------------------------------------------------------------
# HMC core
# ---------------------------------------------------------------------------

class HMCState(NamedTuple):
    y: torch.Tensor        # (C, D) unconstrained positions
    logp: torch.Tensor     # (C,)
    grad: torch.Tensor     # (C, D)


class AdaptState(NamedTuple):
    log_eps: torch.Tensor      # dual-averaging iterates
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor
    mean: torch.Tensor         # Welford running mean over all chains (D,)
    m2: torch.Tensor           # Welford running M2 (D,)
    count: torch.Tensor


def _per_chain(log_density: Callable) -> Callable:
    """A (D,) -> () density as a (C, D) -> (C,) one, chain by chain."""
    return lambda ys: torch.stack([log_density(y) for y in ys])


def _batch_value_and_grad(log_density_batch: Callable) -> Callable:
    """(C, D) -> ((C,) values, (C, D) per-chain gradients) in ONE batched
    evaluation: chains are independent, so the gradient of the summed
    density is the per-chain gradients.  Both come back detached."""
    def vgrad(ys: torch.Tensor):
        ys = ys.detach().requires_grad_()
        with torch.enable_grad():
            logp = log_density_batch(ys)
            (grads,) = torch.autograd.grad(torch.sum(logp), ys)
        return logp.detach(), grads

    return vgrad


def _leapfrog(vgrad, y, p, grad, logp, eps, inv_mass, n_steps: int):
    for _ in range(n_steps):
        p = p + 0.5 * eps * grad
        y = y + eps * inv_mass[None, :] * p
        logp, grad = vgrad(y)
        p = p + 0.5 * eps * grad
    return y, p, grad, logp


def _accept(state: HMCState, y1, p1, grad1, logp1, p0, inv_mass, u):
    """Metropolis step on the proposal; returns the new state and the
    acceptance probabilities.  A NaN energy change rejects, and so does a
    proposal whose gradient is not finite (a divergent trajectory)."""
    ke0 = 0.5 * torch.sum(inv_mass * p0 * p0, dim=-1)
    ke1 = 0.5 * torch.sum(inv_mass * p1 * p1, dim=-1)
    log_accept = (logp1 - ke1) - (state.logp - ke0)
    divergent = torch.isnan(log_accept) | ~torch.all(torch.isfinite(grad1),
                                                     dim=-1)
    log_accept = torch.where(divergent, -torch.inf, log_accept)
    accept_prob = torch.clamp_max(torch.exp(log_accept), 1.0)
    acc = u < accept_prob
    # each (y, logp, grad) triple is self-consistent, so a select keeps the
    # state exact with no recomputation
    new = HMCState(torch.where(acc[:, None], y1, state.y),
                   torch.where(acc, logp1, state.logp),
                   torch.where(acc[:, None], grad1, state.grad))
    return new, accept_prob


def _hmc_step(generator, state: HMCState, eps, inv_mass, n_steps: int,
              log_density_batch, draws=None):
    """One jittered-length HMC update of all chains (batched leapfrog).

    ``draws`` = (momenta (C, D) standard normal, trajectory length, (C,)
    uniforms) replaces the generator's draws."""
    vgrad = _batch_value_and_grad(log_density_batch)
    c, d = state.y.shape
    with torch.no_grad():
        if draws is None:
            normal = torch.randn((c, d), generator=generator, dtype=state.y.dtype,
                                 device=state.y.device)
            # the trajectory length is jittered uniformly in [1, n_steps]
            # and shared by the chains, so that they advance in lock-step
            # batched evaluations
            length = int(torch.randint(1, n_steps + 1, (), generator=generator,
                                       device=state.y.device))
            u = torch.rand((c,), generator=generator, dtype=state.y.dtype,
                           device=state.y.device)
        else:
            normal, length, u = draws
        p0 = normal / torch.sqrt(inv_mass)
        y1, p1, grad1, logp1 = _leapfrog(vgrad, state.y, p0, state.grad,
                                         state.logp, eps, inv_mass, length)
        return _accept(state, y1, p1, grad1, logp1, p0, inv_mass, u)


def _da_update(adapt: AdaptState, accept_mean, step, target, mu,
               gamma=0.05, t0=10.0, kappa=0.75) -> AdaptState:
    """Dual averaging (Hoffman & Gelman 2014, algorithm 5)."""
    t = step + 1.0
    eta_h = 1.0 / (t + t0)
    h_bar = (1.0 - eta_h) * adapt.h_bar + eta_h * (target - accept_mean)
    log_eps = mu - math.sqrt(t) / gamma * h_bar
    eta = t ** (-kappa)
    log_eps_bar = eta * log_eps + (1.0 - eta) * adapt.log_eps_bar
    return adapt._replace(log_eps=log_eps, log_eps_bar=log_eps_bar, h_bar=h_bar)


def _welford(adapt: AdaptState, y: torch.Tensor) -> AdaptState:
    """Pool the chains' positions into the running mean and M2."""
    cnt = adapt.count + y.shape[0]
    delta = y - adapt.mean[None, :]
    mean = adapt.mean + torch.sum(delta, dim=0) / cnt
    m2 = adapt.m2 + torch.sum(delta * (y - mean[None, :]), dim=0)
    return adapt._replace(mean=mean, m2=m2, count=cnt)


def _init_adapt(y0: torch.Tensor, init_step_size: float) -> AdaptState:
    d = y0.shape[1]
    scalar = y0.new_zeros(())
    return AdaptState(scalar + math.log(init_step_size),
                      scalar + math.log(init_step_size), scalar.clone(),
                      y0.new_zeros(d), y0.new_zeros(d), scalar.clone())


def _frozen_inv_mass(adapt: AdaptState) -> torch.Tensor:
    """The inverse mass of the sampling phase: the posterior variance."""
    var = adapt.m2 / torch.clamp_min(adapt.count - 1.0, 1.0)
    return torch.where(var > 0, var, 1.0)


def _sample(generator, log_density, state: HMCState, eps, inv_mass,
            n_samples: int, n_leapfrog: int, thin: int):
    ys, logps, accs = [], [], []
    for _ in range(n_samples):
        state, acc = _hmc_step(generator, state, eps, inv_mass, n_leapfrog,
                               log_density)
        ys.append(state.y)
        logps.append(state.logp)
        accs.append(acc)
    sel = slice(thin - 1, None, thin)
    stats = {"step_size": eps, "inv_mass": inv_mass,
             "accept": torch.stack(accs), "log_prob": torch.stack(logps)[sel],
             "final_state": state}
    return torch.stack(ys)[sel], stats


def run_hmc(generator, log_density: Callable, y0: torch.Tensor,
            n_warmup: int = 500, n_samples: int = 500,
            n_leapfrog: int = 16, target_accept: float = 0.8,
            init_step_size: float = 0.1, thin: int = 1,
            batched: bool = False):
    """Adaptive HMC over (C, D) initial positions (unconstrained space).

    Returns (samples (n_samples // thin, C, D), stats dict).  Warm-up adapts
    the step size (dual averaging) and a diagonal mass matrix (Welford over
    all chains); both freeze for sampling.  ``generator`` is a
    ``torch.Generator`` on ``y0``'s device.

    ``batched=True`` declares that ``log_density`` maps (C, D) -> (C,)
    directly (from :func:`make_transformed_log_prob_batch`); otherwise it
    is called chain by chain.
    """
    y0 = torch.atleast_2d(y0).detach()
    log_density = log_density if batched else _per_chain(log_density)
    logp0, grad0 = _batch_value_and_grad(log_density)(y0)
    state = HMCState(y0, logp0, grad0)
    mu = math.log(10.0 * init_step_size)
    adapt = _init_adapt(y0, init_step_size)
    inv_mass0 = torch.ones_like(y0[0])

    warm_acc = []
    for step in range(n_warmup):
        state, acc = _hmc_step(generator, state, torch.exp(adapt.log_eps),
                               inv_mass0, n_leapfrog, log_density)
        adapt = _da_update(adapt, torch.mean(acc), float(step), target_accept, mu)
        adapt = _welford(adapt, state.y)
        warm_acc.append(torch.mean(acc))

    # freeze the adapted quantities
    ys, stats = _sample(generator, log_density, state,
                        torch.exp(adapt.log_eps_bar), _frozen_inv_mass(adapt),
                        n_samples, n_leapfrog, thin)
    stats["warmup_accept"] = torch.stack(warm_acc) if warm_acc \
        else y0.new_zeros(0)
    return ys, stats


def continue_hmc(generator, log_density: Callable, state: HMCState,
                 step_size, inv_mass, n_samples: int = 500,
                 n_leapfrog: int = 16, thin: int = 1, batched: bool = False):
    """Continue sampling from a post-warm-up state (no re-adaptation): the
    same generator state, state and step give the same chain."""
    log_density = log_density if batched else _per_chain(log_density)
    eps = torch.as_tensor(step_size, dtype=state.y.dtype, device=state.y.device)
    inv_mass = torch.as_tensor(inv_mass, dtype=state.y.dtype,
                               device=state.y.device)
    return _sample(generator, log_density, state, eps, inv_mass, n_samples,
                   n_leapfrog, thin)


def initial_positions(generator, tr: Transform, param_names, init: dict,
                      n_chains: int, init_scale: float) -> torch.Tensor:
    """(C, D) unconstrained starting points scattered around ``init``."""
    x0 = torch.tensor([init[p] for p in param_names], dtype=tr.lo.dtype,
                      device=tr.lo.device)
    noise = torch.randn((n_chains, len(param_names)), generator=generator,
                        dtype=x0.dtype, device=x0.device)
    return tr.unconstrain(x0)[None, :] + init_scale * noise


def sample_hyperposterior(generator, hl, param_names: list[str],
                          bounds: dict[str, tuple[float, float]],
                          init: dict[str, float],
                          n_chains: int = 16, n_warmup: int = 500,
                          n_samples: int = 500, init_scale: float = 0.05,
                          extra_log_prior=None, **hmc_kwargs):
    """End to end: HMC posterior samples of the hyper-parameters.

    Returns (samples dict {name: (n_samples, n_chains)}, stats).
    ``generator`` is a ``torch.Generator`` on the likelihood's device.

    Every leapfrog step is one ``log_like_batch`` over the chains plus one
    backward, and a batch carries a cost that does not grow with the number
    of chains (the population tables' rebuild and its backward, hundreds of
    small launches): more chains per batch amortize it (PERF.md §5)."""
    log_density_batch, tr = make_transformed_log_prob_batch(
        hl, param_names, bounds, extra_log_prior)
    y0 = initial_positions(generator, tr, param_names, init, n_chains,
                           init_scale)
    ys, stats = run_hmc(generator, log_density_batch, y0, n_warmup=n_warmup,
                        n_samples=n_samples, batched=True, **hmc_kwargs)
    xs = tr.constrain(ys)                                      # (S, C, D)
    return {p: xs[:, :, i] for i, p in enumerate(param_names)}, stats
