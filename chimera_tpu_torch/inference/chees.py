"""ChEES-HMC: a learned, shared trajectory length (counterpart of
``chimera_tpu/inference/chees.py``).

The chain axis is the fused kernel's λ axis (``hmc.py``), so every chain
must take the same number of leapfrog steps per iteration, which rules out
NUTS's per-chain tree recursion.  ChEES-HMC (Hoffman, Radul & Sountsov,
AISTATS 2021) adapts ONE trajectory length shared by all chains, jittered
by a low-discrepancy sequence, by stochastic gradient ascent on the
Change-in-the-Estimator-of-the-Expected-Square criterion

    ChEES = 1/4 E[ (||y' - E y'||^2 - ||y - E y||^2)^2 ],

whose gradient in the trajectory time comes from quantities the leapfrog
already computed (end positions and momenta).  All chains advance in
lock-step batched calls; only the number of calls per iteration varies.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from chimera_tpu_torch.inference.hmc import (AdaptState, HMCState, _accept,
                                             _batch_value_and_grad, _da_update,
                                             _frozen_inv_mass, _init_adapt,
                                             _leapfrog, _per_chain, _welford,
                                             initial_positions,
                                             make_transformed_log_prob_batch)


def _halton(n: int, base: int = 2) -> np.ndarray:
    """First n points of the van der Corput / Halton sequence in (0, 1):
    the low-discrepancy trajectory jitter of the ChEES paper (§4)."""
    out = np.zeros(n)
    for i in range(n):
        f, r, x = 1.0, 0.0, i + 1
        while x > 0:
            f /= base
            r += f * (x % base)
            x //= base
        out[i] = r
    return out


class ChEESAdapt(NamedTuple):
    da: AdaptState          # dual-averaging step size (+ Welford mass)
    log_t: torch.Tensor     # log trajectory TIME (not step count)
    adam_m: torch.Tensor    # Adam first moment on d/d(log_t)
    adam_v: torch.Tensor    # Adam second moment
    adam_i: int             # Adam iteration counter


def _trajectory(state: HMCState, normal, eps, inv_mass, t_jit, max_steps: int,
                vgrad):
    """One shared-length trajectory of all chains from the standard-normal
    draws ``normal`` (C, D).

    Returns the proposal (y1, p1, grad1, logp1), the momenta p0 and the
    number of steps taken."""
    p0 = normal / torch.sqrt(inv_mass)
    n_steps = min(max(math.ceil(float(t_jit / eps)), 1), max_steps)
    y1, p1, grad1, logp1 = _leapfrog(vgrad, state.y, p0, state.grad,
                                     state.logp, eps, inv_mass, n_steps)
    return y1, p1, grad1, logp1, p0, n_steps


def _chees_grad(state: HMCState, y1, p1, inv_mass, accept_prob, u):
    """Per-iteration stochastic gradient of ChEES in the log trajectory
    time (paper eq. 14; the caller folds in the factor t of the log
    parameterization).  Differs from the JAX function only where that
    returns NaN."""
    yc0 = state.y - torch.mean(state.y, dim=0, keepdim=True)
    yc1 = y1 - torch.mean(y1, dim=0, keepdim=True)
    delta = torch.sum(yc1 * yc1, dim=-1) - torch.sum(yc0 * yc0, dim=-1)  # (C,)
    v1 = p1 * inv_mass[None, :]          # dy/dt at the endpoint
    dot = torch.sum(yc1 * v1, dim=-1)    # (C,)
    w = accept_prob / torch.clamp_min(torch.sum(accept_prob), 1e-12)
    # a proposal that cannot be accepted (a trajectory that left the
    # density's support ends in NaN) weighs nothing; 0 * NaN would otherwise
    # turn the trajectory time into NaN for good
    return torch.sum(torch.where(w > 0, w * delta * dot, 0.0)) * u


def run_chees(generator, log_density: Callable, y0: torch.Tensor,
              n_warmup: int = 500, n_samples: int = 500,
              target_accept: float = 0.651, init_step_size: float = 0.1,
              init_traj: float | None = None, max_steps: int = 128,
              thin: int = 1, batched: bool = False, adam_lr: float = 0.025):
    """Adaptive ChEES-HMC over (C, D) initial positions.

    The contract of :func:`chimera_tpu_torch.inference.hmc.run_hmc`
    (returns (samples, stats)), with the trajectory length LEARNED during
    warm-up: the step size adapts by dual averaging toward
    ``target_accept`` (0.651 is the ChEES-optimal rate, paper §4.2), the
    trajectory time by Adam ascent on the ChEES criterion, the diagonal
    mass matrix by Welford; all three freeze for sampling, the Halton
    jitter stays.
    """
    y0 = torch.atleast_2d(y0).detach()
    c, d = y0.shape
    log_density = log_density if batched else _per_chain(log_density)
    vgrad = _batch_value_and_grad(log_density)
    logp0, grad0 = vgrad(y0)
    state = HMCState(y0, logp0, grad0)

    mu = math.log(10.0 * init_step_size)
    t0 = init_traj if init_traj is not None else 16.0 * init_step_size
    zero = y0.new_zeros(())
    adapt = ChEESAdapt(_init_adapt(y0, init_step_size), zero + math.log(t0),
                       zero.clone(), zero.clone(), 0)
    inv_mass0 = torch.ones_like(y0[0])

    def step_once(state, eps, inv_mass, t_total, u):
        normal = torch.randn((c, d), generator=generator, dtype=y0.dtype,
                             device=y0.device)
        y1, p1, grad1, logp1, p0, n_steps = _trajectory(
            state, normal, eps, inv_mass, u * t_total, max_steps, vgrad)
        unif = torch.rand((c,), generator=generator, dtype=y0.dtype,
                          device=y0.device)
        new, accept_prob = _accept(state, y1, p1, grad1, logp1, p0, inv_mass,
                                   unif)
        return new, (y1, p1, accept_prob, n_steps)

    warm_acc, warm_steps = [], []
    with torch.no_grad():
        for step, u in enumerate(_halton(n_warmup)):
            eps = torch.exp(adapt.da.log_eps)
            t_total = torch.exp(adapt.log_t)
            new_state, (y1, p1, accept_prob, n_steps) = step_once(
                state, eps, inv_mass0, t_total, float(u))

            # trajectory-time Adam ascent on the ChEES gradient
            g = _chees_grad(state, y1, p1, inv_mass0, accept_prob, float(u)) \
                * t_total
            i1 = adapt.adam_i + 1
            m = 0.9 * adapt.adam_m + 0.1 * g
            v = 0.999 * adapt.adam_v + 0.001 * g * g
            m_hat = m / (1.0 - 0.9 ** i1)
            v_hat = v / (1.0 - 0.999 ** i1)
            log_t = adapt.log_t + adam_lr * m_hat / (torch.sqrt(v_hat) + 1e-8)
            # at least one step, at most max_steps
            log_t = torch.minimum(torch.maximum(log_t, torch.log(eps)),
                                  torch.log(max_steps * eps))

            da = _da_update(adapt.da, torch.mean(accept_prob), float(step),
                            target_accept, mu)
            adapt = ChEESAdapt(_welford(da, new_state.y), log_t, m, v, i1)
            state = new_state
            warm_acc.append(torch.mean(accept_prob))
            warm_steps.append(n_steps)

        eps = torch.exp(adapt.da.log_eps_bar)
        inv_mass = _frozen_inv_mass(adapt.da)
        t_total = torch.exp(adapt.log_t)

        ys, logps, accs, steps = [], [], [], []
        for u in _halton(n_samples):
            state, (_, _, accept_prob, n_steps) = step_once(
                state, eps, inv_mass, t_total, float(u))
            ys.append(state.y)
            logps.append(state.logp)
            accs.append(accept_prob)
            steps.append(n_steps)
    sel = slice(thin - 1, None, thin)
    stats = {
        "step_size": eps,
        "trajectory_time": t_total,
        "mean_leapfrog_steps": float(np.mean(steps)) if steps else 0.0,
        "steps_total": int(np.sum(steps)),
        "inv_mass": inv_mass,
        "warmup_accept": torch.stack(warm_acc) if warm_acc else y0.new_zeros(0),
        "warmup_steps": warm_steps,
        "accept": torch.stack(accs),
        "log_prob": torch.stack(logps)[sel],
        "final_state": state,
    }
    return torch.stack(ys)[sel], stats


def sample_hyperposterior_chees(generator, hl, param_names: list[str],
                                bounds: dict[str, tuple[float, float]],
                                init: dict[str, float],
                                n_chains: int = 16, n_warmup: int = 300,
                                n_samples: int = 500,
                                init_scale: float = 0.05,
                                extra_log_prior=None, **kwargs):
    """End-to-end ChEES-HMC posterior over hyper-parameters: the
    dynamic-trajectory counterpart of ``hmc.sample_hyperposterior``, the
    same batched evaluation with a learned trajectory length."""
    log_density_batch, tr = make_transformed_log_prob_batch(
        hl, param_names, bounds, extra_log_prior)
    y0 = initial_positions(generator, tr, param_names, init, n_chains,
                           init_scale)
    ys, stats = run_chees(generator, log_density_batch, y0, n_warmup=n_warmup,
                          n_samples=n_samples, batched=True, **kwargs)
    xs = tr.constrain(ys)
    return {p: xs[:, :, i] for i, p in enumerate(param_names)}, stats
