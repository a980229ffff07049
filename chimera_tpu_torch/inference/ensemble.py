"""Affine-invariant ensemble MCMC, the Goodman & Weare stretch move
(counterpart of ``chimera_tpu/inference/ensemble.py``).

emcee's default ``StretchMove`` in its red-blue split form (Foreman-Mackey
et al. 2013): each half of the walkers moves against partners drawn from
the other, frozen half, with z ~ g(z) ∝ 1/sqrt(z) on [1/a, a], and is
accepted with probability z^(D-1) p(new) / p(old).  The sampler needs no
gradient, so it runs every likelihood kind on the card, 'full' (whose KDE
kernel K5 has no adjoint) included.

PyTorch idiom: an explicit ``torch.Generator`` takes the place of the PRNG
key and is passed to every call, not kept in the state; a Python loop takes
the place of ``lax.scan``.  A half-step is split into its draws
(:func:`stretch_draws`) and a pure update given them
(:func:`stretch_update`), so that a test can feed the update the JAX step's
draws.  The generator's stream differs from JAX's: chains agree with the
JAX package's as distributions, not number for number.

:func:`make_vector_log_prob` evaluates the walkers of a half-step in ONE
``log_like_batch`` (the λ axis of the kernels), so a step is two batches.
Like the port's HMC it counts every non-finite log density as -inf: the
+inf of a λ whose injection N_eff falls below its gate
(``likelihood.py::_finish``) included, where the JAX sampler maps only NaN
to -inf and a walker that reaches such a λ stays there.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from chimera_tpu_torch.inference.hmc import _finite_or_neginf


class EnsembleState(NamedTuple):
    coords: torch.Tensor       # (n_walkers, D)
    log_prob: torch.Tensor     # (n_walkers,)
    n_accepted: torch.Tensor   # (n_walkers,) int64, cumulative
    iteration: int


class StretchDraws(NamedTuple):
    u: torch.Tensor            # (n,) uniforms of the stretch factor
    partner: torch.Tensor      # (n,) int64 indices into the other half
    accept_u: torch.Tensor     # (n,) uniforms of the acceptance test


def stretch_draws(generator, n_active: int, n_other: int, dtype, device
                  ) -> StretchDraws:
    """The random numbers of one half-step, in the JAX step's order."""
    u = torch.rand((n_active,), generator=generator, dtype=dtype, device=device)
    partner = torch.randint(0, n_other, (n_active,), generator=generator,
                            device=device)
    accept_u = torch.rand((n_active,), generator=generator, dtype=dtype,
                          device=device)
    return StretchDraws(u, partner, accept_u)


def stretch_update(active: torch.Tensor, other: torch.Tensor,
                   logp_active: torch.Tensor, log_prob_fn: Callable,
                   a: float, draws: StretchDraws):
    """One red-blue half update of ``active`` (n, D) against partners from
    ``other`` given ``draws``: returns the new coords, log densities and
    the (n,) acceptances.  One call of ``log_prob_fn`` on all proposals."""
    ndim = active.shape[1]
    z = ((a - 1.0) * draws.u + 1.0) ** 2 / a
    partners = other[draws.partner]
    proposal = partners + z[:, None] * (active - partners)
    logp_new = log_prob_fn(proposal)
    log_accept = (ndim - 1.0) * torch.log(z) + logp_new - logp_active
    accept = torch.log(draws.accept_u) < log_accept
    coords = torch.where(accept[:, None], proposal, active)
    logp = torch.where(accept, logp_new, logp_active)
    return coords, logp, accept


def init_state(coords: torch.Tensor, log_prob_fn: Callable) -> EnsembleState:
    """The walkers' starting state: one evaluation of all of them."""
    coords = torch.as_tensor(coords)
    return EnsembleState(coords, log_prob_fn(coords),
                         torch.zeros(coords.shape[0], dtype=torch.int64,
                                     device=coords.device), 0)


def step(generator, state: EnsembleState, log_prob_fn: Callable,
         a: float = 2.0) -> EnsembleState:
    """One full ensemble update: the first half moves against the second,
    then the second against the moved first.  ``log_prob_fn`` maps (n, D)
    -> (n,); ``generator`` lives on the coords' device."""
    half = state.coords.shape[0] // 2
    first, second = state.coords[:half], state.coords[half:]
    lp1, lp2 = state.log_prob[:half], state.log_prob[half:]
    dt, dev = state.coords.dtype, state.coords.device
    first, lp1, acc1 = stretch_update(
        first, second, lp1, log_prob_fn, a,
        stretch_draws(generator, first.shape[0], second.shape[0], dt, dev))
    second, lp2, acc2 = stretch_update(
        second, first, lp2, log_prob_fn, a,
        stretch_draws(generator, second.shape[0], first.shape[0], dt, dev))
    return EnsembleState(torch.cat([first, second]), torch.cat([lp1, lp2]),
                         state.n_accepted + torch.cat([acc1, acc2]).long(),
                         state.iteration + 1)


def run(generator, state: EnsembleState, log_prob_fn: Callable, n_steps: int,
        a: float = 2.0, thin: int = 1) -> tuple[EnsembleState, dict]:
    """Advance ``n_steps`` iterations.  Returns the final state and the
    thinned history {'coords': (n_steps // thin, n_walkers, D), 'log_prob':
    (n_steps // thin, n_walkers)}: the state after every ``thin`` steps.
    The same generator state and walkers give the same chain."""
    if n_steps % thin:
        raise ValueError("n_steps must be a multiple of thin")
    coords, logps = [], []
    for i in range(n_steps):
        state = step(generator, state, log_prob_fn, a)
        if (i + 1) % thin == 0:
            coords.append(state.coords)
            logps.append(state.log_prob)
    empty = state.coords.new_zeros((0, *state.coords.shape))
    return state, {
        "coords": torch.stack(coords) if coords else empty,
        "log_prob": torch.stack(logps) if logps else empty[..., 0]}


def _bounds(param_names, bounds, dtype, device):
    inf = math.inf
    bounds = bounds or {}
    lo = [bounds.get(p, (-inf, inf))[0] for p in param_names]
    hi = [bounds.get(p, (-inf, inf))[1] for p in param_names]
    return (torch.tensor(lo, dtype=dtype, device=device),
            torch.tensor(hi, dtype=dtype, device=device))


def make_vector_log_prob(hl, param_names: list[str],
                         bounds: dict[str, tuple[float, float]] | None = None,
                         extra_log_prior=None):
    """The hyper-likelihood as a (n, D) -> (n,) function of walker
    positions, columns in the order of ``param_names``, flat priors inside
    ``bounds``.  Each call is ONE ``hl.log_like_batch`` under
    ``torch.no_grad()`` on the walkers clamped into the bounds; out-of-bounds
    walkers and non-finite values are then set to -inf (the clamp keeps the
    batch dense).  ``extra_log_prior`` maps the dict of clamped (n,)
    parameter tensors to (n,) log priors."""
    ref = hl.population.cosmo.H0
    lo, hi = _bounds(param_names, bounds, ref.dtype, ref.device)
    lo_safe = torch.where(torch.isfinite(lo), lo, -1e30)
    hi_safe = torch.where(torch.isfinite(hi), hi, 1e30)

    def batch(vecs: torch.Tensor) -> torch.Tensor:
        vecs = torch.as_tensor(vecs, dtype=ref.dtype, device=ref.device)
        safe = torch.minimum(torch.maximum(vecs, lo_safe), hi_safe)
        lam = {p: safe[:, i] for i, p in enumerate(param_names)}
        with torch.no_grad():
            logp = hl.log_like_batch(lam)
            if extra_log_prior is not None:
                logp = logp + extra_log_prior(lam)
        in_bounds = torch.all((vecs >= lo) & (vecs <= hi), dim=-1)
        return torch.where(in_bounds, _finite_or_neginf(logp), -torch.inf)

    return batch


def initialize_walkers(generator, center: dict, n_walkers: int,
                       param_names: list[str], scale: dict | None = None,
                       bounds: dict | None = None,
                       distribution: str = "gaussian",
                       dtype=torch.float64) -> torch.Tensor:
    """(n_walkers, D) initial positions on the generator's device
    (``chimera_tpu/inference/ensemble.py::initialize_walkers``):

    'gaussian'   — a Gaussian ball around ``center`` (scale 5 % of |center|
                   + 1e-3 unless given), clipped into the bounds;
    'truncgauss' — the same ball, out-of-bounds coordinates redrawn
                   uniformly within the bounds (the reference's scheme);
    'uniform'    — uniform within the bounds (which must be finite).
    """
    device = generator.device
    mu = torch.tensor([center[p] for p in param_names], dtype=dtype,
                      device=device)
    sig = torch.tensor([(scale or {}).get(p, 0.05 * abs(center[p]) + 1e-3)
                        for p in param_names], dtype=dtype, device=device)
    lo, hi = _bounds(param_names, bounds, dtype, device)
    finite = torch.isfinite(hi - lo)
    span = torch.where(finite, hi - lo, 1.0)
    shape = (n_walkers, len(param_names))
    if distribution == "uniform":
        if bounds is None or not bool(torch.all(finite)):
            raise ValueError("'uniform' initialization requires finite bounds")
        return lo + span * torch.rand(shape, generator=generator, dtype=dtype,
                                      device=device)
    if distribution not in ("gaussian", "truncgauss"):
        raise ValueError(
            "distribution must be 'gaussian', 'truncgauss', or 'uniform'")
    x = mu + sig * torch.randn(shape, generator=generator, dtype=dtype,
                               device=device)
    if distribution == "truncgauss":
        redraw = lo + span * torch.rand(shape, generator=generator,
                                        dtype=dtype, device=device)
        return torch.where((x < lo) | (x > hi), redraw, x)
    if bounds:
        x = torch.minimum(torch.maximum(x, lo + 1e-6 * span), hi - 1e-6 * span)
    return x
