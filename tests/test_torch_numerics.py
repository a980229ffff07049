"""Numerics of the PyTorch port against the JAX package (float64, CPU):
trapezoid rules, interpolation, Chebyshev nodes/fits/evaluation and the KDE
bandwidth factor, on numpy-seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_tpu.ops import chebyshev as jcheb
from chimera_tpu.ops import integrate as jint
from chimera_tpu.ops.kde import bw_factor as jbw_factor
from chimera_tpu_torch.ops import chebyshev as tcheb
from chimera_tpu_torch.ops import integrate as tint
from chimera_tpu_torch.ops.interp import interp
from chimera_tpu_torch.ops.kde import bw_factor

RTOL = 1e-12


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(got, expect, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(expect), rtol=rtol,
                               atol=rtol * np.max(np.abs(expect)))


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def test_trapz_per_row_grids(rng):
    x = np.sort(rng.uniform(0.0, 3.0, (5, 40)), axis=-1)
    y = rng.normal(size=(3, 5, 40))
    _close(tint.trapz(_t(y), _t(x)[None]), jint.trapz(y, x[None]))


def test_cumtrapz(rng):
    x = np.sort(rng.uniform(0.0, 3.0, (4, 50)), axis=-1)
    y = np.exp(rng.normal(size=(4, 50)))
    _close(tint.cumtrapz(_t(y), _t(x)), jint.cumtrapz(y, x))


def test_linspace_and_logspace(rng):
    lo, hi = rng.uniform(0.1, 1.0, 6), rng.uniform(2.0, 5.0, 6)
    _close(tint.linspace(_t(lo), _t(hi), 37), jnp.linspace(lo, hi, 37, axis=1))
    _close(tint.logspace(_t(lo), _t(hi), 37),
           jax.vmap(lambda a, b: jnp.logspace(a, b, 37))(lo, hi))


@pytest.mark.parametrize("batched", [False, True])
def test_interp_with_edge_clamping(rng, batched):
    xp = np.sort(rng.uniform(0.0, 10.0, (3, 30)), axis=-1)
    xp[:, 10] = xp[:, 9]                       # a zero-width interval
    fp = rng.normal(size=(3, 30))
    x = rng.uniform(-2.0, 12.0, (3, 25))       # points beyond both edges
    if batched:
        got = interp(_t(x), _t(xp), _t(fp))
        expect = jax.vmap(jnp.interp)(x, xp, fp)
    else:
        got = interp(_t(x), _t(xp[0]), _t(fp[0]))
        expect = jnp.interp(x, xp[0], fp[0])
    _close(got, expect)


def test_cheb_nodes_scalar_and_batched(rng):
    _close(tcheb.cheb_nodes(17, 0.5, 4.0, dtype=torch.float64),
           jcheb.cheb_nodes(17, 0.5, 4.0))
    a, b = rng.uniform(0.0, 1.0, 4), rng.uniform(2.0, 3.0, 4)
    _close(tcheb.cheb_nodes(17, _t(a), _t(b)),
           jax.vmap(lambda u, v: jcheb.cheb_nodes(17, u, v))(a, b))


@pytest.mark.parametrize("clip", [True, False])
def test_chebfit_and_eval(rng, clip):
    a, b = rng.uniform(0.0, 1.0, 3), rng.uniform(2.0, 3.0, 3)
    nodes = jax.vmap(lambda u, v: jcheb.cheb_nodes(48, u, v))(a, b)
    vals = np.sin(3.0 * np.asarray(nodes)) + np.asarray(nodes) ** 2
    coeffs = jax.vmap(jcheb.chebfit_from_values)(vals)
    _close(tcheb.chebfit_from_values(_t(vals)), coeffs)
    x = rng.uniform(-0.5, 3.5, (3, 7, 11))     # clip=True clamps the edges
    if not clip:
        x = np.clip(x, a[:, None, None], b[:, None, None])
    expect = jax.vmap(lambda c, xx, u, v: jcheb.chebeval(c, xx, u, v, clip=clip)
                      )(coeffs, x, a, b)
    _close(tcheb.chebeval(_t(coeffs), _t(x), _t(a), _t(b), clip=clip), expect)


def test_chebeval_float_interval(rng):
    coeffs = rng.normal(size=(1, 64)) / np.arange(1, 65) ** 2
    x = rng.uniform(-1.0, 11.0, (1, 200))
    _close(tcheb.chebeval(_t(coeffs), _t(x), 0.0, 10.0),
           jcheb.chebeval(coeffs[0], x[0], 0.0, 10.0)[None])


@pytest.mark.parametrize("bw_method", [None, "scott", "silverman", 0.3])
def test_bw_factor(rng, bw_method):
    neff = rng.uniform(1.0, 4096.0, 20)
    _close(bw_factor(_t(neff), 1, bw_method) * torch.ones(20, dtype=torch.float64),
           jbw_factor(neff, 1, bw_method) * np.ones(20))
