"""Hyper-parameter gradients of the PyTorch port against the JAX package on
identical data, float64 on the CPU (the port's plain versions; the JAX side
through its XLA engine).

Data: 8 events x 256 samples x 64-point z-grids with degree-16 Chebyshev
engines, the shape of ``tests/test_fused_kernel.py::tiny_spectral_hl``,
rebuilt with ``cut_grid=None``."""

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from chimera_tpu import HyperLikelihood as JHL
from chimera_tpu import SelectionFunction as JSel
from chimera_tpu import pytree as jpytree
from chimera_tpu.likelihood import log_hyperlikelihood_batch
from chimera_tpu.models import FLRW as JFLRW
from chimera_tpu.models import PowerLawPeak as JPLP
from chimera_tpu.models import compute_z_grids as j_compute_z_grids
from chimera_tpu.ops import chebyshev as jcheb
from chimera_tpu.ops.pallas import fused as jfused
from chimera_tpu_torch import HyperLikelihood
from chimera_tpu_torch.convert import state_from_reference
from chimera_tpu_torch.models import FLRW
from chimera_tpu_torch.ops.chebyshev import _chebeval_loop, chebeval
from chimera_tpu_torch.ops.cuda.fused import (MASS_SCALARS, STAT_NAMES,
                                              fused_weights_kde_adjoint_plain,
                                              pack_params)

F64 = torch.float64
NAMES = ("H0", "Om0", "mu_g")
# two hyper-parameter points, a λ batch of 2
LAMBDA = np.array([[68.0, 0.27, 33.0], [74.0, 0.22, 35.0]])


def _rel(got, expect):
    """Largest error relative to the largest entry of each last-axis row."""
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    expect = np.asarray(expect)
    scale = np.max(np.abs(expect), axis=-1, keepdims=True)
    return np.max(np.abs(got - expect) / np.where(scale > 0, scale, 1.0))


def _batch(x):
    return {n: x[:, i] for i, n in enumerate(NAMES)}


@pytest.fixture(scope="module")
def jax_hl(fiducial_population, mock_catalog, mock_injections):
    pop = jpytree.replace(
        fiducial_population, cosmo=JFLRW.create(H0=70.0, Om0=0.25, cheb_deg=16),
        mass=JPLP.create(window_deg=16))
    cat = jtu.tree_map(lambda a: a[:8] if a.ndim >= 1 else a, mock_catalog)
    z_grids = j_compute_z_grids(pop.cosmo, cat,
                                cosmo_prior={"H0": [30.0, 150.0]}, z_int_res=64)
    theta_inj, n_inj = mock_injections
    return JHL.create(cat, z_grids, pop, JSel.create(theta_inj, n_inj),
                      binning=False, cut_grid=None, kde_engine="xla")


@pytest.fixture(scope="module")
def hl(jax_hl):
    return HyperLikelihood.from_state(state_from_reference(jax_hl), "cpu", F64)


# -- (a) the analytic backward of chebeval ----------------------------------

@pytest.mark.parametrize("clip", [True, False])
def test_chebeval_backward(clip):
    """Against autograd through the recurrence and against ``jax.grad`` of
    the JAX package's chebeval, in the coefficients, x, a and b: 1e-12 of
    each gradient's largest entry.  x straddles [a, b] when clipping."""
    rng = np.random.default_rng(3)
    c = rng.normal(size=(2, 9))
    lo, hi = (-0.4, 2.6) if clip else (0.35, 1.9)
    x = rng.uniform(lo, hi, size=(2, 5, 7))
    a, b = np.array([0.1, 0.3]), np.array([2.0, 2.2])
    ct = rng.normal(size=x.shape)

    def grads(fn):
        ins = [torch.tensor(v, requires_grad=True) for v in (c, x, a, b)]
        out = fn(ins[0], ins[1], ins[2], ins[3], clip)
        return torch.autograd.grad(torch.sum(out * torch.tensor(ct)), ins)

    got, loop = grads(chebeval), grads(_chebeval_loop)
    for l in range(2):
        expect = jax.grad(lambda *v: jnp.sum(
            jcheb.chebeval(*v, clip=clip) * ct[l]), argnums=(0, 1, 2, 3))(
                jnp.asarray(c[l]), jnp.asarray(x[l]), a[l], b[l])
        for g, g_loop, e in zip(got, loop, expect):
            e = np.asarray(e).reshape(1, -1)
            assert _rel(g[l].reshape(1, -1), e) <= 1e-12
            assert _rel(g_loop[l].reshape(1, -1), e) <= 1e-12


def test_chebeval_backward_scalar_bounds():
    """Float bounds (the comoving-distance series): gradients in the
    coefficients and x only, equal to autograd through the recurrence."""
    rng = np.random.default_rng(4)
    c = torch.tensor(rng.normal(size=(3, 12)), requires_grad=True)
    x = torch.tensor(rng.uniform(-0.5, 10.5, size=(1, 40)), requires_grad=True)
    ct = torch.tensor(rng.normal(size=(3, 40)))
    got = torch.autograd.grad(torch.sum(chebeval(c, x, 0.0, 10.0) * ct), (c, x))
    loop = torch.autograd.grad(
        torch.sum(_chebeval_loop(c, x, 0.0, 10.0, True) * ct), (c, x))
    for g, e in zip(got, loop):
        assert _rel(g, e.numpy()) <= 1e-12


def test_flrw_table_gradient():
    """d cheb_logh / d{H0, Om0} through the table fit (Newton start on a
    table, three Newton steps, clamps) against ``jax.jacobian`` of the JAX
    ``FLRW.create``."""
    expect = jax.jit(jax.jacobian(lambda h0, om: JFLRW.create(
        H0=h0, Om0=om, cheb_deg=16).cheb_logh, argnums=(0, 1)))(70.0, 0.25)
    x = torch.tensor([70.0, 0.25], dtype=F64, requires_grad=True)
    logh = FLRW.create(H0=x[:1], Om0=x[1:], cheb_deg=16, device="cpu",
                       dtype=F64).cheb_logh[0]
    got = torch.stack([torch.autograd.grad(v, x, retain_graph=True)[0]
                       for v in logh], dim=1)                  # (2, 16)
    assert _rel(got, np.stack([np.asarray(e) for e in expect])) <= 1e-9


# -- (b) the fused pass's packed-row gradients ------------------------------

def _reference_vjp(jax_hl, hl, kernel, ct_den, ct_stats, interpret=False):
    """The JAX package's gradient of the fused pass in its model leaves,
    packed like ``pack_params``: through ``_reference_impl``, or through the
    adjoint Pallas kernel in interpret mode."""
    arrs = [jnp.asarray(t.numpy()) for t in (hl.m1det, hl.m2det, hl.dL,
                                             hl.inv_pe_prior, hl.z_grids)]
    n = ct_den.shape[0]
    lam = {k: jnp.asarray(v[:n]) for k, v in _batch(LAMBDA).items()}
    pop_b = jax.vmap(lambda p: jax_hl.population.update(**p))(lam)
    cfg = jfused._FusedCfg(kernel=kernel, bw_method=None, cut_grid=None,
                           n_grid=arrs[4].shape[1], den_scale="norms",
                           interpret=True, logical_s=None, bwd="pallas")
    cts = (jnp.asarray(ct_den),
           {k: jnp.asarray(ct_stats[..., i]) for i, k in enumerate(STAT_NAMES)})
    residuals = (*arrs[:4], pop_b.cosmo, pop_b.mass, arrs[4], None, None, None,
                 None, None, None, None)
    if interpret:
        out = jfused._adjoint_impl(cfg, residuals, cts)
        d_cosmo, d_mass = out[4], out[5]
    else:
        d_cosmo, d_mass = jax.jit(lambda c, m, ct: jax.vjp(
            lambda c_, m_: jfused._reference_impl(cfg, *arrs[:4], c_, m_,
                                                  arrs[4], None, None),
            c, m)[1](ct))(pop_b.cosmo, pop_b.mass, cts)
    series = np.concatenate(
        [np.asarray(d_cosmo.cheb_logh), np.asarray(d_cosmo.dgw_lo)[:, None],
         np.asarray(d_cosmo.dgw_max)[:, None],
         np.asarray(d_mass.cheb_cdf_window)], axis=1)
    params = np.stack([np.asarray(getattr(d_mass, k)) for k in MASS_SCALARS],
                      axis=1)
    return series, params


def _plain_vjp(hl, kernel, ct_den, ct_stats):
    n = ct_den.shape[0]
    pop_b = hl.population.update_batch(
        {k: v[:n] for k, v in _batch(LAMBDA).items()})
    series, params = pack_params(pop_b.cosmo, pop_b.mass, n, F64)
    return fused_weights_kde_adjoint_plain(
        hl.m1det, hl.m2det, hl.dL, hl.inv_pe_prior, hl.z_grids, series, params,
        torch.tensor(ct_den), torch.tensor(ct_stats), pop_b.cosmo, pop_b.mass,
        kernel)


def _cotangents(hl, n):
    rng = np.random.default_rng(11)
    e, g = hl.z_grids.shape
    return rng.normal(size=(n, e, g)), rng.normal(size=(n, e, 8))


@pytest.mark.parametrize("kernel", ["epan", "gauss"])
def test_fused_pass_gradient_matches_reference(jax_hl, hl, kernel):
    """Random cotangents for den and every stat: the packed-row gradients
    of the plain version against ``jax.vjp`` of ``_reference_impl`` in the
    cosmology and mass leaves, 1e-9 of each row's largest entry."""
    ct_den, ct_stats = _cotangents(hl, 2)
    series, params = _reference_vjp(jax_hl, hl, kernel, ct_den, ct_stats)
    d_series, d_params, _ = _plain_vjp(hl, kernel, ct_den, ct_stats)
    assert np.abs(series).max() > 0 and np.abs(params).max() > 0
    assert _rel(d_series, series) <= 1e-9
    assert _rel(d_params, params) <= 1e-9


def test_fused_pass_gradient_matches_adjoint_kernel_of_the_reference(jax_hl, hl):
    """One λ against the JAX package's adjoint Pallas kernel in interpret
    mode (it walks its grid in Python)."""
    ct_den, ct_stats = _cotangents(hl, 1)
    series, params = _reference_vjp(jax_hl, hl, "epan", ct_den, ct_stats,
                                    interpret=True)
    d_series, d_params, _ = _plain_vjp(hl, "epan", ct_den, ct_stats)
    assert _rel(d_series, series) <= 1e-9
    assert _rel(d_params, params) <= 1e-9


def test_mass_model_gradient_at_its_kinks(hl):
    """Samples straddling the smoothing window's edges and the m_join
    switch between the window series and the closed-form CDF: autograd of
    the plain weights against central differences in the packed scalars."""
    from chimera_tpu_torch.models.mass import p_m1m2
    from chimera_tpu_torch.ops.cuda.fused import unpack_params

    mass = hl.population.mass
    cosmo = hl.population.cosmo
    m_low, m_join = float(mass.m_low), float(mass.m_join)
    m1 = torch.tensor([[m_low - 0.3, m_low + 1e-3, m_low + 1.0, m_join - 1e-3,
                        m_join + 1e-3, m_join + 3.0, 30.0, 34.0, 60.0]], dtype=F64)
    m2 = 0.8 * m1
    series, params = pack_params(cosmo, mass, 1, F64)

    def weights(p):
        return p_m1m2(unpack_params(cosmo, mass, series, p)[1], m1, m2)

    p = params.clone().requires_grad_()
    jac = torch.stack([torch.autograd.grad(w, p, retain_graph=True)[0][0]
                       for w in weights(p)[0]])                # (9, 12)
    assert torch.all(torch.isfinite(jac))
    for i, name in enumerate(MASS_SCALARS):
        step = torch.zeros_like(params)
        step[0, i] = 1e-6 * max(1.0, abs(float(params[0, i])))
        fd = (weights(params + step) - weights(params - step))[0] / (2 * step[0, i])
        scale = jac[:, i].abs().max().clamp_min(1e-12)
        assert ((jac[:, i] - fd).abs().max() / scale) <= 1e-6, name


# -- (c) the log-likelihood's gradient --------------------------------------

@pytest.fixture(scope="module")
def port_gradient(hl):
    x = torch.tensor(LAMBDA, requires_grad=True)
    ll = hl.log_like_batch(_batch(x))
    return ll.detach(), torch.autograd.grad(torch.sum(ll), x)[0]


def test_log_like_gradient_matches_reference(jax_hl, port_gradient):
    """d log L / d{H0, Om0, mu_g} for a batch of 2 against ``jax.grad`` of
    ``log_hyperlikelihood_batch`` (XLA engine): 1e-8 relative."""
    expect = jax.jit(jax.grad(lambda x: jnp.sum(
        log_hyperlikelihood_batch(jax_hl, _batch(x)))))(jnp.asarray(LAMBDA))
    got = port_gradient[1].numpy()
    assert np.all(np.isfinite(got))
    assert np.max(np.abs(got - np.asarray(expect)) / np.abs(expect)) <= 1e-8


def test_log_like_gradient_matches_finite_differences(hl, port_gradient):
    """Against central differences of the port's own float64 log L: 1e-5.
    The steps are small: log L jumps where a sample's source mass crosses a
    hard edge of the mass model (m_high, the peak's 5 sigma cut), and a
    difference across a jump is not the slope (a step of 1e-4 in H0 reads
    7 % off here)."""
    got = port_gradient[1]
    for i, step in enumerate((1e-6, 1e-7, 1e-6)):
        d = torch.zeros(2, 3, dtype=F64)
        d[:, i] = step
        with torch.no_grad():
            fd = (hl.log_like_batch(_batch(torch.tensor(LAMBDA) + d))
                  - hl.log_like_batch(_batch(torch.tensor(LAMBDA) - d))) / (2 * step)
        assert torch.max((got[:, i] - fd).abs() / fd.abs()) <= 1e-5, NAMES[i]


# -- (d) a gated event -------------------------------------------------------

def test_gated_event_gradient_is_the_reference_s(jax_hl, hl):
    """An event whose N_eff falls under ``pe_neff`` has numerator 0 and
    log(0) in the sum.  What the JAX package's gradient is for such a
    batch, the port's is too: NaN in the same entries, equal numbers in the
    others.  (Both give NaN in H0 and Om0 and a finite slope in mu_g: the
    cotangent 0 / 0 of the gated event's log reaches the cosmology through
    p_cbc and the jacobian, while the KDE's cotangent is masked by the
    gate.)"""
    with torch.no_grad():
        pop_b = hl.population.update_batch(_batch(torch.tensor(LAMBDA)))
        from chimera_tpu_torch.ops.cuda.fused import fused_weights_kde_plain
        neff = fused_weights_kde_plain(hl.m1det, hl.m2det, hl.dL,
                                       hl.inv_pe_prior, pop_b.cosmo, pop_b.mass,
                                       hl.z_grids)[1]["neff"]
    # gate the event with the smallest N_eff, in both λ
    cut = float(torch.sort(neff.amax(dim=0)).values[:2].mean())
    assert int((neff < cut).all(dim=0).sum()) == 1
    jhl = jpytree.replace(jax_hl, pe_neff=cut)
    expect = np.asarray(jax.jit(jax.grad(lambda x: jnp.sum(
        log_hyperlikelihood_batch(jhl, _batch(x)))))(jnp.asarray(LAMBDA)))
    gated = HyperLikelihood.from_state(state_from_reference(jhl), "cpu", F64)
    assert gated.pe_neff == cut
    x = torch.tensor(LAMBDA, requires_grad=True)
    got = torch.autograd.grad(torch.sum(gated.log_like_batch(_batch(x))), x)[0].numpy()
    assert np.array_equal(np.isnan(got), np.isnan(expect))
    fin = np.isfinite(expect)
    assert np.array_equal(np.isfinite(got), fin)
    if fin.any():
        assert np.max(np.abs(got[fin] - expect[fin]) / np.abs(expect[fin])) <= 1e-8


# -- (e) float32 -------------------------------------------------------------

def test_float32_gradient(jax_hl, port_gradient):
    """The float32 gradient against the float64 one: 1e-3 relative."""
    hl32 = HyperLikelihood.from_state(state_from_reference(jax_hl), "cpu",
                                      torch.float32)
    x = torch.tensor(LAMBDA, dtype=torch.float32, requires_grad=True)
    got = torch.autograd.grad(torch.sum(hl32.log_like_batch(_batch(x))), x)[0]
    assert got.dtype == torch.float32
    rel = torch.max((got.double() - port_gradient[1]).abs() / port_gradient[1].abs())
    assert rel <= 1e-3, float(rel)
