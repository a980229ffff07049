"""Hyper-parameter gradients of the dark-siren and effective-grid paths of
the PyTorch port against the JAX package on identical data, float64 on the
CPU: the plain adjoints of the fused pass in the modes those paths run
(stats only on logical pixel rows and on events, effective grids, external
bounds with unit mass) and of the rows contraction, against ``jax.vjp`` of
``_reference_impl`` / ``_rows_reference`` and against the adjoint Pallas
kernel in interpret mode; the N_eff clamp's slope; and d log L / dλ of the
three unbinned paths against the JAX package's XLA engine differentiated by
JAX.

Data: the session fixture ``dark_siren_setup`` (8 events x 256 PE samples,
nside {8, 16}, ~6 pixels per event, 100-point z-grids)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_tpu import HyperLikelihood as JHL
from chimera_tpu.likelihood import (_marg_lambda_factors, _marg_static_factors,
                                    _sort_samples_by_distance, log_numerator)
from chimera_tpu.ops.pallas import fused as jfused
from chimera_tpu_torch import HyperLikelihood
from chimera_tpu_torch.convert import state_from_reference
from chimera_tpu_torch.models import FLRW, PowerLawPeak
from chimera_tpu_torch.ops.cuda.fused import (MASS_SCALARS, STAT_NAMES,
                                              fused_weights_kde_adjoint_plain,
                                              fused_weights_kde_plain,
                                              pack_params)
from chimera_tpu_torch.ops.cuda.rows import fused_rows_contract_adjoint_plain

F64 = torch.float64
NAMES = ("H0", "Om0", "mu_g")
LAMBDA = np.array([[68.0, 0.27, 33.0], [74.0, 0.22, 35.0]])


def _t(a, dtype=F64):
    t = torch.as_tensor(np.array(a))
    return t if dtype is None else t.to(dtype)


def _rel(got, expect):
    """Largest error relative to the largest entry of each last-axis row."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    expect = np.asarray(expect)
    got, expect = got.reshape(-1, got.shape[-1]), expect.reshape(-1, expect.shape[-1])
    scale = np.max(np.abs(expect), axis=-1, keepdims=True)
    return np.max(np.abs(got - expect) / np.where(scale > 0, scale, 1.0))


def _batch(x):
    return {n: x[:, i] for i, n in enumerate(NAMES)}


@pytest.fixture(scope="module")
def jax_hl(dark_siren_setup):
    theta, z_grids, pop_pix, sel, _ = dark_siren_setup
    return JHL.create(theta, z_grids, pop_pix, sel, kind="marginalized",
                      binning=False, cut_grid=None, kde_engine="xla")


@pytest.fixture(scope="module")
def models(jax_hl):
    """The JAX λ batch of LAMBDA and the same tables in the port's models."""
    pop_b = jax.jit(jax.vmap(lambda p: jax_hl.population.update(**p)))(
        {k: jnp.asarray(v) for k, v in _batch(LAMBDA).items()})
    st = state_from_reference(pop_b)
    return (pop_b, FLRW.from_state(st, "cosmo.", "cpu", F64),
            PowerLawPeak.from_state(st, "mass.", "cpu", F64))


def _packed(d_cosmo, d_mass):
    """JAX model-leaf cotangents packed like ``pack_params``."""
    series = np.concatenate(
        [np.asarray(d_cosmo.cheb_logh), np.asarray(d_cosmo.dgw_lo)[:, None],
         np.asarray(d_cosmo.dgw_max)[:, None],
         np.asarray(d_mass.cheb_cdf_window)], axis=1)
    params = np.stack([np.asarray(getattr(d_mass, k)) for k in MASS_SCALARS],
                      axis=1)
    return series, params


# ---------------------------------------------------------------------------
# the N_eff clamp
# ---------------------------------------------------------------------------

def test_neff_clip_takes_half_the_slope_at_one_live_sample(jax_hl, models):
    """A row whose weight is one sample's has N_eff = w^2 / w^2 = 1, on the
    clamp's lower bound, where ``jnp.clip`` has slope 1/2.  The gradient of
    the bandwidth in the other samples' inverse priors (whose weights are 0)
    goes through that slope only: the plain version's must be the
    reference's, as must the model rows' gradients of the row's stats."""
    pop_b, cosmo, mass = models
    theta = _sort_samples_by_distance(jax_hl.theta_gw)
    pe = [np.asarray(a)[:2] for a in (theta.m1det, theta.m2det, theta.dL,
                                      1.0 / theta.pe_prior)]
    invp = np.zeros_like(pe[3])
    invp[:, 7] = pe[3][:, 7]                          # one live sample a row
    cfg = jfused._FusedCfg(kernel="epan", bw_method=None, cut_grid=2.0,
                           n_grid=8, den_scale="norms", interpret=False,
                           logical_s=None, stats_only=True)
    ct = np.zeros((2, 2, 8))
    ct[..., 4] = 1.0                                  # the bandwidth's cotangent

    def jax_h(invp_, c_, m_):
        _, st = jfused._reference_impl(cfg, *map(jnp.asarray, pe[:3]), invp_, c_,
                                       m_, None, None, None)
        return st["bandwidth"], st["neff"]

    def reference(invp_, c_, m_):
        (_, neff_), vjp = jax.vjp(jax_h, invp_, c_, m_)
        return neff_, vjp((jnp.asarray(ct[..., 4]), jnp.zeros_like(neff_)))

    neff, (d_invp, d_cos, d_mass) = jax.jit(reference)(
        jnp.asarray(invp), pop_b.cosmo, pop_b.mass)
    assert np.all(np.asarray(neff) == 1.0)
    d_invp = np.asarray(d_invp)
    assert np.abs(d_invp[:, :7]).max() > 0

    invp_t = _t(invp).requires_grad_()
    _, st = fused_weights_kde_plain(*[_t(a) for a in pe[:3]], invp_t, cosmo, mass,
                                    cut_grid=2.0, stats_only=True)
    got = torch.autograd.grad(st["bandwidth"].sum(), invp_t)[0]
    assert _rel(got, d_invp) <= 1e-12
    series, params = pack_params(cosmo, mass, 2, F64)
    d_series, d_params, _ = fused_weights_kde_adjoint_plain(
        *[_t(a) for a in pe[:3]], _t(invp), None, series, params, None,
        _t(ct), cosmo, mass, cut_grid=2.0, stats_only=True)
    series, params = _packed(d_cos, d_mass)
    assert _rel(d_series, series) <= 1e-9
    # the mass scalars reach the bandwidth through N_eff alone, which is
    # flat at one live sample: zero but for rounding, in both
    scale = np.abs(series).max()
    assert np.abs(params).max() <= 1e-12 * scale
    assert d_params.abs().max() <= 1e-12 * scale


# ---------------------------------------------------------------------------
# K3's modes and K2b: the plain adjoints against the reference
# ---------------------------------------------------------------------------

def _mode_inputs(jax_hl, pop_b, mode, kernel):
    """The forward's inputs in ``mode`` as (numpy data, JAX config, port
    keywords): the dark fixture's logical pixel rows (stats only; external
    bounds from the events' stats pass, 50 points, unit mass) or its event
    rows (stats only; an effective grid of 50 points)."""
    theta = _sort_samples_by_distance(jax_hl.theta_gw)
    if mode in ("stats_events", "effective"):
        data = [np.asarray(a) for a in (theta.m1det, theta.m2det, theta.dL,
                                        1.0 / theta.pe_prior)]
        cfg = jfused._FusedCfg(kernel=kernel, bw_method=None, cut_grid=2.0,
                               n_grid=50, den_scale="norms", interpret=True,
                               logical_s=None, stats_only=mode == "stats_events")
        kw = {"cut_grid": 2.0, "n_grid": 50, "stats_only": mode == "stats_events"}
        return data, None, None, None, cfg, kw
    c = jax_hl.compact
    e, p, s_pp = c["dL"].shape
    data = [np.asarray(c[k]).reshape(e * p, s_pp)
            for k in ("m1det", "m2det", "dL", "inv_pe_prior")]
    n_real = np.asarray(c["n_real"]).reshape(-1)
    dl_fill = np.repeat(np.asarray(c["dl_fill"]), p)
    s = theta.dL.shape[1]
    if mode == "stats_logical":
        cfg = jfused._FusedCfg(kernel=kernel, bw_method=None, cut_grid=2.0,
                               n_grid=8, den_scale="unit", interpret=True,
                               logical_s=s, stats_only=True)
        kw = {"cut_grid": 2.0, "stats_only": True}
        return data, n_real, dl_fill, None, cfg, kw
    cfg1 = jfused._FusedCfg(kernel=kernel, bw_method=None, cut_grid=2.0, n_grid=8,
                            den_scale="norms", interpret=True, logical_s=None,
                            stats_only=True)
    ev = jax.jit(lambda c_, m_: jfused._reference_impl(
        cfg1, theta.m1det, theta.m2det, theta.dL, 1.0 / theta.pe_prior, c_, m_,
        None, None, None)[1])(pop_b.cosmo, pop_b.mass)
    ext = np.stack([np.repeat(np.asarray(ev["lo"]), p, axis=1),
                    np.repeat(np.asarray(ev["ub"]), p, axis=1)], axis=-1)
    cfg = jfused._FusedCfg(kernel=kernel, bw_method=None, cut_grid=None,
                           n_grid=50, den_scale="unit", interpret=True,
                           logical_s=s)
    kw = {"n_grid": 50, "den_scale": "unit"}
    return data, n_real, dl_fill, ext, cfg, kw


def _cotangents(n, b, g, n_real, seed=5):
    """Random cotangents of den (L, B, G) and the stats (L, B, 8); a dead
    pixel row's bandwidth and bounds are rounding noise (see
    test_torch_dark.py): they get none."""
    rng = np.random.default_rng(seed)
    ct_den = rng.normal(size=(n, b, g)) if g else None
    ct_stats = rng.normal(size=(n, b, 8))
    if n_real is not None:
        for slot in (0, 1, 4):
            ct_stats[:, n_real == 0, slot] = 0.0
    return ct_den, ct_stats


def _reference_vjp(cfg, data, n_real, dl_fill, ext, cosmo_b, mass_b, ct_den,
                   ct_stats, interpret=False):
    """The JAX package's cotangents of the model leaves (and ext) of the
    fused pass: ``jax.vjp`` of ``_reference_impl``, or its adjoint Pallas
    kernel in interpret mode."""
    arrs = [jnp.asarray(a) for a in data]
    nr = None if n_real is None else jnp.asarray(n_real)
    dlf = None if dl_fill is None else jnp.asarray(dl_fill)
    n = ct_stats.shape[0]
    g = cfg.n_grid
    cts = (jnp.zeros((n, arrs[2].shape[0], g)) if ct_den is None
           else jnp.asarray(ct_den),
           {k: jnp.asarray(ct_stats[..., i]) for i, k in enumerate(STAT_NAMES)})
    if interpret:
        residuals = (*arrs, cosmo_b, mass_b, None, nr, dlf,
                     None if ext is None else jnp.asarray(ext), None, None, None,
                     None)
        out = jfused._adjoint_impl(cfg, residuals, cts)
        return out[4], out[5], out[9]
    primals = [cosmo_b, mass_b] + ([] if ext is None else [jnp.asarray(ext)])

    def fn(c_, m_, *e_):
        return jfused._reference_impl(cfg, *arrs, c_, m_, None, nr, dlf,
                                      e_[0] if e_ else None)

    grads = jax.jit(lambda p, ct: jax.vjp(fn, *p)[1](ct))(primals, cts)
    return grads[0], grads[1], grads[2] if ext is not None else None


def _port_vjp(data, n_real, dl_fill, ext, kw, kernel, cosmo, mass, ct_den,
              ct_stats):
    n = ct_stats.shape[0]
    series, params = pack_params(cosmo, mass, n, F64)
    logical = {} if n_real is None else {
        "n_real": _t(n_real, torch.int64), "dl_fill": _t(dl_fill),
        "logical_s": 256}
    return fused_weights_kde_adjoint_plain(
        *[_t(a) for a in data], None, series, params,
        None if ct_den is None else _t(ct_den), _t(ct_stats), cosmo, mass,
        kernel, ext_bounds=None if ext is None else _t(ext), **logical, **kw)


@pytest.mark.parametrize("mode,kernel,interpret", [
    ("stats_logical", "epan", False), ("stats_events", "epan", False),
    ("effective", "epan", False), ("effective", "gauss", False),
    ("external", "epan", False), ("external", "gauss", False),
    ("stats_logical", "epan", True), ("external", "epan", True)])
def test_fused_pass_gradient_in_every_mode(jax_hl, models, mode, kernel,
                                           interpret):
    """Random cotangents for den and every stat (lo and ub included: the
    chains of the effective grid's bounds into the z range and σ, and
    through external bounds into d_ext): the plain adjoint's packed-row
    gradients and d_ext within 1e-9 of each row's largest entry of the
    reference's, ``jax.vjp`` of ``_reference_impl`` (both λ) or the
    adjoint Pallas kernel in interpret mode (the first λ)."""
    pop_b, cosmo, mass = models
    data, n_real, dl_fill, ext, cfg, kw = _mode_inputs(jax_hl, pop_b, mode, kernel)
    n = 1 if interpret else 2
    b = data[2].shape[0]
    ct_den, ct_stats = _cotangents(n, b, 0 if cfg.stats_only else cfg.n_grid,
                                   n_real)
    cos_j, mass_j = pop_b.cosmo, pop_b.mass
    if interpret:
        one = jax.tree_util.tree_map(lambda a: a[:1], pop_b)
        cos_j, mass_j = one.cosmo, one.mass
        st = state_from_reference(one)
        cosmo = FLRW.from_state(st, "cosmo.", "cpu", F64)
        mass = PowerLawPeak.from_state(st, "mass.", "cpu", F64)
        ext = None if ext is None else ext[:1]
    d_cos, d_mass, d_ext = _reference_vjp(cfg, data, n_real, dl_fill, ext, cos_j,
                                          mass_j, ct_den, ct_stats, interpret)
    got = _port_vjp(data, n_real, dl_fill, ext, kw, kernel, cosmo, mass, ct_den,
                    ct_stats)
    series, params = _packed(d_cos, d_mass)
    assert np.abs(series).max() > 0 and np.abs(params).max() > 0
    assert _rel(got[0], series) <= 1e-9
    assert _rel(got[1], params) <= 1e-9
    assert (got[2] is None) == (ext is None)
    if ext is not None:
        assert np.abs(np.asarray(d_ext)).max() > 0
        assert _rel(got[2], d_ext) <= 1e-9


@pytest.mark.parametrize("kernel", ["epan", "gauss"])
def test_rows_contract_gradient_matches_reference(jax_hl, models, kernel):
    """K2b's plain version on the JAX layout with the JAX stats pass's
    (1/h, scale) and contraction factors (s2 random), random cotangents of
    r: d_series,
    d_params, d_hs, d_f1 and d_f2 within 1e-9 of each row's largest entry
    of ``jax.vjp`` of ``_rows_reference``."""
    pop_b, cosmo, mass = models
    c = jax_hl.compact
    rows = c["rows"]
    e, p, s_pp = c["dL"].shape
    flat = [c[k].reshape(e * p, s_pp) for k in ("m1det", "m2det", "dL",
                                                "inv_pe_prior")]
    cfg = jfused._FusedCfg(kernel=kernel, bw_method=None, cut_grid=2.0, n_grid=8,
                           den_scale="unit", interpret=False, logical_s=256,
                           stats_only=True)
    st = jax.jit(lambda c_, m_: jfused._reference_impl(
        cfg, *flat, c_, m_, None, c["n_real"].reshape(-1),
        jnp.repeat(c["dl_fill"], p))[1])(pop_b.cosmo, pop_b.mass)
    cc = rows["dL"].shape[1]
    gidx = (jnp.arange(e)[:, None] * p + rows["row_pix"]).reshape(-1)
    h, sum_w = st["bandwidth"], st["sum_w"]
    hs = jnp.stack([1.0 / h[:, gidx],
                    jnp.where(sum_w > 0, 1.0 / (h * sum_w), 0.0)[:, gidx]], axis=-1)
    s1, s2 = _marg_static_factors(jax_hl)
    f1, f2, _ = jax.jit(lambda p_: _marg_lambda_factors(jax_hl, p_))(pop_b)
    row_args = [rows[k].reshape(e * cc, -1) for k in ("m1det", "m2det", "dL",
                                                      "inv_pe_prior")]
    rng = np.random.default_rng(7)
    ct = rng.normal(size=(2, e * cc, 2))
    # the fixture's catalog is complete (s2 = (1 - P_compl) ... = 0): a
    # random s2 carries the second sum
    s2 = jnp.asarray(rng.uniform(size=s1.shape)) * s1.max()
    rcfg = jfused._RowsCfg(kernel=kernel, c_per_event=cc, interpret=False)

    def fn(c_, m_, hs_, f1_, f2_):
        return jfused._rows_reference(rcfg, *row_args, c_, m_, jax_hl.z_grids,
                                      hs_, s1[gidx], s2[gidx], f1_, f2_)

    d_cos, d_mass, d_hs, d_f1, d_f2 = jax.jit(
        lambda *a: jax.vjp(fn, *a)[1](jnp.asarray(ct)))(
            pop_b.cosmo, pop_b.mass, hs, f1, f2)
    series, params = pack_params(cosmo, mass, 2, F64)
    got = fused_rows_contract_adjoint_plain(
        *[_t(a) for a in row_args], _t(jax_hl.z_grids), series, params, _t(hs),
        _t(s1[gidx]), _t(s2[gidx]), _t(f1), _t(f2), _t(ct), cosmo, mass, kernel)
    expect = (*_packed(d_cos, d_mass), d_hs, d_f1, d_f2)
    for g, x in zip(got, expect):
        assert np.abs(np.asarray(x)).max() > 0
        assert _rel(g, x) <= 1e-9


# ---------------------------------------------------------------------------
# d log L / dλ end to end
# ---------------------------------------------------------------------------

PATHS = [("marginalized", None), ("marginalized", 2.0), ("approximate", 2.0)]
KERNELS = ["epan", "gauss"]


@pytest.fixture(scope="module")
def reference_gradients(dark_siren_setup):
    """log L and d log L / d{H0, Om0, mu_g} of the batch LAMBDA from the JAX
    package's XLA engine for every (kind, cut_grid, kernel) of the three
    unbinned paths.  ``log_hyperlikelihood`` is the population update, then
    ``log_numerator`` less the selection term; JAX differentiates the
    selection term and each likelihood's log numerator in the updated
    population's float leaves, and one jitted pullback of the update takes
    each sum back to λ.  Six ``jax.grad`` of the whole would trace and
    compile the update's backward six times (~35 s each on one CPU core;
    ~75 s for all six here).  Returns {(kind, cut_grid, kernel): (JAX
    likelihood, log L, gradient)}."""
    theta, z_grids, pop_pix, sel, _ = dark_siren_setup
    cases = [(kind, cut_grid, kernel) for kind, cut_grid in PATHS
             for kernel in KERNELS]
    jhls = [JHL.create(theta, z_grids, pop_pix, sel, kind=kind, binning=False,
                       cut_grid=cut_grid, kernel=kernel, kde_engine="xla")
            for kind, cut_grid, kernel in cases]
    n_ev = jhls[0].n_events_real
    assert all(h.population is pop_pix and h.selection is sel
               and h.n_events_real == n_ev for h in jhls)
    x = jnp.asarray(LAMBDA)

    def update(x):
        return jax.vmap(lambda lam: pop_pix.update(**lam))(_batch(x))

    leaves, treedef = jax.tree_util.tree_flatten(jax.jit(update)(x))
    inexact = [jnp.issubdtype(a.dtype, jnp.inexact) for a in leaves]

    def floats_of(pop):
        return [a for f, a in zip(inexact, jax.tree_util.tree_leaves(pop)) if f]

    def population(floats):
        it = iter(floats)
        return jax.tree_util.tree_unflatten(
            treedef, [next(it) if f else a for f, a in zip(inexact, leaves)])

    def selection_term(floats):
        n_exp = jax.vmap(sel.n_exp)(population(floats))
        per = -n_ev * jnp.log(n_exp) if pop_pix.scale_free else -n_exp
        return jnp.sum(per), per

    def numerator(h):
        def fn(floats):
            per = jax.vmap(lambda pop: log_numerator(h, pop))(population(floats))
            return jnp.sum(per), per
        return fn

    floats = [a for f, a in zip(inexact, leaves) if f]
    (_, sel_ll), sel_ct = jax.jit(jax.value_and_grad(selection_term, has_aux=True))(
        floats)
    pull = jax.jit(lambda x, ct: jax.vjp(lambda y: floats_of(update(y)), x)[1](ct)[0])
    out = {}
    for case, h in zip(cases, jhls):
        (_, ll), ct = jax.jit(jax.value_and_grad(numerator(h), has_aux=True))(floats)
        grad = pull(x, [a + b for a, b in zip(ct, sel_ct)])
        out[case] = (h, np.asarray(ll + sel_ll), np.asarray(grad))
    return out


@pytest.mark.parametrize("kind,cut_grid", PATHS)
@pytest.mark.parametrize("kernel", KERNELS)
def test_log_like_gradient_matches_reference(reference_gradients, kind, cut_grid,
                                             kernel):
    """d log L / d{H0, Om0, mu_g} for a batch of 2 on the three unbinned
    paths — the dark flagship (K1c + K2, cut_grid=None), 'marginalized' with
    cut_grid (K1c on the events + K1d) and an effective-grid event KDE
    (K1b, 'approximate') — against the JAX package's XLA engine
    differentiated by JAX: log L within 1e-10, the gradient within 1e-8
    relative."""
    jhl, value, expect = reference_gradients[(kind, cut_grid, kernel)]
    hl = HyperLikelihood.from_state(state_from_reference(jhl), "cpu", F64)
    assert (hl.kind, hl.cut_grid, hl.kernel) == (kind, cut_grid, kernel)
    x = torch.tensor(LAMBDA, requires_grad=True)
    ll = hl.log_like_batch(_batch(x))
    got = torch.autograd.grad(ll.sum(), x)[0].numpy()
    assert np.all(np.isfinite(expect)) and np.all(np.isfinite(got))
    assert np.max(np.abs(ll.detach().numpy() - value) / np.abs(value)) <= 1e-10
    assert np.max(np.abs(got - expect) / np.abs(expect)) <= 1e-8
