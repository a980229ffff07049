"""The port's run surface and utilities against the JAX package, float64 on
the CPU: ``runconfig`` on the example TOML files (the builders' objects and
errors), localization areas and volumes, magnitudes, the integration,
interpolation and KDE helpers (``kde1d_batch`` on its plain path), the
native KDE oracle, ``StageTimer`` and a plotting smoke test under Agg."""

import importlib
from pathlib import Path

import matplotlib

matplotlib.use("Agg")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from chimera_tpu import runconfig as jrc  # noqa: E402
from chimera_tpu import utils as jutils  # noqa: E402
from chimera_tpu.data import localization as jloc  # noqa: E402
from chimera_tpu.models import FLRW as JFLRW  # noqa: E402
from chimera_tpu.ops import kde as jkde  # noqa: E402
from chimera_tpu_torch import HyperLikelihood, SelectionFunction, convert  # noqa: E402
from chimera_tpu_torch import native, runconfig, utils  # noqa: E402
from chimera_tpu_torch.data import localization as tloc  # noqa: E402
from chimera_tpu_torch.models import FLRW, Population  # noqa: E402
from chimera_tpu_torch.ops import integrate, kde  # noqa: E402

jint = importlib.import_module("chimera_tpu.ops.integrate")
jinterp = importlib.import_module("chimera_tpu.ops.interp")
tinterp = importlib.import_module("chimera_tpu_torch.ops.interp")
F64 = torch.float64
CPU = torch.device("cpu")
EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _rel(got, expect):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    expect = np.asarray(expect)
    return float(np.max(np.abs(got - expect)) / np.max(np.abs(expect)))


def _compare(got, expect, path="") -> int:
    """Every field of two port objects: tensors within 1e-10 of their
    largest value, the rest equal (a table only one of them holds, as the
    JAX object's Newton start table of the Chebyshev engine, is passed
    over); returns the number of tensors compared."""
    import dataclasses

    assert type(got) is type(expect), path
    n = 0
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(expect, f.name)
        if (a is None) != (b is None):
            continue
        if isinstance(a, torch.Tensor):
            assert a.shape == b.shape, path + f.name
            assert (a - b).abs().max() <= 1e-10 * b.abs().max(), path + f.name
            n += 1
        elif dataclasses.is_dataclass(a):
            n += _compare(a, b, f"{path}{f.name}.")
        else:
            assert a == b, path + f.name
    return n


# ---------------------------------------------------------------------------
# runconfig
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("toml", ["spectral_siren.toml", "dark_siren.toml"])
def test_runconfig_builds_the_jax_objects(toml):
    """The port's builders on an example file give the JAX builders'
    population (every hyper-parameter and table within 1e-10 of the JAX
    object's carried by ``convert``, every setting equal), completeness,
    priors and pixelization settings."""
    path = str(EXAMPLES / toml)
    jcfg, tcfg = jrc.RunConfig.load(path), runconfig.RunConfig.load(path)
    assert tcfg.__dict__ == jcfg.__dict__
    expect = convert.state_from_reference(
        jax.jit(lambda: jrc.build_population(jcfg))())
    got = runconfig.build_population(tcfg, device=CPU, dtype=F64)
    assert isinstance(got, Population)
    assert _compare(got, Population.from_state(expect, device=CPU, dtype=F64)) > 10
    assert runconfig.prior_bounds(tcfg) == jrc.prior_bounds(jcfg)
    assert runconfig.cosmo_prior(tcfg) == jrc.cosmo_prior(jcfg)
    assert runconfig.pixelization_kwargs(tcfg) == jrc.pixelization_kwargs(jcfg)
    if tcfg.catalog:
        tc = runconfig.build_completeness(tcfg, device=CPU)
        jc = jrc.build_completeness(jcfg)
        assert type(tc).__name__ == type(jc).__name__
        np.testing.assert_array_equal(tc.z_range.numpy(), np.asarray(jc.z_range))
        assert tc.kind == jc.kind


def _error(fn):
    try:
        fn()
    except Exception as e:  # the exception compared with the other package's
        return type(e), str(e)
    raise AssertionError("no error raised")


@pytest.mark.parametrize("case", ["section", "cosmology", "mass", "rate",
                                  "completeness", "homogeneous", "prior"])
def test_runconfig_raises_the_jax_errors(case):
    """Unknown sections and models, completeness choices (and the
    homogeneous model's missing galaxies) and bad prior ranges raise the
    JAX package's errors with its messages."""
    raw = {"section": {"unknown": {}},
           "cosmology": {"cosmology": {"model": "lcdm"}},
           "mass": {"mass": {"model": "gauss"}},
           "rate": {"rate": {"model": "flat"}},
           "completeness": {"catalog": {"completeness": "volume"}},
           "homogeneous": {"catalog": {"completeness": "homogeneous"}},
           "prior": {"prior": {"H0": {"range": [80.0, 40.0]}}}}[case]

    def run(mod, **kw):
        def go():
            cfg = mod.RunConfig.from_dict(raw)
            if case == "prior":
                return mod.prior_bounds(cfg)
            if case in ("completeness", "homogeneous"):
                return mod.build_completeness(cfg, **kw)
            return mod.build_population(cfg, **kw)
        return go

    # the JAX side under jit: its eager cosmology build takes ~9 s
    expect = _error(jax.jit(run(jrc)) if case in ("mass", "rate") else run(jrc))
    got = _error(run(runconfig, device=CPU))
    assert got[0] is expect[0]
    if case != "homogeneous":  # a missing argument: the signatures differ
        assert got[1] == expect[1]


def test_runconfig_likelihood_and_sampler():
    """The spectral example's [likelihood] section through the port's
    ``build_likelihood`` on a port mock, and its ensemble over the priors:
    finite values, walkers in bounds, the same bits on a repeat."""
    from chimera_tpu_torch.inference import (init_state, initialize_walkers,
                                             make_vector_log_prob, run)

    cfg = runconfig.RunConfig.load(str(EXAMPLES / "spectral_siren.toml"))
    cat, inj, n_gen, z_grids = chip_smoke.mock(8, 128, 20_000, 64, 300, 42,
                                               device=CPU)
    hl = runconfig.build_likelihood(cfg, cat, z_grids,
                                    runconfig.build_population(cfg, device=CPU),
                                    SelectionFunction.create(inj, n_gen))
    assert isinstance(hl, HyperLikelihood) and hl.kind == "1d" and not hl.binning
    bounds = runconfig.prior_bounds(cfg)
    names = list(bounds)
    log_prob = make_vector_log_prob(hl, names, bounds)
    chains = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(3)
        x0 = initialize_walkers(gen, {"H0": 70.0, "Om0": 0.3}, 8, names,
                                bounds=bounds)
        state, hist = run(gen, init_state(x0, log_prob), log_prob, 2)
        chains.append(hist["coords"])
    assert torch.equal(*chains) and torch.all(torch.isfinite(chains[0]))
    for i, p in enumerate(names):
        assert torch.all((chains[0][..., i] > bounds[p][0])
                         & (chains[0][..., i] < bounds[p][1]))


# ---------------------------------------------------------------------------
# localization, magnitudes, helpers
# ---------------------------------------------------------------------------

def test_localization_matches_jax():
    """Areas (deg^2 and sr) and comoving volumes between two cosmologies
    within 1e-12 of the JAX package's."""
    rng = np.random.default_rng(1)
    th = rng.normal(1.0, 0.05, (5, 300))
    ph = rng.normal(2.0, 0.05, (5, 300)) + 0.3 * (th - 1.0)
    dl = rng.lognormal(0.0, 0.2, (5, 300))
    for unit in ("deg2", "rad2"):
        assert _rel(tloc.localization_areas(torch.tensor(th), torch.tensor(ph),
                                            80.0, unit),
                    jloc.localization_areas(jnp.asarray(th), jnp.asarray(ph),
                                            80.0, unit)) <= 1e-12
    make = jax.jit(lambda h: JFLRW.create(H0=h, cheb_deg=16, z_grid_res=500))
    j_lo, j_hi = make(120.0), make(40.0)
    t_lo, t_hi = (FLRW.from_state(convert.state_from_reference(c), device=CPU)
                  for c in (j_lo, j_hi))
    expect = jax.jit(jloc.localization_volumes)(
        jnp.asarray(th), jnp.asarray(ph), jnp.asarray(dl), j_lo, j_hi)
    got = tloc.localization_volumes(torch.tensor(th), torch.tensor(ph),
                                    torch.tensor(dl), t_lo, t_hi)
    assert _rel(got, expect) <= 1e-12


def test_magnitudes_match_jax():
    """Every conversion of ``utils.mags`` in every band within 1e-12 of the
    JAX package's; an unknown band raises."""
    m = np.array([-21.0, -18.5, 3.27, 12.0])
    dl = np.array([0.04, 0.4, 1.0, 2.5])
    for band in ("bol", "B", "W1", "K"):
        assert _rel(utils.mag2lum(torch.tensor(m), band),
                    jutils.mag2lum(jnp.asarray(m), band)) <= 1e-12
        assert _rel(utils.lum2mag(torch.tensor(np.abs(m) * 1e9), band),
                    jutils.lum2mag(jnp.asarray(np.abs(m) * 1e9), band)) <= 1e-12
    assert _rel(utils.absolute_magnitude(torch.tensor(m + 40), torch.tensor(dl)),
                jutils.absolute_magnitude(jnp.asarray(m + 40), jnp.asarray(dl))) <= 1e-12
    assert _rel(utils.apparent_magnitude(torch.tensor(m), torch.tensor(dl)),
                jutils.apparent_magnitude(jnp.asarray(m), jnp.asarray(dl))) <= 1e-12
    x = np.array([0.0, 0.01, 0.5, 1.0, 3.0, 10.0])
    for alpha, weighted in ((-1.07, True), (-0.5, False)):
        assert _rel(utils.schechter_luminosity_fraction(torch.tensor(x), alpha,
                                                        weighted),
                    jutils.schechter_luminosity_fraction(jnp.asarray(x), alpha,
                                                         weighted)) <= 1e-12
    with pytest.raises(ValueError):
        utils.mag2lum(torch.tensor(m), band="Q")


def test_helpers_match_jax():
    """masked_trapz, neumaier_sum, sum_and_sumsq, interp_batch, kde1d and
    kde1d_batch (its plain path on CPU tensors, both kernels, every
    bandwidth rule) within 1e-12 of the JAX package's; the native 1-D KDE
    oracle against kde1d_core."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 400)) * np.exp(3.0 * rng.normal(size=(5, 400)))
    nodes = np.sort(rng.uniform(size=(5, 400)), axis=1)
    mask = rng.uniform(size=x.shape) > 0.3
    assert _rel(integrate.masked_trapz(torch.tensor(x), torch.tensor(nodes),
                                       torch.tensor(mask)),
                jint.masked_trapz(jnp.asarray(x), jnp.asarray(nodes),
                                  jnp.asarray(mask))) <= 1e-12
    assert _rel(integrate.neumaier_sum(torch.tensor(x), dim=1),
                jax.jit(jint.neumaier_sum, static_argnums=1)(jnp.asarray(x), 1)
                ) <= 1e-12
    for got, expect in zip(integrate.sum_and_sumsq(torch.tensor(x), dim=0),
                           jint.sum_and_sumsq(jnp.asarray(x), axis=0)):
        assert _rel(got, expect) <= 1e-12
    q = np.concatenate([rng.uniform(-0.1, 1.1, (5, 60)), nodes[:, :3]], axis=1)
    for lr in ((None, None), (0.0, -1.0)):
        assert _rel(tinterp.interp_batch(torch.tensor(q), torch.tensor(nodes),
                                         torch.tensor(x), *lr),
                    jax.jit(jinterp.interp_batch, static_argnums=(3, 4))(
                        jnp.asarray(q), jnp.asarray(nodes), jnp.asarray(x), *lr)
                    ) <= 1e-12
    d = rng.normal(0.5, 0.1, (3, 4, 200))
    w = rng.uniform(0.0, 1.0, (3, 4, 200))
    g = np.sort(rng.uniform(0.0, 1.0, (3, 4, 50)), axis=-1)
    j_batch = jax.jit(jkde.kde1d_batch, static_argnums=(3, 4))
    j_one = jax.jit(jkde.kde1d, static_argnums=(3,))
    for kernel in ("epan", "gauss"):
        for bw in (None, "silverman", 0.3):
            assert _rel(kde.kde1d_batch(torch.tensor(d), torch.tensor(g),
                                        torch.tensor(w), kernel, bw),
                        j_batch(jnp.asarray(d), jnp.asarray(g), jnp.asarray(w),
                                kernel, bw)) <= 1e-12
        assert _rel(kde.kde1d(torch.tensor(d[0, 0]), torch.tensor(g[0, 0]),
                              kernel=kernel),
                    j_one(jnp.asarray(d[0, 0]), jnp.asarray(g[0, 0]), None,
                          kernel)) <= 1e-12
        wn, h = kde.kde1d_params(torch.tensor(d[0, 0]), torch.tensor(w[0, 0]), None)
        assert _rel(native.kde1d(d[0, 0], wn.numpy(), float(h), g[0, 0], kernel),
                    kde.kde1d_core(torch.tensor(d[0, 0]), torch.tensor(g[0, 0]),
                                   wn, h, kernel)) <= 1e-12


@pytest.mark.parametrize("kind,binning,cut_grid", [
    ("approximate", False, 2.0), ("marginalized", False, None),
    ("marginalized", True, 2.0)])
def test_p_gw_3d_matches_jax(kind, binning, cut_grid):
    """``utils.plotting.p_gw_3d`` (the curves of ``plot_p_gw3d_pixelated``)
    within 1e-10 of the JAX package's ``p_gw_3d_*`` on 8 events x 384
    samples of the dark precision mock (a multiple of 128, which the JAX
    object does not pad): the event KDE, the fused path's per-pixel
    rectangle (256 slots, padded to the 384 samples with fillers) and the
    staged path's sample-to-pixel mask."""
    from chimera_tpu import HyperLikelihood as JHL
    from chimera_tpu import SelectionFunction as JSel
    from chimera_tpu.catalog import DVdzCompleteness as JDVdz
    from chimera_tpu.catalog.pixelated import PixelatedCatalog as JPixCat
    from chimera_tpu.data.structs import ThetaInjDet as JInj
    from chimera_tpu.data.structs import ThetaPEDet as JTheta
    from chimera_tpu.likelihood import _P_GW_3D
    from chimera_tpu.models import MadauDickinsonRate as JMD
    from chimera_tpu.models import Population as JPop
    from chimera_tpu.models import PowerLawPeak as JPLP
    from chimera_tpu_torch.utils.plotting import p_gw_3d

    cat, z_grids, gal_cat, inj, n_gen = chip_smoke.parity_dark_mock(CPU)

    def ev(t, s=None):
        return jnp.asarray(t[:8, :s].numpy() if s else t[:8].numpy())

    theta = JTheta(**{f: ev(getattr(cat, f), 384) for f in (
        "m1det", "m2det", "dL", "pe_prior", "ra", "dec", "pixels_pe_opt_nside")},
        **{f: ev(getattr(cat, f)) for f in (
            "opt_nsides", "pixels_opt_nsides", "ra_pix", "dec_pix",
            "gw_loc2d_pdf", "pixel_mask")})
    jcat = JPixCat(p_cat=ev(gal_cat.p_cat), P_compl=ev(gal_cat.P_compl),
                   pixel_mask=ev(gal_cat.pixel_mask), n_gal=ev(gal_cat.n_gal),
                   completeness=JDVdz.create(z_range=(0.0, 3.0)))
    pop = JPop.create(
        jax.jit(lambda: JFLRW.create(cheb_deg=16, z_grid_res=500))(),
        jax.jit(lambda: JPLP.create(window_deg=16, grid_res=300))(),
        JMD.create(), gal_cat=jcat)
    sel = JSel.create(JInj(**{f: jnp.asarray(getattr(inj, f).numpy()) for f in
                              ("m1det", "m2det", "dL", "p_draw")}), float(n_gen))
    jhl = JHL.create(theta, ev(z_grids), pop, sel, kind=kind, binning=binning,
                     cut_grid=cut_grid, kde_engine="xla")
    expect = np.asarray(jax.jit(_P_GW_3D[kind])(jhl, jhl.population))
    hl = HyperLikelihood.from_state(convert.state_from_reference(jhl), CPU, F64)
    got = p_gw_3d(hl, hl.population)[0]
    assert got.shape == expect.shape and np.abs(expect).max() > 0
    assert _rel(got, expect) <= 1e-10


def test_stage_timer_and_plots(tmp_path):
    """``StageTimer`` on CPU tensors (host clock, no card times), its
    report; ``device_trace`` writes a Chrome trace; the plots of a
    pixelization, p_cat, p_gal and p_gw3d ('marginalized' and 'full')
    under Agg."""
    import matplotlib.pyplot as plt

    from chimera_tpu_torch.utils import plotting

    timer = utils.StageTimer()
    with timer.stage("a", torch.ones(3)):
        pass
    out = timer.time_fn("b", torch.zeros, 4)
    assert out.shape == (4,) and timer.counts == {"a": 1, "b": 1}
    assert not timer.device_times and "a:" in timer.report()
    assert utils.compile_time() == 0.0
    with utils.device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64) @ torch.ones(64)
    assert prof.key_averages() and list((tmp_path / "trace").glob("*.json"))

    cat, z_grids, gal_cat, inj, n_gen = chip_smoke.parity_dark_mock(CPU)
    pop = Population.create(FLRW.create(device=CPU), *(
        getattr(importlib.import_module("chimera_tpu_torch.models"), n).create(
            device=CPU) for n in ("PowerLawPeak", "MadauDickinsonRate")),
        gal_cat=gal_cat)
    hl = HyperLikelihood.create(cat, z_grids, pop, SelectionFunction.create(inj, n_gen),
                                kind="marginalized", binning=False, cut_grid=None)
    full = HyperLikelihood.create(cat, z_grids, pop,
                                  SelectionFunction.create(inj, n_gen),
                                  kind="full")
    figs = [plotting.plot_pixelization(cat, 0),
            plotting.plot_p_cat_pixelated(gal_cat, z_grids, 1),
            plotting.plot_p_gal_pixelated(hl, 2, H0=65.0),
            plotting.plot_p_gw3d_pixelated(hl, 3, H0=72.0),
            plotting.plot_p_gw3d_pixelated(full, 4)]
    for i, fig in enumerate(figs):
        assert fig.axes[0].lines
        fig.savefig(tmp_path / f"{i}.png")
        plt.close(fig)
