"""The device mass models beside PowerLawPeak on the host
(``tests/host_harness.py``): ``TruncatedPowerLaw``, ``BrokenPowerLaw``,
``PowerLawTwoPeaks`` and ``PowerLawSpline``, each a build of the
emulations with CHIMERA_MASS_KIND (``csrc/population.cuh``), as the card
builds each kernel once a model:

* the reverse sweep of each model with a gradient on the card
  (``SampleAdjoint::mass_vjp``) against the dual numbers it replaces, at
  points that reach every branch and clip tie;
* K1 in every mode and K2 against the plain versions (the kernels' bars);
* K3 in every mode and K2b against the plain adjoints;
* the prologue's record against the wrappers' sizes;
* the card's gradient of the spectral (K1a + K3) and dark-siren (K1c + K2 +
  K3c + K2b) paths with the emulations as the launches, PowerLawSpline's
  in its coefficients too.

PowerLawPeak's own cases are in the other ``test_torch_host_*.py`` files."""

import ctypes
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chimera_tpu_torch import HyperLikelihood, SelectionFunction
from chimera_tpu_torch.models import Population
from chimera_tpu_torch.ops.cuda import fused, launch_counts, rows

from host_harness import (CSRC, F32, F64, HERE, MODEL_KW, MODEL_LAMBDA,
                          _adjoint_case, _build_host, _check_fused_mode, _dark_hl,
                          _emulate_the_card, _host_adjoint, _host_rows_adjoint,
                          _host_rows_contract, _k2_args, _population, _row_rel,
                          _rows_case, dark_data, data)


MODELS = ("TruncatedPowerLaw", "BrokenPowerLaw", "PowerLawTwoPeaks",
          "PowerLawSpline")
WITH_GRAD = MODELS
_LIBS: dict = {}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """model -> {source name: the emulation built for it}, every model's
    built at first use, one g++ each, all at once."""
    def get(model):
        if not _LIBS:
            builds = [(m, n) for m in MODELS for n in (
                "fused_host", "rows_adjoint_host") + (
                ("adjoint_host",) if m in WITH_GRAD else ())]
            # each build's directory made here, not by the threads
            dirs = [SimpleNamespace(mktemp=lambda _, d=tmp_path_factory.mktemp(
                "host_emulation"): d) for _ in builds]
            with ThreadPoolExecutor(len(builds)) as pool:
                built = list(pool.map(lambda b, d: _build_host(
                    d, b[1], kind=fused.MASS_KINDS[b[0]]), builds, dirs))
            for (m, n), lib in zip(builds, built):
                _LIBS.setdefault(m, {})[n] = lib
        return _LIBS[model]
    return get


def _model_points(model, mass, rng):
    """(scalars (n, P), m1det, m2det, z) at points that reach every branch
    and clip tie of the model's p_m1m2: anywhere, in the CDF's window, at
    m_low, m_join, m_high and the model's own edges (the break, each peak's
    5 sigma cut) exactly (z = 0), m2 in the window and at m1, and the
    closed form's log branch (beta = -1)."""
    names = fused.MODEL_SCALARS[model]
    base = np.array([float(getattr(mass, k)) for k in names])
    val = dict(zip(names, base))
    m_low, m_high = val["m_low"], val["m_high"]
    dm = val.get("delta_m", 0.0)
    m_join = val.get("m_join", m_low)
    edges = [m_low, m_join, m_high]
    if model == "BrokenPowerLaw":
        edges.append(m_low + val["break_fraction"] * (m_high - m_low))
    if model == "PowerLawTwoPeaks":
        edges += [val["mu1_g"] + 5.0 * val["sigma1_g"],
                  val["mu2_g"] + 5.0 * val["sigma2_g"]]
    pts = []

    def add(m1, m2, z, **change):
        s = base.copy()
        for k, v in change.items():
            s[names.index(k)] = v
        pts.append((s, m1, m2, z))

    for _ in range(40):
        m1 = rng.uniform(2.0, 1.2 * m_high)
        add(m1, m1 * rng.uniform(0.05, 1.0), rng.uniform(0.0, 1.5))
    for _ in range(20):
        m1, z = rng.uniform(m_low + 0.01, max(m_join, m_low + dm, m_low + 1.0)), \
            rng.uniform(0.0, 1.5)
        add(m1 * (1 + z), m1 * (1 + z) * rng.uniform(0.5, 1.0), z)
    for m1 in (0.8 * m_low, m_low + 0.3 * dm, 0.97 * m_join, 1.03 * m_join,
               1.1 * m_high):
        z = rng.uniform(0.05, 0.8)
        add(m1 * (1 + z), m_low * (1 + z) * 1.01, z)
        add(m1 * (1 + z), m1 * (1 + z) * (1 - 1e-9), z)
    for m1 in edges:
        add(m1, m1, 0.0)
        add(m1, 0.6 * m1, 0.0)
    for _ in range(6):
        m1 = rng.uniform(m_low + dm, m_high)
        add(m1, 0.7 * m1, rng.uniform(0.0, 1.0), beta=-1.0)
    if model == "PowerLawSpline":
        # every knot interval, m1 at each knot (its exp of the log-uniform
        # knot), and the row's num_knots and coefficients padded to the
        # kernels' width
        k = mass.num_knots
        for x in np.linspace(np.log(m_low), np.log(m_high), k + 2):
            add(np.exp(x), 0.6 * np.exp(x), 0.0)
            add(np.exp(x + 0.3 / (k + 1)), 0.5 * np.exp(x), 0.0)
        tail = np.zeros(1 + fused._MAX_KNOTS)
        tail[0] = k
        tail[1:1 + k] = mass.spline_coeffs[0].numpy()
        pts = [(np.concatenate([s, tail]), *rest) for s, *rest in pts]
    s, m1, m2, z = zip(*pts)
    return (np.array(s), np.array(m1), np.array(m2), np.array(z))


def _grad_columns(model, mass) -> list:
    """The packed row's columns with a cotangent: the model's scalars and,
    for PowerLawSpline, its num_knots coefficients (not num_knots, nor the
    padding)."""
    p = len(fused.MODEL_SCALARS[model])
    if model != "PowerLawSpline":
        return list(range(p))
    return list(range(p)) + list(range(p + 1, p + 1 + mass.num_knots))


@pytest.mark.parametrize("model", WITH_GRAD)
def test_mass_vjp_matches_dual(libs, model):
    """The model's reverse sweep (the cotangents of its scalars through
    the prologue's Jacobian of the derived fields, of z and of the window
    series' value; PowerLawSpline's coefficients through its knots' point)
    against its dual numbers, float64, within 1e-12 of each point's
    largest entry; every scalar's slope and z's exercised, and no slope
    where the row has no such field."""
    lib = libs(model)["adjoint_host"]
    mass = _population(F64, model).mass
    scalars, m1, m2, z = _model_points(model, mass, np.random.default_rng(17))
    n, p = scalars.shape
    gw = np.random.default_rng(3).normal(size=n)
    window = (torch.zeros(1, dtype=F64) if fused.window_degree(mass) == 0
              else mass.cheb_cdf_window.double().contiguous())
    arrays = [np.ascontiguousarray(a, dtype=np.float64) for a in
              (scalars, m1, m2, z, gw)]
    rev, dual, tw = np.zeros((n, p + 2)), np.zeros((n, p + 2)), np.zeros((n, 2))
    fn = lib.host_mass_vjp
    fn.restype = None
    fn(*[a.ctypes.data_as(ctypes.c_void_p) for a in arrays],
       ctypes.c_void_p(window.data_ptr()), fused.window_degree(mass), n,
       *[a.ctypes.data_as(ctypes.c_void_p) for a in (rev, dual, tw)])
    assert np.all(np.isfinite(rev)) and np.all(np.isfinite(dual))
    scale = np.maximum(np.abs(dual).max(axis=1, keepdims=True), 1e-300)
    assert (np.abs(rev - dual) / scale).max() <= 1e-12
    slopes = np.abs(dual[:, :p]).max(axis=0)
    live = _grad_columns(model, mass)
    assert np.all(slopes[live] > 0), [k for k in live if slopes[k] == 0]
    assert np.all(np.delete(np.abs(rev[:, :p]), live, axis=1) == 0)
    assert (np.abs(dual[:, p]) > 0).sum() > 30
    if fused.window_degree(mass):
        assert (np.abs(dual[:, p + 1]) > 0).sum() > 10


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("mode,kernel", [
    ("analysis", "epan"), ("effective", "gauss"), ("stats", "epan"),
    ("stats_logical", "epan"), ("external", "epan"), ("contract", "epan")])
@pytest.mark.parametrize("model", MODELS)
def test_emulated_fused_modes_match_plain(libs, data, model, mode, kernel,
                                          dtype):
    """K1 in each mode, built for the model, against the plain version:
    float64 within 1e-12, float32 within 1e-4 of each row's largest value
    (``_check_fused_mode``)."""
    _check_fused_mode(libs(model)["fused_host"], data, mode, kernel, dtype,
                      model)


@pytest.mark.parametrize("dtype,tol", [(F64, 1e-12), (F32, 1e-4)])
@pytest.mark.parametrize("model", MODELS)
def test_emulated_rows_contract_matches_plain(libs, data, model, dtype, tol):
    """K2 against ``fused_rows_contract_plain`` on the chunk rows of
    _rows_case: r within tol of each λ's largest |r|."""
    args, _ = _rows_case(data, dtype, "epan", model)
    m1, m2, dl, invp, grids, _, _, hs, s1, s2, f1, f2, _, cosmo, mass, _ = args
    expect = rows.fused_rows_contract_plain(m1, m2, dl, invp, cosmo, mass,
                                            grids, hs, s1, s2, f1, f2, "epan")
    got = _host_rows_contract(libs(model)["rows_adjoint_host"], *_k2_args(args))
    r_max = expect.double().abs().amax(dim=(1, 2), keepdim=True)
    assert torch.all(r_max > 0)
    assert ((got.double() - expect.double()).abs() / r_max).max() <= tol


@pytest.mark.parametrize("dtype,tol", [(F64, 1e-12), (F32, 1e-3)])
@pytest.mark.parametrize("mode,kernel", [
    ("analysis", "epan"), ("effective", "epan"), ("stats", "epan"),
    ("stats_logical", "epan"), ("external", "gauss")])
@pytest.mark.parametrize("model", WITH_GRAD)
def test_emulated_adjoint_modes_match_plain(libs, data, model, mode, kernel,
                                            dtype, tol):
    """K3 in each mode, built for the model, against the plain adjoint
    (autograd through the plain forward): each gradient row, the model's
    own scalars', within tol of its largest entry."""
    if mode == "analysis":
        args, kw = _adjoint_case(data, dtype, "effective", kernel, model=model)
        cat, z_grids, _, _ = data
        kw = {}
        args = (*args[:4], z_grids.to(dtype), *args[5:7],
                torch.randn(3, z_grids.shape[0], z_grids.shape[1],
                            generator=torch.Generator().manual_seed(8),
                            dtype=F64).to(dtype), *args[8:])
    else:
        args, kw = _adjoint_case(data, dtype, mode, kernel, model=model)
    expect = fused.fused_weights_kde_adjoint_plain(*args, **kw)
    got = _host_adjoint(libs(model)["adjoint_host"], *args, **kw)
    assert got[1].shape[1] == fused.packed_width(_population(F64, model).mass)
    for g, e in zip(got, expect):
        if g is None:
            continue
        assert e.abs().max() > 0
        assert _row_rel(g.reshape(-1, g.shape[-1]), e.reshape(-1, e.shape[-1])) <= tol


@pytest.mark.parametrize("dtype,tol", [(F64, 1e-12), (F32, 1e-4)])
@pytest.mark.parametrize("model", WITH_GRAD)
def test_emulated_rows_adjoint_matches_plain(libs, data, model, dtype, tol):
    """K2b against autograd through ``fused_rows_contract_plain``: every
    output within tol of each row's largest entry (a live row of scale 0
    has its scale's cotangent taken as 0, as in PowerLawPeak's test)."""
    args, zeroed = _rows_case(data, dtype, "epan", model)
    expect = list(rows.fused_rows_contract_adjoint_plain(*args))
    got = _host_rows_adjoint(libs(model)["rows_adjoint_host"], *args)
    expect[2][:, zeroed, 1] = 0.0
    for g, e in zip(got, expect):
        assert e.abs().max() > 0
        assert _row_rel(g.reshape(-1, g.shape[-1]), e.reshape(-1, e.shape[-1])) <= tol


@pytest.mark.parametrize("model", WITH_GRAD)
def test_scratch_layout_matches_the_kernels(libs, model):
    """The wrappers' sizes of the prologue's record and ``partials``
    scratch (``_RECORD_EXTRA`` of the model) against the model's build of
    record_bytes and records_offset (csrc/adjoint.cuh)."""
    fn = libs(model)["adjoint_host"].host_adjoint_scratch
    fn.restype = ctypes.c_longlong
    mass = _population(F32, model).mass
    p = fused.packed_width(mass)
    for dtype, sum_size in ((F32, 4), (F32, 8), (F64, 8)):
        for n, rows_, cd, wd in [(3, 37, 13, 48), (16, 5, 32, 0)]:
            series = torch.zeros(n, cd + 2 + wd, dtype=F64)
            params = torch.zeros(n, p, dtype=dtype)
            record = ctypes.c_longlong()
            doubles = fn(torch.finfo(dtype).bits // 8, sum_size, n, rows_, cd,
                         wd, ctypes.byref(record))
            assert fused.smem_bytes(series, sum_size, params,
                                    fused._RECORD_EXTRA[model]) == record.value
            assert fused.adjoint_scratch(n, rows_, series, sum_size, params,
                                         mass).numel() == doubles


@pytest.mark.parametrize("kind,launched", [
    ("1d", {"K1a": 1, "K3": 1}),
    ("marginalized", {"K1c": 1, "K2": 1, "K3c": 1, "K2b": 1})])
@pytest.mark.parametrize("model", MODELS)
def test_emulated_card_gradient(libs, data, dark_data, monkeypatch, model,
                                kind, launched):
    """log L and d log L / d(H0, Om0, the model's own parameter; and
    PowerLawSpline's coefficients) through the wrappers' CUDA branches with
    the model's emulations as the launches, float64: log L within 1e-12 and
    the gradient within 1e-11 of autograd through the plain versions, each
    kernel launched once."""
    if kind == "1d":
        cat, z_grids, inj, n_gen = data
        args = (cat, z_grids, _population(F64, model),
                SelectionFunction.create(inj, n_gen))
    else:
        cat, z_grids, pop, sel = _dark_hl(dark_data)
        base = _population(F64, model)
        args = (cat, z_grids, Population.create(base.cosmo, base.mass, base.rate,
                                                gal_cat=pop.gal_cat), sel)
    hl = HyperLikelihood.create(*args, kind=kind, binning=False, cut_grid=None)
    lam = {k: torch.tensor(v, dtype=F64) for k, v in MODEL_LAMBDA[model].items()}
    if model == "PowerLawSpline":
        coeffs = torch.tensor(MODEL_KW[model]["spline_coeffs"], dtype=F64)
        lam["spline_coeffs"] = coeffs * torch.tensor([[1.0], [0.5], [-0.8]],
                                                     dtype=F64)

    def grad():
        x = {k: v.clone().requires_grad_() for k, v in lam.items()}
        ll = hl.log_like_batch(x)
        return ll.detach(), torch.autograd.grad(ll.sum(), list(x.values()))

    ll, expect = grad()
    built = libs(model)
    kind_no = fused.MASS_KINDS[model]
    lib_map = {("fused_kde", kind_no): built["fused_host"],
               ("rows_contract", kind_no): built["rows_adjoint_host"],
               ("fused_kde_adjoint", kind_no): built["adjoint_host"],
               ("rows_contract_adjoint", kind_no): built["rows_adjoint_host"]}
    _emulate_the_card(monkeypatch, lib_map)
    before = launch_counts()
    ll_card = hl.log_like_batch(lam)
    after = launch_counts()
    forward = {k: v for k, v in launched.items() if k in ("K1a", "K1c", "K2")}
    assert {k: after[k] - before[k] for k in after} == \
        {k: forward.get(k, 0) for k in after}
    assert torch.all(torch.isfinite(ll))
    assert torch.allclose(ll_card, ll, rtol=1e-12, atol=0)
    before = launch_counts()
    ll_card, got = grad()
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == \
        {k: launched.get(k, 0) for k in after}
    for g, e in zip(got, expect):
        assert torch.all(torch.isfinite(e)) and e.abs().max() > 0
        assert ((g - e).abs() / e.abs().max()).max() <= 1e-11


@pytest.mark.parametrize("model", WITH_GRAD)
def test_device_functions_build_for_the_card_blocks(model):
    """K3 in every mode, K4, K4b, K1e and K1d with the card's blocks
    (``tests/host_emulation/card_blocks.cpp``) pass g++'s syntax check in
    the model's build, as PowerLawPeak's do (``test_torch_host_card.py``)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host emulation")
    proc = subprocess.run(
        [gxx, "-std=c++17", "-fsyntax-only", "-Wno-unknown-pragmas",
         f"-DCHIMERA_MASS_KIND={fused.MASS_KINDS[model]}", f"-I{HERE}",
         f"-I{CSRC}", str(HERE / "card_blocks.cpp")], capture_output=True,
        text=True)
    assert proc.returncode == 0, proc.stderr
