"""The arithmetic of the CUDA kernels on the CPU: the adjoint kernel K3 in
every mode, the rows-contraction adjoint K2b, the fused pass K1 in its four
modes and the batched KDE K4.

A CUDA kernel has no interpret mode, but its arithmetic lives in device
functions (``chimera_tpu_torch/csrc/adjoint.cuh``, ``kde.cuh`` and
``population.cuh``) that a C++ compiler can build for the host once
``__device__`` and friends are defined away
(``tests/host_emulation/cuda_runtime.h``).  The kernels' per-row and
per-event functions are written once for a block of threads;
``tests/host_emulation/adjoint_host.cpp`` (K3), ``rows_adjoint_host.cpp``
(K2b) and ``fused_host.cpp`` (K1, K4) run them with a block of one thread,
behind the kernels' own C interfaces.  Here the emulations are held against
the plain versions (``fused_weights_kde_adjoint_plain`` and
``fused_rows_contract_adjoint_plain``, autograd through the plain forward;
``fused_weights_kde_plain``, ``kde1d_grid_plain``), float64 and float32, and
put in place of the launches behind the wrappers' CUDA branches, to show
the autograd wiring of the card's backward and what the float32 kernel
engine does to d log L / dλ.  K1a's and K2b's pair loops pruned to the
Epanechnikov support are held bit for bit to the unpruned loops, with the
card's tile widths.  What the emulation cannot show: the block sums, the
launch and the shared-memory layout (``tests/test_torch_cuda.py``, on the
card).

This module holds what the tests of each kernel family share (the builds,
the mock data, the wrappers' signatures on the emulations' C interfaces,
the constructed cases of the pruned loops, ``_emulate_the_card``); the
tests are ``tests/test_torch_host_*.py``, a file a family."""

import ctypes
import dataclasses
import math
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import chimera_tpu_torch.likelihood as likelihood_module
from chimera_tpu_torch import HyperLikelihood, SelectionFunction
from chimera_tpu_torch.data.mock import make_mock_catalog, make_mock_injections
from chimera_tpu_torch.models import (FLRW, MadauDickinsonRate, Population,
                                      compute_z_grids)
from chimera_tpu_torch.models.cosmology import z_from_dgw
from chimera_tpu_torch.models.mass import MASS_MODELS, p_m1m2
from chimera_tpu_torch.ops.cuda import fused, kde, rows

HERE = Path(__file__).resolve().parent / "host_emulation"


CSRC = Path(fused.__file__).resolve().parents[2] / "csrc"


F64, F32 = torch.float64, torch.float32


LAMBDA = {"H0": [62.0, 70.0, 81.0], "Om0": [0.2, 0.25, 0.33],
          "mu_g": [30.0, 34.0, 36.0]}


# float64 only: m_low = 8 puts many of the scaled masses at the window's
# foot, where the CDF is ~1e-6 of its series' terms and a float32 sum of it
# is noise (tests/test_torch_models.py)
WINDOW_LAMBDA = {"m_low": [4.0, 5.1, 8.0], "delta_m": [3.0, 4.8, 6.0]}


def _build_host(tmp_path_factory, name: str, csrc: Path = CSRC,
                kind: int = 0) -> ctypes.CDLL:
    """Build ``tests/host_emulation/<name>.cpp`` for the mass model ``kind``
    (CHIMERA_MASS_KIND, ``fused.MASS_KINDS``; 0, PowerLawPeak, the build
    without the macro, as the kernels')."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host emulation")
    so = tmp_path_factory.mktemp("host_emulation") / f"lib{name}_m{kind}.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-Wno-unknown-pragmas",
         *([f"-DCHIMERA_MASS_KIND={kind}"] if kind else []),
         f"-I{HERE}", f"-I{csrc}", "-o", str(so), str(HERE / f"{name}.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return _build_host(tmp_path_factory, "adjoint_host")


@pytest.fixture(scope="module")
def fused_host_lib(tmp_path_factory):
    return _build_host(tmp_path_factory, "fused_host")


@pytest.fixture(scope="module")
def rows_host_lib(tmp_path_factory):
    return _build_host(tmp_path_factory, "rows_adjoint_host")


# each mass model's configuration in the emulation tests, and a λ batch of
# three in (H0, Om0) and one of its own hyper-parameters
MODEL_KW = {"PowerLawSpline": dict(num_knots=6,
                                   spline_coeffs=[0.3, -0.2, 0.5, 0.1, -0.4, 0.2])}
MODEL_LAMBDA = {
    "PowerLawPeak": LAMBDA,
    "TruncatedPowerLaw": {"H0": [62.0, 70.0, 81.0], "Om0": [0.2, 0.25, 0.33],
                          "alpha": [2.2, 2.5, 2.9]},
    "BrokenPowerLaw": {"H0": [62.0, 70.0, 81.0], "Om0": [0.2, 0.25, 0.33],
                       "alpha_1": [1.3, 1.6, 2.0]},
    "PowerLawTwoPeaks": {"H0": [62.0, 70.0, 81.0], "Om0": [0.2, 0.25, 0.33],
                         "mu2_g": [60.0, 68.0, 72.0]},
    "PowerLawSpline": {"H0": [62.0, 70.0, 81.0], "Om0": [0.2, 0.25, 0.33],
                       "alpha": [3.0, 3.4, 3.8]},
}


def _population(dtype, model: str = "PowerLawPeak"):
    return Population.create(
        FLRW.create(H0=70.0, Om0=0.25, device="cpu", dtype=dtype),
        MASS_MODELS[model].create(**MODEL_KW.get(model, {}), device="cpu",
                                  dtype=dtype),
        MadauDickinsonRate.create(device="cpu", dtype=dtype))


@pytest.fixture(scope="module")
def data():
    """12 events x 128 samples x 48-point grids drawn by the port at H0 = 70.
    Half the events have their masses scaled into the low-mass window (below
    m_join, where the conditional CDF is the Chebyshev window series), and a
    few distances lie beyond the inverse map's bounds."""
    pop = _population(F64)
    gen = torch.Generator().manual_seed(5)
    cat = make_mock_catalog(gen, pop, n_events=12, n_samples=128,
                            snr_threshold=12.0, oversample=300)
    scale = torch.ones(12, 1, dtype=F64)
    scale[:6] = 0.25
    dl = cat.dL.clone()
    dl[0, :5], dl[1, :5] = 1e-5, 900.0
    cat = dataclasses.replace(cat, m1det=cat.m1det * scale,
                              m2det=cat.m2det * scale, dL=dl)
    inj, n_gen = make_mock_injections(gen, pop, n_generated=20_000,
                                      snr_threshold=12.0)
    z_grids = compute_z_grids(pop.cosmo, cat, cosmo_prior={"H0": [40.0, 120.0]},
                              z_int_res=48)
    return cat, z_grids, inj, n_gen


def _likelihood(data, dtype, kernel="epan", bw_method=None):
    cat, z_grids, inj, n_gen = data
    return HyperLikelihood.create(cat, z_grids, _population(dtype),
                                  SelectionFunction.create(inj, n_gen),
                                  kernel=kernel, bw_method=bw_method,
                                  binning=False, cut_grid=None)


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _host_adjoint(lib, m1det, m2det, dl, inv_pe_prior, grids, series, params,
                  ct_den, ct_stats, cosmo, mass, kernel="epan", bw_method=None,
                  *, cut_grid=None, n_grid=None, ext_bounds=None, n_real=None,
                  dl_fill=None, logical_s=None, den_scale="norms",
                  stats_only=False, entry="host_fused_kde_adjoint_"):
    """``fused_weights_kde_adjoint``'s signature on the host emulation
    (``entry``: its C entry, less the dtype suffix)."""
    mode = fused._mode_of(grids, ext_bounds, stats_only)
    g = grids.shape[1] if mode == fused._ANALYSIS_GRID else \
        0 if mode == fused._STATS_ONLY else int(n_grid)
    d_series, d_params = torch.zeros_like(series), torch.zeros_like(params)
    d_ext = None if ext_bounds is None else torch.zeros_like(ext_bounds)
    fn = getattr(lib, entry + ("f64" if dl.dtype == F64 else "f32"))
    fn.restype = None
    keep = [None if t is None else t.contiguous() for t in (
        m1det, m2det, dl, inv_pe_prior,
        grids if mode == fused._ANALYSIS_GRID else None, ext_bounds, n_real,
        dl_fill, series, params, ct_den, ct_stats)]
    bw_mode, bw_value = fused._bw_code(bw_method)
    e, s = dl.shape
    fn(*[_ptr(t) for t in (*keep, None, d_series, d_params, d_ext)],
       series.shape[0], e, s, g, cosmo.cheb_deg, fused.window_degree(mass),
       logical_s or 0, mode, 0 if kernel == "epan" else 1, bw_mode,
       ctypes.c_double(bw_value), ctypes.c_double(cut_grid or 0.0),
       int(den_scale == "unit"))
    return d_series, d_params, d_ext


def _row_rel(got, expect):
    scale = expect.double().abs().amax(dim=1, keepdim=True).clamp_min(1e-300)
    return float(((got.double() - expect.double()).abs() / scale).max())


def _emulated_kernel_engine(lib):
    """``fused_weights_kde`` as the CUDA path runs it: the forward without
    a graph, the backward in the packed rows from the host emulation of
    K3."""
    class Emulated(torch.autograd.Function):
        @staticmethod
        def forward(ctx, series, params, cosmo, mass, kernel, bw_method, *data):
            ctx.save_for_backward(series, params, *data)
            ctx.cfg = (cosmo, mass, kernel, bw_method)
            models = fused.unpack_params(cosmo, mass, series, params)
            den, stats = fused.fused_weights_kde_plain(
                *data[:4], *models, data[4], kernel, bw_method)
            stats = [stats[k] for k in fused.STAT_NAMES]
            return den, torch.stack(stats + [torch.zeros_like(stats[0])], dim=-1)

        @staticmethod
        def backward(ctx, ct_den, ct_stats):
            series, params, *data = ctx.saved_tensors
            grads = _host_adjoint(lib, *data, series, params, ct_den, ct_stats,
                                  *ctx.cfg)
            return (*grads[:2], None, None, None, None) + (None,) * 5

    def fused_weights_kde(m1det, m2det, dl, inv_pe_prior, cosmo, mass, grids,
                          kernel="epan", bw_method=None):
        n = max(cosmo.L, mass.L)
        series, params = fused.pack_params(cosmo, mass, n, dl.dtype)
        den, stats = Emulated.apply(series, params, cosmo, mass, kernel,
                                    bw_method, m1det, m2det, dl, inv_pe_prior,
                                    grids)
        return den, fused._stats_dict(stats)

    return fused_weights_kde


def _host_fused(lib, mode, m1det, m2det, dl, inv_pe_prior, cosmo, mass,
                grids=None, kernel="epan", n_grid=0, ext_bounds=None,
                n_real=None, dl_fill=None, logical_s=None, cut_grid=None,
                den_scale="norms", contract=None, entry="host_fused_kde_",
                raw=False):
    """``fused._launch_k1``'s arguments on the host emulation (``entry``:
    the emulation's C entry, less its dtype suffix); the stats as a dict,
    or the (L, B, 8) tensor where ``raw``."""
    dt = dl.dtype
    b, s = dl.shape
    n = max(cosmo.L, mass.L)
    series, params = fused.pack_params(cosmo, mass, n, dt)
    g = grids.shape[1] if mode in (fused._ANALYSIS_GRID, fused._CONTRACT) else \
        0 if mode == fused._STATS_ONLY else n_grid
    den = torch.zeros((n, b, 2 if mode == fused._CONTRACT else max(g, 1)),
                      dtype=dt)
    stats = torch.zeros((n, b, 8), dtype=dt)
    fn = getattr(lib, entry + ("f64" if dt == F64 else "f32"))
    fn.restype = None
    factors = [None] * 4 if contract is None else [t.contiguous() for t in contract]
    keep = [t.contiguous() if t is not None else None for t in
            (m1det, m2det, dl, inv_pe_prior, grids, ext_bounds, n_real, dl_fill)]
    fn(*[_ptr(t) for t in (*keep, series, params, *factors, den, stats)], n, b,
       s, g, cosmo.cheb_deg, fused.window_degree(mass), logical_s or 0, mode,
       0 if kernel == "epan" else 1, 0, ctypes.c_double(0.0),
       ctypes.c_double(cut_grid or 0.0), int(den_scale == "unit"),
       0 if contract is None else b // contract[2].shape[1])
    return den, stats if raw else fused._stats_dict(stats)


def _pixel_rows(cat, dtype):
    """Logical per-pixel rows of the mock's events (``data.pixelize.
    compact_samples_by_pixel``): each sample dealt at random to one of
    three pixels, a fourth pixel left empty (a dead row), 64-slot rows."""
    from chimera_tpu_torch.data.pixelize import compact_samples_by_pixel

    e, s = cat.dL.shape
    gen = torch.Generator().manual_seed(11)
    theta = cat.update(
        pixels_opt_nsides=torch.arange(4).expand(e, 4),
        pixels_pe_opt_nside=torch.randint(0, 3, (e, s), generator=gen))
    c = compact_samples_by_pixel(theta, pad_multiple=64)
    flat = [c[k].reshape(e * 4, -1).to(dtype)
            for k in ("m1det", "m2det", "dL", "inv_pe_prior")]
    return flat, c["n_real"].reshape(-1), c["dl_fill"].repeat_interleave(4).to(dtype)


def _contract_factors(b: int, npix: int, n: int, g: int, dtype, seed=6):
    """Random positive K1e factors: s1, s2 (b, g) per row, f1, f2
    (n, b / npix, g) per (λ, event)."""
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, dtype=F64).to(dtype)

    return (rand(b, g), rand(b, g), rand(n, b // npix, g), rand(n, b // npix, g))


def _kde_rows(dtype, b=9, s=200, g=250, seed=4):
    """K4's inputs: b rows of s normalized weights on g-point grids, the
    bandwidths, a row of zero weights (row 1) and, for the Epanechnikov
    slope, a row whose grid points sit at |u| = 1 exactly of some samples
    (row 2: z and the grid on multiples of 1/8, h = 1/4)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(1.0, 0.2, (b, s))
    w = rng.uniform(size=(b, s))
    w[1] = 0.0
    z[2] = rng.integers(4, 12, s) / 8.0
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-300)
    grids = np.linspace(0.3, 1.8, g)[None] * rng.uniform(0.8, 1.2, (b, 1))
    grids[2] = np.arange(g) / 8.0 - 4.0
    h = rng.uniform(0.02, 0.1, b)
    h[2] = 0.25
    return [torch.tensor(a, dtype=dtype) for a in (z, w, grids, h)]


def _adjoint_case(data, dtype, mode, kernel, seed=2, model="PowerLawPeak"):
    """K3's arguments and mode keywords for ``mode`` on the emulation's
    data, with random cotangents (a dead pixel row's bandwidth and bounds
    are rounding noise, as in the forward tests: they get none)."""
    cat, _, _, _ = data
    pop = _population(dtype, model).update_batch(MODEL_LAMBDA[model])
    cosmo, mass = pop.cosmo, pop.mass
    pe = [t.to(dtype) for t in (cat.m1det, cat.m2det, cat.dL, 1.0 / cat.pe_prior)]
    if mode == "effective":
        kw = {"cut_grid": 2.0, "n_grid": 24}
    elif mode == "stats":
        kw = {"cut_grid": 2.0, "stats_only": True}
    else:
        ev = fused.fused_row_stats_plain(*pe, cosmo, mass)
        pe, n_real, dl_fill = _pixel_rows(cat, dtype)
        kw = {"n_real": n_real, "dl_fill": dl_fill, "logical_s": cat.dL.shape[1]}
        if mode == "stats_logical":
            kw.update(cut_grid=2.0, stats_only=True)
        else:
            kw.update(n_grid=24, den_scale="unit", ext_bounds=torch.stack(
                [ev["lo"], ev["ub"]], dim=-1).repeat_interleave(4, dim=1))
    n, b = 3, pe[2].shape[0]
    series, params = fused.pack_params(cosmo, mass, n, dtype)
    gen = torch.Generator().manual_seed(seed)
    ct_den = None if kw.get("stats_only") else torch.randn(
        n, b, kw["n_grid"], generator=gen, dtype=F64).to(dtype)
    ct_stats = torch.randn(n, b, 8, generator=gen, dtype=F64).to(dtype)
    if "n_real" in kw:
        for slot in (0, 1, 4):
            ct_stats[:, kw["n_real"] == 0, slot] = 0.0
    return (*pe, None, series, params, ct_den, ct_stats, cosmo, mass, kernel), kw


def _rows_case(data, dtype, kernel, model="PowerLawPeak"):
    """K2b's arguments on chunk rows of 32 samples built from the emulation
    data's per-pixel rows, (1/h, scale) from their plain stats pass, random
    positive s, f factors and random cotangents (two rows without); and the
    row numbers of two live rows whose scale is then set to 0."""
    from chimera_tpu_torch.data.pixelize import (chunk_rows_from_compact,
                                                 compact_samples_by_pixel)

    cat, z_grids, _, _ = data
    pop = _population(dtype, model).update_batch(MODEL_LAMBDA[model])
    cosmo, mass = pop.cosmo, pop.mass
    e, s = cat.dL.shape
    gen = torch.Generator().manual_seed(11)
    theta = cat.update(pixels_opt_nsides=torch.arange(4).expand(e, 4),
                       pixels_pe_opt_nside=torch.randint(0, 3, (e, s), generator=gen))
    comp = compact_samples_by_pixel(theta, pad_multiple=64)
    chunks = chunk_rows_from_compact(comp, chunk=32)
    c = chunks["dL"].shape[1]
    keys = ("m1det", "m2det", "dL", "inv_pe_prior")
    flat = [chunks[k].reshape(e * c, -1).to(dtype) for k in keys]
    pix = [comp[k].reshape(e * 4, -1).to(dtype) for k in keys]
    st = fused.fused_row_stats_plain(*pix, cosmo, mass, comp["n_real"].reshape(-1),
                                     comp["dl_fill"].repeat_interleave(4).to(dtype), s)
    h, sum_w = st["bandwidth"], st["sum_w"]
    row_pixel = (torch.arange(e)[:, None] * 4 + chunks["row_pix"]).reshape(-1)
    scale = torch.where(sum_w > 0, 1.0 / (h * sum_w), 0.0)
    hs = torch.stack([(1.0 / h)[:, row_pixel], scale[:, row_pixel]], dim=-1)
    live = torch.nonzero((flat[3] > 0).any(dim=1)).flatten()
    zeroed = live[[3, 9]]
    hs[:, zeroed, 1] = 0.0
    gen = torch.Generator().manual_seed(3)
    g = z_grids.shape[1]

    def rand(*shape):
        return torch.rand(*shape, generator=gen, dtype=F64).to(dtype)

    ct = torch.randn(3, e * c, 2, generator=gen, dtype=F64).to(dtype)
    ct[:, live[[5, 6]]] = 0.0
    series, params = fused.pack_params(cosmo, mass, 3, dtype)
    return (*flat, z_grids.to(dtype), series, params, hs, rand(e * c, g),
            rand(e * c, g), rand(3, e, g), rand(3, e, g), ct, cosmo, mass,
            kernel), zeroed


def _host_rows_adjoint(lib, m1det, m2det, dl, inv_pe_prior, grids, series,
                       params, hs, s1, s2, f1, f2, ct_r, cosmo, mass,
                       kernel="epan", entry="host_rows_contract_adjoint_"):
    """``rows.fused_rows_contract_adjoint``'s signature on the host
    emulation (``entry``: its C entry, less the dtype suffix)."""
    n, (r_rows, chunk), (e, g) = series.shape[0], dl.shape, grids.shape
    outs = [torch.zeros_like(t) for t in (series, params, hs, f1, f2)]
    fn = getattr(lib, entry + ("f64" if dl.dtype == F64 else "f32"))
    fn.restype = None
    keep = [t.contiguous() for t in (m1det, m2det, dl, inv_pe_prior, grids,
                                     series, params, hs, s1, s2, f1, f2, ct_r)]
    fn(*[_ptr(t) for t in keep], None, *[_ptr(t) for t in outs], n, e,
       r_rows // e, chunk, g, cosmo.cheb_deg, fused.window_degree(mass),
       0 if kernel == "epan" else 1)
    return tuple(outs)


@pytest.fixture(scope="module")
def dark_data():
    """8 events x 256 samples of a port-generated dark siren (σ_sky 0.03
    rad, nside {8, 16}, 6 pixels asked, 48-point grids, 3000 background
    galaxies, step completeness)."""
    from chimera_tpu_torch.catalog import DVdzCompleteness
    from chimera_tpu_torch.catalog.build import build_pixelated_catalog
    from chimera_tpu_torch.data.mock import make_mock_galaxies
    from chimera_tpu_torch.data.pixelize import pixelize_gw_catalog

    pop = _population(F64)
    gen = torch.Generator().manual_seed(9)
    cat, truths = make_mock_catalog(gen, pop, n_events=8, n_samples=256,
                                    snr_threshold=12.0, sigma_sky_rad=0.03,
                                    oversample=300, return_truths=True)
    inj, n_gen = make_mock_injections(gen, pop, n_generated=20_000,
                                      snr_threshold=12.0)
    gal = make_mock_galaxies(gen, pop, truths, n_background=3000)
    cat = pixelize_gw_catalog(cat, nside_list=[8, 16], mean_npixels_event=6,
                              sky_conf=0.9)
    z_grids = compute_z_grids(pop.cosmo, cat, cosmo_prior={"H0": [40.0, 120.0]},
                              z_int_res=48)
    compl = DVdzCompleteness.create(z_range=(0.0, 3.0), kind="step",
                                    device="cpu", dtype=F64)
    gal_cat = build_pixelated_catalog(gal, cat, z_grids, pop.cosmo, compl,
                                      z_err=0.01)
    return cat, z_grids, gal_cat, inj, n_gen


def _emulate_the_card(monkeypatch, libs):
    """Make the kernel wrappers of ``fused``, ``rows`` and ``kde`` take
    their CUDA branches on CPU tensors, with ``launch`` calling the host
    emulation of the same C interface (``libs``: the emulations by kernel
    source name; another mass model's under ``(name, kind)``).  Every
    launch counter the emulated launches move is restored with the rest of
    the patch, so a later test in the same process starts from the counts
    it had."""
    from chimera_tpu_torch.ops.cuda import launch_counters

    for wrapper, attr in launch_counters().values():
        monkeypatch.setattr(wrapper, attr, getattr(wrapper, attr))

    def launch(lib_name, symbol, dtype, device, args, mass_kind=0):
        lib = libs[lib_name] if mass_kind == 0 else libs[(lib_name, mass_kind)]
        fn = getattr(lib, symbol.replace("chimera", "host")
                     + ("_f32" if dtype == F32 else "_f64"))
        fn.restype = None
        fn(*[_ptr(a) if isinstance(a, torch.Tensor) or a is None
             else ctypes.c_double(a) if isinstance(a, float) else a for a in args])

    for module in (fused, rows):
        monkeypatch.setattr(module, "on_card", lambda t: True)
        monkeypatch.setattr(module, "launch", launch)
        monkeypatch.setattr(module, "check_cuda_call", lambda *args: None)
    monkeypatch.setattr(kde, "_check", lambda *args: None)


def _dark_hl(dark_data):
    """The dark data's likelihood arguments: PE data, grids, the population
    with its pixelated catalog, the selection."""
    cat, z_grids, gal_cat, inj, n_gen = dark_data
    pop = _population(F64)
    pop = Population.create(pop.cosmo, pop.mass, pop.rate, gal_cat=gal_cat)
    return cat, z_grids, pop, SelectionFunction.create(inj, n_gen)


def _mass_points(mass, rng):
    """(scalars (n, 12), m1det, m2det, z) at points that reach every branch
    and clip tie of p_m1m2: m1 below m_low, in the smoothing window, at
    m_low, m_join, m_high and the peak's 5 sigma cut exactly (z = 0), below
    and above m_join, above m_high; m2 in the window, at and near m1; and
    the closed form's log branch (beta = -1) and the power law's (alpha =
    1)."""
    base = np.array([float(getattr(mass, k)) for k in fused.MASS_SCALARS])
    m_low, m_high, _, _, dm, _, mu, sig, _, _, m_join, _ = base
    pts = []

    def add(m1, m2, z, **change):
        s = base.copy()
        for k, v in change.items():
            s[fused.MASS_SCALARS.index(k)] = v
        pts.append((s, m1, m2, z))

    for _ in range(40):                       # anywhere
        m1 = rng.uniform(2.0, 1.2 * m_high)
        add(m1, m1 * rng.uniform(0.05, 1.0), rng.uniform(0.0, 1.5))
    for _ in range(20):                       # in the CDF's window
        m1, z = rng.uniform(m_low + dm, m_join), rng.uniform(0.0, 1.5)
        add(m1 * (1 + z), m1 * (1 + z) * rng.uniform(0.5, 1.0), z)
    for m1 in (0.8 * m_low, m_low + 0.3 * dm, m_low + 0.9 * dm,
               0.97 * m_join, 1.03 * m_join, 1.1 * m_high):
        z = rng.uniform(0.05, 0.8)
        add(m1 * (1 + z), m_low * (1 + z) * 1.01, z)           # m2 in the window
        add(m1 * (1 + z), m1 * (1 + z) * (1 - 1e-9), z)        # m2 near m1
        add(m1 * (1 + z), 0.5 * m1 * (1 + z), z)
    for m1 in (m_low, m_join, m_high, mu + 5.0 * sig):        # exact ties
        add(m1, m1, 0.0)
        add(m1, 0.6 * m1, 0.0)
    for _ in range(6):
        m1 = rng.uniform(m_low + dm, m_high)
        add(m1, 0.7 * m1, rng.uniform(0.0, 1.0), beta=-1.0)
        add(m1, 0.7 * m1, rng.uniform(0.0, 1.0), alpha=1.0)
    s, m1, m2, z = zip(*pts)
    return (np.array(s), np.array(m1), np.array(m2), np.array(z))


def _logical_rows(data, dtype, n_rows=37, width=200, logical_s=260,
                  events=2):
    """``n_rows`` logical rows of ``width`` slots (the kernel takes 4 rows
    a block; the last block is short) drawn from ``events`` consecutive
    events of the emulation's: real counts from 0 (an empty row) to
    ``width`` (a full one, over the 128 samples phase D stashes at a time),
    the fillers after them at dl_fill with no weight, one row whose fillers
    sit below every real distance (they hold the minimum z), the rest
    above."""
    cat = data[0]
    rng = np.random.default_rng(23)
    n_real = rng.integers(1, width, n_rows)
    n_real[0], n_real[5], n_real[17] = 0, width, 1
    rows = [torch.zeros(n_rows, width, dtype=F64) for _ in range(4)]
    dl_fill = torch.zeros(n_rows, dtype=F64)
    n_ev = cat.dL.shape[0]
    src = [cat.m1det, cat.m2det, cat.dL, 1.0 / cat.pe_prior]
    for b in range(n_rows):
        e, k = b % n_ev, int(n_real[b])
        pool = [torch.cat([t[(e + i) % n_ev] for i in range(events)])
                for t in src]
        pick = torch.as_tensor(rng.choice(len(pool[0]), k, replace=False))
        for r, p in zip(rows, pool):
            r[b, :k] = p[pick]
        real_dl = rows[2][b, :k]
        dl_fill[b] = (0.5 * real_dl.min() if b == 9 else 1.5 * real_dl.max()) \
            if k else 2000.0
        rows[0][b, k:], rows[1][b, k:] = 30.0, 20.0
        rows[2][b, k:] = dl_fill[b]
        rows[3][b, k:] = 0.0
    return ([r.to(dtype) for r in rows], torch.as_tensor(n_real),
            dl_fill.to(dtype), logical_s)


def _tie_bandwidth(z0, z_sig):
    """A grid point g and a bandwidth factor c with h = c z_sig such that
    (g - z0) / h and (g - z0) * (1 / h) are exactly 1."""
    g = z0 + 0.5 * z_sig
    for _ in range(400):
        g = math.nextafter(g, math.inf)
        d = g - z0
        c = d / z_sig
        for _ in range(8):
            if c * z_sig == d and d * (1.0 / d) == 1.0:
                return g, c
            c = math.nextafter(c, math.inf if c * z_sig < d else -math.inf)
    raise AssertionError("no tie found")


def _off_edge(z, h, g, gen):
    """(E, g) grid points off the support's edge: z0 + h (-0.8 .. 0.8)."""
    return z[:, :1] + h * (torch.rand(len(z), g, generator=gen,
                                      dtype=z.dtype) * 1.6 - 0.8)


def _same_bits(a, b) -> bool:
    """Whether two float tensors hold the same bits, signed zeros too, with
    NaN where the other has NaN (a NaN's sign and payload follow operand
    order, which a compiler may swap in an add)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = torch.int64 if a.element_size() == 8 else torch.int32
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a[~nan].view(view), b[~nan].view(view))


def _tally(lib) -> tuple[int, int]:
    """The tiles the pruned loops tested and skipped since the last call."""
    out = (ctypes.c_longlong * 2)()
    lib.host_tile_tally(out)
    return out[0], out[1]


def _host_contract(lib, z, w, grids, inv_h, prune):
    """The Epanechnikov densities (without the constant) of rows of (z, w)
    on their grids at 1/h, pruned (contract_pruned) or not (contract)."""
    b, s = z.shape
    out = torch.zeros(b, grids.shape[1], dtype=z.dtype)
    keep = [t.contiguous() for t in (z, w, grids, inv_h)]
    fn = getattr(lib, "host_contract_" + ("f64" if z.dtype == F64 else "f32"))
    fn.restype = None
    fn(*[_ptr(t) for t in (*keep, out)], b, s, grids.shape[1], int(prune))
    return out


CONTRACT_CASES = ("sorted", "tie", "rounds_to_one", "unsorted", "fillers",
                  "zero_weight", "nan_h", "zero_h", "non_finite_z",
                  "non_finite_w", "non_finite_grid")


def _contract_case(case: str, dtype, s: int = 256, g: int = 200):
    """A row of 256 dL-sorted samples (z ~ N(1, 0.1), w in [0.1, 1.1)) on a
    200-point grid over [0.4, 1.6] at h = 2^-6, changed as ``case`` says:
    grid points at exactly z +- h on a 2^-12 lattice ('tie', u = +-1); at
    z + h (1 + k eps), |k| <= 4, with h not a power of two
    ('rounds_to_one'); the samples shuffled ('unsorted'); the last 48
    samples weightless at z = 0.5, the tail of a dark row ('fillers'); no
    weight; a NaN or zero bandwidth; an infinite and a NaN z, an infinite
    w, a NaN grid point.  Returns z, w, grid and 1/h in ``dtype``."""
    gen = torch.Generator().manual_seed(21)
    z = torch.sort(1.0 + 0.1 * torch.randn(s, generator=gen, dtype=F64)).values
    w = torch.rand(s, generator=gen, dtype=F64) + 0.1
    grid = torch.linspace(0.4, 1.6, g, dtype=F64)
    inv_h = 64.0
    if case == "tie":
        z = torch.round(z * 4096.0) / 4096.0
        pick = z[::16]
        grid = torch.sort(torch.cat([grid[:g - 2 * len(pick)],
                                     pick + 2.0 ** -6, pick - 2.0 ** -6])).values
    elif case == "rounds_to_one":
        h = 0.0173
        inv_h = 1.0 / h
        eps = torch.finfo(dtype).eps
        edge = (z[::16, None] + h * (1.0 + eps * torch.arange(
            -4, 5, dtype=F64))[None]).flatten()
        grid = torch.sort(torch.cat([grid[:g - len(edge)], edge])).values
    elif case == "unsorted":
        perm = torch.randperm(s, generator=gen)
        z, w = z[perm], w[perm]
    elif case == "fillers":
        z[-48:], w[-48:] = 0.5, 0.0
    elif case == "zero_weight":
        w[:] = 0.0
    elif case == "nan_h":
        inv_h = math.nan
    elif case == "zero_h":
        inv_h = math.inf
    elif case == "non_finite_z":
        z[40], z[41], z[120] = math.inf, -math.inf, math.nan
    elif case == "non_finite_w":
        w[100] = math.inf
    elif case == "non_finite_grid":
        grid[5] = math.nan
    return (z.to(dtype), w.to(dtype), grid.to(dtype),
            torch.tensor(inv_h, dtype=F64).to(dtype))


def _check_pruned_k1(lib, data, dtype, mode, kw, min_skip: float):
    """K1 in ``mode`` (Epanechnikov) with the pruned loop against the
    unpruned mode (contract): densities and stats of the same bits on the
    emulation data's rows sorted by distance as ``create`` sorts them
    (skipping more than ``min_skip`` of the tiles) and in the catalog's
    order."""
    cat, _, _, _ = data
    pop = _population(dtype).update_batch({"H0": [62.0, 70.0, 81.0]})
    hl = _likelihood(data, dtype)
    rows_sorted = [hl.m1det, hl.m2det, hl.dL, hl.inv_pe_prior]
    rows_raw = [t.to(dtype) for t in (cat.m1det, cat.m2det, cat.dL,
                                      1.0 / cat.pe_prior)]
    for pe in (rows_sorted, rows_raw):
        _tally(lib)
        den, st = _host_fused(lib, mode, *pe, pop.cosmo, pop.mass, **kw)
        tested, skipped = _tally(lib)
        den_u, st_u = _host_fused(lib, mode, *pe, pop.cosmo, pop.mass, **kw,
                                  entry="host_fused_kde_unpruned_")
        assert _tally(lib) == (0, 0)
        assert tested > 0 and (pe is rows_raw or skipped > tested * min_skip)
        assert _same_bits(den, den_u) and den.abs().max() > 0
        for k in fused.STAT_NAMES:
            assert _same_bits(st[k], st_u[k]), k


K1E_CASES = ("sorted", "unsorted", "near_edge")


def _k1e_case(data, dtype, case):
    """K1e's arguments (the contract mode on logical rows, unit mass) on 20
    logical rows of up to 600 slots (logical_s 700) drawn from 5 events of
    the emulation data, 4 rows an event: an empty row, rows of 1, of over
    128 and of 600 samples, one whose fillers hold the minimum z, and row 3
    with its weights scaled below sqrt(tiny) (r = 0 with no loop); each
    row's real samples sorted by distance as the pixelization keeps them
    ('sorted'), in random order ('unsorted'), or sorted with row 17's
    single sample at u = 1 - 2^-10 of the lowest point of its grid's
    second 32-point run at the first λ ('near_edge': in the support, the
    corner test must keep the tile).  Each row's grid is its event's
    analysis grid; random positive factors."""
    cat, z_grids = data[0], data[1]
    pop = _population(dtype).update_batch(LAMBDA)
    cosmo, mass = pop.cosmo, pop.mass
    pe, n_real, dl_fill, logical_s = _logical_rows(data, F64, n_rows=20,
                                                   width=600, logical_s=700,
                                                   events=5)
    if case != "unsorted":
        for b, k in enumerate(n_real.tolist()):
            order = torch.argsort(pe[2][b, :k])
            for t in pe:
                t[b, :k] = t[b, :k][order]
    pe[3][3] *= 1e-30 if dtype == F32 else 1e-160
    pe = [t.to(dtype) for t in pe]
    dl_fill = dl_fill.to(dtype)
    b, g = len(n_real), z_grids.shape[1]
    grids = z_grids.double()[torch.arange(b) % cat.dL.shape[0]]
    kw = {"n_real": n_real, "dl_fill": dl_fill, "logical_s": logical_s}
    if case == "near_edge":
        st = fused.fused_row_stats_plain(*pe, cosmo, mass, **kw)
        z0 = z_from_dgw(cosmo, pe[2][17, :1][None]).double()[0, 0]
        h = st["bandwidth"][0, 17].double()
        g32 = z0 + h * (1.0 - 2.0 ** -10)
        grids[17] = g32 + (torch.arange(g, dtype=F64) - 32) * h / 8
    kw.update(grids=grids.to(dtype), den_scale="unit",
              contract=_contract_factors(b, 4, 3, g, dtype))
    return (*pe, cosmo, mass), kw


K1D_CASES = ("sorted", "unsorted", "near_edge", "empty_rows", "tiny_weight")


def _k1d_case(data, dtype, case):
    """K1d's arguments (given bounds on logical rows, unit mass) on 21
    logical rows of up to 600 slots (logical_s 700) drawn from 5 events of
    the emulation data: an empty row, rows of 1, of over 128 and of 600
    samples, one whose fillers hold the minimum z, a short last block of 4
    rows; each row's real samples sorted by distance as the pixelization
    keeps them ('sorted'), in random order ('unsorted'), sorted with row
    17's single sample at u = 1 - 2^-10 of the lowest point of its grid's
    second 32-point run at every λ ('near_edge': in the support, the corner
    test must keep the tile), sorted with every even row emptied
    ('empty_rows': empty and full rows in turn in each block), or sorted
    with rows 3 and 6's weights below sqrt(tiny) ('tiny_weight').  250-point
    grids over each row's z range widened by half of it on either side (the
    event's range holds a pixel's samples)."""
    pop = _population(dtype).update_batch(LAMBDA)
    cosmo, mass = pop.cosmo, pop.mass
    pe, n_real, dl_fill, logical_s = _logical_rows(data, F64, n_rows=21,
                                                   width=600, logical_s=700,
                                                   events=5)
    if case != "unsorted":
        for b, k in enumerate(n_real.tolist()):
            order = torch.argsort(pe[2][b, :k])
            for t in pe:
                t[b, :k] = t[b, :k][order]
    if case == "empty_rows":
        n_real[::2] = 0
    if case == "tiny_weight":
        for b in (3, 6):
            pe[3][b] *= 1e-30 if dtype == F32 else 1e-160
    pe = [t.to(dtype) for t in pe]
    dl_fill = dl_fill.to(dtype)
    kw = {"n_real": n_real, "dl_fill": dl_fill, "logical_s": logical_s}
    st = fused.fused_row_stats_plain(*pe, cosmo, mass, cut_grid=0.0, **kw)
    lo, ub = st["lo"].double(), st["ub"].double()
    g = 250
    ext = torch.stack([lo - 0.5 * (ub - lo), ub + 0.5 * (ub - lo)], dim=-1)
    if case == "near_edge":
        z0 = z_from_dgw(cosmo, pe[2][17, :1][None]).double()[:, 0]
        h = st["bandwidth"][:, 17].double()
        ext[:, 17, 0] = z0 + h * (1.0 - 2.0 ** -10) - 32 * h / 8
        ext[:, 17, 1] = ext[:, 17, 0] + (g - 1) * h / 8
    kw.update(n_grid=g, den_scale="unit", ext_bounds=ext.to(dtype))
    return (*pe, cosmo, mass), kw


def _sorted_data(data, n_grid: int = 200):
    """The emulation data with each event's samples sorted by distance (as
    ``create`` sorts them) and ``n_grid``-point grids."""
    cat, _, inj, n_gen = data
    cat = likelihood_module._sort_samples_by_distance(cat)
    z_grids = compute_z_grids(_population(F64).cosmo, cat,
                              cosmo_prior={"H0": [40.0, 120.0]},
                              z_int_res=n_grid)
    return cat, z_grids, inj, n_gen


ROWS_CASES = ("pixel_rows", "sorted", "tie", "unsorted", "nan_h")


def _rows_prune_case(rows_host_lib, data, dtype, case):
    """K2b's arguments (_rows_case, Epanechnikov): on the emulation data's
    chunk rows in catalog order, with their weightless fillers at each
    pixel's tail, dead rows and rows without scale or cotangent
    ('pixel_rows'); on the dL-sorted data with 200-point grids ('sorted');
    that with, at the first λ, 1/h = 2^k on each event's rows and the
    event's first two 32-point grid tiles ending at z - 2^-k and starting
    at z + 2^-k exactly for one sample z, u = -1 and 1 at the tiles'
    corners ('tie'); the sorted rows' samples shuffled within each row
    ('unsorted'); a NaN 1/h on two live rows ('nan_h')."""
    args, _ = _rows_case(data if case == "pixel_rows" else _sorted_data(data),
                         dtype, "epan")
    args = list(args)
    m1, m2, dl, invp, grids, series, params, hs = args[:8]
    live = torch.nonzero((invp > 0).any(dim=1)).flatten()
    if case == "tie":
        e_ev, per = grids.shape[0], dl.shape[0] // grids.shape[0]
        dl = dl.contiguous()
        z, ser0, prm0 = torch.empty_like(dl), series[0].clone(), params[0].clone()
        fn = getattr(rows_host_lib, "host_rows_z_" + ("f64" if dtype == F64 else "f32"))
        fn.restype = None
        fn(_ptr(ser0), _ptr(prm0), args[13].cheb_deg, args[14].window_deg,
           _ptr(dl), dl.numel(), _ptr(z))
        grids, hs = grids.clone(), hs.clone()
        for e in range(e_ev):
            r = next(r for r in live.tolist() if r // per == e)
            z0 = float(z[r][(z[r] > 0.05) & (invp[r] > 0)][0])
            k = next(k for k in range(5, 14)
                     if float(torch.tensor(z0 + 2.0 ** -k, dtype=dtype)) - z0
                     == 2.0 ** -k)
            hs[0, e * per:(e + 1) * per, 0] = 2.0 ** k
            # the first grid tile ends at z0 - h, the second starts at z0 + h
            step = 2.0 ** -k * torch.arange(32, dtype=F64)
            grids[e, :64] = torch.cat([z0 - 2.0 ** -k - step.flip(0),
                                       z0 + 2.0 ** -k + step]).to(dtype)
        args[4], args[7] = grids, hs
    elif case == "unsorted":
        perm = torch.argsort(torch.rand(dl.shape, generator=torch.Generator(
        ).manual_seed(5)), dim=1)
        for i in range(4):
            args[i] = torch.take_along_dim(args[i], perm, dim=1)
    elif case == "nan_h":
        hs = hs.clone()
        hs[:, live[[1, 4]], 0] = math.nan
        args[7] = hs
    return args


def _host_rows_contract(lib, m1det, m2det, dl, inv_pe_prior, grids, series,
                        params, hs, s1, s2, f1, f2, cosmo, mass, kernel="epan",
                        entry="host_rows_contract_"):
    """``rows._launch_k2``'s launch on the host emulation (``entry``: its C
    entry, less the dtype suffix); returns r (L, R, 2)."""
    n, (r_rows, chunk), (e, g) = series.shape[0], dl.shape, grids.shape
    out = torch.zeros((n, r_rows, 2), dtype=dl.dtype)
    fn = getattr(lib, entry + ("f64" if dl.dtype == F64 else "f32"))
    fn.restype = None
    keep = [t.contiguous() for t in (m1det, m2det, dl, inv_pe_prior, grids,
                                     series, params, hs, s1, s2, f1, f2)]
    fn(*[_ptr(t) for t in (*keep, out)], n, e, r_rows // e, chunk, g,
       cosmo.cheb_deg, fused.window_degree(mass), 0 if kernel == "epan" else 1)
    return out


def _k2_args(args):
    """K2's arguments in the order of _host_rows_contract from K2b's
    (_rows_case): the rows, grids, packed rows, hs and factors."""
    return (*args[:12], args[13], args[14], args[15])


K2_CASES = ROWS_CASES + ("near_edge", "non_finite")


def _near_edge(rows_host_lib, args, dtype):
    """The dL-sorted rows of K2 with, at the first λ, 1/h = 2^8 on the rows
    of each event and the event's first two 32-point grid tiles ending at
    z_lo - h (1 - 2^-10) and starting at z_hi + h (1 - 2^-10), for the
    (z_lo, z_hi) of the first 32-sample tile of the event's first row with
    a scale and more than 4 samples of non-zero weight there: pairs at |u| = 1 - 2^-10 on both tile corners, just inside the
    support."""
    m1, m2, dl, invp, grids, series, params, hs = args[:8]
    per = dl.shape[0] // grids.shape[0]
    z = torch.empty_like(dl)
    fn = getattr(rows_host_lib, "host_rows_z_" + ("f64" if dtype == F64 else "f32"))
    fn.restype = None
    fn(_ptr(series[0].clone()), _ptr(params[0].clone()), args[13].cheb_deg,
       args[14].window_deg, _ptr(dl.contiguous()), dl.numel(), _ptr(z))
    # the weights at the first λ as the plain version has them: the tile
    # bounds are over the samples with w != 0
    cosmo, mass = args[13], args[14]
    inv1pz = 1.0 / (1.0 + z_from_dgw(cosmo, dl[None])[0])
    w = p_m1m2(mass, m1[None] * inv1pz, m2[None] * inv1pz)[0] * invp
    weighted = w[:, :32] != 0
    live = torch.nonzero((weighted.sum(dim=1) > 4) & (hs[0, :, 1] != 0)).flatten()
    grids, hs = grids.clone(), hs.clone()
    events = sorted({r // per for r in live.tolist()})
    assert len(events) > grids.shape[0] // 2
    for e in events:
        r = next(r for r in live.tolist() if r // per == e)
        zt = z[r, :32][weighted[r]].double()
        h = 2.0 ** -8
        hs[0, e * per:(e + 1) * per, 0] = 1.0 / h
        edge = h * (1.0 - 2.0 ** -10)
        step = h * torch.arange(32, dtype=F64)
        grids[e, :64] = torch.cat([zt.min() - edge - step.flip(0),
                                   zt.max() + edge + step]).to(dtype)
    args[4], args[7] = grids, hs
    return args


K4B_CASES = ("sorted", "unsorted", "tie", "near_edge", "zero_weight",
             "non_finite_z", "non_finite_w", "non_finite_grid",
             "non_finite_d_out", "huge", "nan_h", "zero_h")


def _k4b_case(case: str, dtype, b: int = 4, s: int = 200, g: int = 250):
    """K4b's inputs as the binned path hands them (z, w, grids, h, out,
    d_out): b rows of s sorted, uniformly spaced bin centres of a histogram
    of 4096 samples (empty bins in the tails without weight), normalized
    weights, a g-point linear grid over [min - 2σ, max + 2σ], Scott's h at
    N_eff = 1000, random cotangents; changed as ``case`` says: the bins and
    the grid points shuffled ('unsorted'); the bins and grid points on a
    2^-8 lattice at h = 2^-5, so that tile corners lie at |u| = 1 exactly
    ('tie') or, the grid shifted by -2^-15, at |u| = 1 - 2^-10
    ('near_edge'); row 1 without weight; an infinite and a NaN z, w, grid
    point or d_out in rows 1 and 2; a w and a d_out of 1e307, whose
    products with u overflow ('huge'); a NaN or zero h."""
    from chimera_tpu_torch.ops.cuda.kde import kde1d_grid_plain

    rng = np.random.default_rng(8)
    z, w = np.empty((b, s)), np.empty((b, s))
    grids, h = np.empty((b, g)), np.empty(b)
    for r in range(b):
        x = rng.normal(1.0 + 0.1 * r, 0.1, 4096)
        edges = np.linspace(x.min(), x.max(), s + 1)
        z[r] = 0.5 * (edges[:-1] + edges[1:])
        w[r] = np.histogram(x, edges)[0] / x.size
        grids[r] = np.linspace(x.min() - 2 * x.std(), x.max() + 2 * x.std(), g)
        h[r] = 1.06 * x.std() * 1000 ** -0.2
    d_out = rng.normal(size=(b, g))
    if case in ("tie", "near_edge"):
        z[:] = (np.arange(s) + 40)[None] * 2.0 ** -8
        grids[:] = np.arange(g)[None] * 2.0 ** -8 - (2.0 ** -15 if case == "near_edge"
                                                     else 0.0)
        h[:] = 2.0 ** -5
    elif case == "unsorted":
        for r in range(b):
            ps, pg = rng.permutation(s), rng.permutation(g)
            z[r], w[r], grids[r], d_out[r] = z[r, ps], w[r, ps], grids[r, pg], d_out[r, pg]
    elif case == "zero_weight":
        w[1] = 0.0
    elif case == "non_finite_z":
        z[1, 30], z[1, 31], z[2, 50] = np.inf, -np.inf, np.nan
    elif case == "non_finite_w":
        w[1, 40], w[2, 60] = np.inf, np.nan
    elif case == "non_finite_grid":
        grids[1, 100], grids[2, 10] = np.nan, np.inf
    elif case == "non_finite_d_out":
        d_out[1, 100], d_out[2, 5] = np.inf, np.nan
    elif case == "huge":
        w[1, 70], d_out[2, 120] = 1e307, 1e307
    elif case == "nan_h":
        h[1] = np.nan
    elif case == "zero_h":
        h[2] = 0.0
    z, w, grids, h, d_out = (torch.tensor(a, dtype=dtype) for a in (z, w, grids, h, d_out))
    with np.errstate(all="ignore"):
        out = kde1d_grid_plain(z, w, grids, h, "epan")
    return z, w, grids, h, out, d_out


def _host_k4b(lib, args, entry="host_kde1d_adjoint_"):
    """K4b (Epanechnikov) on the host emulation: (d_z, d_w, d_grid, d_h);
    ``entry`` host_kde1d_adjoint_unpruned_ for the full sweeps."""
    z, grids = args[0], args[2]
    (b, s), g = z.shape, grids.shape[1]
    got = [torch.zeros_like(t) for t in (z, z, grids, args[3])]
    fn = getattr(lib, entry + ("f64" if z.dtype == F64 else "f32"))
    fn.restype = None
    keep = [t.contiguous() for t in args]
    fn(*[_ptr(t) for t in (*keep, *got)], b, s, g,
       *(() if "unpruned" in entry else (0,)))
    return got


K4_CASES = ("sorted", "zero_weight", "tie", "near_edge", "unsorted",
            "non_finite_z", "non_finite_w", "non_finite_grid", "nan_h",
            "zero_h", "negative_h")


def _k4_case(case: str, dtype, g: int):
    """K4's inputs (z, w, grids, h) as the binned path hands them:
    _k4b_case's rows (sorted bin centres of a histogram, the empty bins of
    its tails without weight, a g-point linear grid), changed as ``case``
    says; 'tie' and 'near_edge' put the bins on a 2^-8 lattice whose first
    _K4_TILE-bin tile ends 8 steps (h = 2^-5) below the lowest point of the
    third 32-point run: a tile corner at u = 1 exactly, or at 1 - 2^-10
    with the grid shifted by -2^-15 (a term in the support, which the
    corner test must keep); 'negative_h': row 2's h below 0."""
    z, w, grids, h = _k4b_case({"negative_h": "sorted"}.get(case, case),
                               dtype, g=g)[:4]
    if case in ("tie", "near_edge"):
        off = 2 * fused._TILE_G - fused._K4_TILE + 1 - 8
        z[:] = ((torch.arange(z.shape[1], dtype=F64) + off) * 2.0 ** -8).to(dtype)
    if case == "negative_h":
        h[2] = -h[2]
    return z, w, grids, h


def _host_k4(lib, z, w, grids, h, pruned: bool = True):
    """K4 (Epanechnikov) on the host emulation, with the pruned loop or the
    full one (host_kde1d_unpruned)."""
    (b, s), g = z.shape, grids.shape[1]
    out = torch.zeros(b, g, dtype=z.dtype)
    fn = getattr(lib, ("host_kde1d_" if pruned else "host_kde1d_unpruned_")
                 + ("f64" if z.dtype == F64 else "f32"))
    fn.restype = None
    keep = [t.contiguous() for t in (z, w, grids, h)]
    fn(*[_ptr(t) for t in (*keep, out)], b, s, g, *((0,) if pruned else ()))
    return out


@pytest.fixture(scope="module")
def k4_tile16_lib(tmp_path_factory):
    """K4's host emulation built against a copy of the kernels' sources in
    16-bin tiles (``tools/k3_variants.py`` variant ``k4_tile16``: their
    bounds a thread a tile, thread_tile_bounds over the bins with
    weight)."""
    src = tmp_path_factory.mktemp("k4_tile16_csrc")
    for f in CSRC.iterdir():
        if f.suffix in (".cuh", ".cu"):
            shutil.copy2(f, src / f.name)
    text = (src / "kde.cuh").read_text()
    old = "constexpr int kK4Tile = 32;"
    assert text.count(old) == 1
    (src / "kde.cuh").write_text(text.replace(old, "constexpr int kK4Tile = 16;"))
    return _build_host(tmp_path_factory, "fused_host", src)


K3B_PAIR_CASES = ("sorted", "unsorted", "tie", "near_edge", "non_finite_z",
                  "non_finite_c1", "non_finite_grid", "huge_u", "nan_h")


def _k3b_pair_case(case: str, dtype, n: int = 257, g: int = 250):
    """Phase B's inputs of one row: n dL-sorted samples z ~ N(1, 0.1), a
    g-point linear grid over [0.4, 1.6], random cotangents c1, 1/h = 50;
    changed as ``case`` says: the samples shuffled ('unsorted'); samples and
    grid on a 2^-8 lattice at 1/h = 2^5, tile corners at |u| = 1 exactly
    ('tie') or, the grid shifted by -2^-15, at |u| = 1 - 2^-10
    ('near_edge'); an infinite and a NaN z, c1 or grid point; 1/h so large
    that u^2 overflows ('huge_u'); a NaN 1/h."""
    gen = torch.Generator().manual_seed(12)
    z = torch.sort(1.0 + 0.1 * torch.randn(n, generator=gen, dtype=F64)).values
    grid = torch.linspace(0.4, 1.6, g, dtype=F64)
    c1 = torch.randn(g, generator=gen, dtype=F64)
    inv_h = 50.0
    if case in ("tie", "near_edge"):
        z = torch.round(z * 256.0) / 256.0
        grid = (torch.arange(g, dtype=F64) + 77.0) / 256.0 - (
            2.0 ** -15 if case == "near_edge" else 0.0)
        inv_h = 32.0
    elif case == "unsorted":
        z = z[torch.randperm(n, generator=gen)]
    elif case == "non_finite_z":
        z[5], z[9] = math.inf, math.nan
    elif case == "non_finite_c1":
        c1[20], c1[140] = math.inf, math.nan
    elif case == "non_finite_grid":
        grid[17] = math.nan
    elif case == "huge_u":
        inv_h = 1e30 if dtype == F32 else 1e200
    elif case == "nan_h":
        inv_h = math.nan
    return z.to(dtype), grid.to(dtype), c1.to(dtype), inv_h


def _host_slot_sums(lib, z, grid, c1, inv_h, prune):
    """Phase B's pair sums (adjoint.cuh, slot_pair_sums) of the samples z on
    the (grid, c1) pairs: the full loop (``prune`` False or 0), K3b's
    ballot walk (True or 1) or K3d's run walk (2); (n, 4) a0-a3."""
    out = torch.zeros(z.shape[0], 4, dtype=z.dtype)
    f64 = z.dtype == F64
    fn = getattr(lib, "host_slot_pair_sums_" + ("f64" if f64 else "f32"))
    fn.restype = None
    keep = [t.contiguous() for t in (z, grid, c1)]
    fn(_ptr(keep[0]), z.shape[0], _ptr(keep[1]), _ptr(keep[2]), grid.shape[0],
       (ctypes.c_double if f64 else ctypes.c_float)(inv_h), int(prune),
       _ptr(out))
    return out


K3B_CASES = ("sorted", "unsorted", "zero_weight", "non_finite_ct")


def _k3b_case(data, dtype, case):
    """K3b's arguments (_adjoint_case, effective grids, Epanechnikov) on
    250-point grids: the emulation data sorted by distance ('sorted'), in
    catalog order ('unsorted'), sorted with an event without weight
    ('zero_weight', its h NaN) or with an infinite and a NaN density
    cotangent ('non_finite_ct')."""
    args, kw = _adjoint_case(data if case == "unsorted" else _sorted_data(data),
                             dtype, "effective", "epan")
    args = list(args)
    kw["n_grid"] = 250
    gen = torch.Generator().manual_seed(17)
    args[7] = torch.randn(args[5].shape[0], args[2].shape[0], 250,
                          generator=gen, dtype=F64).to(dtype)
    if case == "zero_weight":
        args[3] = args[3].clone()
        args[3][2] = 0.0
    elif case == "non_finite_ct":
        args[7][0, 3, 100], args[7][1, 5, 7] = math.inf, math.nan
    return args, kw


K3D_CASES = K3B_CASES + ("near_edge",)


def _k3d_case(data, dtype, kernel, case):
    """K3d's arguments (the adjoint kernel on given bounds, logical rows,
    unit mass) on 21 logical rows of up to 600 slots (logical_s 700) drawn
    from 5 events of the emulation data: an empty row, rows of 1, of over
    128 (phase D's stash) and of 600 samples (over 512: several rounds of
    the 4-warp block's slots), one whose fillers hold the minimum z, a
    short last block of 4 rows; each row's real samples sorted by distance
    as the pixelization keeps them ('sorted'), in random order
    ('unsorted'), sorted with a row without weight ('zero_weight', its h
    NaN) or with an infinite and a NaN density cotangent
    ('non_finite_ct'); 'near_edge': sorted, with row 1's grid placed so that
    its second 32-point tile starts at u = 1 - 2^-10 of the row's first
    sample (the grid point is in the support, the tile's corner test must
    keep it).  250-point grids over each row's z range widened by half of
    it on either side (the event's range holds a pixel's samples), random
    cotangents (an empty row's lo, ub and h get none)."""
    pop = _population(dtype).update_batch(LAMBDA)
    cosmo, mass = pop.cosmo, pop.mass
    pe, n_real, dl_fill, logical_s = _logical_rows(data, F64, n_rows=21,
                                                   width=600, logical_s=700,
                                                   events=5)
    if case != "unsorted":
        for b, k in enumerate(n_real.tolist()):
            order = torch.argsort(pe[2][b, :k])
            for t in pe:
                t[b, :k] = t[b, :k][order]
    pe = [t.to(dtype) for t in pe]
    dl_fill = dl_fill.to(dtype)
    if case == "zero_weight":
        pe[3][3] = 0.0
    kw = {"n_real": n_real, "dl_fill": dl_fill, "logical_s": logical_s}
    st = fused.fused_row_stats_plain(*pe, cosmo, mass, cut_grid=0.0, **kw)
    lo, ub = st["lo"].double(), st["ub"].double()
    n, b, g = 3, len(n_real), 250
    ext = torch.stack([lo - 0.5 * (ub - lo), ub + 0.5 * (ub - lo)], dim=-1)
    if case == "near_edge":
        z0 = z_from_dgw(cosmo, pe[2][1, :1][None]).double()[:, 0]
        h = st["bandwidth"][:, 1].double()
        delta = (ext[:, 1, 1] - ext[:, 1, 0]) / (g - 1)
        ext[:, 1, 0] = z0 + h * (1.0 - 2.0 ** -10) - 32 * delta
        ext[:, 1, 1] = ext[:, 1, 0] + (g - 1) * delta
    kw.update(n_grid=g, den_scale="unit", ext_bounds=ext.to(dtype))
    series, params = fused.pack_params(cosmo, mass, n, dtype)
    gen = torch.Generator().manual_seed(29)
    ct_den = torch.randn(n, b, g, generator=gen, dtype=F64).to(dtype)
    ct_stats = torch.randn(n, b, 8, generator=gen, dtype=F64).to(dtype)
    for slot in (0, 1, 4):
        ct_stats[:, n_real == 0, slot] = 0.0
    if case == "non_finite_ct":
        ct_den[0, 5, 100], ct_den[1, 9, 7] = math.inf, math.nan
    return (*pe, None, series, params, ct_den, ct_stats, cosmo, mass,
            kernel), kw


@pytest.fixture(scope="module")
def strict_corner_libs(tmp_path_factory):
    """The host emulations of K4b, K3b, K4 and K1e built against a copy of
    the kernels' sources whose corner tests skip a tile too early: the
    adjoints' at |u| = 1 too (outside_support with >= and <=), the
    densities' at |u| >= 0.999 (contract_pruned): the mutations that the
    tie and near-edge cases must catch."""
    src = tmp_path_factory.mktemp("mutated_csrc")
    for f in CSRC.iterdir():
        if f.suffix in (".cuh", ".cu"):
            shutil.copy2(f, src / f.name)
    text = (src / "kde.cuh").read_text()
    old = "return (u_lo > T(1) && u_hi <= max_u<T>())\n         || (u_hi < T(-1)"
    assert text.count(old) == 1
    text = text.replace(old, old.replace(
        "u_lo > T(1)", "u_lo >= T(1)").replace("u_hi < T(-1)", "u_hi <= T(-1)"))
    old = "* inv_h >= T(1)\n                           || (hi - b.x) * inv_h <= T(-1)"
    assert text.count(old) == 1
    (src / "kde.cuh").write_text(text.replace(old, old.replace(
        "T(1)", "T(0.999)").replace("T(-1)", "T(-0.999)")))
    return (_build_host(tmp_path_factory, "fused_host", src),
            _build_host(tmp_path_factory, "adjoint_host", src))


def _check_fused_mode(lib, data, mode, kernel, dtype, model="PowerLawPeak"):
    """K1 in ``mode`` on the emulation (``lib``, built for ``model``)
    against ``fused_weights_kde_plain``: float64 within 1e-12 and float32
    within 1e-4 of each density row's largest value, stats likewise, on the
    rows with weight; the contract mode's r1 and r2 each within the same of
    their largest value over the rows, and exactly 0 on the dead pixel
    rows."""
    cat, z_grids, _, _ = data
    pop = _population(dtype, model).update_batch(
        {"H0": [62.0, 70.0, 81.0], **({} if model == "PowerLawPeak"
                                      else MODEL_LAMBDA[model])})
    cosmo, mass = pop.cosmo, pop.mass
    pe = [t.to(dtype) for t in (cat.m1det, cat.m2det, cat.dL, 1.0 / cat.pe_prior)]
    kw = {"kernel": kernel}
    if mode == "analysis":
        m, kw["grids"] = fused._ANALYSIS_GRID, z_grids.to(dtype)
    elif mode == "effective":
        m, kw["cut_grid"], kw["n_grid"] = fused._EFFECTIVE_GRID, 2.0, 24
    elif mode == "stats":
        m, kw["cut_grid"] = fused._STATS_ONLY, 2.0
    else:
        pe, n_real, dl_fill = _pixel_rows(cat, dtype)
        kw.update(n_real=n_real, dl_fill=dl_fill, logical_s=cat.dL.shape[1])
        if mode == "stats_logical":
            m, kw["cut_grid"] = fused._STATS_ONLY, 2.0
        elif mode == "contract":
            m, kw["den_scale"] = fused._CONTRACT, "unit"
            kw["grids"] = z_grids.to(dtype).repeat_interleave(4, dim=0)
            kw["contract"] = _contract_factors(pe[2].shape[0], 4, 3,
                                               z_grids.shape[1], dtype)
        else:
            m, kw["n_grid"], kw["den_scale"] = fused._EXTERNAL_BOUNDS, 24, "unit"
            ev = fused.fused_row_stats_plain(
                *[t.to(dtype) for t in (cat.m1det, cat.m2det, cat.dL,
                                        1.0 / cat.pe_prior)], cosmo, mass)
            kw["ext_bounds"] = torch.stack([ev["lo"], ev["ub"]], dim=-1
                                           ).repeat_interleave(4, dim=1)
    den, st = _host_fused(lib, m, *pe, cosmo, mass, **kw)
    stats_only = m == fused._STATS_ONLY
    den_p, st_p = fused.fused_weights_kde_plain(
        *pe, cosmo, mass, stats_only=stats_only, **kw)
    tol = 1e-12 if dtype == F64 else 1e-4
    live = st_p["sum_w"] > 0
    assert 0 < int(live.sum()) and (mode not in ("stats_logical", "external")
                                    or not live.all())
    for k in fused.STAT_NAMES:
        ref = st_p[k].abs().double() if k not in ("lo", "ub") \
            else st_p["ub"].abs().max().double()
        err = (st[k].double() - st_p[k].double()).abs() / ref.clamp_min(1e-300)
        assert err[live].max() <= tol, k
    if m == fused._CONTRACT:
        assert torch.all(den[~live] == 0) and torch.all(den_p[~live] == 0)
        r_max = den_p.double().abs().amax(dim=1, keepdim=True)
        assert ((den.double() - den_p.double()).abs() / r_max).max() <= tol
    elif not stats_only:
        # a row whose 24 grid points all miss its samples' support is 0
        row_max = den_p.abs().amax(dim=-1).double().clamp_min(1e-300)
        err = (den.double() - den_p.double()).abs().amax(dim=-1) / row_max
        assert err[live].max() <= tol
