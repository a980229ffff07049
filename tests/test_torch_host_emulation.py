"""The arithmetic of the adjoint CUDA kernel K3 on the CPU.

A CUDA kernel has no interpret mode, but its arithmetic lives in device
functions (``chimera_tpu_torch/csrc/adjoint.cuh`` and ``population.cuh``)
that a C++ compiler can build for the host once ``__device__`` and friends
are defined away (``tests/host_emulation/cuda_runtime.h``).
``tests/host_emulation/adjoint_host.cpp`` runs them serially per (λ, event)
in the kernel's phases; here that emulation is held against
``fused_weights_kde_adjoint_plain`` (autograd through the plain version),
float64 and float32, and put behind the likelihood as its backward to show
what the float32 'kernel' engine does to d log L / dλ.  What the emulation
cannot show: the block sums, the launch and the shared-memory layout
(``tests/test_torch_cuda.py``, on the card)."""

import ctypes
import dataclasses
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
                                      PowerLawPeak, compute_z_grids)
from chimera_tpu_torch.ops.cuda import fused

HERE = Path(__file__).resolve().parent / "host_emulation"
CSRC = Path(fused.__file__).resolve().parents[2] / "csrc"
F64, F32 = torch.float64, torch.float32
LAMBDA = {"H0": [62.0, 70.0, 81.0], "Om0": [0.2, 0.25, 0.33],
          "mu_g": [30.0, 34.0, 36.0]}
# float64 only: m_low = 8 puts many of the scaled masses at the window's
# foot, where the CDF is ~1e-6 of its series' terms and a float32 sum of it
# is noise (tests/test_torch_models.py)
WINDOW_LAMBDA = {"m_low": [4.0, 5.1, 8.0], "delta_m": [3.0, 4.8, 6.0]}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host emulation")
    so = tmp_path_factory.mktemp("host_emulation") / "libadjoint_host.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-Wno-unknown-pragmas",
         f"-I{HERE}", f"-I{CSRC}", "-o", str(so), str(HERE / "adjoint_host.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(so))


def _population(dtype):
    return Population.create(
        FLRW.create(H0=70.0, Om0=0.25, device="cpu", dtype=dtype),
        PowerLawPeak.create(device="cpu", dtype=dtype),
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


def _host_adjoint(lib, m1det, m2det, dl, inv_pe_prior, grids, series, params,
                  ct_den, ct_stats, cosmo, mass, kernel="epan", bw_method=None):
    """``fused_weights_kde_adjoint``'s signature on the host emulation."""
    d_series, d_params = torch.zeros_like(series), torch.zeros_like(params)
    fn = getattr(lib, "host_fused_kde_adjoint_"
                 + ("f64" if dl.dtype == F64 else "f32"))
    fn.restype = None
    tensors = [t.contiguous() for t in (m1det, m2det, dl, inv_pe_prior, grids,
                                        series, params, ct_den, ct_stats)]
    bw_mode, bw_value = fused._bw_code(bw_method)
    e, s = dl.shape
    fn(*[ctypes.c_void_p(t.data_ptr()) for t in (*tensors, d_series, d_params)],
       series.shape[0], e, s, grids.shape[1], cosmo.cheb_deg, mass.window_deg,
       0 if kernel == "epan" else 1, bw_mode, ctypes.c_double(bw_value))
    return d_series, d_params


def _row_rel(got, expect):
    scale = expect.double().abs().amax(dim=1, keepdim=True).clamp_min(1e-300)
    return float(((got.double() - expect.double()).abs() / scale).max())


@pytest.mark.parametrize("dtype,tol", [(F64, 1e-7), (F32, 1e-3)])
@pytest.mark.parametrize("kernel,bw_method", [("epan", None), ("gauss", None),
                                              ("epan", "silverman"),
                                              ("gauss", 0.3)])
def test_device_functions_match_plain_adjoint(host_lib, data, dtype, tol, kernel,
                                              bw_method):
    """Random cotangents for den and every stat; H0, Om0, mu_g varied and
    in float64 the window's m_low and delta_m too: each gradient row within
    tol of its largest entry, the window coefficients' and the distance
    bounds' gradients among them (float64 reads ~1e-14 but for the window
    row at m_low = 8, 6e-8: its terms cancel to 1e-6 of their size)."""
    hl = _likelihood(data, dtype, kernel, bw_method)
    pop_b = hl.population.update_batch(
        {**LAMBDA, **(WINDOW_LAMBDA if dtype == F64 else {})})
    series, params = fused.pack_params(pop_b.cosmo, pop_b.mass, 3, dtype)
    gen = torch.Generator().manual_seed(1)
    e, g = hl.z_grids.shape
    ct_den = torch.randn(3, e, g, generator=gen, dtype=F64).to(dtype)
    ct_stats = torch.randn(3, e, 8, generator=gen, dtype=F64).to(dtype)
    args = (hl.m1det, hl.m2det, hl.dL, hl.inv_pe_prior, hl.z_grids, series,
            params, ct_den, ct_stats, pop_b.cosmo, pop_b.mass, kernel, bw_method)
    expect = fused.fused_weights_kde_adjoint_plain(*args)
    got = _host_adjoint(host_lib, *args)
    cd = pop_b.cosmo.cheb_deg
    assert expect[0][:, cd + 2:].abs().max() > 0      # the window is exercised
    assert expect[0][:, cd:cd + 2].abs().min() > 0    # and both distance bounds
    assert _row_rel(got[0], expect[0]) <= tol
    assert _row_rel(got[1], expect[1]) <= tol


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
            return (*grads, None, None, None, None) + (None,) * 5

    def fused_weights_kde(m1det, m2det, dl, inv_pe_prior, cosmo, mass, grids,
                          kernel="epan", bw_method=None):
        n = max(cosmo.L, mass.L)
        series, params = fused.pack_params(cosmo, mass, n, dl.dtype)
        den, stats = Emulated.apply(series, params, cosmo, mass, kernel,
                                    bw_method, m1det, m2det, dl, inv_pe_prior,
                                    grids)
        return den, fused._stats_dict(stats)

    return fused_weights_kde


@pytest.mark.parametrize("kernel,tol32", [("gauss", 1e-4), ("epan", 1e-2)])
def test_emulated_kernel_engine_gradient(host_lib, data, monkeypatch, kernel,
                                         tol32):
    """d log L / d(H0, Om0, mu_g) with K3's arithmetic as the backward.
    Float64: equal to autograd through the plain version.  Float32 against
    float64: the Gaussian kernel shows the arithmetic alone (~1e-5 of each
    parameter's largest slope); the Epanechnikov slope is discontinuous at
    the support's edge, where float32 rounding decides a pair's side, and
    moves by up to ~1e-3."""
    rng = np.random.default_rng(8)
    x0 = np.array([70.0, 0.25, 34.0]) + rng.normal(size=(6, 3)) * [3.0, 0.02, 0.5]

    def grad(dtype, emulate):
        hl = _likelihood(data, dtype, kernel)
        if emulate:
            monkeypatch.setattr(likelihood_module, "fused_weights_kde",
                                _emulated_kernel_engine(host_lib))
        x = torch.tensor(x0, dtype=dtype, requires_grad=True)
        ll = hl.log_like_batch({"H0": x[:, 0], "Om0": x[:, 1], "mu_g": x[:, 2]})
        out = torch.autograd.grad(ll.sum(), x)[0].double()
        monkeypatch.undo()
        return out

    expect = grad(F64, False)
    scale = expect.abs().amax(dim=0)
    assert torch.all(torch.isfinite(expect))
    assert ((grad(F64, True) - expect).abs() / scale).max() <= 1e-11
    assert ((grad(F32, True) - expect).abs() / scale).max() <= tol32
