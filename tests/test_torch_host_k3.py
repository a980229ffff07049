"""The host emulation of the CUDA kernels (``tests/host_harness.py``): K3, the
fused pass's adjoint, in every mode: the device functions against the plain
adjoint, the float32 kernel engine's gradient, the mass model's reverse
sweep against its dual numbers, the warp's projections, the prologue's
scratch layout, K3c's several rows a block, the pruned phase B of K3b and
its slot pair sums."""

import ctypes

import numpy as np
import pytest
import torch

import chimera_tpu_torch.likelihood as likelihood_module
from chimera_tpu_torch.models.cosmology import z_from_dgw
from chimera_tpu_torch.ops.cuda import fused

from host_harness import (F32, F64, K3B_CASES, K3B_PAIR_CASES, LAMBDA,
                          WINDOW_LAMBDA, _adjoint_case,
                          _emulated_kernel_engine, _host_adjoint,
                          _host_slot_sums, _k3b_case, _k3b_pair_case,
                          _likelihood, _logical_rows, _mass_points,
                          _population, _row_rel, _same_bits, _tally, data,
                          host_lib)


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


@pytest.mark.parametrize("dtype,tol", [(F64, 1e-12), (F32, 1e-3)])
@pytest.mark.parametrize("mode,kernel", [
    ("effective", "epan"), ("effective", "gauss"), ("stats", "epan"),
    ("stats_logical", "epan"), ("external", "epan"), ("external", "gauss")])
def test_emulated_adjoint_modes_match_plain(host_lib, data, mode, kernel, dtype,
                                            tol):
    """K3 in the modes of K1b (effective grids: the chains of lo and ub
    into the z range and σ), K1c (stats only, of plain rows and of the
    logical per-pixel rows with a dead pixel: the fillers' zf, which ties
    with the z minimum of the pixel holding the event's nearest sample) and
    K1d (external bounds, logical rows, unit mass: d_ext): each gradient row
    within tol of its largest entry."""
    args, kw = _adjoint_case(data, dtype, mode, kernel)
    expect = fused.fused_weights_kde_adjoint_plain(*args, **kw)
    got = _host_adjoint(host_lib, *args, **kw)
    assert (got[2] is None) == (expect[2] is None) == (mode != "external")
    for g, e in zip(got, expect):
        if g is None:
            continue
        assert e.abs().max() > 0
        assert _row_rel(g.reshape(-1, g.shape[-1]), e.reshape(-1, e.shape[-1])) <= tol


def test_mass_vjp_matches_dual(host_lib):
    """The hand-written reverse sweep of the mass model (the cotangents of
    the 12 scalars through the prologue's Jacobian of the derived fields,
    of z and of the window series' value) against the dual numbers it
    replaced, float64, within 1e-12 of each point's largest entry, at
    points that reach every branch and clip tie."""
    mass = _population(F64).mass
    rng = np.random.default_rng(17)
    scalars, m1, m2, z = _mass_points(mass, rng)
    n = len(m1)
    gw = rng.normal(size=n)
    window = mass.cheb_cdf_window.double().contiguous()
    arrays = [np.ascontiguousarray(a, dtype=np.float64) for a in
              (scalars, m1, m2, z, gw)]
    rev, dual, tw = np.zeros((n, 14)), np.zeros((n, 14)), np.zeros((n, 2))
    fn = host_lib.host_mass_vjp
    fn.restype = None
    fn(*[a.ctypes.data_as(ctypes.c_void_p) for a in arrays],
       ctypes.c_void_p(window.data_ptr()), window.numel(), n,
       *[a.ctypes.data_as(ctypes.c_void_p) for a in (rev, dual, tw)])
    assert np.all(np.isfinite(rev)) and np.all(np.isfinite(dual))
    p = tw[:, 1]
    in_window = tw[:, 0] != 0.0
    assert in_window.sum() > 10 and (~in_window & (p > 0)).sum() > 10
    assert (p == 0).sum() > 3                        # below m_low, zeroed p21
    scale = np.maximum(np.abs(dual).max(axis=1, keepdims=True), 1e-300)
    assert (np.abs(rev - dual) / scale).max() <= 1e-12
    assert np.all(np.abs(dual[:, :12]).max(axis=0) > 0)  # each scalar's slope
    assert (np.abs(dual[:, 12]) > 0).sum() > 30      # z's slope is exercised
    assert (np.abs(dual[:, 13]) > 0).sum() > 10      # and the window's value


@pytest.mark.parametrize("deg", [64, 48, 33, 1])
def test_warp_projection_matches_cheb_project(host_lib, deg):
    """The projections sum_s a_s T_k(t_s) of a warp of 32 lanes, emulated
    lane by lane in a fixed order (each lane's chunk of 32 coefficients in
    registers, the five reduce-scatter stages, lane j keeping k = j and
    j + 32), against cheb_project in a serial loop: float64 within 1e-12 of
    the largest coefficient."""
    rng = np.random.default_rng(deg)
    n = 101
    t = np.ascontiguousarray(rng.uniform(-1.0, 1.0, n))
    a = np.ascontiguousarray(rng.normal(size=n))
    warp, serial = np.zeros(deg), np.zeros(deg)
    fn = host_lib.host_warp_project
    fn.restype = None
    fn(t.ctypes.data_as(ctypes.c_void_p), a.ctypes.data_as(ctypes.c_void_p),
       n, deg, warp.ctypes.data_as(ctypes.c_void_p),
       serial.ctypes.data_as(ctypes.c_void_p))
    assert np.abs(serial).max() > 0
    assert np.abs(warp - serial).max() <= 1e-12 * np.abs(serial).max()


@pytest.mark.parametrize("dtype,sum_size", [(F32, 4), (F32, 8), (F64, 8)])
def test_scratch_layout_matches_the_kernels(host_lib, dtype, sum_size):
    """The wrappers' sizes of the adjoints' prologue record and ``partials``
    scratch (``fused.smem_bytes`` with ``_RECORD_EXTRA``,
    ``fused.adjoint_scratch``, which K3 and K2b allocate) against the
    kernels' own layout (record_bytes, records_offset in csrc/adjoint.cuh),
    in each working dtype and summation type, at series lengths that do and
    do not fill 16 bytes: a smaller scratch would let the prologue write
    past its end on the card."""
    fn = host_lib.host_adjoint_scratch
    fn.restype = ctypes.c_longlong
    for n, rows_, cd, wd in [(3, 37, 13, 48), (1, 1, 64, 64), (16, 5, 32, 47)]:
        series = torch.zeros(n, cd + 2 + wd, dtype=F64)
        params = torch.zeros(n, 12, dtype=dtype)
        record = ctypes.c_longlong()
        doubles = fn(torch.finfo(dtype).bits // 8, sum_size, n, rows_, cd, wd,
                     ctypes.byref(record))
        mass = _population(dtype).mass
        assert fused.smem_bytes(series, sum_size, params,
                                fused._RECORD_EXTRA["PowerLawPeak"]) == record.value
        assert fused.adjoint_scratch(n, rows_, series, sum_size, params,
                                     mass).numel() == doubles


@pytest.mark.parametrize("dtype,tol", [(F64, 1e-12), (F32, 1e-3)])
def test_emulated_stats_rows_blocks(host_lib, data, dtype, tol):
    """K3c on logical rows as the kernel runs them, several rows a block (a
    warp a row, 4 rows a block, the block's gradients summed once, phase D
    128 samples at a time): rows of unequal real counts, an empty row, a
    full one of 200, a row whose fillers hold the minimum z (its lo
    cotangent goes to zf) and a short last block, against the plain
    version, each gradient row within tol of its largest entry."""
    pop = _population(dtype).update_batch(LAMBDA)
    pe, n_real, dl_fill, logical_s = _logical_rows(data, dtype)
    series, params = fused.pack_params(pop.cosmo, pop.mass, 3, dtype)
    gen = torch.Generator().manual_seed(4)
    ct_stats = torch.randn(3, len(n_real), 8, generator=gen, dtype=F64).to(dtype)
    ct_stats[:, 0, :] = 0.0  # the empty row: dead, its stats are noise
    kw = {"n_real": n_real, "dl_fill": dl_fill, "logical_s": logical_s,
          "cut_grid": 2.0, "stats_only": True}
    args = (*pe, None, series, params, None, ct_stats, pop.cosmo, pop.mass,
            "epan")
    zf = z_from_dgw(pop.cosmo, dl_fill[None])
    z9 = z_from_dgw(pop.cosmo, pe[2][None, 9, :n_real[9]])
    assert torch.all(zf[:, 9] < z9.amin(-1))  # row 9's fillers hold the minimum
    expect = fused.fused_weights_kde_adjoint_plain(*args, **kw)
    got = _host_adjoint(host_lib, *args, **kw)
    for g, e in zip(got[:2], expect[:2]):
        assert e.abs().max() > 0
        assert _row_rel(g, e) <= tol


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("case", K3B_PAIR_CASES)
def test_pruned_slot_pair_sums_keep_the_bits(host_lib, case, dtype):
    """K3b's phase B pruned (slot_pair_sums: tiles of kGridTile grid points,
    outside_support) gives each sample's four sums of the same bits as the
    full loop, float64 and float32, on every case of _k3b_pair_case (NaN
    where NaN); on the sorted row more than half of the tiles are
    skipped."""
    args = _k3b_pair_case(case, dtype)
    _tally(host_lib)
    expect = _host_slot_sums(host_lib, *args, prune=False)
    assert _tally(host_lib) == (0, 0)
    got = _host_slot_sums(host_lib, *args, prune=True)
    tested, skipped = _tally(host_lib)
    assert _same_bits(got, expect) and tested > 0
    if case in ("sorted", "tie", "near_edge"):
        assert skipped > tested // 2 and torch.all(torch.isfinite(got))
        assert expect.abs().amax() > 0
    if case == "tie":
        u = (args[1][:, None].double() - args[0][None].double()) * args[3]
        assert (u == 1).any() and (u == -1).any()
    if case in ("huge_u", "nan_h"):
        assert skipped == 0


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("case", K3B_PAIR_CASES)
def test_run_walk_slot_pair_sums_keep_the_bits(host_lib, case, dtype):
    """K3d's phase B walk (slot_pair_sums, kRunWalk: each slot's run of
    kGridTile-point tiles between the first and the last that the corner
    test does not prove outside, found from both ends of the grid) gives
    each sample's four sums of the same bits as the full loop, float64 and
    float32, on every case of _k3b_pair_case (NaN where NaN); on the sorted,
    the shuffled and the lattice rows more than half of the tiles are
    skipped, none where u^2 overflows or 1/h is NaN."""
    args = _k3b_pair_case(case, dtype)
    expect = _host_slot_sums(host_lib, *args, prune=0)
    _tally(host_lib)
    got = _host_slot_sums(host_lib, *args, prune=2)
    tested, skipped = _tally(host_lib)
    assert _same_bits(got, expect) and tested > 0
    if case in ("sorted", "tie", "near_edge", "unsorted"):
        assert skipped > tested // 2 and torch.all(torch.isfinite(got))
        assert expect.abs().amax() > 0
    if case in ("huge_u", "nan_h"):
        assert skipped == 0


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("case", K3B_CASES)
def test_pruned_k3b_keeps_the_bits(host_lib, data, case, dtype):
    """K3b (the adjoint kernel on effective grids, Epanechnikov) with phase
    B pruned gives d_series and d_params of the same bits as phase B's full
    loop (host_fused_kde_adjoint_unpruned), float64 and float32, on the
    cases of _k3b_case; on the sorted rows more than half of the tiles are
    skipped."""
    args, kw = _k3b_case(data, dtype, case)
    _tally(host_lib)
    expect = _host_adjoint(host_lib, *args, **kw,
                           entry="host_fused_kde_adjoint_unpruned_")
    assert _tally(host_lib) == (0, 0)
    got = _host_adjoint(host_lib, *args, **kw)
    tested, skipped = _tally(host_lib)
    assert tested > 0
    for g, e in zip(got[:2], expect[:2]):
        assert _same_bits(g, e)
    if case == "sorted":
        assert skipped > tested // 2
    if case in ("sorted", "unsorted"):
        assert all(torch.isfinite(g).all() for g in got[:2])
