"""The host emulation of the CUDA kernels (``tests/host_harness.py``): K4, the
batched KDE, and K4b, its adjoint, against the plain versions, their pruned
loops and K4's 16-bin variant bit for bit against the full loops."""

import numpy as np
import pytest
import torch

from chimera_tpu_torch.ops.cuda import fused

from host_harness import (F32, F64, K4B_CASES, K4_CASES, _host_k4, _host_k4b,
                          _k4_case, _k4b_case, _kde_rows, _ptr, _same_bits,
                          _tally, fused_host_lib, k4_tile16_lib)


@pytest.mark.parametrize("dtype,tol", [(F64, 1e-12), (F32, 1e-6)])
@pytest.mark.parametrize("kernel", ["epan", "gauss"])
def test_emulated_kde1d_adjoint_matches_plain(fused_host_lib, kernel, dtype,
                                              tol):
    """K4b's arithmetic against ``kde1d_grid_adjoint_plain``: d_z, d_w,
    d_grids and d_h within tol of each row's largest entry (d_h of the
    largest |d_h|), on 250- and 130-point grids; in float32 against the
    float64 plain version on the same inputs (the kernel computes in
    double, and rounds its outputs to float32 once).  The row of zero
    weights gets finite cotangents, zero but for d_w; the row with ties at
    |u| = 1 takes all of the Epanechnikov slope there (``kde1d_core``'s
    select form), as the plain version does."""
    from chimera_tpu_torch.ops.cuda.kde import (kde1d_grid_adjoint_plain,
                                                kde1d_grid_plain)

    for g in (250, 130):
        z, w, grids, h = _kde_rows(dtype, g=g)
        out = kde1d_grid_plain(z, w, grids, h, kernel)
        d_out = torch.tensor(np.random.default_rng(g).normal(size=out.shape),
                             dtype=dtype)
        got = [torch.zeros_like(t) for t in (z, w, grids, h)]
        fn = getattr(fused_host_lib, "host_kde1d_adjoint_"
                     + ("f64" if dtype == F64 else "f32"))
        fn.restype = None
        fn(*[_ptr(t) for t in (z, w, grids, h, out, d_out, *got)], 9, 200, g,
           0 if kernel == "epan" else 1)
        expect = kde1d_grid_adjoint_plain(
            *(t.double() for t in (z, w, grids, h, out, d_out)), kernel)
        for k, e in zip(got, expect):
            assert torch.all(torch.isfinite(k))
            if k.dim() == 1:
                k, e = k[None], e[None]
            scale = e.double().abs().amax(dim=-1, keepdim=True).clamp_min(1e-300)
            assert ((k.double() - e.double()).abs() / scale).max() <= tol
        assert all(torch.all(t[1] == 0) for t in (got[0], got[2], got[3]))


@pytest.mark.parametrize("dtype,tol", [(F64, 1e-12), (F32, 1e-5)])
@pytest.mark.parametrize("kernel", ["epan", "gauss"])
def test_emulated_kde1d_matches_plain(fused_host_lib, kernel, dtype, tol):
    """K4's arithmetic against ``kde1d_grid_plain`` on 9 rows of 200 bin
    centres, 250-point grids (more than two thread tiles of grid points:
    the four-a-thread branch) and 130-point ones (the two-a-thread one)."""
    from chimera_tpu_torch.ops.cuda.kde import kde1d_grid_plain

    rng = np.random.default_rng(4)
    for g in (250, 130):
        z = torch.tensor(rng.normal(1.0, 0.2, (9, 200)), dtype=dtype)
        w = torch.tensor(rng.uniform(size=(9, 200)), dtype=dtype)
        w = w / w.sum(dim=1, keepdim=True)
        grids = torch.tensor(np.linspace(0.3, 1.8, g)[None] * rng.uniform(
            0.8, 1.2, (9, 1)), dtype=dtype)
        h = torch.tensor(rng.uniform(0.02, 0.1, 9), dtype=dtype)
        out = torch.zeros((9, g), dtype=dtype)
        fn = getattr(fused_host_lib, "host_kde1d_" + ("f64" if dtype == F64 else "f32"))
        fn.restype = None
        fn(*[_ptr(t) for t in (z, w, grids, h, out)], 9, 200, g,
           0 if kernel == "epan" else 1)
        expect = kde1d_grid_plain(z, w, grids, h, kernel)
        err = (out - expect).abs().amax(dim=1) / expect.abs().amax(dim=1)
        assert err.max() <= tol


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("case", K4B_CASES)
def test_pruned_kde1d_adjoint_keeps_the_bits(fused_host_lib, case, dtype):
    """K4b with both sweeps pruned (kde.cuh, kde_row_adjoint: walk_tiles
    over kK4bTile-entry tiles, outside_support) gives d_z, d_w, d_grid and
    d_h of the same bits as the full sweeps (host_kde1d_adjoint_unpruned),
    float64 and float32, on every case of _k4b_case; on the sorted rows
    more than half of the tiles are skipped, and tiles are skipped at the
    ties."""
    args = _k4b_case(case, dtype)
    _tally(fused_host_lib)  # what earlier emulations left
    expect = _host_k4b(fused_host_lib, args, "host_kde1d_adjoint_unpruned_")
    assert _tally(fused_host_lib) == (0, 0)
    got = _host_k4b(fused_host_lib, args)
    tested, skipped = _tally(fused_host_lib)
    for g, e in zip(got, expect):
        assert _same_bits(g, e)
    assert tested > 0 and expect[1].abs().nan_to_num().amax() > 0
    if case in ("sorted", "tie", "near_edge"):
        assert skipped > tested // 2 and all(torch.isfinite(t).all() for t in got)
    if case == "tie":  # u = +-1 exactly at some pairs
        u = (args[2][0, :, None].double() - args[0][0, None].double()) / args[3][0]
        assert (u == 1).any() and (u == -1).any()


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("g", [250, 500])
@pytest.mark.parametrize("case", K4_CASES)
def test_pruned_k4_keeps_the_bits(fused_host_lib, case, g, dtype):
    """K4 with the pruned loop (kde.cuh, kde_row: tile_bounds over the bins
    with weight and contract_pruned, the card's tile widths) gives densities
    of the same bits as the full loop (contract, host_kde1d_unpruned),
    float64 and float32, on every case of _k4_case, 200 bins (not a
    multiple of a tile) on 250- and 500-point grids; on the sorted rows
    more than half of the tiles are skipped, on a row without weight all
    of them (its densities +0), at a NaN or negative h none."""
    z, w, grids, h = _k4_case(case, dtype, g)
    _tally(fused_host_lib)
    expect = _host_k4(fused_host_lib, z, w, grids, h, pruned=False)
    assert _tally(fused_host_lib) == (0, 0)
    got = _host_k4(fused_host_lib, z, w, grids, h)
    tested, skipped = _tally(fused_host_lib)
    assert _same_bits(got, expect) and tested > 0
    assert expect.abs().nan_to_num().amax() > 0
    if case in ("sorted", "tie", "near_edge"):
        assert skipped > tested // 2 and torch.isfinite(got).all()
    if case == "tie":  # a tile corner at u = 1 exactly
        u = (grids[0, 2 * fused._TILE_G] - z[0, fused._K4_TILE - 1]) / h[0]
        assert u == 1
    one = {"zero_weight": 1, "nan_h": 1, "negative_h": 2}.get(case)
    if one is not None:  # that row alone
        got1 = _host_k4(fused_host_lib, *(t[one:one + 1] for t in (z, w, grids, h)))
        tested, skipped = _tally(fused_host_lib)
        assert skipped == (tested if case == "zero_weight" else 0)
        if case == "zero_weight":
            assert _same_bits(got1, torch.zeros_like(got1))


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("case", ["sorted", "zero_weight", "near_edge",
                                  "unsorted", "non_finite_w"])
def test_k4_tile16_variant_keeps_the_bits(k4_tile16_lib, case, dtype):
    """K4 in 16-bin tiles (the timing variant of the kernel's 32) gives the
    densities of the full loop too, skipping more than half of its tiles
    on the sorted rows."""
    z, w, grids, h = _k4_case(case, dtype, 250)
    expect = _host_k4(k4_tile16_lib, z, w, grids, h, pruned=False)
    _tally(k4_tile16_lib)
    got = _host_k4(k4_tile16_lib, z, w, grids, h)
    tested, skipped = _tally(k4_tile16_lib)
    assert _same_bits(got, expect) and tested > 0
    if case in ("sorted", "near_edge"):
        assert skipped > tested // 2
