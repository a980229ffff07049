"""The host emulation of the CUDA kernels (``tests/host_harness.py``): K1, the
fused weights+KDE pass, in its modes against the plain version, and the
pruned pair loops of K1a, K1b and K1e and the contraction bit for bit
against the full loops; K1c's warp a row replaying the block."""

import pytest
import torch

from chimera_tpu_torch.models.cosmology import z_from_dgw
from chimera_tpu_torch.ops.cuda import fused

from host_harness import (CONTRACT_CASES, F32, F64, K1E_CASES, LAMBDA,
                          _check_fused_mode, _check_pruned_k1, _contract_case,
                          _host_contract, _host_fused, _k1e_case,
                          _logical_rows, _population, _same_bits, _tally, data,
                          fused_host_lib)


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("mode,kernel", [
    ("analysis", "epan"), ("analysis", "gauss"), ("effective", "epan"),
    ("effective", "gauss"), ("stats", "epan"), ("stats_logical", "epan"),
    ("external", "epan"), ("external", "gauss"), ("contract", "epan"),
    ("contract", "gauss")])
def test_emulated_fused_modes_match_plain(fused_host_lib, data, mode, kernel,
                                          dtype):
    """Float64 within 1e-12 and float32 within 1e-4 of each density row's
    largest value (the spectral modes sum the Chebyshev series in float32,
    the plain version in float64), stats likewise, on the rows with
    weight; the contract mode's r1 and r2 each within the same of their
    largest value over the rows, and exactly 0 on the dead pixel rows."""
    _check_fused_mode(fused_host_lib, data, mode, kernel, dtype)


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("case", CONTRACT_CASES)
def test_pruned_contract_keeps_the_bits(fused_host_lib, case, dtype):
    """The pruned pair loop (kde.cuh, tile_bounds and contract_pruned, with
    the card's 32 x 32 tiles) gives the bits of the unpruned one
    (contract) on every case of _contract_case, float64 and float32; on
    the dL-sorted row it skips more than half of the tiles, on a row
    without weight all of them and at a NaN bandwidth none."""
    z, w, grid, inv_h = _contract_case(case, dtype)
    args = (z[None], w[None], grid[None], inv_h[None])
    expect = _host_contract(fused_host_lib, *args, prune=False)
    _tally(fused_host_lib)
    got = _host_contract(fused_host_lib, *args, prune=True)
    tested, skipped = _tally(fused_host_lib)
    assert _same_bits(got, expect)
    assert tested == 7 * 8  # 7 runs of 32 grid points x 8 tiles of 32 samples
    if case in ("sorted", "tie", "rounds_to_one"):
        assert expect.abs().max() > 0 and skipped > tested // 2
    if case == "zero_weight":
        assert skipped == tested and torch.all(got == 0)
    if case == "nan_h":
        assert skipped == 0
    if case == "tie":  # u = +-1 exactly at some pairs
        u = (grid[:, None] - z[None]) * inv_h
        assert (u == 1).any() and (u == -1).any()


@pytest.mark.parametrize("dtype", [F64, F32])
def test_pruned_k1a_keeps_the_bits(fused_host_lib, data, dtype):
    """K1a (the analysis-grid mode, Epanechnikov) with the pruned loop gives
    densities and stats of the same bits as the unpruned mode (contract),
    float64 and float32, on the emulation data's rows sorted by distance
    as ``create`` sorts them (some tiles skipped) and in the catalog's
    order."""
    _check_pruned_k1(fused_host_lib, data, dtype, fused._ANALYSIS_GRID,
                     {"grids": data[1].to(dtype)}, min_skip=0.0)


@pytest.mark.parametrize("dtype", [F64, F32])
def test_pruned_k1b_keeps_the_bits(fused_host_lib, data, dtype):
    """K1b (the effective-grid mode, Epanechnikov: the row's linear grid
    over [z_min - 2 sigma, z_max + 2 sigma]) with the pruned loop gives
    densities and stats of the same bits as the unpruned mode (contract),
    float64 and float32, on 250-point grids of the emulation data's rows
    sorted by distance (more than half of the tiles skipped) and in the
    catalog's order."""
    _check_pruned_k1(fused_host_lib, data, dtype, fused._EFFECTIVE_GRID,
                     {"n_grid": 250, "cut_grid": 2.0}, min_skip=0.5)


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("case", K1E_CASES)
def test_pruned_k1e_keeps_the_bits(fused_host_lib, data, case, dtype):
    """K1e (the contract mode, Epanechnikov) with the pruned loop, folding
    each density into r1 and r2 as it is stored, gives r and the stats of
    the same bits as the full loop (contract_epilogue_tiles,
    host_fused_kde_unpruned), float64 and float32, on the cases of
    _k1e_case: more than a quarter of the tiles skipped on the sorted rows
    (the emulation data's grids are narrow), r exactly 0 on the empty row
    and on the row below sqrt(tiny)."""
    args, kw = _k1e_case(data, dtype, case)
    _tally(fused_host_lib)
    expect, st_u = _host_fused(fused_host_lib, fused._CONTRACT, *args, **kw,
                               entry="host_fused_kde_unpruned_")
    assert _tally(fused_host_lib) == (0, 0)
    got, st = _host_fused(fused_host_lib, fused._CONTRACT, *args, **kw)
    tested, skipped = _tally(fused_host_lib)
    assert _same_bits(got, expect)
    for k in fused.STAT_NAMES:
        assert _same_bits(st[k], st_u[k]), k
    assert tested > 0 and (case == "unsorted" or skipped > tested // 4)
    assert torch.all(got[:, 0] == 0) and torch.all(got[:, 3] == 0)
    assert torch.all(st["sum_w"][:, 3] > 0) and got.abs().max() > 0


@pytest.mark.parametrize("dtype", [F64, F32])
def test_logical_stats_warp_replays_the_block(fused_host_lib, data, dtype):
    """K1c on logical rows a warp a row (kde.cuh, logical_row_stats: lane j
    keeps the partials of the block's ranks j + 32 k and the warp folds them
    as the block's warps would), emulated lane by lane, gives stats of the
    same bits as the block-a-row layout, its 128 ranks and 4 warps emulated
    one by one (host_logical_stats_block), float64 and float32: rows of
    unequal real counts, an empty row, one of 200 real samples (over 128),
    one whose fillers hold the minimum z, 37 rows (a short last block of
    4)."""
    pop = _population(dtype).update_batch(LAMBDA)
    pe, n_real, dl_fill, logical_s = _logical_rows(data, dtype)
    kw = {"n_real": n_real, "dl_fill": dl_fill, "logical_s": logical_s,
          "cut_grid": 2.0, "raw": True}
    _, got = _host_fused(fused_host_lib, fused._STATS_ONLY, *pe, pop.cosmo,
                         pop.mass, **kw)
    _, expect = _host_fused(fused_host_lib, fused._STATS_ONLY, *pe, pop.cosmo,
                            pop.mass, entry="host_logical_stats_block_", **kw)
    assert _same_bits(got, expect)
    assert torch.all(got[:, n_real > 0, 5] > 0) and torch.all(got[:, 0, 5] == 0)
    zf = z_from_dgw(pop.cosmo, dl_fill[None])
    z9 = z_from_dgw(pop.cosmo, pe[2][None, 9, :n_real[9]])
    assert torch.all(zf[:, 9] < z9.amin(-1))  # row 9's fillers hold the minimum
    assert int(n_real.max()) > 128 and len(n_real) % 4 == 1
