"""The host emulation of the CUDA kernels (``tests/host_harness.py``): K1d's
pruned pair loop, a warp a row and in the 4-warp block, bit for bit against
the full loop."""

import pytest
import torch

from chimera_tpu_torch.ops.cuda import fused

from host_harness import (F32, F64, K1D_CASES, _host_fused, _k1d_case,
                          _same_bits, _tally, data, fused_host_lib)


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("layout", ["warp", "block"])
@pytest.mark.parametrize("case", K1D_CASES)
def test_pruned_k1d_keeps_the_bits(fused_host_lib, data, case, layout, dtype):
    """K1d (given bounds on logical rows, Epanechnikov) with the pruned loop
    on its rows' linear grids, a warp a row (logical_kde_kernel: the stats
    replayed lane by lane) or a block a row (fused_row, the variant
    k1d_block), gives densities and stats of the same bits as the full loop
    (contract, host_fused_kde_unpruned), float64 and float32, on the cases
    of _k1d_case: NaN densities on the empty rows (their h is NaN), finite
    ones elsewhere, and on the sorted rows more than a quarter of the tiles
    skipped."""
    args, kw = _k1d_case(data, dtype, case)
    _tally(fused_host_lib)
    expect, st_u = _host_fused(fused_host_lib, fused._EXTERNAL_BOUNDS, *args,
                               **kw, entry="host_fused_kde_unpruned_")
    assert _tally(fused_host_lib) == (0, 0)
    got, st = _host_fused(fused_host_lib, fused._EXTERNAL_BOUNDS, *args, **kw,
                          entry="host_fused_kde_" if layout == "warp"
                          else "host_logical_stats_block_")
    tested, skipped = _tally(fused_host_lib)
    assert _same_bits(got, expect)
    for k in fused.STAT_NAMES:
        assert _same_bits(st[k], st_u[k]), k
    empty = kw["n_real"] == 0
    assert torch.isnan(got[:, empty]).all() and int(empty.sum()) > 0
    if case != "tiny_weight":
        assert torch.isfinite(got[:, ~empty]).all()
        assert got[:, ~empty].abs().amax() > 0
    assert tested > 0 and (case == "unsorted" or skipped > tested // 4)
