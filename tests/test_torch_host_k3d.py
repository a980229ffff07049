"""The host emulation of the CUDA kernels (``tests/host_harness.py``): K3d's
pruned phase B (the run walk) bit for bit against the full loop."""

import pytest
import torch

from host_harness import (F32, F64, K3D_CASES, _host_adjoint, _k3d_case,
                          _same_bits, _tally, data, host_lib)


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("kernel", ["epan", "gauss"])
@pytest.mark.parametrize("case", K3D_CASES)
def test_pruned_k3d_keeps_the_bits(host_lib, data, case, kernel, dtype):
    """K3d (the adjoint kernel on given bounds, logical rows, unit mass)
    with phase B on the slots that hold samples and, Epanechnikov, pruned
    to each slot's run of tiles gives d_series, d_params and d_ext of the
    same bits as phase B's full loop over every slot
    (host_fused_kde_adjoint_unpruned), float64 and float32, both KDE
    kernels, on the cases of _k3d_case; on the sorted rows more than half
    of the tiles are skipped."""
    args, kw = _k3d_case(data, dtype, kernel, case)
    _tally(host_lib)
    expect = _host_adjoint(host_lib, *args, **kw,
                           entry="host_fused_kde_adjoint_unpruned_")
    assert _tally(host_lib) == (0, 0)
    got = _host_adjoint(host_lib, *args, **kw)
    tested, skipped = _tally(host_lib)
    assert tested > 0 and (kernel == "epan" or skipped == 0)
    for g, e in zip(got, expect):
        assert _same_bits(g, e)
    if kernel == "epan" and case in ("sorted", "near_edge"):
        assert skipped > tested // 2
    if case != "non_finite_ct":
        assert all(torch.isfinite(g).all() for g in got)
        assert all(g.abs().max() > 0 for g in got)
