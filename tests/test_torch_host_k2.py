"""The host emulation of the CUDA kernels (``tests/host_harness.py``): K2, the
rows contraction, and K2b, its adjoint, against the plain versions, and
their pruned passes bit for bit against the full loops."""

import math

import pytest
import torch

from chimera_tpu_torch.ops.cuda import rows

from host_harness import (F32, F64, K2_CASES, ROWS_CASES, _host_rows_adjoint,
                          _host_rows_contract, _k2_args, _near_edge, _row_rel,
                          _rows_case, _rows_prune_case, _same_bits, _tally,
                          data, rows_host_lib)


@pytest.mark.parametrize("dtype,tol", [(F64, 1e-12), (F32, 1e-4)])
@pytest.mark.parametrize("kernel", ["epan", "gauss"])
def test_emulated_rows_adjoint_matches_plain(rows_host_lib, data, kernel, dtype,
                                             tol):
    """K2b against autograd through ``fused_rows_contract_plain``: every
    output (d_series, d_params, d_hs, d_f1, d_f2) within tol of each row's
    largest entry.  Padding rows (no weight), rows without a cotangent and
    rows of scale 0 give exact zeros; a live row of scale 0 is one that r
    has as 0 whatever its density, and its scale's cotangent is taken as 0
    (on the main path scale is 0 only below sqrt(tiny) pixel weight, where
    the density itself is of that size)."""
    args, zeroed = _rows_case(data, dtype, kernel)
    expect = list(rows.fused_rows_contract_adjoint_plain(*args))
    got = _host_rows_adjoint(rows_host_lib, *args)
    assert torch.all(got[2][:, zeroed] == 0) and torch.all(expect[2][:, zeroed, 0] == 0)
    expect[2][:, zeroed, 1] = 0.0
    dead = ~(args[3] > 0).any(dim=1)
    assert dead.any() and torch.all(got[2][:, dead] == 0)
    for g, e in zip(got, expect):
        assert e.abs().max() > 0
        assert _row_rel(g.reshape(-1, g.shape[-1]), e.reshape(-1, e.shape[-1])) <= tol


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("case", ROWS_CASES)
def test_pruned_rows_adjoint_keeps_the_bits(rows_host_lib, data, case, dtype):
    """K2b with both passes pruned (adjoint.cuh, rows_adjoint_event) gives
    every output (d_series, d_params, d_hs, d_f1, d_f2) of the same bits as
    the full loops (the emulation's oracle, host_rows_contract_adjoint_
    unpruned), float64 and float32, on every case of _rows_prune_case; on
    the dL-sorted rows more than half of the tiles are skipped."""
    args = _rows_prune_case(rows_host_lib, data, dtype, case)
    _tally(rows_host_lib)  # what earlier emulations left
    expect = _host_rows_adjoint(rows_host_lib, *args,
                                entry="host_rows_contract_adjoint_unpruned_")
    assert _tally(rows_host_lib) == (0, 0)
    got = _host_rows_adjoint(rows_host_lib, *args)
    tested, skipped = _tally(rows_host_lib)
    assert tested > 0
    for g, e in zip(got, expect):
        assert _same_bits(g, e)
    if case == "sorted":
        assert skipped > tested // 2
    if case != "nan_h":
        assert all(torch.isfinite(g).all() for g in got)


@pytest.mark.parametrize("dtype,tol", [(F64, 1e-10), (F32, 1e-4)])
@pytest.mark.parametrize("kernel", ["epan", "gauss"])
def test_emulated_rows_contract_matches_plain(rows_host_lib, data, kernel,
                                              dtype, tol):
    """K2 (adjoint.cuh, rows_contract_event; the Epanechnikov kernel's pair
    loop pruned) against ``fused_rows_contract_plain`` on the chunk rows of
    _rows_case: r within tol of each λ's largest |r| (float32: phase 7's
    bar), exact zeros on the rows of scale 0 and on the padding rows."""
    args, zeroed = _rows_case(data, dtype, kernel)
    m1, m2, dl, invp, grids, _, _, hs, s1, s2, f1, f2, _, cosmo, mass, _ = args
    expect = rows.fused_rows_contract_plain(m1, m2, dl, invp, cosmo, mass,
                                            grids, hs, s1, s2, f1, f2, kernel)
    got = _host_rows_contract(rows_host_lib, *_k2_args(args))
    dead = ~(invp > 0).any(dim=1)
    assert dead.any() and torch.all(got[:, dead] == 0)
    assert torch.all(got[:, zeroed] == 0) and torch.all(expect[:, zeroed] == 0)
    r_max = expect.double().abs().amax(dim=(1, 2), keepdim=True)
    assert torch.all(r_max > 0)
    assert ((got.double() - expect.double()).abs() / r_max).max() <= tol


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("case", K2_CASES)
def test_pruned_rows_contract_keeps_the_bits(rows_host_lib, data, case, dtype):
    """K2 with its pair loop pruned gives r of the same bits as the full
    loop (host_rows_contract_unpruned), float64 and float32, on the cases
    of _rows_prune_case (chunk rows with fillers, dead, padding and scale-0
    rows; dL-sorted rows; a tie at |u| = 1 on tile corners; rows out of z
    order; a NaN bandwidth), on the sorted rows with tile corners at
    |u| = 1 - 2^-10 ('near_edge', _near_edge) and with an infinite weight
    on one live row, a NaN grid point and, at the third λ, an infinite z
    of every sample ('non_finite': that row NaN at that λ, the others 0);
    on the dL-sorted rows more than half of the tiles are skipped."""
    if case == "near_edge":
        args = _near_edge(rows_host_lib,
                          _rows_prune_case(rows_host_lib, data, dtype, "sorted"),
                          dtype)
    elif case == "non_finite":
        args = _rows_prune_case(rows_host_lib, data, dtype, "sorted")
        invp, grids, series = args[3].clone(), args[4].clone(), args[5].clone()
        live = torch.nonzero((invp > 0).any(dim=1)).flatten()
        r = int(live[2])
        invp[r, int(torch.nonzero(invp[r] > 0)[0])] = math.inf
        grids[1, 40] = math.nan
        series[2, 0] += 1e4  # exp of the distance series overflows: z = inf
        args[3], args[4], args[5] = invp, grids, series
    else:
        args = _rows_prune_case(rows_host_lib, data, dtype, case)
    k2 = _k2_args(args)
    _tally(rows_host_lib)  # what earlier emulations left
    expect = _host_rows_contract(rows_host_lib, *k2,
                                 entry="host_rows_contract_unpruned_")
    assert _tally(rows_host_lib) == (0, 0)
    got = _host_rows_contract(rows_host_lib, *k2)
    tested, skipped = _tally(rows_host_lib)
    assert tested > 0 and _same_bits(got, expect)
    assert expect.abs().nan_to_num().amax() > 0
    if case == "sorted":
        assert skipped > tested // 2
    if case == "non_finite":
        assert torch.isnan(got[2, r]).all() and torch.all(got[2, :r] == 0)
    elif case != "nan_h":
        assert torch.all(torch.isfinite(got))
