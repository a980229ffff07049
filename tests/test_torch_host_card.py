"""The host emulation of the CUDA kernels (``tests/host_harness.py``): the
emulations as the launches behind the wrappers' CUDA branches (the card's
gradient of every path, the contract path), the tile widths, the card's
blocks, the Epanechnikov tie's half slope in K3 and K2b, and copies of the
sources with a loose corner test."""

import ctypes
import shutil
import subprocess

import pytest
import torch

from chimera_tpu_torch import HyperLikelihood, SelectionFunction
from chimera_tpu_torch.models.cosmology import z_from_dgw
from chimera_tpu_torch.ops.cuda import fused, launch_counts, rows

from host_harness import (CSRC, F32, F64, HERE, LAMBDA, _dark_hl,
                          _emulate_the_card, _host_adjoint, _host_fused,
                          _host_k4, _host_k4b, _host_rows_adjoint,
                          _host_slot_sums, _k1d_case, _k1e_case,
                          _k3b_pair_case, _k4_case, _k4b_case, _off_edge,
                          _population, _ptr, _row_rel, _same_bits,
                          _tie_bandwidth, dark_data, data, fused_host_lib,
                          host_lib, rows_host_lib, strict_corner_libs)


@pytest.mark.parametrize("kind,cut_grid,launched", [
    ("marginalized", None, {"K1c": 1, "K2": 1, "K3c": 1, "K2b": 1}),
    ("marginalized", 2.0, {"K1c": 1, "K1d": 1, "K3c": 1, "K3d": 1}),
    ("1d", 2.0, {"K1b": 1, "K3b": 1}), ("1d", None, {"K1a": 1, "K3": 1}),
    ("1d", 2.0, {"K4": 1, "K4b": 1}), ("1d", None, {"K4": 1, "K4b": 1}),
    ("approximate", 2.0, {"K4": 1, "K4b": 1}),
    ("marginalized", 2.0, {"K4": 1, "K4b": 1}),
    ("marginalized", None, {"K4": 1, "K4b": 1})])
def test_emulated_card_gradient(host_lib, fused_host_lib, rows_host_lib, data,
                                dark_data, monkeypatch, kind, cut_grid, launched):
    """d log L / d(H0, Om0, mu_g) through the wrappers' CUDA branches with
    the kernels' host emulations as the launches, float64: within 1e-11 of
    autograd through the plain versions, with each kernel launched exactly
    as on the card.  Unbinned: the autograd Functions around K1 and K2, K1's
    raw statistics (NaN on the dead pixel rows, scrubbed by the likelihood's
    selects), the cotangent slots the backward hands K3 and K2b.  Binned
    (the launches name K4): the autograd Function around K4, the saved
    output and cotangent its backward hands K4b."""
    if kind == "1d":
        cat, z_grids, inj, n_gen = data
        args = (cat, z_grids, _population(F64), SelectionFunction.create(inj, n_gen))
    else:
        args = _dark_hl(dark_data)
    hl = HyperLikelihood.create(*args, kind=kind, binning="K4" in launched,
                                cut_grid=cut_grid)
    x0 = torch.tensor([[66.0, 0.24, 33.5], [71.0, 0.27, 34.0], [77.0, 0.3, 34.6]],
                      dtype=F64)

    def grad():
        x = x0.clone().requires_grad_()
        ll = hl.log_like_batch({"H0": x[:, 0], "Om0": x[:, 1], "mu_g": x[:, 2]})
        return ll.detach(), torch.autograd.grad(ll.sum(), x)[0]

    ll, expect = grad()
    assert torch.all(torch.isfinite(expect))
    _emulate_the_card(monkeypatch, {"fused_kde": fused_host_lib,
                                    "fused_kde_adjoint": host_lib,
                                    "rows_contract": rows_host_lib,
                                    "rows_contract_adjoint": rows_host_lib,
                                    "kde1d": fused_host_lib})
    before = launch_counts()
    ll_card, got = grad()
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == \
        {k: launched.get(k, 0) for k in after}
    assert torch.allclose(ll_card, ll, rtol=1e-12, atol=0)
    scale = expect.abs().amax(dim=0)
    assert ((got - expect).abs() / scale).max() <= 1e-11


def test_emulated_contract_path(fused_host_lib, dark_data, monkeypatch):
    """'marginalized', unbinned, cut_grid=None on a layout without chunk
    rows: one K1e launch a batch through the CUDA branch of
    ``fused_weights_kde`` (its raw statistics, the r it hands the mixture),
    with K1e's host emulation as the launch, float64: log L within 1e-12 of
    the plain version's and of the rows path's (K1c + K2); its gradient
    raises on the card, as K1e has no adjoint kernel."""
    args = _dark_hl(dark_data)
    contract = HyperLikelihood._create(
        *args, kind="marginalized", kernel="epan", bw_method=None,
        cut_grid=None, binning=False, num_bins=200, pe_neff=2.0,
        chunk_rows=False)
    assert not hasattr(contract, "row_dL") and contract.pix_s1.shape == \
        (contract.pix_dL.shape[0], contract.z_grids.shape[1])
    rows_ll = HyperLikelihood.create(*args, kind="marginalized", binning=False,
                                     cut_grid=None).log_like_batch(LAMBDA)
    plain = contract.log_like_batch(LAMBDA)
    assert torch.all(torch.isfinite(plain))
    assert torch.allclose(plain, rows_ll, rtol=1e-12, atol=0)
    _emulate_the_card(monkeypatch, {"fused_kde": fused_host_lib})
    before = launch_counts()
    card = contract.log_like_batch(LAMBDA)
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == \
        {k: int(k == "K1e") for k in after}
    assert torch.allclose(card, plain, rtol=1e-12, atol=0)
    h0 = torch.tensor(LAMBDA["H0"], dtype=F64, requires_grad=True)
    with pytest.raises(NotImplementedError, match="K1e's adjoint"):
        contract.log_like_batch({"H0": h0})


def test_tile_widths_match_the_kernels(rows_host_lib):
    """The wrappers' tile widths of the pruned pair loops (``fused._TILE_S``,
    ``_TILE_G``, ``_GRID_TILE``, ``_K4B_TILE``, ``_K4_TILE``: the shared
    memory of the tile bounds that ``fused.py``, ``rows.py`` and ``kde.py``
    check, and the terms that ``chip_smoke.py`` counts) against the
    kernels' kTileS, kTileG, kGridTile, kK4bTile and kK4Tile
    (csrc/kde.cuh, csrc/adjoint.cuh)."""
    out = (ctypes.c_int * 5)()
    rows_host_lib.host_tile_widths(out)
    assert list(out) == [fused._TILE_S, fused._TILE_G, fused._GRID_TILE,
                         fused._K4B_TILE, fused._K4_TILE]


def test_device_functions_build_for_the_card_blocks():
    """K3's adjoint_row in every mode and KDE kernel, K4b's
    kde_row_adjoint, K4's kde_row, K1e's and K1d's fused_row and K1d's
    warp-a-row logical_row_stats and external_kde, instantiated with the
    card's blocks (DeviceBlock of 8 and 4 warps, K3c's and K1d's WarpBlock:
    tests/host_emulation/card_blocks.cpp), K5's recurrence (pruned and
    unpruned walks of every tier) as kde3d.cu instantiates it, and K5b's
    phases with its warp's union of ranges and shuffle tree,
    pass g++'s syntax check: the host emulations instantiate them with a
    block of one thread only, whose members the card's blocks may lack."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host emulation")
    proc = subprocess.run(
        [gxx, "-std=c++17", "-fsyntax-only", "-Wno-unknown-pragmas", f"-I{HERE}",
         f"-I{CSRC}", str(HERE / "card_blocks.cpp")], capture_output=True,
        text=True)
    assert proc.returncode == 0, proc.stderr


def test_epanechnikov_tie_takes_half_the_slope(host_lib, rows_host_lib, data):
    """K3 and K2b at a constructed Epanechnikov tie, float64: a grid point
    picked after h so that u = (g - z) / h is exactly 1 for a sample, where
    0.75 max(0, 1 - u^2) has half its slope (jnp.maximum's, as the Pallas
    references and the plain versions take it): the emulations within 1e-12
    of the plain versions (a kernel taking all of the slope, or none, misses
    by the tie's term)."""
    cat = data[0]
    pop = _population(F64).update_batch({"H0": [70.0]})
    series, params = fused.pack_params(pop.cosmo, pop.mass, 1, F64)
    gen = torch.Generator().manual_seed(12)
    # K3 on analysis grids: rows of two samples and a fixed bandwidth factor,
    # so that h is the same sum of two terms in the kernel and the plain
    # version; samples whose z the float64 kernel and the plain version round
    # alike (exp differs in the last bit at a few), the tie on row 0
    dl = cat.dL[6:].reshape(-1, 2)
    z = z_from_dgw(pop.cosmo, dl[None])[0]
    zk = torch.empty_like(z)
    fn = host_lib.host_z_from_dgw
    fn.restype = None
    fn(_ptr(series), _ptr(params), pop.cosmo.cheb_deg, pop.mass.window_deg,
       _ptr(dl.contiguous()), dl.numel(), _ptr(zk))
    pick = torch.nonzero((z == zk).all(dim=1)).flatten()[:4]
    assert len(pick) == 4
    pe = [t[6:].reshape(-1, 2)[pick].contiguous() for t in (
        cat.m1det, cat.m2det, cat.dL, 1.0 / cat.pe_prior)]
    z = z[pick]
    grid = _off_edge(z, 0.01, 8, gen)
    _, st = fused.fused_weights_kde_plain(*pe, pop.cosmo, pop.mass, grid,
                                          bw_method=1.0)
    g0, c = _tie_bandwidth(float(z[0, 0]), float(st["bandwidth"][0, 0]))
    grid[0, 0] = g0
    h = fused.fused_weights_kde_plain(*pe, pop.cosmo, pop.mass, grid,
                                      bw_method=c)[1]["bandwidth"][0, 0]
    assert (grid[0, 0] - z[0, 0]) / h == 1.0
    assert (grid[0, 0] - z[0, 0]) * (1.0 / h) == 1.0
    ct_den = torch.randn(1, 4, grid.shape[1], generator=gen, dtype=F64)
    args = (*pe, grid, series, params, ct_den, torch.zeros(1, 4, 8, dtype=F64),
            pop.cosmo, pop.mass, "epan", c)
    expect = fused.fused_weights_kde_adjoint_plain(*args)
    got = _host_adjoint(host_lib, *args)
    assert _row_rel(got[0], expect[0]) <= 1e-12
    assert _row_rel(got[1], expect[1]) <= 1e-12
    # K2b, 1/h an input: two events of two rows of two samples, the tie on
    # each event's first sample at 1/h a power of two
    rows_pe = [t.reshape(4, 2) for t in pe]
    zr = z.reshape(4, 2)
    grids = _off_edge(zr[::2], 0.01, 8, gen)
    inv_h = torch.zeros(4, dtype=F64)
    for e in range(2):
        z0 = float(zr[2 * e, 0])
        k = next(k for k in range(3, 12) if (z0 + 2.0 ** -k) - z0 == 2.0 ** -k)
        grids[e, 0], inv_h[2 * e:2 * e + 2] = z0 + 2.0 ** -k, 2.0 ** k
    assert torch.all((grids[:, 0] - zr[::2, 0]) * inv_h[::2] == 1.0)
    hs = torch.stack([inv_h[None], torch.full((1, 4), 0.3, dtype=F64)], dim=-1)
    s12 = [torch.rand(4, 8, generator=gen, dtype=F64) for _ in range(2)]
    f12 = [torch.rand(1, 2, 8, generator=gen, dtype=F64) for _ in range(2)]
    ct_r = torch.randn(1, 4, 2, generator=gen, dtype=F64)
    rargs = (*rows_pe, grids, series, params, hs, *s12, *f12, ct_r, pop.cosmo,
             pop.mass, "epan")
    expect = rows.fused_rows_contract_adjoint_plain(*rargs)
    got = _host_rows_adjoint(rows_host_lib, *rargs)
    for g, e in zip(got, expect):
        assert _row_rel(g.reshape(-1, g.shape[-1]), e.reshape(-1, e.shape[-1])) <= 1e-12


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("kernel", ["K4b", "K3b", "K3d", "K4", "K1e", "K1d"])
def test_tie_cases_catch_a_loose_corner_test(strict_corner_libs, data, kernel,
                                             dtype):
    """A corner test that skips tiles at |u| = 1 (>= in place of >) gives
    other bits than the full loops on the tie case of K4b and of K3b's and
    K3d's phase B walks, where the slope factor (K4b) or the support weight
    (K3b, K3d, 1/2) is not 0; a density's corner test of 0.999 in place of
    1 (a density's term is 0 at |u| = 1, so skipping there is right) gives
    other bits on the near-edge cases of K4 and K1e: the tie and near-edge
    cases of the tests above can fail."""
    fused_lib, adjoint_lib = strict_corner_libs
    if kernel == "K4":
        args = _k4_case("near_edge", dtype, 250)
        assert not _same_bits(_host_k4(fused_lib, *args),
                              _host_k4(fused_lib, *args, pruned=False))
    elif kernel == "K1e":
        args, kw = _k1e_case(data, dtype, "near_edge")
        got, _ = _host_fused(fused_lib, fused._CONTRACT, *args, **kw)
        expect, _ = _host_fused(fused_lib, fused._CONTRACT, *args, **kw,
                                entry="host_fused_kde_unpruned_")
        assert not _same_bits(got, expect)
    elif kernel == "K1d":
        args, kw = _k1d_case(data, dtype, "near_edge")
        got, _ = _host_fused(fused_lib, fused._EXTERNAL_BOUNDS, *args, **kw)
        expect, _ = _host_fused(fused_lib, fused._EXTERNAL_BOUNDS, *args, **kw,
                                entry="host_fused_kde_unpruned_")
        assert not _same_bits(got, expect)
    elif kernel == "K4b":
        args = _k4b_case("tie", dtype)
        expect = _host_k4b(fused_lib, args, "host_kde1d_adjoint_unpruned_")
        got = _host_k4b(fused_lib, args)
        assert not all(_same_bits(g, e) for g, e in zip(got, expect))
    else:
        args = _k3b_pair_case("tie", dtype)
        walk = 1 if kernel == "K3b" else 2
        assert not _same_bits(_host_slot_sums(adjoint_lib, *args, prune=walk),
                              _host_slot_sums(adjoint_lib, *args, prune=0))
