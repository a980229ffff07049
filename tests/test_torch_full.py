"""Kind 'full' of the port (the 3-D (z, ra, dec) Gaussian KDE per event on
its pixels x z-grid lattice) against the JAX package, float64 on the CPU:

* ``ops/kde.py``: ``gaussian_kde_3d_lattice`` (the dense z sweep and the
  uniform-z recurrence at K = 8, 16, 32), ``gaussian_kde_nd_stream`` with
  and without ``in_log``, a dead (zero-weight) row;
* K5 (``csrc/kde3d.cu``) and its adjoint K5b through their host
  emulations (``tests/host_emulation/kde3d_host.cpp``, the kernels' own
  device functions in ``csrc/kde3d.cuh``) against the plain version and
  autograd of it, and as the launches of the wrappers' CUDA branches on
  CPU tensors;
* ``likelihood.z_recurrence_plan`` against a numpy recomputation, on the
  narrow-outlier recipe of ``tests/test_ops.py::
  test_full_kind_buckets_match_dense`` at 256-point grids;
* ``log_like_batch`` of ``from_state`` (the JAX object's plan carried) and
  of the port's own ``create`` against the JAX package's, on the repo's
  dark-siren precision mock (``tests/data/f32_parity_dark.npz``: 16 events
  x 512 samples, <= 8 pixels, 200-point z-grids) with its pixelated
  catalog and with an empty one, and d log L / d(H0, Om0) against
  ``jax.grad``, with K5 and its adjoint K5b emulated as the card's
  launches too.

The JAX side is its XLA path: 'full' has no Pallas kernel to interpret.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import k5b_cases
from chimera_tpu_torch import HyperLikelihood, SelectionFunction, convert
from chimera_tpu_torch.catalog import EmptyCatalog
from chimera_tpu_torch.likelihood import z_recurrence_plan
from chimera_tpu_torch.ops import kde as tkde
from chimera_tpu_torch.ops.cuda import fused, kde3d, launch_counts

F64, F32 = torch.float64, torch.float32
HERE = Path(__file__).resolve().parent
H0S = np.array([60.0, 70.0, 80.0])


def _t(x, dtype=F64):
    return torch.as_tensor(np.asarray(x)).to(dtype)


def _lattice_data(rng, n_ev=3, s=500, p=5, g=128):
    """Events of correlated (z, ra, dec) samples around (0.5, 2.0, 0.3)
    (sigma 0.05, 0.03, 0.03), random weights, pixel centres near the sky
    mean, uniform 128-point z-grids over [0.3, 0.7]: whitened grid step
    ~0.15, so K = 32 keeps K h <= 5.5."""
    base = rng.normal(size=(n_ev, 3, s))
    mix = np.array([[1.0, 0.0, 0.0], [0.3, 1.0, 0.0], [-0.2, 0.4, 1.0]])
    data = np.einsum("ij,ejs->eis", mix, base) * np.array([0.05, 0.03, 0.03])[:, None] \
        + np.array([0.5, 2.0, 0.3])[:, None]
    w = rng.uniform(0.1, 1.0, size=(n_ev, s))
    ra_pix = 2.0 + 0.04 * rng.normal(size=(n_ev, p))
    dec_pix = 0.3 + 0.04 * rng.normal(size=(n_ev, p))
    grid = np.tile(np.linspace(0.3, 0.7, g), (n_ev, 1))
    return data, w, ra_pix, dec_pix, grid


def _close(got, expect, rel):
    got, expect = np.asarray(got), np.asarray(expect)
    assert np.all(np.isfinite(got)) and np.all(np.isfinite(expect))
    scale = np.abs(expect).max()
    np.testing.assert_allclose(got, expect, rtol=rel, atol=rel * scale)


@pytest.mark.parametrize("k_block", [0, 8, 16, 32])
def test_lattice_matches_reference(k_block):
    """The port's lattice KDE, batched over events (one call, per-event K
    as a tensor), against the JAX function event by event: dense sweep and
    recurrence, 500 samples in two chunks of 256 (the last padded), a
    128-point grid (whole blocks; the padded last block is the next
    test's, on 100 points)."""
    data, w, ra_pix, dec_pix, grid = _lattice_data(np.random.default_rng(3))
    got = tkde.gaussian_kde_3d_lattice(
        _t(data), _t(ra_pix), _t(dec_pix), _t(grid), _t(w), sample_chunk=256,
        z_block=torch.full((3,), k_block))
    for e in range(3):
        expect = jkde.gaussian_kde_3d_lattice(
            jnp.asarray(data[e]), jnp.asarray(ra_pix[e]), jnp.asarray(dec_pix[e]),
            jnp.asarray(grid[e]), weights=jnp.asarray(w[e]), sample_chunk=256,
            uniform_z=k_block > 0, z_block=k_block or 32)
        _close(got[e].numpy(), expect, 1e-10)


def test_lattice_mixed_blocks_and_dead_row():
    """One call with a different K per event (dense, 8, 32) on a grid of
    100 points (the recurrence's last block padded), the first event with
    every weight 0: the uniform fallback keeps it finite, as in the JAX
    package."""
    data, w, ra_pix, dec_pix, grid = _lattice_data(np.random.default_rng(4), g=100)
    grid = np.tile(np.linspace(0.35, 0.65, 100), (3, 1))
    w[0] = 0.0
    ks = [0, 8, 32]
    got = tkde.gaussian_kde_3d_lattice(_t(data), _t(ra_pix), _t(dec_pix),
                                       _t(grid), _t(w), z_block=torch.tensor(ks))
    for e, k in enumerate(ks):
        expect = jkde.gaussian_kde_3d_lattice(
            jnp.asarray(data[e]), jnp.asarray(ra_pix[e]), jnp.asarray(dec_pix[e]),
            jnp.asarray(grid[e]), weights=jnp.asarray(w[e]), uniform_z=k > 0,
            z_block=k or 32)
        _close(got[e].numpy(), expect, 1e-10)


@pytest.mark.parametrize("in_log", [False, True])
def test_kde_nd_stream_matches_reference(in_log):
    """``gaussian_kde_nd_stream`` (500 samples in chunks of 256, the last
    padded) against the JAX function, and the batched direct KDE against
    the streamed one."""
    data, w, _, _, _ = _lattice_data(np.random.default_rng(5))
    pts = data[:, :, :40] + 0.01
    got = tkde.gaussian_kde_nd_stream(_t(data), _t(pts), _t(w), in_log=in_log,
                                      sample_chunk=256)
    for e in range(3):
        expect = jkde.gaussian_kde_nd_stream(
            jnp.asarray(data[e]), jnp.asarray(pts[e]), jnp.asarray(w[e]),
            in_log=in_log, sample_chunk=256)
        _close(got[e].numpy(), expect, 1e-10)
    direct = tkde.gaussian_kde_nd_batch(_t(data), _t(pts), _t(w), in_log=in_log)
    _close(direct.numpy(), got.numpy(), 1e-10)


# ---------------------------------------------------------------------------
# K5's host emulation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def k5_host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host emulation")
    so = tmp_path_factory.mktemp("host_emulation") / "libkde3d_host.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-Wno-unknown-pragmas",
         f"-I{HERE / 'host_emulation'}", f"-I{Path(fused.__file__).parents[2] / 'csrc'}",
         "-o", str(so), str(HERE / "host_emulation" / "kde3d_host.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(so))


def _emulate_k5(monkeypatch, lib):
    """``lattice_kde3d`` and ``lattice_kde3d_adjoint`` take their CUDA
    branches on CPU tensors, their launches (K5, K5b) the host emulations of
    the same C interfaces; the launch counters are restored with the
    patch."""
    for fn in (kde3d.lattice_kde3d, kde3d.lattice_kde3d_adjoint):
        monkeypatch.setattr(fn, "launches", fn.launches)

    def launch(lib_name, symbol, dtype, device, args):
        assert lib_name == "kde3d" and symbol in ("chimera_kde3d",
                                                  "chimera_kde3d_adjoint")
        fn = getattr(lib, symbol.replace("chimera_", "host_") + "_"
                     + ("f32" if dtype == F32 else "f64"))
        fn.restype = ctypes.c_int
        assert fn(*[ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
                    else ctypes.c_double(a) if isinstance(a, float) else a
                    for a in args]) == 0

    monkeypatch.setattr(fused, "on_card", lambda t: True)
    monkeypatch.setattr(fused, "launch", launch)


def _k5_inputs(dtype):
    """Two λ x three events of 500 samples, 5 pixels (the last of event 1
    fake, at a finite centre), 100-point grids; event 2 at K = 13 (not a
    tier: the 16-register path with a padded last block), event 0 dense,
    event 1 at K = 32; (λ 1, event 0) without weight."""
    data, w, ra_pix, dec_pix, grid = _lattice_data(np.random.default_rng(6), g=100)
    grid = np.tile(np.linspace(0.35, 0.65, 100), (3, 1))
    rng = np.random.default_rng(7)
    z = np.stack([data[:, 0], data[:, 0] + 0.002 * rng.normal(size=data[:, 0].shape)])
    w2 = np.stack([w, w * rng.uniform(0.5, 1.5, size=w.shape)])
    w2[1, 0] = 0.0
    mask = np.ones((3, 5), dtype=bool)
    mask[1, 4] = False
    return (_t(z, dtype), _t(w2, dtype), _t(data[:, 1], dtype), _t(data[:, 2], dtype),
            _t(ra_pix, dtype), _t(dec_pix, dtype), torch.as_tensor(mask),
            _t(grid, dtype), torch.tensor([0, 32, 13]))


@pytest.mark.parametrize("dtype", [F64, F32])
def test_k5_host_emulation_matches_plain(k5_host, monkeypatch, dtype):
    """K5's arithmetic (prologue in double, centred sky factors, dense sweep
    and recurrence in the kernel's thread layout) through the wrapper's
    CUDA branch, one launch: float64 within 1e-10 of each (λ, event, pixel)
    row's max of the plain version, float32 within 1e-4 of the float64
    plain version's; a fake pixel's row 0."""
    args = _k5_inputs(dtype)
    expect = kde3d.lattice_kde3d_plain(*(a.double() if a.is_floating_point()
                                         else a for a in args))
    _emulate_k5(monkeypatch, k5_host)
    before = launch_counts()
    got = kde3d.lattice_kde3d(*args)
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == \
        {k: int(k == "K5") for k in after}
    assert got.dtype == dtype and got.shape == expect.shape
    assert torch.all(got[:, 1, 4] == 0) and torch.all(torch.isfinite(got))
    rel = (got.double() - expect).abs() / expect.abs().amax(dim=-1, keepdim=True)
    assert rel.nan_to_num(0.0).max() <= (1e-10 if dtype == F64 else 1e-4)


def test_k5_refuses_a_block_length_it_does_not_take(k5_host, monkeypatch):
    """A K outside [0, 32] gives NaN rows on the card (the wrapper does not
    read K back from the device); a fake pixel's row stays 0."""
    args = list(_k5_inputs(F64))
    args[8] = torch.tensor([0, 33, 8])
    _emulate_k5(monkeypatch, k5_host)
    got = kde3d.lattice_kde3d(*args)
    assert torch.all(torch.isnan(got[:, 1, :4])) and torch.all(got[:, 1, 4] == 0)
    assert torch.all(torch.isfinite(got[:, 0])) and torch.all(torch.isfinite(got[:, 2]))


# ---------------------------------------------------------------------------
# K5b, the adjoint (host emulation)
# ---------------------------------------------------------------------------

def _k5b_inputs(k_block: int, dtype):
    """Two λ x three events of 128 samples, 3 pixels (event 1's last fake,
    at a finite centre, the others near the sky mean and 0.1 rad off it),
    64-point grids over [-0.6, 1.6] (~90 bandwidths: the far blocks' refreshes
    flush), every event at K = ``k_block``; sample 0 without weight and
    sample 1's weight below the smallest normal times the sum (e below the
    smallest normal: no cotangent on the recurrence's path, one on the dense
    sweep's); (λ 1, event 0) with two samples of weight (no whitening: a
    dead row); and a cotangent d_out drawn from a seed, 0 on event 2's
    second pixel (a skipped pixel)."""
    rng = np.random.default_rng(19)
    data, w, ra_pix, dec_pix, _ = _lattice_data(rng, s=128, p=3, g=64)
    ra_pix[:, 1] += 0.1
    grid = np.tile(np.linspace(-0.6, 1.6, 64), (3, 1))
    z = np.stack([data[:, 0], data[:, 0] + 0.002 * rng.normal(size=data[:, 0].shape)])
    w2 = np.stack([w, w * rng.uniform(0.5, 1.5, size=w.shape)])
    w2[..., 0] = 0.0
    w2[..., 1] = 1e-3 * float(torch.finfo(dtype).tiny)
    w2[1, 0, 4:] = 0.0
    mask = np.ones((3, 3), dtype=bool)
    mask[1, 2] = False
    d_out = rng.normal(size=(2, 3, 3, 64))
    d_out[:, 2, 1] = 0.0
    return ((_t(z, dtype), _t(w2, dtype), _t(data[:, 1], dtype),
             _t(data[:, 2], dtype), _t(ra_pix, dtype), _t(dec_pix, dtype),
             torch.as_tensor(mask), _t(grid, dtype), torch.full((3,), k_block)),
            _t(d_out, dtype))


@pytest.mark.parametrize("k_block", [0, 8, 16, 32])
def test_k5b_host_emulation_matches_plain(k5_host, monkeypatch, k_block):
    """K5b's arithmetic (kde3d.cuh: the dense terms of the blocks whose
    refresh the forward keeps, the pixels' and event's sums in rank order)
    and the chain through the float64 record (``ops/kde.py::
    lattice_record``), through ``lattice_kde3d_adjoint``'s CUDA branch with
    the host emulations as its launches (K5 for the record, then K5b),
    against autograd of the plain version, float64: every gradient (z, w,
    ra, dec, the pixel centres)
    within 1e-9 of each row's largest entry, NaN in the same places (the
    dead (λ, event)'s z and w, and every ra, dec and pixel centre of its
    event), finite elsewhere; a second call gives the same bits."""
    args, d_out = _k5b_inputs(k_block, F64)
    expect = kde3d.lattice_kde3d_adjoint_plain(*args, d_out)
    _emulate_k5(monkeypatch, k5_host)
    before = launch_counts()
    got = kde3d.lattice_kde3d_adjoint(*args, d_out)
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == \
        {k: int(k in ("K5", "K5b")) for k in after}
    again = kde3d.lattice_kde3d_adjoint(*args, d_out)
    assert torch.isnan(got[0][1, 0]).all() and torch.isfinite(got[0][0]).all()
    for name, g, e, r in zip(kde3d._WRT, got, expect, again):
        nan = torch.isnan(e)
        assert torch.equal(torch.isnan(g), nan), name
        assert torch.isfinite(e[~nan]).all() and _same_bits(g, r), name
        g, e = g.masked_fill(nan, 0.0), e.masked_fill(nan, 0.0)
        scale = e.abs().amax(dim=-1, keepdim=True).clamp_min(1e-300)
        assert ((g - e).abs() / scale).max() <= 1e-9, name


def _host_k5b(lib, args, d_out, entry="", records=None):
    """K5b's host emulation called directly on ``records`` (by default the
    records of K5's host emulation on the same inputs): ``entry`` "" the
    kernel's walk, "unpruned_" every block tested (the walk of K5b's first
    kernel, the reference); returns (d_samp, d_pix, d_event, records)."""
    z, w, ra, dec, ra_pix, dec_pix, mask, grids, z_block = args
    n, e, s = z.shape
    p, g = ra_pix.shape[1], grids.shape[1]
    sfx = "f32" if z.dtype == F32 else "f64"
    inputs = [t.contiguous() for t in (z, w, ra, dec, ra_pix, dec_pix, mask,
                                        grids)] + [z_block.to(torch.int32)]
    out = [torch.empty((n, e, s, 4), dtype=F64), torch.empty((n, e, p, 3), dtype=F64),
           torch.empty((n, e, 3), dtype=F64)]
    calls = [(getattr(lib, f"host_kde3d_adjoint_{entry}{sfx}"),
              [*inputs, records, d_out.contiguous(), *out], [])]
    if records is None:
        records = torch.empty((n, e, 16), dtype=F64)
        calls = [(getattr(lib, "host_kde3d_" + sfx),
                  [*inputs, records, torch.empty((n, e, p, g), dtype=z.dtype)],
                  [0, ctypes.c_double(0.0)]),
                 (calls[0][0], [*inputs, records, d_out.contiguous(), *out], [])]
    for fn, tensors, tail in calls:
        fn.restype = ctypes.c_int
        assert fn(*[ctypes.c_void_p(t.data_ptr()) for t in tensors], n, e, s, p,
                  g, *tail) == 0
    return (*out, records)


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("case", list(k5b_cases.CASES))
def test_k5b_range_walk_keeps_the_bits(k5_host, case, dtype):
    """K5b's walk of each (sample, pixel)'s ``kept_range`` (the blocks
    within the sample's skip radius, an estimate moved to the range's exact
    ends) gives the bits of the walk that tests every block, the previous
    kernel's, in every output: each tier of K and the dense sweep, chunks
    of pixels, 2 000 samples, a dead (λ, event), fake and skipped pixels,
    samples without weight or below the flush."""
    args, d_out = k5b_cases.k5b_case(case, dtype)
    got = _host_k5b(k5_host, args, d_out)
    expect = _host_k5b(k5_host, args, d_out, "unpruned_")
    for name, a, b in zip(("d_samp", "d_pix", "d_event"), got[:3], expect[:3]):
        assert _same_bits(a, b), name
    assert torch.isfinite(got[0][0]).all()


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("case", list(k5b_cases.CASES))
def test_k5b_sample_order_keeps_d_samp(k5_host, case, dtype):
    """Each event's samples sorted by their whitened z (the first λ's, from
    ``ops/kde.py::lattice_record``) against their input order, on the same
    records: d_samp the same bits, sample for sample (a sample's sums take
    its pixels and blocks in order, whichever thread and warp take it); the
    pixel and event sums, taken over other warps, within 1e-12 of each
    row's largest entry, NaN in the same places."""
    args, d_out = k5b_cases.k5b_case(case, dtype)
    *expect, records = _host_k5b(k5_host, args, d_out)
    z, w, ra, dec = args[:4]
    a = tkde.lattice_record(z.double(), w.double(), ra.double(), dec.double(),
                            args[4].double(), args[5].double())["a"][0]
    order = torch.argsort(a.nan_to_num(float("inf")), dim=-1, stable=True)  # (E, S)
    assert not torch.equal(order, torch.arange(z.shape[2]).expand_as(order))
    take = lambda x: torch.take_along_dim(x, order.expand_as(x), dim=-1)  # noqa: E731
    permuted = (take(z), take(w), take(ra), take(dec), *args[4:])
    got = _host_k5b(k5_host, permuted, d_out, records=records)
    d_samp = torch.empty_like(got[0])
    d_samp.scatter_(2, order[None, :, :, None].expand_as(got[0]), got[0])
    assert _same_bits(d_samp, expect[0])
    for a, b in zip(got[1:3], expect[1:]):
        nan = torch.isnan(b)
        assert torch.equal(torch.isnan(a), nan)
        a, b = a.masked_fill(nan, 0.0), b.masked_fill(nan, 0.0)
        scale = b.abs().amax(dim=-1, keepdim=True).clamp_min(1e-300)
        assert ((a - b).abs() / scale).max() <= 1e-12


@pytest.mark.parametrize("case", list(k5b_cases.CASES))
def test_k5b_cases_match_plain(k5_host, monkeypatch, case):
    """K5b's host emulation as the launch of ``lattice_kde3d_adjoint``'s
    CUDA branch (K5's for the record) against autograd of the plain
    version, float64: every gradient within 1e-10 of each row's largest
    entry, NaN in the same places (the dead (λ, event) of "k16")."""
    args, d_out = k5b_cases.k5b_case(case, F64)
    expect = kde3d.lattice_kde3d_adjoint_plain(*args, d_out)
    _emulate_k5(monkeypatch, k5_host)
    got = kde3d.lattice_kde3d_adjoint(*args, d_out)
    for name, g, e in zip(kde3d._WRT, got, expect):
        nan = torch.isnan(e)
        assert torch.equal(torch.isnan(g), nan), name
        assert torch.isfinite(e[~nan]).all() and torch.isfinite(g[~nan]).all(), name
        g, e = g.masked_fill(nan, 0.0), e.masked_fill(nan, 0.0)
        scale = e.abs().amax(dim=-1, keepdim=True).clamp_min(1e-300)
        assert ((g - e).abs() / scale).max() <= 1e-10, name
    if case == "k16":
        assert torch.isnan(got[0][1, 0]).all()


# one (sample, pixel) of K5b: (e, t, K) on 500 grid points of whitened step
# 0.25 from -60 (32 blocks at K = 16); "radius" and "minus_radius" put u0
# of a block exactly on +R and -R
_EDGES = {"e_2_20": (2.0 ** 20, 3.0, 16), "e_inf": (float("inf"), 3.0, 16),
          "e_nan": (float("nan"), 3.0, 16),
          "e_below_flush": (None, 3.0, 16), "e_zero": (0.0, 3.0, 16),
          "e_negative": (-1e-3, 3.0, 16), "t_nan": (1e-3, float("nan"), 16),
          "t_inf": (1e-3, float("inf"), 16), "radius": (1e-3, None, 16),
          "minus_radius": (1e-3, None, 16), "k8": (1e-3, 0.7, 8),
          "k16": (1e-3, 0.7, 16), "k32": (1e-3, -7.3, 32),
          "dense": (1e-3, 0.7, 0)}


def _pixel_walk(lib, dtype, e, t, k, zl, zeta, dg, walk):
    np_t = np.float32 if dtype == F32 else np.float64
    c_t = ctypes.c_float if dtype == F32 else ctypes.c_double
    fn = getattr(lib, "host_kde3d_pixel_walk_" + ("f32" if dtype == F32 else "f64"))
    fn.restype = None
    out, rng = np.zeros(3, dtype=np_t), np.zeros(2, dtype=np.int32)
    fn(c_t(e), c_t(t), *[x.ctypes.data_as(ctypes.c_void_p) for x in (zl, zeta, dg)],
       ctypes.c_double(-60.0), ctypes.c_double(0.25), len(zl), k, walk,
       out.ctypes.data_as(ctypes.c_void_p), rng.ctypes.data_as(ctypes.c_void_p))
    return out, rng


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("edge", list(_EDGES))
def test_k5b_kept_range_edges(k5_host, edge, dtype):
    """One (sample, pixel)'s sums over ``kept_range``'s blocks against those
    over every block tested, the same bits, at the range's edges: e at 2^20
    (a finite radius) and +inf (every block), NaN, below the smallest
    normal times e^-1.5, 0 and negative (no block), t NaN and +inf (every
    block, none kept), u0 of a block exactly +R or -R (the block inside
    the range), K = 8, 16, 32 (a range short of the grid) and the dense
    sweep."""
    np_t = np.float32 if dtype == F32 else np.float64
    e, t, k = _EDGES[edge]
    tiny = float(torch.finfo(dtype).tiny)
    if e is None:
        e = 0.9 * tiny * np.exp(-1.5)
    zl = (-60.0 + 0.25 * np.arange(500)).astype(np_t)
    zeta = (0.004 * np.arange(500) - 1.0).astype(np_t)
    dg = np.random.default_rng(5).normal(size=500).astype(np_t)
    if t is None:
        radius = getattr(k5_host, "host_kde3d_skip_radius_"
                         + ("f32" if dtype == F32 else "f64"))
        radius.restype = ctypes.c_float if dtype == F32 else ctypes.c_double
        r = np_t(radius((ctypes.c_float if dtype == F32 else ctypes.c_double)(e)))
        target = r if edge == "radius" else -r
        j0 = int(round((float(target) + 60.0) / (0.25 * k)))
        zl0 = np_t(-60.0 + j0 * k * 0.25)
        t = np_t(target - zl0)
        for _ in range(64):
            if np_t(zl0 + t) == target:
                break
            t = np.nextafter(t, np_t(np.inf) if np_t(zl0 + t) < target else np_t(-np.inf))
        assert np_t(zl0 + t) == target
    got, rng = _pixel_walk(k5_host, dtype, e, t, k, zl, zeta, dg, 1)
    expect, full = _pixel_walk(k5_host, dtype, e, t, k, zl, zeta, dg, 0)
    assert got.tobytes() == expect.tobytes()
    j_n = -(-500 // k) if k else 0
    assert list(full) == [0, j_n - 1]
    if edge in ("radius", "minus_radius"):
        assert rng[0] <= j0 <= rng[1]
    if edge in ("e_2_20", "radius", "minus_radius", "k8", "k16", "k32"):
        assert 0 < rng[1] - rng[0] + 1 < j_n and np.any(got != 0)
    if edge in ("e_inf", "t_nan", "t_inf"):
        assert list(rng) == [0, j_n - 1]
    if edge in ("e_nan", "e_below_flush", "e_zero", "e_negative"):
        assert rng[0] > rng[1] and np.all(got == 0)


def test_k5b_layout_matches_the_wrapper(k5_host):
    """The wrapper's copies of K5b's shared memory and pixels a chunk
    (``kde3d.adjoint_smem``, ``adjoint_chunk``) against the kernel's
    (kde3d.cuh: ``adjoint_layout``, ``adjoint_chunk``), at every chunk
    size; the arrays that the kernel reads in 16-byte loads (the rows, the
    grid twice, the blocks' starts) start on 16-byte boundaries (the host
    emulation keeps them in arrays of their own, so only this shows it)."""
    smem, chunk = k5_host.host_kde3d_adjoint_smem, k5_host.host_kde3d_adjoint_chunk
    smem.restype, chunk.restype = ctypes.c_longlong, ctypes.c_int
    offsets = (ctypes.c_longlong * 4)()
    for g in (1, 5, 64, 500, 3000, 8000):
        for size in (4, 8):
            for p in (1, 13, 15, 64):
                pc = kde3d.adjoint_chunk(p, g, size)
                assert pc == chunk(p, g, size)
                for c in range(1, pc + 1):
                    assert kde3d.adjoint_smem(g, c, size) == smem(g, c, size, offsets)
                    assert all(o % 16 == 0 for o in offsets), (g, size, c, list(offsets))


# ---------------------------------------------------------------------------
# K5's pruned walk against the unpruned walk (host emulation)
# ---------------------------------------------------------------------------

# host_kde3d_tally: what the last call's walk did (kde3d_host.cpp, Tally)
_TALLY = ("pruned_rows", "unpruned_rows", "skipped", "walked_kept",
          "walked_flushed", "skipped_kept", "chains", "empty_chains",
          "band_skipped")


def _host_k5(lib, args, pruned=True):
    """K5's host emulation called directly (``pruned=False``: every sample
    walked, the oracle): the (L, E, P, G) output and the walk's tally."""
    z, w, ra, dec, ra_pix, dec_pix, mask, grids, z_block = args
    n, e, s = z.shape
    p, g = ra_pix.shape[1], grids.shape[1]
    out = torch.empty((n, e, p, g), dtype=z.dtype)
    records = torch.empty((n, e, 16), dtype=F64)
    fn = getattr(lib, "host_kde3d_" + ("" if pruned else "unpruned_")
                 + ("f32" if z.dtype == F32 else "f64"))
    fn.restype = ctypes.c_int
    tensors = [t.contiguous() for t in (z, w, ra, dec, ra_pix, dec_pix, mask,
                                        grids)] + [z_block.to(torch.int32), records, out]
    assert fn(*[ctypes.c_void_p(t.data_ptr()) for t in tensors], n, e, s, p, g,
              0, ctypes.c_double(0.0)) == 0
    tally = (ctypes.c_longlong * len(_TALLY))()
    lib.host_kde3d_tally(tally)
    return out, dict(zip(_TALLY, tally))


def _same_bits(a, b):
    view = torch.int64 if a.element_size() == 8 else torch.int32
    return a.shape == b.shape and torch.equal(a.contiguous().view(view),
                                              b.contiguous().view(view))


# (samples, pixels, grid points, K per event): "wide" K = 16, 13 (not a
# tier) and the dense sweep; "short" K = 32 on a short grid (15 blocks, 8
# slices); "blocks" K = 4 on 150 blocks (a thread a whole block); "overflow"
# K = 8 on 75 blocks x 32 mask words (over kMaskWords: the unpruned walk)
# beside K = 16 on 38 (pruned)
_PRUNED_CASES = {"wide": (500, 6, 400, [16, 13, 0]),
                 "short": (500, 4, 480, [32]),
                 "blocks": (256, 3, 600, [4]),
                 "overflow": (1024, 3, 600, [8, 16])}


def _pruned_case(name, dtype):
    """Two λ of the events of ``_lattice_data`` on z-grids over [-0.4, 1.4]
    (>= 80 bandwidths, so that most (sample, block) refreshes are flushed),
    pixels near the sky mean and 0.1 and 0.2 rad off it (sky factors from
    ~1e-3 down to below the smallest normal); sample 0 without weight and
    sample 1's weight below the smallest normal times the sum (e < the
    smallest normal); in "wide", the second λ's event 0 with two samples of
    weight (no whitening: NaN rows) and event 1's last pixel fake."""
    s, p, g, ks = _PRUNED_CASES[name]
    rng = np.random.default_rng(15)
    data, w, ra_pix, dec_pix, _ = _lattice_data(rng, n_ev=len(ks), s=s, p=p, g=g)
    ra_pix[:, 1] += 0.1
    dec_pix[:, 2] -= 0.2
    grid = np.tile(np.linspace(-0.4, 1.4, g), (len(ks), 1))
    z = np.stack([data[:, 0], data[:, 0] + 0.002 * rng.normal(size=data[:, 0].shape)])
    w2 = np.stack([w, w * rng.uniform(0.5, 1.5, size=w.shape)])
    w2[..., 0] = 0.0
    w2[..., 1] = 1e-3 * float(torch.finfo(dtype).tiny)
    mask = np.ones((len(ks), p), dtype=bool)
    if name == "wide":
        w2[1, 0, 4:] = 0.0
        mask[1, -1] = False
    return (_t(z, dtype), _t(w2, dtype), _t(data[:, 1], dtype), _t(data[:, 2], dtype),
            _t(ra_pix, dtype), _t(dec_pix, dtype), torch.as_tensor(mask),
            _t(grid, dtype), torch.tensor(ks))


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("case", list(_PRUNED_CASES))
def test_k5_pruned_walk_keeps_the_bits(k5_host, case, dtype):
    """K5's pruned walk (skip radii, the band of blocks some sample
    reaches, masks, chains ranked by their set bits, each chain's set bits
    in order) gives the unpruned walk's bits, NaN rows and fake pixels
    included, and skips no refresh that the flush keeps; the wide grids
    span >= 80 bandwidths, the band leaves blocks out, and pairs fall on
    both sides of the flush inside the skip radius."""
    args = _pruned_case(case, dtype)
    got, tally = _host_k5(k5_host, args)
    expect, _ = _host_k5(k5_host, args, pruned=False)
    assert _same_bits(got, expect)
    assert tally["skipped_kept"] == 0 and tally["skipped"] > 0
    assert tally["walked_kept"] > 0 and tally["walked_flushed"] > 0
    assert tally["band_skipped"] > 0
    zz, ww, ra, dec = (a.double() for a in args[:4])
    _, wh, _ = tkde._whitening(torch.stack([zz, ra.expand_as(zz), dec.expand_as(zz)],
                                           dim=-2), ww, None)
    span = wh[..., 0, 0] * 1.8
    assert torch.all((span >= 80) | torch.isnan(span))
    if case == "wide":
        nan_rows = torch.isnan(got).all(dim=-1)
        assert nan_rows[1, 0].all() and nan_rows.sum() == args[4].shape[1]
        assert torch.all(got[:, 1, -1] == 0)
        assert tally["empty_chains"] > 0 and tally["unpruned_rows"] == 0
    elif case == "blocks":
        assert tally["pruned_rows"] > 0 and tally["chains"] == 0
    elif case == "overflow":
        assert tally["pruned_rows"] == tally["unpruned_rows"] == 2 * 3
    else:
        assert tally["empty_chains"] > 0 and tally["unpruned_rows"] == 0


# kde3d.cuh's skip tests loosened: a radius short of the flush by a factor
# e^3 in v (ln(e / m) - 1.5 in place of + 1.5), and a band 3 bandwidths
# narrower on each side
_K5_MUTATIONS = {
    "radius": ("- ln_smallest_normal<T>() + T(1.5);", "+ T(1.5)", "- T(1.5)"),
    "band": ("if (add_rn(zl0, t_max) < -r_max || add_rn(zl0, t_min) > r_max) continue;",
             "-r_max ||", "-r_max + T(3) ||")}


@pytest.fixture(scope="module", params=list(_K5_MUTATIONS))
def k5_loose_host(request, tmp_path_factory):
    """K5's host emulation built against a copy of kde3d.cuh with one skip
    test loosened (_K5_MUTATIONS): it skips refreshes that the flush
    keeps."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host emulation")
    src = tmp_path_factory.mktemp("mutated_kde3d")
    csrc = Path(fused.__file__).parents[2] / "csrc"
    text = (csrc / "kde3d.cuh").read_text()
    old, a, b = _K5_MUTATIONS[request.param]
    assert text.count(old) == 1
    (src / "kde3d.cuh").write_text(text.replace(old, old.replace(a, b)))
    so = src / "libkde3d_loose.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-Wno-unknown-pragmas",
         f"-I{HERE / 'host_emulation'}", f"-I{src}", "-o", str(so),
         str(HERE / "host_emulation" / "kde3d_host.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(so))


@pytest.mark.parametrize("dtype", [F64, F32])
def test_k5_wide_case_catches_a_loose_skip(k5_loose_host, dtype):
    """A skip radius short of the flush, or a band narrower than the
    samples' reach, skips refreshes that the flush keeps, and the wide
    case's outputs then differ from the unpruned walk's: the test above
    can fail."""
    args = _pruned_case("wide", dtype)
    got, tally = _host_k5(k5_loose_host, args)
    expect, _ = _host_k5(k5_loose_host, args, pruned=False)
    assert tally["skipped_kept"] > 0
    assert not _same_bits(got, expect)


# ---------------------------------------------------------------------------
# the recurrence plan
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def outlier_fixture():
    """tests/test_ops.py::test_full_kind_buckets_match_dense's recipe, drawn
    by the port's generator: 16 events x 256 samples (sigma_sky 0.03 rad,
    oversample 300), event 3's dL spread shrunk 20x (a narrow outlier),
    nside 8, 4 pixels asked, 256-point grids (H0 prior [40, 120]); as numpy
    arrays (z at the fiducial cosmology, ra, dec, the grids), with the JAX
    'full' object built on the same arrays."""
    from chimera_tpu_torch.data.mock import make_mock_catalog
    from chimera_tpu_torch.data.pixelize import pixelize_gw_catalog
    from chimera_tpu_torch.models import compute_z_grids, theta_det_to_src

    pop = chip_smoke.population(F64, None, torch.device("cpu"))
    cat = make_mock_catalog(torch.Generator().manual_seed(9), pop, n_events=16,
                            n_samples=256, snr_threshold=12.0,
                            sigma_sky_rad=0.03, oversample=300)
    dl = cat.dL.clone()
    dl[3] = dl[3].mean() + 0.05 * (dl[3] - dl[3].mean())
    cat = pixelize_gw_catalog(cat.update(dL=dl), nside_list=[8],
                              mean_npixels_event=4, sky_conf=0.9)
    z_grids = compute_z_grids(pop.cosmo, cat, cosmo_prior={"H0": [40.0, 120.0]},
                              z_int_res=256)
    # the plan needs no injections
    jhl = _jax_full((cat, z_grids, None, None, None), True)
    z = theta_det_to_src(pop.cosmo, cat).z[0].numpy()
    return (z, cat.ra.numpy(), cat.dec.numpy(), z_grids.numpy()), jhl


def test_plan_matches_a_numpy_recomputation(outlier_fixture):
    """Each event's K: inv(cov)_00 as the inverse of the Schur complement
    of the sky block, the factor at n_eff = S, the tier below
    floor(5.5 / h) capped at 32; the outlier dense; never below the JAX
    object's K (which only demotes tiers to multiples of 8 events), and
    ``from_state`` carries the JAX object's K."""
    (z, ra, dec, zg), jhl = outlier_fixture
    k, outcome = z_recurrence_plan(z, ra, dec, zg, None)
    data = np.stack([z, ra, dec], axis=1)
    data = data - data.mean(axis=-1, keepdims=True)
    cov = np.einsum("eis,ejs->eij", data, data) / (z.shape[1] - 1)
    schur = cov[:, 0, 0] - np.einsum("ei,eij,ej->e", cov[:, 0, 1:],
                                     np.linalg.inv(cov[:, 1:, 1:]), cov[:, 0, 1:])
    factor = z.shape[1] ** (-1.0 / 7.0)
    h = (zg[:, -1] - zg[:, 0]) / (zg.shape[1] - 1) / (np.sqrt(schur) * factor)
    safe = np.floor(5.5 / h)
    expect = np.where(safe >= 32, 32, np.where(safe >= 16, 16,
                                               np.where(safe >= 8, 8, 0)))
    np.testing.assert_array_equal(k, expect)
    assert k[3] == 0 and (k > 0).sum() >= 8, (k, outcome)
    assert np.all(k * h <= 5.5 + 1e-9)
    k_jax = convert.state_from_reference(jhl)["z_block"]
    assert np.all(k_jax <= k) and np.any(k_jax > 0)


# ---------------------------------------------------------------------------
# log L on the dark precision mock
# ---------------------------------------------------------------------------

def _jax_full(port_data, empty: bool, **cosmo_config):
    """The JAX 'full' object on the port mock's arrays (binning=False:
    events and samples are already multiples of 8 and 128), without a
    selection function where the data has no injections; ``cosmo_config``
    goes to ``FLRW.create``."""
    from chimera_tpu import HyperLikelihood as JHL
    from chimera_tpu import SelectionFunction as JSel
    from chimera_tpu.catalog import DVdzCompleteness
    from chimera_tpu.catalog import EmptyCatalog as JEmpty
    from chimera_tpu.catalog.pixelated import PixelatedCatalog
    from chimera_tpu.data.structs import ThetaInjDet, ThetaPEDet
    from chimera_tpu.models import (FLRW, MadauDickinsonRate, Population,
                                    PowerLawPeak)

    cat, z_grids, gal_cat, inj, n_gen = port_data
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    theta = ThetaPEDet(**{f: j(getattr(cat, f)) for f in (
        "m1det", "m2det", "dL", "pe_prior", "ra", "dec", "opt_nsides",
        "pixels_opt_nsides", "ra_pix", "dec_pix", "gw_loc2d_pdf",
        "pixels_pe_opt_nside", "pixel_mask")})
    jgc = JEmpty() if empty else PixelatedCatalog(
        p_cat=j(gal_cat.p_cat), P_compl=j(gal_cat.P_compl),
        pixel_mask=j(gal_cat.pixel_mask), n_gal=j(gal_cat.n_gal),
        completeness=DVdzCompleteness.create(z_range=(0.0, 3.0), kind="step"))
    pop = Population.create(FLRW.create(H0=70.0, Om0=0.25, **cosmo_config),
                            PowerLawPeak.create(),
                            MadauDickinsonRate.create(), gal_cat=jgc)
    sel = None if inj is None else JSel.create(
        ThetaInjDet(**{f: j(getattr(inj, f)) for f in
                       ("m1det", "m2det", "dL", "p_draw")}), n_gen)
    return JHL.create(theta, j(z_grids), pop, sel, kind="full", binning=False)


@pytest.fixture(scope="module")
def dark_cases():
    """Per catalog (pixelated, empty): the JAX object and its log L at H0S."""
    port_data = chip_smoke.parity_dark_mock(torch.device("cpu"))
    out = {}
    for name in ("pixelated", "empty"):
        jhl = _jax_full(port_data, name == "empty")
        ll = np.asarray(jhl.log_like_batch({"H0": jnp.asarray(H0S)}))
        assert np.all(np.isfinite(ll))
        out[name] = (jhl, ll)
    return port_data, out


def _port_create(port_data, empty: bool):
    cat, z_grids, gal_cat, inj, n_gen = port_data
    pop = chip_smoke.population(F64, None if empty else gal_cat,
                                torch.device("cpu"))
    if empty:
        pop = type(pop).create(pop.cosmo, pop.mass, pop.rate, gal_cat=EmptyCatalog())
    return HyperLikelihood.create(cat, z_grids, pop,
                                  SelectionFunction.create(inj, n_gen),
                                  kind="full", kernel="epan")


@pytest.mark.parametrize("name", ["pixelated", "empty"])
def test_from_state_matches_reference(dark_cases, name):
    """The JAX object's plan (8 events at K = 8, 8 dense) carried by
    ``from_state``: log L within 1e-10, relative."""
    _, cases = dark_cases
    jhl, expect = cases[name]
    hl = HyperLikelihood.from_state(convert.state_from_reference(jhl), "cpu",
                                    F64)
    assert hl.kernel == "gauss" and hl.kind == "full"
    assert sorted(hl.z_block.tolist()) == [0] * 8 + [8] * 8
    got = hl.log_like_batch({"H0": torch.as_tensor(H0S)}).numpy()
    np.testing.assert_allclose(got, expect, rtol=1e-10, atol=0)


@pytest.mark.parametrize("name", ["pixelated", "empty"])
def test_create_matches_reference_create(dark_cases, name):
    """The port's own ``create`` (its plan, 'epan' asked and the Gaussian
    kernel taken) against the JAX package's ``create``: within 5e-9, the
    bar at which tests/test_ops.py holds the recurrence to the dense
    sweep."""
    port_data, cases = dark_cases
    hl = _port_create(port_data, name == "empty")
    assert hl.kernel == "gauss" and np.any(hl.z_block.numpy() > 0)
    got = hl.log_like_batch({"H0": torch.as_tensor(H0S)}).numpy()
    np.testing.assert_allclose(got, cases[name][1], rtol=5e-9, atol=0)


@pytest.fixture(scope="module")
def full_gradient(dark_cases):
    """d log L / d(H0, Om0) by ``jax.grad`` of the JAX object (empty
    catalog, two λ) and the port's ``from_state`` of it, float64.  The
    gradient's compile is most of this file's time whatever the data's
    size: its cosmology's Chebyshev series are unrolled, so they are of
    degree 16 here (the same in the port, which ``from_state`` carries),
    and the JAX object is an argument of the jitted gradient, not a
    constant of it."""
    from chimera_tpu.likelihood import log_hyperlikelihood_batch

    port_data, _ = dark_cases
    jhl = _jax_full(port_data, True, cheb_deg=16)
    h0, om0 = np.array([65.0, 75.0]), np.array([0.25, 0.3])
    expect = jax.jit(jax.grad(lambda m, h, o: jnp.sum(log_hyperlikelihood_batch(
        m, {"H0": h, "Om0": o})), argnums=(1, 2)))(jhl, jnp.asarray(h0),
                                                  jnp.asarray(om0))
    hl = HyperLikelihood.from_state(convert.state_from_reference(jhl), "cpu", F64)
    return hl, (h0, om0), [np.asarray(e) for e in expect]


def _port_gradient(hl, points):
    h, o = (_t(x).requires_grad_() for x in points)
    return torch.autograd.grad(hl.log_like_batch({"H0": h, "Om0": o}).sum(), (h, o))


def _hold_gradient(got, expect):
    for g, e in zip(got, expect):
        assert np.all(np.isfinite(e))
        np.testing.assert_allclose(g.numpy(), e, rtol=0, atol=1e-9 * np.abs(e).max())


def test_gradient_matches_jax_grad(full_gradient):
    """d log L / d(H0, Om0) on the CPU (autograd through the plain
    version) against ``jax.grad`` of the JAX object, empty catalog, two λ:
    within 1e-9 relative of each parameter's largest."""
    hl, points, expect = full_gradient
    _hold_gradient(_port_gradient(hl, points), expect)


def test_emulated_card_gradient_matches_jax_grad(k5_host, full_gradient,
                                                 monkeypatch):
    """The same gradient through ``lattice_kde3d``'s CUDA branch on CPU
    tensors, K5 and K5b the host emulations (one launch each) and the
    chain through the float64 record: within 1e-9 of ``jax.grad``, relative
    to each parameter's largest."""
    hl, points, expect = full_gradient
    _emulate_k5(monkeypatch, k5_host)
    before = launch_counts()
    got = _port_gradient(hl, points)
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == \
        {k: int(k in ("K5", "K5b")) for k in after}
    _hold_gradient(got, expect)


def test_emulated_card_full_batch(k5_host, dark_cases, monkeypatch):
    """The pixelated case through ``lattice_kde3d``'s CUDA branch on CPU
    tensors with K5's host emulation as the launch: one K5 launch a batch,
    log L within 1e-10 of the plain version's; with tensors that require
    grad one K5 and one K5b launch, d log L / dH0 within 1e-9 of autograd
    through the plain version."""
    port_data, _ = dark_cases
    hl = _port_create(port_data, False)
    h0 = torch.as_tensor(H0S)
    expect = hl.log_like_batch({"H0": h0})
    x = h0.clone().requires_grad_()
    g_plain = torch.autograd.grad(hl.log_like_batch({"H0": x}).sum(), x)[0]
    _emulate_k5(monkeypatch, k5_host)
    before = launch_counts()
    got = hl.log_like_batch({"H0": h0})
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == \
        {k: int(k == "K5") for k in after}
    np.testing.assert_allclose(got.numpy(), expect.numpy(), rtol=1e-10, atol=0)
    before = launch_counts()
    g_card = torch.autograd.grad(hl.log_like_batch({"H0": x}).sum(), x)[0]
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == \
        {k: int(k in ("K5", "K5b")) for k in after}
    assert torch.all(torch.isfinite(g_plain))
    np.testing.assert_allclose(g_card.numpy(), g_plain.numpy(), rtol=0,
                               atol=1e-9 * g_plain.abs().max().item())


from chimera_tpu.ops import kde as jkde  # noqa: E402
