"""The port's distribution layer (``chimera_tpu_torch/parallel``) on the
CPU: padding leaves log L unchanged, the partial sums of every shard of a
cut finish to the unsharded batch on every kind and layout, a 2 x 2 grid of
four gloo ranks that import no JAX matches the JAX package's sharded batch
on its 8 virtual CPU devices, the sharded batch refuses a gradient and
an uneven λ split, a hybrid grid keeps each data group inside one node,
and a params rank's sums are taken at its rows' place in the batch.

Data: the port's spectral mock (13 events x 256 samples, drawn on the
CPU) and 13 events of the repo's dark-siren precision mock
(``tests/data/f32_parity_dark.npz``), uneven against a data size of 3 so
that padding is exercised; for the JAX comparison 9 spectral events x 128
samples and 7 dark events, as the JAX package's structures."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import chip_smoke
from chimera_tpu import HyperLikelihood as JHL
from chimera_tpu.parallel import (log_like_batch_sharded as jax_sharded,
                                  make_mesh as jax_mesh,
                                  shard_hyperlikelihood as jax_shard)
from chimera_tpu_torch.convert import state_from_reference
from chimera_tpu_torch.entry import check_same_state
from chimera_tpu_torch.parallel import (Mesh, log_like_batch_sharded,
                                        make_mesh, pad_events, pad_injections,
                                        shard_hyperlikelihood)
from chimera_tpu_torch.pytree import batch_sum
from chimera_tpu_torch.parallel.spawn import run_ranks

CPU, F64 = torch.device("cpu"), torch.float64
H0S = torch.tensor([62.0, 70.0, 79.0], dtype=F64)
# (data, kind or None for the contract path, create's keywords)
CONFIGS = {
    "1d": ("spectral", dict(binning=False, cut_grid=None)),
    "1d_binned": ("spectral", dict(binning=True, num_bins=100, cut_grid=2.0)),
    "approximate": ("dark", dict(kind="approximate", binning=False, cut_grid=2.0)),
    "marginalized_rows": ("dark", dict(kind="marginalized", binning=False,
                                       cut_grid=None)),
    "marginalized_contract": ("dark", None),
    "marginalized_cut_grid": ("dark", dict(kind="marginalized", binning=False,
                                           cut_grid=2.0)),
    "marginalized_binned": ("dark", dict(kind="marginalized", binning=True,
                                         num_bins=100, cut_grid=2.0)),
    "full": ("dark", dict(kind="full", cut_grid=2.0)),
}


@pytest.fixture(scope="module")
def data():
    return {"spectral": chip_smoke.mock(13, 256, 20_000, 64, 300, 42, device=CPU),
            "dark": chip_smoke.cut_dark_events(chip_smoke.parity_dark_mock(CPU), 13)}


def _likelihood(data, name):
    which, cfg = CONFIGS[name]
    if which == "spectral":
        return chip_smoke.likelihood(data[which], F64, **cfg)
    if cfg is None:
        return chip_smoke.contract_likelihood(data[which], F64)
    return chip_smoke.dark_likelihood(data[which], F64, **cfg)


def _rel(got, expect):
    assert torch.all(torch.isfinite(expect))
    return float(((got - expect).abs() / expect.abs()).max())


@pytest.mark.parametrize("name", ["1d", "marginalized_rows", "full"])
def test_padding_leaves_log_like_unchanged(data, name):
    """13 events padded to 15 (two copies of the last, masked out) and the
    injections to a multiple of 7 (zero-rate rows): log L, the real-event
    count and compute_all's decomposition unchanged."""
    hl = _likelihood(data, name)
    expect = hl.log_like_batch({"H0": H0S})
    padded = pad_events(hl, 5)
    padded.selection = pad_injections(hl.selection, 7)
    assert padded.n_events == 15 and padded.n_events_real == 13
    assert padded.selection.dL.shape[0] % 7 == 0
    assert _rel(padded.log_like_batch({"H0": H0S}), expect) <= 1e-12
    got, want = padded.compute_all(H0=70.0), hl.compute_all(H0=70.0)
    assert got[0].shape == want[0].shape
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-12


@pytest.mark.parametrize("name", list(CONFIGS))
def test_shard_partial_sums_finish_to_the_batch(data, name):
    """Each shard of a data = 3 cut (13 events: 5 + 5 + 3 real, 2 padding;
    its third of the injections), cut in one process with no process
    group: the shards' partial sums, added and finished, give the
    unsharded batch; each shard holds only its events."""
    hl = _likelihood(data, name)
    expect = hl.log_like_batch({"H0": H0S})
    shards = [shard_hyperlikelihood(hl, Mesh(1, 3, d, CPU)) for d in range(3)]
    assert [s.local.n_events for s in shards] == [5, 5, 5]
    assert [s.local.n_events_real for s in shards] == [5, 5, 3]
    assert all(s.n_events_real == 13 for s in shards)
    pops = [s.population.update_batch({"H0": H0S}) for s in shards]
    sums = sum(s.partial_sums(p) for s, p in zip(shards, pops))
    assert _rel(shards[0].finish(pops[0], sums), expect) <= 1e-12


@pytest.mark.parametrize("case", ["requires_grad", "uneven_batch"])
def test_sharded_batch_refuses(data, case):
    """A tensor that requires grad raises (no gradient through the
    all-reduces), and so does a batch not divisible by the params size."""
    hl = _likelihood(data, "1d")
    if case == "requires_grad":
        mesh = Mesh(1, 1, 0, CPU)
        h0 = H0S.clone().requires_grad_()
        with pytest.raises(NotImplementedError, match="item 18"):
            log_like_batch_sharded(shard_hyperlikelihood(hl, mesh), {"H0": h0}, mesh)
        with torch.no_grad():
            got = log_like_batch_sharded(shard_hyperlikelihood(hl, mesh),
                                         {"H0": h0}, mesh)
        assert torch.equal(got, hl.log_like_batch({"H0": H0S}))
    else:
        mesh = Mesh(2, 1, 0, CPU)
        with pytest.raises(ValueError, match="not divisible by params=2"):
            log_like_batch_sharded(shard_hyperlikelihood(hl, mesh), {"H0": H0S}, mesh)


@pytest.mark.parametrize("local_world,params,ok", [
    (4, 2, True), (4, 4, True), (8, 1, True), (4, 1, False), (2, 2, False)])
def test_hybrid_mesh_keeps_data_groups_in_a_node(monkeypatch, local_world,
                                                 params, ok):
    """8 ranks in nodes of ``local_world`` (``LOCAL_WORLD_SIZE``; the
    process group stubbed, ``new_group`` returning its ranks): hybrid=True
    takes a params size divisible by the node count, and then every data
    group of rank 5 lies in one node; it raises otherwise."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_world))
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 8)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 5)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    monkeypatch.setattr(dist, "new_group", lambda ranks, **kw: tuple(ranks))
    if not ok:
        with pytest.raises(ValueError, match="divisible by the node count"):
            make_mesh(params=params, devices="cpu", hybrid=True)
        return
    mesh = make_mesh(params=params, devices="cpu", hybrid=True)
    assert (mesh.params, mesh.data) == (params, 8 // params)
    assert 5 in mesh.data_group and len(mesh.data_group) == mesh.data
    assert len({r // local_world for r in mesh.data_group}) == 1
    assert 5 in mesh.params_group and len(mesh.params_group) == params


@pytest.mark.parametrize("start", [0, 4, 8])
def test_batch_sum_takes_rows_at_their_place(start):
    """A params rank's sums: rows start .. start + 4 of a 12-row batch,
    summed at their place, are the whole batch's sums of those rows bit
    for bit (on the card a sum over the 4 rows alone may differ in its last
    bits, ``test_torch_cuda.py::test_batch_sum_keeps_the_whole_batch_bits``);
    no place is a plain sum."""
    x = torch.from_numpy(np.random.default_rng(start).standard_normal(
        (12, 3, 1001)).astype(np.float32))
    rows = slice(start, start + 4)
    assert torch.equal(batch_sum(x[rows], (12, start)), torch.sum(x, -1)[rows])
    assert torch.equal(batch_sum(x[rows]), torch.sum(x[rows], -1))


@pytest.mark.parametrize("how,match", [
    ("raises", "rank 1 fails on purpose"), ("outlasts", "still ran after 6 s")])
def test_a_failed_rank_fails_the_run(how, match):
    """run_ranks raises when a rank raises (with that rank's traceback) or
    outlasts the run's timeout, and leaves no rank running.  A raising rank
    ends the run at once, so its run's timeout is one that the ranks' start
    (their imports, under a loaded machine) cannot reach."""
    import multiprocessing

    timeout = 120.0 if how == "raises" else 6.0
    with pytest.raises(RuntimeError, match=match):
        run_ranks("torch_parallel_ranks:fails", 3, {"how": how}, timeout=timeout)
    assert not multiprocessing.active_children()


def _jax_setups(n_spectral=9, n_dark=7) -> dict:
    """The JAX package's likelihoods (XLA engine) on the port's spectral
    mock (``n_spectral`` events x 128 samples, 64-point grids; unbinned on
    the analysis grids) and on the first ``n_dark`` events of the dark
    precision mock ('marginalized' on the chunk rows), one population of
    degree-16 series for both (the JAX package's compiles stay short)."""
    import jax.numpy as jnp

    from chimera_tpu import SelectionFunction, pytree
    from chimera_tpu.catalog import DVdzCompleteness, EmptyCatalog
    from chimera_tpu.catalog.pixelated import PixelatedCatalog
    from chimera_tpu.data.structs import ThetaInjDet, ThetaPEDet
    from chimera_tpu.models import FLRW, MadauDickinsonRate, Population, PowerLawPeak

    def j(t):
        return jnp.asarray(t.numpy())

    def selection(inj, n_gen):
        return SelectionFunction.create(ThetaInjDet(**{
            f: j(getattr(inj, f)) for f in ("m1det", "m2det", "dL", "p_draw")}),
            float(n_gen))

    pop = Population.create(FLRW.create(H0=70.0, Om0=0.25, cheb_deg=16),
                            PowerLawPeak.create(window_deg=16, grid_res=300),
                            MadauDickinsonRate.create(), gal_cat=EmptyCatalog())
    cat, inj, n_gen, z_grids = chip_smoke.mock(n_spectral, 128, 20_000, 64, 300,
                                               42, device=CPU)
    theta = ThetaPEDet(**{f: j(getattr(cat, f)) for f in
                          ("m1det", "m2det", "dL", "pe_prior")})
    out = {"spectral": JHL.create(theta, j(z_grids), pop, selection(inj, n_gen),
                                  binning=False, cut_grid=None, kde_engine="xla")}
    cat, z_grids, gal_cat, inj, n_gen = chip_smoke.cut_dark_events(
        chip_smoke.parity_dark_mock(CPU), n_dark)
    theta = ThetaPEDet(**{f: j(getattr(cat, f)) for f in (
        "m1det", "m2det", "dL", "pe_prior", "ra", "dec", "opt_nsides",
        "pixels_opt_nsides", "ra_pix", "dec_pix", "gw_loc2d_pdf",
        "pixels_pe_opt_nside", "pixel_mask")})
    jgc = PixelatedCatalog(
        p_cat=j(gal_cat.p_cat), P_compl=j(gal_cat.P_compl),
        pixel_mask=j(gal_cat.pixel_mask), n_gal=j(gal_cat.n_gal),
        completeness=DVdzCompleteness.create(z_range=(0.0, 3.0), kind="step"))
    out["dark"] = JHL.create(theta, j(z_grids), pytree.replace(pop, gal_cat=jgc),
                             selection(inj, n_gen), kind="marginalized",
                             binning=False, cut_grid=None, kde_engine="xla")
    return out


def test_four_gloo_ranks_match_the_jax_mesh(tmp_path):
    """Four CPU ranks of one gloo group on a 2 x 2 grid, importing no JAX,
    rebuild the spectral and dark 'marginalized' likelihoods from the JAX
    objects' states, shard them and evaluate 4 H0 values: every rank
    returns the same bits, within 1e-9 of the JAX package's
    log_like_batch_sharded on its 2 x 4 mesh of virtual CPU devices; then
    the same ranks take the dry run's ensemble step and end equal."""
    import jax.numpy as jnp

    jhls = _jax_setups()
    h0s = [55.0, 66.0, 74.0, 90.0]
    mesh = jax_mesh(params=2, data=4)
    expect, paths = {}, {}
    for name, jhl in jhls.items():
        expect[name] = np.asarray(jax_sharded(jax_shard(jhl, mesh),
                                              {"H0": jnp.asarray(h0s)}, mesh))
        assert np.all(np.isfinite(expect[name]))
        paths[name] = str(tmp_path / f"{name}.npz")
        np.savez(paths[name], **state_from_reference(jhl))
    ranks = run_ranks("torch_parallel_ranks:sharded_from_states", 4,
                      {"states": paths, "h0s": h0s, "params": 2}, timeout=240.0)
    assert not any(r["jax_imported"] for r in ranks)
    for name in jhls:
        got = [r[name] for r in ranks]
        assert all(torch.equal(g, got[0]) for g in got)
        np.testing.assert_allclose(got[0].numpy(), expect[name], rtol=1e-9)
    check_same_state([r["dryrun"] for r in ranks])
