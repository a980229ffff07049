"""Entry points of the port: a one-card check and a multi-rank dry run
(counterpart of ``__graft_entry__.py``).

``entry()`` returns the batched hyper-likelihood forward on a tiny
spectral-siren setup (mock data, PowerLawPeak + Madau-Dickinson) and its
example arguments, on the card.

``dryrun_multichip(n)`` starts n ranks of one gloo process group (on the
card, which they share, or on the CPU when asked), lays them out as a
(params x data) grid, shards events, injections and walkers over it, and
takes ONE affine-invariant ensemble step over the sharded hyper-likelihood
on two tiny setups: the spectral siren and the pixelated dark siren
'marginalized' (the design point of the reference's MPI 'data' scheme).

    python -m chimera_tpu_torch.entry [--device cpu] [--ranks N]

The mock data are drawn on the CPU in float64, so every rank draws the
same; the likelihood is built on the rank's device.
"""

from __future__ import annotations

import argparse

import torch

from chimera_tpu_torch.config import default_dtype, resolve_device

NAMES = ["H0", "Om0"]
BOUNDS = {"H0": (40.0, 120.0), "Om0": (0.05, 0.95)}


def _population(device, dtype, gal_cat=None):
    from chimera_tpu_torch.models import (FLRW, MadauDickinsonRate, Population,
                                          PowerLawPeak)

    return Population.create(
        FLRW.create(H0=70.0, Om0=0.25, device=device, dtype=dtype),
        PowerLawPeak.create(device=device, dtype=dtype),
        MadauDickinsonRate.create(device=device, dtype=dtype), gal_cat=gal_cat)


def _build_setup(device):
    """The tiny spectral-siren likelihood (``__graft_entry__.py:19-41``: 8
    events x 128 samples, 20 000 generated injections, 64-point grids),
    unbinned on the analysis grids: K1a on the card."""
    from chimera_tpu_torch import HyperLikelihood, SelectionFunction
    from chimera_tpu_torch.data.mock import make_mock_catalog, make_mock_injections
    from chimera_tpu_torch.models import compute_z_grids

    cpu = torch.device("cpu")
    pop = _population(cpu, torch.float64)
    gen = torch.Generator(device=cpu).manual_seed(42)
    cat = make_mock_catalog(gen, pop, n_events=8, n_samples=128,
                            snr_threshold=12.0)
    inj, n_gen = make_mock_injections(gen, pop, n_generated=20_000,
                                      snr_threshold=12.0)
    z_grids = compute_z_grids(pop.cosmo, cat, cosmo_prior={"H0": [40.0, 120.0]},
                              z_int_res=64)
    device = torch.device(device)
    return HyperLikelihood.create(
        cat, z_grids, _population(device, default_dtype(device)),
        SelectionFunction.create(inj, n_gen), binning=False, cut_grid=None)


def _build_dark_setup(device):
    """The tiny pixelated dark-siren 'marginalized' likelihood
    (``__graft_entry__.py:44-84``: 8 events x 128 samples, nside {8, 16},
    3 000 background galaxies, 8 000 generated injections, 48-point grids)
    on the chunk rows: K1c + K2 on the card."""
    from chimera_tpu_torch import HyperLikelihood, SelectionFunction
    from chimera_tpu_torch.catalog import DVdzCompleteness
    from chimera_tpu_torch.catalog.build import build_pixelated_catalog
    from chimera_tpu_torch.data.mock import (make_mock_catalog,
                                             make_mock_galaxies,
                                             make_mock_injections)
    from chimera_tpu_torch.data.pixelize import pixelize_gw_catalog
    from chimera_tpu_torch.models import compute_z_grids

    cpu = torch.device("cpu")
    pop = _population(cpu, torch.float64)
    gen = torch.Generator(device=cpu).manual_seed(5)
    cat, truths = make_mock_catalog(gen, pop, n_events=8,
                                    n_samples=128, snr_threshold=14.0,
                                    sigma_sky_rad=0.03, oversample=400,
                                    return_truths=True)
    cat = pixelize_gw_catalog(cat, nside_list=[8, 16], mean_npixels_event=4,
                              sky_conf=0.9)
    z_grids = compute_z_grids(pop.cosmo, cat, cosmo_prior={"H0": [40.0, 120.0]},
                              z_int_res=48)
    gals = make_mock_galaxies(gen, pop, truths, n_background=3000)
    compl = DVdzCompleteness.create(z_range=(0.0, 3.0), kind="step",
                                    device=cpu, dtype=torch.float64)
    gal_cat = build_pixelated_catalog(gals, cat, z_grids, pop.cosmo, compl,
                                      z_err=0.01)
    inj, n_gen = make_mock_injections(gen, pop, n_generated=8_000,
                                      snr_threshold=14.0)
    device = torch.device(device)
    return HyperLikelihood.create(
        cat, z_grids, _population(device, default_dtype(device), gal_cat),
        SelectionFunction.create(inj, n_gen), kind="marginalized",
        binning=False, cut_grid=None)


def entry(device=None):
    """(fn, example_args): the batched hyper-likelihood forward on the card
    (or ``device``), fn(H0 values) -> log L per value."""
    device = resolve_device(device)
    hl = _build_setup(device)

    def fn(h0_batch):
        return hl.log_like_batch({"H0": h0_batch})

    return fn, (torch.linspace(60.0, 80.0, 4, dtype=default_dtype(device),
                               device=device),)


def dryrun_step(params: int, device: str) -> dict:
    """One rank's part of the dry run, inside a process group: for each
    setup, one ensemble step of 4 x world walkers over a (params x data)
    mesh, the walkers and the generator the same on every rank.  Returns
    {setup: {"coords", "log_prob", "iteration"}} on the CPU."""
    import torch.distributed as dist

    from chimera_tpu_torch.inference import (init_state, initialize_walkers,
                                             make_vector_log_prob, step)
    from chimera_tpu_torch.parallel import make_mesh, shard_hyperlikelihood

    mesh = make_mesh(params=params, devices=device)
    out = {}
    for seed, (name, build) in enumerate((("spectral", _build_setup),
                                          ("dark", _build_dark_setup))):
        hl = shard_hyperlikelihood(build(mesh.device), mesh)
        logp = make_vector_log_prob(hl, NAMES, BOUNDS)
        gen = torch.Generator(device=mesh.device).manual_seed(seed)
        walkers = initialize_walkers(gen, {"H0": 70.0, "Om0": 0.25},
                                     4 * dist.get_world_size(), NAMES,
                                     scale={"H0": 5.0, "Om0": 0.02},
                                     bounds=BOUNDS,
                                     dtype=hl.population.cosmo.H0.dtype)
        state = step(gen, init_state(walkers, logp), logp)
        if not bool(torch.all(torch.isfinite(state.log_prob))):
            raise AssertionError(f"non-finite {name} log-prob in the dry run")
        if state.iteration != 1:
            raise AssertionError(f"{name}: iteration {state.iteration}, not 1")
        out[name] = {"coords": state.coords.cpu(),
                     "log_prob": state.log_prob.cpu(),
                     "iteration": state.iteration}
    return out


def check_same_state(states: list[dict]) -> None:
    """Every rank's walkers and log-probs the same bits at iteration 1
    (``dryrun_step`` held each rank's finite)."""
    for rank, s in enumerate(states[1:], 1):
        for name, got in s.items():
            ref = states[0][name]
            if not (torch.equal(got["coords"], ref["coords"])
                    and torch.equal(got["log_prob"], ref["log_prob"])
                    and got["iteration"] == ref["iteration"] == 1):
                raise AssertionError(f"{name}: rank {rank}'s state is not rank 0's")


def dryrun_multichip(n_devices: int, device=None) -> list[dict]:
    """One sharded ensemble step over a (2 x n/2) mesh, 1 x n for odd n, on
    the spectral and dark setups, in n gloo ranks sharing the card
    ("cuda:0", raising without one) or on ``device`` ("cpu").  Raises
    unless every rank ends with the same finite state at iteration 1;
    returns the ranks' states.  A rank that fails or runs past 300 s
    fails the run."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for CPU ranks")
    params = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    from chimera_tpu_torch.parallel.spawn import run_ranks

    states = run_ranks("chimera_tpu_torch.entry:dryrun_step", n_devices,
                       {"params": params, "device": str(device or "cuda:0")},
                       timeout=300.0)
    check_same_state(states)
    return states


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for CPU ranks; default: the card")
    ap.add_argument("--ranks", type=int, default=8)
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    print("entry:", fn(*example).tolist(), flush=True)
    dryrun_multichip(args.ranks, args.device)
    print(f"dryrun_multichip({args.ranks}) OK", flush=True)


if __name__ == "__main__":
    main()
