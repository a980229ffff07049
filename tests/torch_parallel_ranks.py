"""The ranks of ``tests/test_torch_parallel.py``'s multi-process test: each
imports no JAX, rebuilds the likelihoods from the states the test wrote
(``convert.state_from_reference`` of the JAX objects, as ``.npz``), shards
them over a (params x data) mesh of CPU ranks and evaluates a λ batch,
then takes the dry run's ensemble step (``entry.dryrun_step``); and two
ranks that fail, one by raising, one by outlasting its run."""

import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from chimera_tpu_torch import HyperLikelihood
from chimera_tpu_torch.entry import dryrun_step
from chimera_tpu_torch.parallel import (log_like_batch_sharded, make_mesh,
                                        shard_hyperlikelihood)


def sharded_from_states(states: dict, h0s: list, params: int) -> dict:
    """{name: log L (L,)} of each state's sharded likelihood at the H0
    values ``h0s``, the dry run's states under "dryrun", and whether JAX
    was imported."""
    mesh = make_mesh(params=params, devices="cpu")
    out = {}
    for name, path in states.items():
        hl = HyperLikelihood.from_state(dict(np.load(path)), "cpu", torch.float64)
        shard = shard_hyperlikelihood(hl, mesh)
        out[name] = log_like_batch_sharded(shard, {"H0": h0s}, mesh)
    out["dryrun"] = dryrun_step(params, "cpu")
    out["jax_imported"] = "jax" in sys.modules
    return out


def fails(how: str) -> int:
    """Rank 1 raises ("raises") or sleeps past the run's timeout
    ("outlasts"); the other ranks wait for it at a barrier."""
    if dist.get_rank() == 1:
        if how == "raises":
            raise ValueError("rank 1 fails on purpose")
        time.sleep(120.0)
    dist.barrier()
    return dist.get_rank()
