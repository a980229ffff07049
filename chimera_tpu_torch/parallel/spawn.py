"""Run a function as the ranks of one gloo process group on this host, each
rank a process of its own, for the multi-process checks: the dry run
(``chimera_tpu_torch.entry.dryrun_multichip``), the on-card phase of
``chip_smoke.py`` and the CPU tests.  ``torchrun`` is the way to run the
port itself on several cards.

    run_ranks("package.module:function", n, {"arg": value})

The ranks start through ``torch.multiprocessing.start_processes`` and join
through a ``FileStore`` in a temporary directory (no port to collide with
another run), with a timeout on the rendezvous and on every collective.
Each calls ``function(**kwargs)`` and saves its return value (tensors,
numbers, strings and containers of them) with ``torch.save``.  They use
gloo: NCCL refuses two ranks on one card, and gloo all-reduces CUDA
tensors as well as CPU ones.
"""

from __future__ import annotations

import importlib
import os
import pickle
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException, ProcessExitedException

from chimera_tpu_torch.parallel.mesh import init_distributed


def run_ranks(target: str, n: int, kwargs: dict | None = None,
              timeout: float = 600.0) -> list:
    """Run ``target`` ("module:function") as ranks 0..n-1 of one gloo
    process group and return each rank's return value, in rank order.  The
    ranks see ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` as under ``torchrun``, one thread a rank unless
    ``OMP_NUM_THREADS`` is set, and this process's import path (and
    re-import this process's main script, as every spawned process does).
    If a rank fails, the others are stopped and this raises with the
    traceback of every rank that raised; if the run outlasts ``timeout``
    seconds, every rank still running is killed and this raises."""
    with tempfile.TemporaryDirectory(prefix="chimera_ranks_") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(target, tmp, n, kwargs or {}, timeout), nprocs=n,
            join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise RuntimeError(
                        f"{target}: a rank of {n} still ran after {timeout:.0f} s")
        except ProcessException as e:
            # every rank that raised, not only the first one joined: a rank
            # that fails breaks the collectives of the others
            raised = "".join(f"\n-- rank {r}:\n{_traceback(f)}"
                             for r, f in enumerate(ctx.error_files)
                             if os.path.exists(f))
            how = f" ({str(e).strip()})" if isinstance(e, ProcessExitedException) else ""
            raise RuntimeError(f"{target}: rank {e.error_index} of {n} failed"
                               f"{how}{raised}") from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
            for f in ctx.error_files:
                if os.path.exists(f):
                    os.unlink(f)
        return [torch.load(Path(tmp, f"rank{r}.pt"), weights_only=True)
                for r in range(n)]


def _traceback(error_file: str) -> str:
    with open(error_file, "rb") as fh:
        return pickle.load(fh)


def _rank_main(rank: int, target: str, tmp: str, n: int, kwargs: dict,
               timeout: float) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(n))
    if "OMP_NUM_THREADS" not in os.environ:
        torch.set_num_threads(1)
    init_distributed(require=True, backend="gloo",
                     init_method=f"file://{tmp}/store", rank=rank,
                     world_size=n, timeout=timeout)
    try:
        module, name = target.split(":")
        out = getattr(importlib.import_module(module), name)(**kwargs)
        torch.save(out, Path(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
