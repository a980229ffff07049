"""Stage timers, device traces and kernel build times (counterpart of
``chimera_tpu/utils/profiling.py``).

``StageTimer`` times named stages on the host clock, synchronizing the CUDA
device of a stage's result first, and on the card also by CUDA events
recorded around the stage; ``device_trace`` wraps ``torch.profiler`` and
writes a Chrome trace; ``compile_time`` reads the first-use ``nvcc`` build
seconds that ``ops/cuda/build.py`` records.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch

from chimera_tpu_torch.config import logger


def _cuda_devices(result) -> set:
    """The CUDA devices of the tensors in ``result`` (a tensor, or nested
    tuples, lists, dicts and dataclasses of them)."""
    if isinstance(result, torch.Tensor):
        return {result.device} if result.device.type == "cuda" else set()
    if isinstance(result, dict):
        result = list(result.values())
    elif hasattr(result, "__dataclass_fields__"):
        result = [getattr(result, f) for f in result.__dataclass_fields__]
    if isinstance(result, (list, tuple)):
        out = set()
        for r in result:
            out |= _cuda_devices(r)
        return out
    return set()


@dataclass
class StageTimer:
    """Seconds per named stage (host clock, after synchronizing the result's
    CUDA device), the number of times each ran, and, where the result lies
    on the card, the seconds between CUDA events recorded around it
    (``device_times``)."""

    times: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)
    device_times: dict = field(default_factory=dict)

    def _add(self, name: str, seconds: float, device_seconds: float | None):
        self.times[name] = self.times.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1
        if device_seconds is not None:
            self.device_times[name] = self.device_times.get(name, 0.0) + device_seconds

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        """Time the enclosed block; ``result`` is a tensor (or container of
        tensors) the block fills, or a zero-argument function returning
        it, whose device is synchronized before the clock stops."""
        on_card = torch.cuda.is_available()
        start = end = None
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            out = result() if callable(result) else result
            devices = _cuda_devices(out)
            if on_card:
                end.record()
            for d in devices:
                torch.cuda.synchronize(d)
            if on_card:
                end.synchronize()
            dt = time.perf_counter() - t0
            self._add(name, dt, start.elapsed_time(end) / 1e3 if on_card else None)

    def time_fn(self, name: str, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` timed as the stage ``name``."""
        box = []
        with self.stage(name, lambda: box[0] if box else None):
            box.append(fn(*args, **kwargs))
        return box[0]

    def report(self) -> str:
        lines = []
        for k, v in sorted(self.times.items()):
            dev = (f", card {self.device_times[k]:.4f}s"
                   if k in self.device_times else "")
            lines.append(f"{k}: {v:.4f}s{dev} (n={self.counts[k]})")
        msg = "; ".join(lines)
        logger.info("timing: %s", msg)
        return msg


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the enclosed block with ``torch.profiler`` (CPU and, with a
    card, CUDA activities) and write a Chrome trace into ``logdir``; yields
    the profiler (``key_averages()`` and the rest)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))


def compile_time(name: str | None = None, kind: int = 0) -> float:
    """Seconds ``nvcc`` took, in this process, for the kernel library
    ``name`` (mass model ``kind``), or for every library built so far when
    ``name`` is None; a library loaded from an earlier build counts 0."""
    from chimera_tpu_torch.ops.cuda import build

    if name is None:
        return sum(info["seconds"] for info in build.build_info.values())
    return build.build_info.get(build.lib_name(name, kind), {}).get("seconds", 0.0)
