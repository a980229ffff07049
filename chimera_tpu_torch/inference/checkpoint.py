"""Chain checkpoints and restarts in HDF5 (counterpart of
``chimera_tpu/inference/checkpoint.py``), in the JAX package's layout:
numbered chain files ``<prefix>_<n>.h5`` with ``chain``, ``log_prob``, the
sampler state under ``state/`` (``coords``, ``state_log_prob``,
``n_accepted``) and the ``param_names`` and ``iteration`` attributes; HMC
checkpoints with ``samples``, ``log_prob`` and ``state/`` (``y``, ``logp``,
``grad``, ``step_size``, ``inv_mass``).

The random stream.  The JAX package keeps a PRNG key in its sampler state
and writes it as ``state/key``; the port's samplers take a
``torch.Generator``, whose stream is not JAX's.  So the port writes the
generator's state under ``state/torch_generator`` (with its device type as
an attribute) and never a ``state/key``.  Either package's files load here:
``load_chain`` reads both alike, and ``load_state`` / ``load_hmc`` return
the coordinates and counters of both, with the generator state of a port
file and None for a JAX file.  Restoring the stream thus works from port to
port only; a chain resumed from a JAX file continues from its coordinates
with a fresh generator.

``h5py`` is imported inside the functions: the module imports where it is
not installed.
"""

from __future__ import annotations

import os
import re
from typing import Iterable

import numpy as np
import torch

from chimera_tpu_torch.config import resolve_device
from chimera_tpu_torch.inference.ensemble import EnsembleState

GENERATOR_KEY = "torch_generator"


def _chain_index(path: str, prefix: str) -> int | None:
    m = re.fullmatch(re.escape(os.path.basename(prefix)) + r"_(\d+)\.h5",
                     os.path.basename(path))
    return int(m.group(1)) if m else None


def latest_chain_file(prefix: str) -> str | None:
    """The highest-numbered existing ``<prefix>_<n>.h5``, or None."""
    d = os.path.dirname(prefix) or "."
    if not os.path.isdir(d):
        return None
    best, best_n = None, -1
    for f in os.listdir(d):
        full = os.path.join(d, f)
        n = _chain_index(full, prefix)
        if n is not None and n > best_n:
            best, best_n = full, n
    return best


def next_chain_file(prefix: str) -> str:
    """The file name after the latest: ``<prefix>_<n + 1>.h5``."""
    latest = latest_chain_file(prefix)
    n = -1 if latest is None else _chain_index(latest, prefix)
    return f"{prefix}_{n + 1}.h5"


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _names(f) -> list[str]:
    return [s if isinstance(s, str) else s.decode() for s in f.attrs["param_names"]]


def _write_generator(group, generator) -> None:
    if generator is not None:
        d = group.create_dataset(GENERATOR_KEY,
                                 data=generator.get_state().cpu().numpy())
        d.attrs["device"] = generator.device.type


def _read_generator(group) -> torch.Tensor | None:
    if GENERATOR_KEY not in group:
        return None
    return torch.as_tensor(group[GENERATOR_KEY][:], dtype=torch.uint8)


def save_chain(path: str, state: EnsembleState, history: dict,
               param_names: Iterable[str], generator=None) -> None:
    """Write a chain segment (``history['coords']``, ``['log_prob']``) and
    the ensemble's state, with ``generator``'s state where one is given."""
    import h5py

    with h5py.File(path, "w") as f:
        f.attrs["param_names"] = list(param_names)
        f.attrs["iteration"] = int(state.iteration)
        f.create_dataset("chain", data=_np(history["coords"]))
        f.create_dataset("log_prob", data=_np(history["log_prob"]))
        g = f.create_group("state")
        g.create_dataset("coords", data=_np(state.coords))
        g.create_dataset("state_log_prob", data=_np(state.log_prob))
        g.create_dataset("n_accepted", data=_np(state.n_accepted))
        _write_generator(g, generator)


def load_state(path: str, device=None
               ) -> tuple[EnsembleState, list[str], torch.Tensor | None]:
    """(state, param_names, generator state) of a chain file of either
    package, the state's tensors on ``device``; the generator state (for
    ``torch.Generator.set_state``) is None in a JAX file."""
    import h5py

    dev = resolve_device(device)
    with h5py.File(path, "r") as f:
        g = f["state"]
        state = EnsembleState(
            coords=torch.as_tensor(g["coords"][:], device=dev),
            log_prob=torch.as_tensor(g["state_log_prob"][:], device=dev),
            n_accepted=torch.as_tensor(g["n_accepted"][:], device=dev
                                       ).to(torch.int64),
            iteration=int(f.attrs["iteration"]))
        return state, _names(f), _read_generator(g)


def load_chain(path: str) -> dict:
    """{'chain', 'log_prob', 'param_names'} of a chain file of either
    package, numpy arrays."""
    import h5py

    with h5py.File(path, "r") as f:
        return {"chain": f["chain"][:], "log_prob": f["log_prob"][:],
                "param_names": _names(f)}


def save_hmc(path: str, samples, stats: dict, generator,
             param_names: Iterable[str]) -> None:
    """Checkpoint an HMC run: the samples, the final chain state, the frozen
    adaptation (step size, inverse mass) and ``generator``'s state:
    everything ``inference.hmc.continue_hmc`` needs."""
    import h5py

    state = stats["final_state"]
    with h5py.File(path, "w") as f:
        f.attrs["param_names"] = list(param_names)
        f.create_dataset("samples", data=_np(samples))
        f.create_dataset("log_prob", data=_np(stats["log_prob"]))
        g = f.create_group("state")
        g.create_dataset("y", data=_np(state.y))
        g.create_dataset("logp", data=_np(state.logp))
        g.create_dataset("grad", data=_np(state.grad))
        g.create_dataset("step_size", data=_np(stats["step_size"]))
        g.create_dataset("inv_mass", data=_np(stats["inv_mass"]))
        _write_generator(g, generator)


def load_hmc(path: str, device=None):
    """(state, step_size, inv_mass, generator state, param_names) of an HMC
    checkpoint of either package, tensors on ``device``; the generator
    state is None in a JAX file."""
    import h5py

    from chimera_tpu_torch.inference.hmc import HMCState

    dev = resolve_device(device)
    with h5py.File(path, "r") as f:
        g = f["state"]

        def t(key):
            return torch.as_tensor(g[key][()], device=dev)

        state = HMCState(y=t("y"), logp=t("logp"), grad=t("grad"))
        return state, t("step_size"), t("inv_mass"), _read_generator(g), _names(f)
