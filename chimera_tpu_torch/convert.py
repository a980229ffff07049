"""Carrying parameters and data from the JAX package to the port.

``state_from_reference`` reads a built ``chimera_tpu`` object (a
``HyperLikelihood``, ``Population``, ``SelectionFunction`` or model, batched
or not) through attribute access and ``np.array`` into a flat dict keyed
by dotted attribute paths; it never imports ``jax``.  The port's
``from_state`` constructors (``HyperLikelihood.from_state``,
``Population.from_state``, ``FLRW.from_state``, ...) rebuild objects from
that dict, so a test can run both packages on identical inputs and tables.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from chimera_tpu_torch.config import default_dtype


def state_from_reference(obj) -> dict[str, np.ndarray]:
    """Flatten a JAX-package dataclass tree to ``{path: np.ndarray}``.

    Each dataclass contributes ``<path>.__class__`` (its class name);
    ``None`` fields and nested containers (the dark-siren sample layouts)
    are skipped.  A ``HyperLikelihood`` whose ``create`` padded the sample
    or event axis for its TPU tiling is sliced back to the real samples and
    events: the port's kernel tiles any shape.
    """
    state: dict[str, np.ndarray] = {}
    _flatten(obj, "", state)
    if hasattr(obj, "theta_gw") and hasattr(obj, "z_grids"):
        n_s = getattr(obj, "n_samples_real", None)
        n_e = getattr(obj, "n_events_input", None)
        for key, val in state.items():
            if key.startswith("theta_gw.") and val.ndim == 2:
                state[key] = val[:n_e, :n_s]
        state["z_grids"] = state["z_grids"][:n_e]
    return state


def _flatten(obj, prefix: str, out: dict) -> None:
    out[prefix + "__class__"] = np.asarray(type(obj).__name__)
    for f in dataclasses.fields(obj):
        val = getattr(obj, f.name)
        if val is None or isinstance(val, (dict, tuple, list)):
            continue
        if dataclasses.is_dataclass(val):
            _flatten(val, f"{prefix}{f.name}.", out)
        else:
            out[prefix + f.name] = np.array(val)  # a writable host copy


def class_name(state: dict, prefix: str) -> str:
    return str(state[prefix + "__class__"])


def model_from_state(cls, state: dict, prefix: str, device=None, dtype=None):
    """Build a port model of type ``cls`` from the hyper-parameters and
    tables under ``prefix``; an unbatched reference model gets a λ axis of
    length 1."""
    device = torch.device(device if device is not None else "cpu")
    dtype = dtype or default_dtype(device)
    first = next(iter(cls.hyper_defaults))
    batched = np.ndim(state[prefix + first]) == 1
    kwargs = {}
    for f in dataclasses.fields(cls):
        key = prefix + f.name
        if key not in state:
            continue
        if f.name in cls.config_keys:
            kwargs[f.name] = state[key].item()
        else:
            t = torch.as_tensor(np.asarray(state[key]), dtype=dtype, device=device)
            kwargs[f.name] = t if batched else t[None]
    if kwargs.get("interp_method", "chebyshev") != "chebyshev" or \
            kwargs.get("cdf_engine", "analytic") != "analytic":
        raise NotImplementedError(
            "only the chebyshev cosmology and analytic mass-CDF engines are "
            "ported; the table engines are ROADMAP.md §1 item 3")
    return cls(**kwargs)
