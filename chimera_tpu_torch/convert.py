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

from chimera_tpu_torch.config import default_dtype, resolve_device

# per-sample fields of ThetaPEDet, padded along the sample axis by the
# reference's create(); the other theta_gw fields are per event or per pixel
_PER_SAMPLE_FIELDS = ("m1det", "m2det", "dL", "phi", "theta", "ra", "dec",
                      "pe_prior", "pixels_pe_opt_nside")
# the event-indexed arrays of a pixelated catalog, padded with the events
_CATALOG_EVENT_KEYS = tuple(f"population.gal_cat.{f}" for f in
                            ("p_cat", "P_compl", "pixel_mask", "n_gal"))


def state_from_reference(obj) -> dict[str, np.ndarray]:
    """Flatten a JAX-package dataclass tree to ``{path: np.ndarray}``.

    Each dataclass contributes ``<path>.__class__`` (its class name);
    ``None`` fields and nested containers (the dark-siren sample layouts,
    which the port rebuilds) are skipped, but for ``compact_rows``: whether
    a ``compact`` layout holds the chunk rows, and for ``z_block``: the
    'full' kind's recurrence plan as each event's block length (0 dense).
    A ``HyperLikelihood`` whose
    ``create`` padded the sample or event axis for its TPU tiling is sliced
    back to the real samples and events — the PE data, the z-grids and the
    event-indexed arrays of a pixelated catalog: the port's kernels tile
    any shape.
    """
    state: dict[str, np.ndarray] = {}
    _flatten(obj, "", state)
    compact = getattr(obj, "compact", None)
    if isinstance(compact, dict):
        # the layout itself is rebuilt; whether it has chunk rows selects the
        # port's rows (K1c + K2) or contract (K1e) pass
        state["compact_rows"] = np.asarray("rows" in compact)
    if getattr(obj, "kind", None) == "full":
        state["z_block"] = _z_block(obj)
    if hasattr(obj, "theta_gw") and hasattr(obj, "z_grids"):
        n_s = getattr(obj, "n_samples_real", None)
        n_e = getattr(obj, "n_events_input", None)
        for key, val in state.items():
            if key.startswith("theta_gw.") and val.ndim >= 1:
                val = val[:n_e]
                if key.split(".")[-1] in _PER_SAMPLE_FIELDS:
                    val = val[:, :n_s]
                state[key] = val
            elif key in _CATALOG_EVENT_KEYS:
                state[key] = val[:n_e]
        state["z_grids"] = state["z_grids"][:n_e]
        if "z_block" in state:
            state["z_block"] = state["z_block"][:n_e]
    return state


def _z_block(hl) -> np.ndarray:
    """The block length of each (padded) event under a JAX 'full' object's
    plan: its per-event tiers ``z_full_buckets`` ((K, global event
    indices), ...) where it has them, else its batch-global
    ``z_block_full`` (None: every event dense, 0)."""
    k = np.full(hl.z_grids.shape[0], hl.z_block_full or 0, dtype=np.int64)
    for tier, idx in hl.z_full_buckets or ():
        k[np.asarray(idx, dtype=np.int64)] = tier
    return k


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
    device = resolve_device(device)
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
            dt = torch.float64 if f.name in getattr(cls, "float64_fields", ()) \
                else dtype
            t = torch.as_tensor(np.asarray(state[key]), dtype=dt, device=device)
            kwargs[f.name] = t if batched else t[None]
    if kwargs.get("interp_method", "chebyshev") != "chebyshev" or \
            kwargs.get("cdf_engine", "analytic") != "analytic":
        raise NotImplementedError(
            "only the chebyshev cosmology and analytic mass-CDF engines are "
            "ported; the table engines are ROADMAP.md §1 item 3")
    return cls(**kwargs)
