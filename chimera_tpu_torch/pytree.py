"""Batched model state: the conventions every model of the port follows.

Counterpart of ``chimera_tpu/pytree.py``.  The JAX package evaluates a batch
of hyper-parameter samples (λ) with ``vmap`` over model pytrees; the port
writes that batch axis out instead:

* every tensor field of a model (hyper-parameters and the tables built from
  them) carries a leading λ axis of length L — a single model has L = 1;
* a function of a model and an array ``x`` takes ``x`` with a leading axis
  of length 1 or L and returns a result with leading axis L (``lam`` reshapes
  a per-λ field so that it broadcasts against ``x``);
* models are frozen dataclasses; ``tensor_map`` applies a function to every
  tensor they hold (device and dtype moves, λ broadcasts).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from chimera_tpu_torch.config import default_dtype, resolve_device


def lam(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Reshape a per-λ field ``p`` (L, ...) to broadcast against ``x``, whose
    leading axis is λ (size 1 or L)."""
    extra = x.dim() - p.dim()
    return p.reshape(p.shape + (1,) * extra) if extra > 0 else p


def as_batch(value: Any, device, dtype) -> torch.Tensor:
    """Scalar, sequence or tensor -> 1-D tensor (a λ axis) on device/dtype."""
    return torch.as_tensor(value, dtype=dtype, device=device).reshape(-1)


def batch_size(*tensors: torch.Tensor) -> int:
    """Common λ length of 1-D tensors of length 1 or L."""
    sizes = {t.shape[0] for t in tensors} - {1}
    if len(sizes) > 1:
        raise ValueError(f"inconsistent λ batch lengths {sorted(sizes)}")
    return sizes.pop() if sizes else 1


def tensor_map(obj: Any, fn: Callable[[torch.Tensor], torch.Tensor]) -> Any:
    """Apply ``fn`` to every tensor field of a (nested) dataclass."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = fn(v)
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            changes[f.name] = tensor_map(v, fn)
    return dataclasses.replace(obj, **changes)


def expand_batch(obj: Any, n: int) -> Any:
    """Broadcast an L = 1 model to a λ batch of n (views, no copies)."""
    return tensor_map(obj, lambda t: expand_lam(t, n))


def fit_in_float64(model: Any, build: Callable[[Any], Any]) -> Any:
    """Run ``build`` (a model's table fits) in float64 whatever the model's
    dtype, and cast the result back, except the fields the model lists in
    ``float64_fields``.  The fits are a few small tensor ops per λ; a
    float32 fit biases the tables (see ``models.cosmology.z_from_dgw``)."""
    dtype = next(v.dtype for v in vars(model).values() if isinstance(v, torch.Tensor))
    if dtype == torch.float64:
        return build(model)
    out = build(tensor_map(model, lambda t: t.to(torch.float64)))
    keep = getattr(model, "float64_fields", ())
    return dataclasses.replace(out, **{
        f.name: getattr(out, f.name).to(dtype) for f in dataclasses.fields(out)
        if isinstance(getattr(out, f.name), torch.Tensor) and f.name not in keep})


def resolve_params(cls, kwargs: dict, device, dtype) -> tuple[dict, dict]:
    """A model's ``create`` arguments -> (hyper-parameters as tensors
    broadcast to one λ length, config values); ``cls`` declares
    ``hyper_defaults`` and ``config_keys``."""
    unknown = set(kwargs) - set(cls.hyper_defaults) - set(cls.config_keys)
    if unknown:
        raise TypeError(f"unknown {cls.name} parameters: {sorted(unknown)}")
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    vector = getattr(cls, "vector_hypers", ())
    hyper = {k: as_batch(kwargs.get(k, d), device, dtype) if k not in vector
             else as_rows(kwargs[k], device, dtype)
             for k, d in cls.hyper_defaults.items()}
    n = batch_size(*hyper.values())
    defaults = {f.name: f.default for f in dataclasses.fields(cls)}
    return ({k: expand_lam(v, n) for k, v in hyper.items()},
            {k: kwargs.get(k, defaults[k]) for k in cls.config_keys})


def as_rows(value: Any, device, dtype) -> torch.Tensor:
    """A vector hyper-parameter (a sequence, or rows of them) -> (L, K)."""
    t = torch.as_tensor(value, dtype=dtype, device=device)
    return t[None] if t.dim() == 1 else t


def expand_lam(t: torch.Tensor, n: int) -> torch.Tensor:
    """Broadcast a field's λ axis (of length 1 or n) to n, as a view."""
    return t.expand((n,) + tuple(t.shape[1:]))


def update_batch(model, batch: dict, n: int):
    """λ batch of n for one model: rebuild it (``create``) if ``batch`` holds
    any of its hyper-parameters (each an (n,) tensor), else broadcast it."""
    relevant = {k: v for k, v in batch.items() if k in model.hyper_defaults}
    if not relevant:
        return expand_batch(model, n) if model.L != n else model
    params = {k: expand_lam(getattr(model, k), n) for k in model.hyper_defaults}
    params.update(relevant)
    ref = next(iter(params.values()))
    return type(model).create(
        **params, **{k: getattr(model, k) for k in model.config_keys},
        device=ref.device, dtype=ref.dtype)


def batch_sum(x: torch.Tensor, place: tuple[int, int] | None = None
              ) -> torch.Tensor:
    """``torch.sum(x, dim=-1)`` of the rows of a λ batch.  With ``place`` =
    (n, start) the l rows of ``x`` are rows start .. start + l of an n-row
    batch, and are summed at that place in a zero-filled (n, ...) tensor.
    On the card PyTorch's reduction picks its threads' layout, and so the
    order in which it adds, from the number of rows, so a row summed among
    l rows can differ in its last bits from the same row among n: summed
    in place, each row keeps the bits it has in the whole batch."""
    if place is None or place[0] == x.shape[0]:
        return torch.sum(x, dim=-1)
    n, start = place
    rows = slice(start, start + x.shape[0])
    whole = x.new_zeros((n,) + tuple(x.shape[1:]))
    whole[rows] = x
    return torch.sum(whole, dim=-1)[rows]
