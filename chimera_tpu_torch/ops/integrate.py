"""Trapezoid rules (counterpart of ``chimera_tpu/ops/integrate.py``)."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def trapz(y: torch.Tensor, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Trapezoidal integral of ``y`` over nodes ``x`` along ``dim``; ``x``
    broadcasts against ``y`` (per-row grids).  Same pairing as
    ``jnp.trapezoid``: 0.5 * sum(dx * (y[1:] + y[:-1]))."""
    n = y.shape[dim]
    dx = torch.diff(x, dim=dim)
    return 0.5 * torch.sum(dx * (y.narrow(dim, 1, n - 1) + y.narrow(dim, 0, n - 1)),
                           dim=dim)


def trapz_weights(x: torch.Tensor) -> torch.Tensor:
    """Per-node trapezoid weights over the last axis:
    ``trapz(y, x) == sum(trapz_weights(x) * y, -1)`` up to summation order.
    They fold the z-integral into the dark-siren contraction as a static
    factor."""
    dx = torch.diff(x, dim=-1)
    zeros = torch.zeros_like(x[..., :1])
    return 0.5 * (torch.cat([zeros, dx], dim=-1) + torch.cat([dx, zeros], dim=-1))


def cumtrapz(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Cumulative trapezoid over the last axis with a leading zero (shape
    preserved): out[0] = 0, out[i] = sum_{j<i} 0.5 (y[j] + y[j+1]) dx[j]."""
    seg = 0.5 * (y[..., :-1] + y[..., 1:]) * torch.diff(x, dim=-1)
    res = torch.cumsum(seg, dim=-1)
    return torch.cat([torch.zeros_like(res[..., :1]), res], dim=-1)


def linspace(start, stop, num: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, num, axis=-1)`` for tensor endpoints of any
    (matching) shape: start (1 - t) + stop t with t = i / (num - 1), and the
    exact endpoint appended — the arithmetic of JAX's implementation."""
    start, stop = torch.broadcast_tensors(start, stop)
    div = num - 1
    step = torch.arange(div, dtype=start.dtype, device=start.device) / div
    out = start[..., None] * (1 - step) + stop[..., None] * step
    return torch.cat([out, stop[..., None]], dim=-1)


def logspace(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """``jnp.logspace(start, stop, num)``: 10 ** linspace(start, stop, num)."""
    return torch.pow(10.0, linspace(start, stop, num))


@lru_cache(maxsize=16)
def gauss_legendre_unit(n: int, dtype: torch.dtype, device: torch.device
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """n-point Gauss–Legendre nodes and weights on (0, 1), computed on the
    host in float64 and copied to the device once."""
    x, w = np.polynomial.legendre.leggauss(n)
    return (torch.as_tensor(0.5 * (x + 1.0), dtype=dtype, device=device),
            torch.as_tensor(0.5 * w, dtype=dtype, device=device))
