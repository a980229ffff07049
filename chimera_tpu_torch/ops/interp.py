"""Piecewise-linear interpolation with ``jnp.interp``'s semantics
(counterpart of the ``jnp.interp`` calls in ``chimera_tpu``): outside
[xp[0], xp[-1]] the edge values are returned, and a zero-width interval
returns its left value.

``xp`` and ``fp`` are each 1-D (shared) or (L, M) rows (one table per λ);
with a batched table, ``x`` has a leading axis of length 1 or L.
"""

from __future__ import annotations

import numpy as np
import torch


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    if xp.dim() == 1 and fp.dim() == 1:
        return _interp_rows(x.reshape(1, -1), xp[None], fp[None]).reshape(x.shape)
    n = xp.shape[0] if xp.dim() == 2 else fp.shape[0]
    m = xp.shape[-1]
    xp2 = xp.expand(n, m).contiguous()
    fp2 = fp.expand(n, m)
    x2 = x.reshape(x.shape[0] if x.dim() else 1, -1).expand(n, -1).contiguous()
    out_shape = (n,) + tuple(x.shape[1:]) if x.dim() else (n,)
    return _interp_rows(x2, xp2, fp2).reshape(out_shape)


def _interp_rows(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """x (R, K), xp/fp (R, M) with each xp row ascending.  The table is read
    by indexing, whose backward accumulates by a sorted ``index_put_`` (as
    ``uniform_interp``'s): many points of one interval give the same
    gradient bits in every run on CUDA too, where ``gather``'s backward
    adds by atomics."""
    m = xp.shape[-1]
    i = torch.searchsorted(xp, x, right=True).clamp(1, m - 1)
    r = torch.arange(x.shape[0], device=x.device)[:, None]
    xp_lo, xp_hi = xp[r, i - 1], xp[r, i]
    fp_lo, fp_hi = fp[r, i - 1], fp[r, i]
    dx = xp_hi - xp_lo
    eps = float(np.spacing(np.finfo(
        np.float64 if xp.dtype == torch.float64 else np.float32).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp_lo,
                    fp_lo + ((x - xp_lo) / torch.where(dx0, 1.0, dx)) * (fp_hi - fp_lo))
    f = torch.where(x < xp[:, :1], fp[:, :1], f)
    return torch.where(x > xp[:, -1:], fp[:, -1:], f)


def uniform_interp(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                   fp: torch.Tensor, left: float = 0.0, right: float = 0.0
                   ) -> torch.Tensor:
    """Linear interpolation on uniform nodes ``linspace(lo, hi, M)`` by index
    arithmetic (``chimera_tpu/ops/interp.py::uniform_interp``), batched over
    rows: x (..., N), lo and hi (...,), fp (..., M) -> (..., N).  Outside
    [lo, hi] the value is ``left`` / ``right``.  A row with hi == lo gives
    NaN between them, as the reference; its index is taken as 0 (a float to
    integer conversion of NaN is undefined in torch).  The nodes are read by
    indexing, whose backward accumulates by a sorted ``index_put_``: equal
    inputs give equal gradient bits on CUDA too (``torch.gather``'s backward
    adds by atomics)."""
    m = fp.shape[-1]
    lo, hi = lo[..., None], hi[..., None]
    t = (x - lo) / (hi - lo) * (m - 1)
    i = torch.nan_to_num(torch.floor(t).clamp(0, m - 2), nan=0.0).long()
    frac = t - i
    rows = fp.expand(*i.shape[:-1], m).reshape(-1, m)
    r = torch.arange(rows.shape[0], device=fp.device)[:, None]
    i2 = i.reshape(rows.shape[0], -1)
    val = (rows[r, i2].reshape(i.shape) * (1.0 - frac)
           + rows[r, i2 + 1].reshape(i.shape) * frac)
    val = torch.where(x < lo, left, val)
    return torch.where(x > hi, right, val)
