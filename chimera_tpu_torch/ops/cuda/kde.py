"""Batched weighted 1-D KDE on per-row grids (counterpart of
``chimera_tpu/ops/pallas/kde.py::kde1d_grid``, K4): the KDE of the
stage-by-stage path that every binned configuration takes.

    out[b, g] = sum_s w[b, s] K((grids[b, g] - z[b, s]) / h[b]) / h[b]

with normalized weights (``chimera_tpu/ops/kde.py::kde1d_core``).
``kde1d_grid`` runs the hand-written CUDA kernel
(``chimera_tpu_torch/csrc/kde1d.cu``) on CUDA tensors, counting its
launches in ``kde1d_grid.launches``, and the plain PyTorch version
``kde1d_grid_plain`` on CPU tensors; on CUDA it launches the kernel or
raises, and raises where an input requires grad (the kernel has no
backward; on CPU tensors autograd runs through the plain version).
"""

from __future__ import annotations

import torch

from chimera_tpu_torch.ops.cuda.fused import _SMEM_LIMIT, launch, refuse_grad
from chimera_tpu_torch.ops.kde import kde1d_core

# elements of one (rows, G, S) intermediate in the plain version
_PLAIN_BUDGET = 1 << 25


def kde1d_grid_plain(z: torch.Tensor, weights: torch.Tensor,
                     grids: torch.Tensor, bandwidths: torch.Tensor,
                     kernel: str = "epan") -> torch.Tensor:
    """Plain PyTorch version of ``kde1d_grid``: ``kde1d_core`` over chunks
    of rows, so that no (B, G, S) tensor is ever materialized."""
    b, s = z.shape
    chunk = max(1, _PLAIN_BUDGET // (grids.shape[1] * s))
    return torch.cat([kde1d_core(z[r], grids[r], weights[r], bandwidths[r], kernel)
                      for r in (slice(b0, b0 + chunk) for b0 in range(0, b, chunk))])


def kde1d_grid(z: torch.Tensor, weights: torch.Tensor, grids: torch.Tensor,
               bandwidths: torch.Tensor, kernel: str = "epan") -> torch.Tensor:
    """Batched KDE: z (B, S) samples, weights (B, S) *normalized* weights,
    grids (B, G) evaluation points, bandwidths (B,) -> (B, G) densities."""
    if z.device.type == "cpu":
        return kde1d_grid_plain(z, weights, grids, bandwidths, kernel)
    if z.device.type != "cuda":
        raise ValueError(f"kde1d_grid: unsupported device {z.device}")
    if kernel not in ("epan", "gauss"):
        raise ValueError(f"unknown KDE kernel {kernel!r}")
    dt, dev = z.dtype, z.device
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"kde1d_grid takes float32 or float64, not {dt}")
    b, s = z.shape
    g = grids.shape[-1]
    for name, t, shape in (("weights", weights, (b, s)), ("grids", grids, (b, g)),
                           ("bandwidths", bandwidths, (b,))):
        if t.shape != shape or t.dtype != dt or t.device != dev:
            raise ValueError(f"{name} must be {shape} {dt} on {dev}")
    refuse_grad("kde1d_grid", z, weights, grids, bandwidths)
    smem = 2 * s * z.element_size()
    if smem > _SMEM_LIMIT:
        raise ValueError(f"S = {s} samples need {smem} bytes of shared memory "
                         f"per block, over the {_SMEM_LIMIT}-byte limit")
    out = torch.empty((b, g), dtype=dt, device=dev)
    launch("kde1d", "chimera_kde1d", dt, dev,
           [z.contiguous(), weights.contiguous(), grids.contiguous(),
            bandwidths.contiguous(), out, b, s, g, 0 if kernel == "epan" else 1])
    kde1d_grid.launches += 1
    return out


kde1d_grid.launches = 0
