"""Batched weighted 1-D KDE on per-row grids (counterpart of
``chimera_tpu/ops/pallas/kde.py::kde1d_grid``, K4) and its adjoint (K4b):
the KDE of the stage-by-stage path that every binned configuration takes.

    out[b, g] = sum_s w[b, s] K((grids[b, g] - z[b, s]) / h[b]) / h[b]

with normalized weights (``chimera_tpu/ops/kde.py::kde1d_core``).
``kde1d_grid`` runs the hand-written CUDA kernel
(``chimera_tpu_torch/csrc/kde1d.cu``) on CUDA tensors, counting its
launches in ``kde1d_grid.launches``, and the plain PyTorch version
``kde1d_grid_plain`` on CPU tensors; on CUDA it launches the kernel or
raises.

Gradients.  On CPU tensors autograd differentiates the plain version.  On
CUDA tensors, where an input requires grad, the launch sits in a
``torch.autograd.Function`` whose backward is ``kde1d_grid_adjoint``: the
hand-written adjoint kernel K4b (the same source), counted in
``kde1d_grid_adjoint.launches``, which returns the cotangents of z, w, the
grids and h from the forward's saved output.  The JAX package has no kernel
for it (``jax.grad`` through its Pallas K4 raises): its counterpart is
``jax.vjp`` of ``kde1d_core``, and ``kde1d_grid_adjoint_plain`` is its
plain version.
"""

from __future__ import annotations

import torch

from chimera_tpu_torch.ops.cuda import fused
from chimera_tpu_torch.ops.cuda.fused import _K4_TILE, _K4B_TILE, _SMEM_LIMIT
from chimera_tpu_torch.ops.kde import KERNELS, kde1d_core

# elements of one (rows, G, S) intermediate in the plain versions
_PLAIN_BUDGET = 1 << 25
# K'(u) = -_SLOPE[kernel] u f(u) (csrc/kde.cuh, kernel_slope_norm)
_SLOPE = {"epan": 1.5, "gauss": 0.3989422804014327}


def _chunks(b: int, g: int, s: int, budget: int = _PLAIN_BUDGET):
    chunk = max(1, budget // (g * s))
    return [slice(b0, b0 + chunk) for b0 in range(0, b, chunk)]


def kde1d_grid_plain(z: torch.Tensor, weights: torch.Tensor,
                     grids: torch.Tensor, bandwidths: torch.Tensor,
                     kernel: str = "epan") -> torch.Tensor:
    """Plain PyTorch version of ``kde1d_grid``: ``kde1d_core`` over chunks
    of rows, so that no (B, G, S) tensor is ever materialized."""
    return torch.cat([
        kde1d_core(z[r], grids[r], weights[r], bandwidths[r], kernel)
        for r in _chunks(z.shape[0], grids.shape[1], z.shape[1])])


def _slope_factor(u: torch.Tensor, kernel: str) -> torch.Tensor:
    """f of K'(u) = -slope u f(u): for Epanechnikov 1 on |u| <= 1, the
    closed support of the select form that ``kde1d_core``'s reference
    differentiates (all of the slope at |u| = 1 exactly), 0 outside;
    Gaussian exp(-u^2 / 2)."""
    if kernel == "epan":
        return (torch.abs(u) <= 1.0).to(u.dtype)
    return torch.exp(-0.5 * u * u)


@torch.no_grad()
def kde1d_grid_adjoint_plain(z: torch.Tensor, weights: torch.Tensor,
                             grids: torch.Tensor, bandwidths: torch.Tensor,
                             out: torch.Tensor, d_out: torch.Tensor,
                             kernel: str = "epan"):
    """Plain PyTorch version of ``kde1d_grid_adjoint``, chunked over rows like
    ``kde1d_grid_plain``.  With u = (g - z) / h and K'(u) = -slope u f(u):

        d_w[s]    = sum_g d_out[g] K(u) / h
        d_z[s]    = -sum_g d_out[g] w[s] K'(u) / h^2
        d_grid[g] = d_out[g] sum_s w[s] K'(u) / h^2
        d_h       = -sum_g d_out[g] (out[g] + sum_s w[s] u K'(u) / h) / h

    Returns (d_z (B, S), d_w (B, S), d_grids (B, G), d_h (B,)), outside the
    autograd graph: the inputs a backward hands it are saved tensors of the
    forward that require grad, and a graph of its chunks' (c, G, S)
    intermediates would outlive the call."""
    kfn, slope = KERNELS[kernel], _SLOPE[kernel]
    parts = []
    for r in _chunks(z.shape[0], grids.shape[1], z.shape[1]):
        h = bandwidths[r][:, None, None]
        u = (grids[r][:, :, None] - z[r][:, None, :]) / h        # (c, G, S)
        dg = d_out[r][:, :, None]
        kp = -slope * u * _slope_factor(u, kernel)                # K'(u)
        w = weights[r][:, None, :]
        d_w = torch.sum(dg * kfn(u), dim=1) / h[:, 0]
        d_z = -torch.sum(dg * kp, dim=1) * weights[r] / h[:, 0] ** 2
        d_grid = d_out[r] * torch.sum(w * kp, dim=2) / h[:, 0] ** 2
        inner = out[r] + torch.sum(w * u * kp, dim=2) / h[:, 0]
        d_h = -torch.sum(d_out[r] * inner, dim=1) / bandwidths[r]
        parts.append((d_z, d_w, d_grid, d_h))
    return tuple(torch.cat(p) for p in zip(*parts))


def _check(name, z, tensors: dict):
    """The checks of a K4/K4b launch: CUDA tensors of one float dtype and the
    given shapes."""
    if z.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {z.device}")
    dt, dev = z.dtype, z.device
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"{name} takes float32 or float64, not {dt}")
    for key, (t, shape) in tensors.items():
        if t.shape != shape or t.dtype != dt or t.device != dev:
            raise ValueError(f"{key} must be {shape} {dt} on {dev}")


def _launch_k4(z, weights, grids, bandwidths, kernel):
    b, s = z.shape
    out = torch.empty((b, grids.shape[1]), dtype=z.dtype, device=z.device)
    fused.launch("kde1d", "chimera_kde1d", z.dtype, z.device,
                 [z, weights, grids, bandwidths, out, b, s, grids.shape[1],
                  0 if kernel == "epan" else 1])
    kde1d_grid.launches += 1
    return out


class _KDE1d(torch.autograd.Function):
    """K4 on CUDA tensors, with K4b as its backward."""

    @staticmethod
    def forward(ctx, z, weights, grids, bandwidths, kernel):
        out = _launch_k4(z, weights, grids, bandwidths, kernel)
        ctx.save_for_backward(z, weights, grids, bandwidths, out)
        ctx.kernel = kernel
        return out

    @staticmethod
    def backward(ctx, d_out):
        z, weights, grids, bandwidths, out = ctx.saved_tensors
        grads = kde1d_grid_adjoint(z, weights, grids, bandwidths, out,
                                   d_out.contiguous(), ctx.kernel)
        return (*(g if need else None for g, need in
                  zip(grads, ctx.needs_input_grad)), None)


def kde1d_grid(z: torch.Tensor, weights: torch.Tensor, grids: torch.Tensor,
               bandwidths: torch.Tensor, kernel: str = "epan") -> torch.Tensor:
    """Batched KDE: z (B, S) samples, weights (B, S) *normalized* weights,
    grids (B, G) evaluation points, bandwidths (B,) -> (B, G) densities.
    On CUDA tensors that require grad the backward is K4b."""
    if not fused.on_card(z):
        return kde1d_grid_plain(z, weights, grids, bandwidths, kernel)
    if kernel not in ("epan", "gauss"):
        raise ValueError(f"unknown KDE kernel {kernel!r}")
    b, s = z.shape
    g = grids.shape[-1]
    _check("kde1d_grid", z, {"weights": (weights, (b, s)),
                             "grids": (grids, (b, g)),
                             "bandwidths": (bandwidths, (b,))})
    # the (z, w) pairs and, Epanechnikov, the pruned loop's bin tiles' bounds
    smem = (2 * s + (2 * -(-s // _K4_TILE) if kernel == "epan" else 0)) \
        * z.element_size()
    if smem > _SMEM_LIMIT:
        raise ValueError(f"S = {s} samples need {smem} bytes of shared memory "
                         f"per block, over the {_SMEM_LIMIT}-byte limit")
    args = [t.contiguous() for t in (z, weights, grids, bandwidths)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _KDE1d.apply(*args, kernel)
    return _launch_k4(*args, kernel)


kde1d_grid.launches = 0


def kde1d_grid_adjoint(z: torch.Tensor, weights: torch.Tensor,
                       grids: torch.Tensor, bandwidths: torch.Tensor,
                       out: torch.Tensor, d_out: torch.Tensor,
                       kernel: str = "epan"):
    """The backward of ``kde1d_grid`` (K4b): given the forward's inputs, its
    output ``out`` (B, G) and the cotangent ``d_out`` (B, G), returns
    (d_z (B, S), d_w (B, S), d_grids (B, G), d_h (B,)).  A row of zero
    weights, or of zero span, gets finite cotangents.  CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise.  The kernel
    computes in double for float32 inputs too (d_z's sum over the grid
    cancels to a small part of its terms), so in float32 it is closer to
    the float64 plain version on the same inputs than the float32 one is."""
    if not fused.on_card(z):
        return kde1d_grid_adjoint_plain(z, weights, grids, bandwidths, out,
                                        d_out, kernel)
    if kernel not in ("epan", "gauss"):
        raise ValueError(f"unknown KDE kernel {kernel!r}")
    b, s = z.shape
    g = grids.shape[-1]
    _check("kde1d_grid_adjoint", z, {
        "weights": (weights, (b, s)), "grids": (grids, (b, g)),
        "bandwidths": (bandwidths, (b,)), "out": (out, (b, g)),
        "d_out": (d_out, (b, g))})
    # (z, w) and (grid, d_out) pairs in double, and their tiles' bounds
    smem = 16 * (s + g + -(-s // _K4B_TILE) + -(-g // _K4B_TILE))
    if smem > _SMEM_LIMIT:
        raise ValueError(f"S + G = {s + g} need {smem} bytes of shared memory "
                         f"per block, over the {_SMEM_LIMIT}-byte limit")
    d_z, d_w = (torch.empty((b, s), dtype=z.dtype, device=z.device)
                for _ in range(2))
    d_grids = torch.empty((b, g), dtype=z.dtype, device=z.device)
    d_h = torch.empty((b,), dtype=z.dtype, device=z.device)
    fused.launch("kde1d", "chimera_kde1d_adjoint", z.dtype, z.device,
                 [*(t.contiguous() for t in (z, weights, grids, bandwidths,
                                             out, d_out)),
                  d_z, d_w, d_grids, d_h, b, s, g,
                  0 if kernel == "epan" else 1])
    kde1d_grid_adjoint.launches += 1
    return d_z, d_w, d_grids, d_h


kde1d_grid_adjoint.launches = 0
