"""Chebyshev interpolants (counterpart of ``chimera_tpu/ops/chebyshev.py``).

Series coefficients carry the λ axis: ``coeffs`` is (L, n), and ``chebeval``
evaluates row l of the series on row l of ``x`` (leading axis 1 or L).  The
per-sample evaluation is a fixed-depth Clenshaw recurrence — the same
arithmetic the CUDA kernels run per PE sample (``csrc/population.cuh``).
``chebeval`` carries the analytic backward of the JAX package
(``chimera_tpu/ops/chebyshev.py:102-150``): autograd through the unrolled
recurrence would keep one tensor of ``x``'s size per coefficient.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from chimera_tpu_torch.pytree import lam


@lru_cache(maxsize=32)
def _unit_nodes(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Chebyshev–Gauss nodes on [-1, 1], ascending, computed on the host in
    float64 and copied to the device once."""
    x = np.cos(np.pi * (np.arange(n) + 0.5) / n)[::-1].copy()
    return torch.as_tensor(x, dtype=dtype, device=device)


def cheb_nodes(n: int, a, b, *, dtype=None, device=None) -> torch.Tensor:
    """Chebyshev–Gauss nodes mapped to [a, b], ascending.  ``a``/``b`` are
    floats (-> (n,)) or per-λ tensors of shape (L,) (-> (L, n))."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        ref = a if isinstance(a, torch.Tensor) else b
        dtype, device = ref.dtype, ref.device
        a = a[..., None] if isinstance(a, torch.Tensor) else a
        b = b[..., None] if isinstance(b, torch.Tensor) else b
    x = _unit_nodes(n, dtype, torch.device(device if device is not None else "cpu"))
    return 0.5 * (a + b) + 0.5 * (b - a) * x


@lru_cache(maxsize=32)
def _dct_basis(n: int) -> np.ndarray:
    """DCT-II projection matrix, an exact host-float64 constant (computing
    the cos of ~200-rad arguments on the device in float32 puts ~1e-5
    noise on every basis entry — chimera_tpu/ops/chebyshev.py:38-51)."""
    k = np.arange(n)
    j = np.arange(n)
    return np.cos(np.pi * j[:, None] * (k[None, :] + 0.5) / n)


@lru_cache(maxsize=32)
def _dct_basis_t(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The host basis, transposed and cast once per (n, dtype, device)."""
    return torch.as_tensor(_dct_basis(n).T.copy(), dtype=dtype, device=device)


def chebfit_from_values(vals: torch.Tensor) -> torch.Tensor:
    """Coefficients from values at ``cheb_nodes(n, a, b)`` along the last
    axis: a DCT-II projection as one (…, n) x (n, n) matmul (TF32 off, see
    config)."""
    n = vals.shape[-1]
    basis_t = _dct_basis_t(n, vals.dtype, vals.device)
    coeffs = (2.0 / n) * torch.matmul(vals.flip(-1), basis_t)
    return torch.cat([0.5 * coeffs[..., :1], coeffs[..., 1:]], dim=-1)


def _clenshaw(coeffs: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Unrolled Clenshaw recurrence on normalized t; ``coeffs`` (L, n)."""
    n = coeffs.shape[-1]
    c = [lam(coeffs[:, k], t) for k in range(n)]
    t2 = 2.0 * t
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    for i in range(n - 1):
        b1, b2 = t2 * b1 - b2 + c[n - 1 - i], b1
    return t * b1 - b2 + c[0]


def _chebeval_loop(coeffs: torch.Tensor, x: torch.Tensor, a, b,
                   clip: bool) -> torch.Tensor:
    """The series at ``x`` through the unrolled recurrence: the forward of
    ``chebeval``, and under autograd the plain alternative to its analytic
    backward."""
    if isinstance(a, torch.Tensor):
        a, b = lam(a, x), lam(b, x)
        if clip:
            x = torch.minimum(torch.maximum(x, a), b)
    elif clip:
        x = torch.clamp(x, a, b)
    t = (2.0 * x - (a + b)) / (b - a)
    return _clenshaw(coeffs, t)


class _ChebEval(torch.autograd.Function):
    """``_chebeval_loop`` with the analytic backward of
    ``chimera_tpu/ops/chebyshev.py::_chebeval_bwd_core``, per λ row:

        d/dc_k = sum(ct T_k(t))                    forward T_k recurrence
        d/dx   = ct S'(t) 2 / (b - a)              S' = sum_k k c_k U_{k-1}
        d/da   = sum(ct S'(t) (t - 1) / (b - a))   through t
        d/db   = sum(-ct S'(t) (t + 1) / (b - a))

    A clipped point has t pinned at -1 or 1: its partials in x, a and b are
    zero.  The backward keeps a handful of tensors of the output's size
    whatever the degree."""

    @staticmethod
    def forward(ctx, coeffs, x, a, b, clip):
        ctx.save_for_backward(coeffs, x, *(v for v in (a, b)
                                           if isinstance(v, torch.Tensor)))
        ctx.bounds = None if isinstance(a, torch.Tensor) else (a, b)
        ctx.clip = clip
        return _chebeval_loop(coeffs, x, a, b, clip)

    @staticmethod
    def backward(ctx, ct):
        coeffs, x, *ab = ctx.saved_tensors
        per_lam = ctx.bounds is None
        a, b = ab if per_lam else ctx.bounds
        n = coeffs.shape[-1]
        al, bl = (lam(a, x), lam(b, x)) if per_lam else (a, b)
        span = bl - al
        ct_t = ct
        if ctx.clip:
            xc = torch.minimum(torch.maximum(x, al), bl) if per_lam \
                else torch.clamp(x, al, bl)
            ct_t = torch.where((x > al) & (x < bl), ct, 0.0)
        else:
            xc = x
        t = (2.0 * xc - (al + bl)) / span
        dims = tuple(range(1, ct.dim()))

        def proj(v):  # per-λ sum of ct * v
            return torch.sum(ct * v, dim=dims) if dims else ct * v

        c = [lam(coeffs[:, k], ct) for k in range(n)]
        g = [proj(torch.ones_like(t))]
        t_km1, t_k = torch.ones_like(t), t
        u_km1, u_k = torch.ones_like(t), 2.0 * t       # U_0, U_1
        d_s = c[1] * u_km1 if n > 1 else torch.zeros_like(ct)
        if n > 1:
            g.append(proj(t_k))
        for k in range(2, n):
            t_km1, t_k = t_k, 2.0 * t * t_k - t_km1
            g.append(proj(t_k))
            d_s = d_s + c[k] * k * u_k                 # u_k is U_{k-1} here
            u_km1, u_k = u_k, 2.0 * t * u_k - u_km1
        d_coeffs = torch.stack(g, dim=-1).sum_to_size(coeffs.shape)
        d_t = ct_t * d_s
        d_x = (d_t * (2.0 / span)).sum_to_size(x.shape) \
            if ctx.needs_input_grad[1] else None
        d_a = d_b = None
        if per_lam:
            d_a = torch.sum(d_t * (t - 1.0) / span, dim=dims).sum_to_size(a.shape)
            d_b = torch.sum(-d_t * (t + 1.0) / span, dim=dims).sum_to_size(b.shape)
        return d_coeffs, d_x, d_a, d_b, None


def chebeval(coeffs: torch.Tensor, x: torch.Tensor, a, b,
             clip: bool = True) -> torch.Tensor:
    """Evaluate the per-λ series at ``x`` on [a, b]; ``a``/``b`` are both
    floats or both (L,) tensors.  ``clip=True`` clamps x into [a, b] like
    ``jnp.interp``.  Differentiable in the coefficients, x and tensor
    bounds through the analytic backward of ``_ChebEval``."""
    return _ChebEval.apply(coeffs, x, a, b, clip)
