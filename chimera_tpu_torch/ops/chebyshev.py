"""Chebyshev interpolants (counterpart of ``chimera_tpu/ops/chebyshev.py``).

Series coefficients carry the λ axis: ``coeffs`` is (L, n), and ``chebeval``
evaluates row l of the series on row l of ``x`` (leading axis 1 or L).  The
per-sample evaluation is a fixed-depth Clenshaw recurrence — the same
arithmetic the CUDA kernel runs per PE sample (``csrc/fused_kde.cu``).
Only the forward pass is ported; the analytic backward
(``chimera_tpu/ops/chebyshev.py:102-150``) arrives with gradients.
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


def chebeval(coeffs: torch.Tensor, x: torch.Tensor, a, b,
             clip: bool = True) -> torch.Tensor:
    """Evaluate the per-λ series at ``x`` on [a, b]; ``a``/``b`` are both
    floats or both (L,) tensors.  ``clip=True`` clamps x into [a, b] like ``jnp.interp``."""
    if isinstance(a, torch.Tensor):
        a, b = lam(a, x), lam(b, x)
        if clip:
            x = torch.minimum(torch.maximum(x, a), b)
    elif clip:
        x = torch.clamp(x, a, b)
    t = (2.0 * x - (a + b)) / (b - a)
    return _clenshaw(coeffs, t)
