"""KDE bandwidth factor and kernels (part of ``chimera_tpu/ops/kde.py``).

The bandwidth conventions are the reference's: Scott/Silverman factor of the
Kish effective sample size times the *unweighted* std of the samples.
"""

from __future__ import annotations

import torch

_SQRT_2PI = 2.5066282746310002


def bw_factor(neff: torch.Tensor, d: int, bw_method) -> torch.Tensor:
    """Scott/Silverman/scalar bandwidth prefactor for dimension ``d``, in the
    exp/log form the kernels use (chimera_tpu/ops/kde.py:50-60)."""
    if bw_method is None or bw_method == "scott":
        return torch.exp((-1.0 / (d + 4)) * torch.log(neff))
    if bw_method == "silverman":
        return torch.exp((-1.0 / (d + 4)) * torch.log(neff * (d + 2) / 4.0))
    if isinstance(bw_method, str):
        raise ValueError("bw_method must be 'scott', 'silverman', or a scalar")
    return torch.as_tensor(float(bw_method), dtype=neff.dtype, device=neff.device)


def epanechnikov_kernel(u: torch.Tensor) -> torch.Tensor:
    """0.75 (1 - u^2) on |u| <= 1, else 0 (the fused kernel's max form)."""
    return 0.75 * torch.clamp_min(1.0 - u * u, 0.0)


def gaussian_kernel(u: torch.Tensor) -> torch.Tensor:
    return torch.exp(-0.5 * u * u) * (1.0 / _SQRT_2PI)


KERNELS = {"epan": epanechnikov_kernel, "gauss": gaussian_kernel}
