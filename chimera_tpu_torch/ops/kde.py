"""KDE bandwidth factor, kernels and the d-dimensional Gaussian KDE (part
of ``chimera_tpu/ops/kde.py``).

The bandwidth conventions are the reference's: Scott/Silverman factor of the
Kish effective sample size times the *unweighted* std of the samples (1-D),
or times the weighted covariance (d-D).
"""

from __future__ import annotations

import math

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


def _safe_norm_weights(weights, shape, dtype, device) -> torch.Tensor:
    """Unit-mass weights over the last axis; an all-zero row falls back to
    uniform weights so every value downstream stays finite."""
    s = shape[-1]
    if weights is None:
        return torch.full(shape, 1.0 / s, dtype=dtype, device=device)
    sw = torch.sum(weights, dim=-1, keepdim=True)
    return torch.where(sw > 0, weights / torch.where(sw > 0, sw, 1.0), 1.0 / s)


def gaussian_kde_nd(dataset: torch.Tensor, points: torch.Tensor,
                    weights: torch.Tensor | None = None, bw_method=None
                    ) -> torch.Tensor:
    """Weighted d-dimensional Gaussian KDE, batched over leading axes
    (``chimera_tpu/ops/kde.py::gaussian_kde_nd``).

    dataset (..., d, S) samples, points (..., d, P) evaluation points,
    weights (..., S) or None -> density (..., P).  The covariance carries the
    reference's small-sample correction 1 / (1 - sum w^2); the kernel is
    whitened with the Cholesky factor of the scaled inverse covariance.  The
    chi-square is summed in DIFFERENCE form, one squared difference per
    dimension: the expanded p^2 + s^2 - 2 p.s form cancels for nearby
    points, and at reduced matmul precision turned into large negative
    values (exp(+big) = inf) in the JAX package's localization pdfs.
    """
    d, s = dataset.shape[-2:]
    w = _safe_norm_weights(weights, dataset.shape[:-2] + (s,), dataset.dtype,
                           dataset.device)
    neff = 1.0 / torch.sum(w * w, dim=-1)
    factor = bw_factor(neff, d, bw_method)

    mean = torch.sum(w[..., None, :] * dataset, dim=-1, keepdim=True)
    resid = dataset - mean
    cov = torch.einsum("...is,...js->...ij", resid * w[..., None, :], resid)
    cov = cov / (1.0 - torch.sum(w * w, dim=-1))[..., None, None]
    inv_cov = torch.linalg.inv(cov) / (factor * factor)[..., None, None]
    whitening = torch.linalg.cholesky(inv_cov)      # inv_cov = L L^T
    pts_w = torch.einsum("...dp,...dk->...pk", points, whitening)
    data_w = torch.einsum("...ds,...dk->...sk", dataset, whitening)
    log_norm = torch.sum(torch.log(torch.diagonal(whitening, dim1=-2, dim2=-1)),
                         dim=-1) - 0.5 * d * math.log(2 * math.pi)
    chi2 = torch.zeros(pts_w.shape[:-1] + (s,), dtype=dataset.dtype,
                       device=dataset.device)
    for k in range(d):
        diff = pts_w[..., :, k, None] - data_w[..., None, :, k]
        chi2 = chi2 + diff * diff
    return torch.exp(log_norm)[..., None] * torch.sum(
        torch.exp(-0.5 * chi2) * w[..., None, :], dim=-1)
