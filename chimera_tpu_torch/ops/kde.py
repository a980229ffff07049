"""KDE bandwidth factor, kernels, the 1-D KDE's parameters and contraction
and the d-dimensional Gaussian KDE (part of ``chimera_tpu/ops/kde.py``).

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


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: maximum with ``lo``, then minimum with ``hi``, whose
    slope is half at a bound where ``torch.clamp``'s is 1 (a row with one
    live sample sits at N_eff = 1 exactly)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def var_floor(var: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(var, sqrt(tiny))``: a variance floored so that the
    bandwidth's backward partials stay finite on dead rows."""
    return torch.maximum(var, var.new_tensor(math.sqrt(torch.finfo(var.dtype).tiny)))


def epanechnikov_kernel(u: torch.Tensor) -> torch.Tensor:
    """0.75 (1 - u^2) on |u| <= 1, else 0, in the select form of
    ``chimera_tpu/ops/kde.py::epanechnikov_kernel`` (``kde1d_core``'s): its
    slope at |u| = 1 exactly is all of -1.5 u."""
    return torch.where(torch.abs(u) <= 1.0, 0.75 * (1.0 - u * u), 0.0)


def epanechnikov_max_form(u: torch.Tensor) -> torch.Tensor:
    """The same values in the max form of the Pallas kernels and their
    references (``0.75 * jnp.maximum(0, 1 - u^2)``, ``ops/pallas/fused.py``)
    whose slope at |u| = 1 exactly is half of -1.5 u: ``torch.maximum``
    splits it as ``jnp.maximum`` does (``torch.clamp_min`` keeps all of
    it)."""
    q = 1.0 - u * u
    return 0.75 * torch.maximum(q, q.new_zeros(()))


def gaussian_kernel(u: torch.Tensor) -> torch.Tensor:
    return torch.exp(-0.5 * u * u) * (1.0 / _SQRT_2PI)


# the 1-D KDE's kernels (kde1d_core); the fused passes' plain versions take
# the max form, as their references do
KERNELS = {"epan": epanechnikov_kernel, "gauss": gaussian_kernel}
MAX_FORM_KERNELS = {"epan": epanechnikov_max_form, "gauss": gaussian_kernel}


def kde1d_params(dataset: torch.Tensor, weights: torch.Tensor | None, bw_method
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Unit-mass weights and bandwidth of 1-D KDEs over the last axis, with
    the reference's conventions (``chimera_tpu/ops/kde.py::kde1d_params``):
    Kish n_eff of the normalized weights, clipped to [1, S]; the Scott,
    Silverman or fixed factor times the *unweighted* std of the dataset
    (ddof 0), its variance floored at sqrt(tiny).  A row of zero weights
    keeps zero weights and gets finite parameters.  Returns (..., S) weights
    and (...,) bandwidths."""
    s = dataset.shape[-1]
    if weights is None:
        weights = torch.full(dataset.shape, 1.0 / s, dtype=dataset.dtype,
                             device=dataset.device)
    else:
        sw = torch.sum(weights, dim=-1, keepdim=True)
        weights = weights / torch.where(sw > 0, sw, 1.0)
    s2 = torch.sum(weights * weights, dim=-1)
    neff = clip(1.0 / torch.where(s2 > 0, s2, 1.0), 1.0, float(s))
    sig = torch.sqrt(var_floor(torch.var(dataset, dim=-1, correction=0)))
    return weights, bw_factor(neff, 1, bw_method) * sig


def kde1d_core(dataset: torch.Tensor, grid: torch.Tensor,
               norm_weights: torch.Tensor, bandwidth: torch.Tensor,
               kernel: str = "epan") -> torch.Tensor:
    """The raw 1-D KDE contraction, batched over leading axes: dataset and
    normalized weights (..., S), grid (..., G), bandwidth (...,) -> (..., G)
    = sum_s w_s K((g - z_s) / h) / h (``chimera_tpu/ops/kde.py::
    kde1d_core``).  Materializes (..., G, S): callers chunk."""
    h = bandwidth[..., None, None]
    u = (grid[..., :, None] - dataset[..., None, :]) / h
    return torch.sum(norm_weights[..., None, :] * KERNELS[kernel](u),
                     dim=-1) / bandwidth[..., None]


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
