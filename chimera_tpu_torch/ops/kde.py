"""KDE bandwidth factor, kernels, the 1-D KDE's parameters and contraction,
the d-dimensional Gaussian KDE (direct, batched and streamed over the
samples) and the 3-D Gaussian KDE on a (pixel x z-grid) lattice of the
'full' likelihood (counterpart of ``chimera_tpu/ops/kde.py``).

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


def kde1d(dataset: torch.Tensor, grid: torch.Tensor,
          weights: torch.Tensor | None = None, kernel: str = "epan",
          bw_method=None) -> torch.Tensor:
    """Weighted 1-D KDE of ``dataset`` (S,) on ``grid`` (G,) -> (G,), the
    reference's bandwidth conventions (``kde1d_params``)."""
    return kde1d_batch(dataset[None], grid[None],
                       None if weights is None else weights[None],
                       kernel, bw_method)[0]


def kde1d_batch(dataset: torch.Tensor, grid: torch.Tensor,
                weights: torch.Tensor | None = None, kernel: str = "epan",
                bw_method=None) -> torch.Tensor:
    """:func:`kde1d` over leading axes: dataset and weights (..., S), each
    row's grid (..., G) -> (..., G).  The rows' normalized weights and
    bandwidths come from ``kde1d_params``; their densities from
    ``ops.cuda.kde.kde1d_grid``: on CUDA tensors ONE launch of the
    hand-written kernel K4 over all rows (its adjoint K4b under autograd),
    on CPU tensors its plain version.  A row longer than K4's shared memory
    holds raises there."""
    from chimera_tpu_torch.ops.cuda.kde import kde1d_grid

    lead = dataset.shape[:-1]
    s, g = dataset.shape[-1], grid.shape[-1]
    z = dataset.reshape(-1, s)
    w = None if weights is None else weights.reshape(-1, s)
    wn, h = kde1d_params(z, w, bw_method)
    out = kde1d_grid(z, wn.to(z.dtype), grid.expand(*lead, g).reshape(-1, g),
                     h.to(z.dtype), kernel)
    return out.reshape(*lead, g)


def _safe_norm_weights(weights, shape, dtype, device) -> torch.Tensor:
    """Unit-mass weights over the last axis; an all-zero row falls back to
    uniform weights so every value downstream stays finite."""
    s = shape[-1]
    if weights is None:
        return torch.full(shape, 1.0 / s, dtype=dtype, device=device)
    sw = torch.sum(weights, dim=-1, keepdim=True)
    return torch.where(sw > 0, weights / torch.where(sw > 0, sw, 1.0), 1.0 / s)


def _weighted_cov(dataset: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted covariance of (..., d, S) samples under unit-mass (..., S)
    weights, with the reference's small-sample correction: divided by
    1 - sum w^2 (``chimera_tpu/ops/kde.py::_weighted_cov``).  (..., d, d)."""
    mean = torch.sum(weights[..., None, :] * dataset, dim=-1, keepdim=True)
    resid = dataset - mean
    cov = torch.einsum("...is,...js->...ij", resid * weights[..., None, :], resid)
    return cov / (1.0 - torch.sum(weights * weights, dim=-1))[..., None, None]


def _whitening(dataset: torch.Tensor, weights, bw_method
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unit-mass weights, the Cholesky factor L of inv(cov) / factor^2
    (lower-triangular, inv(cov) / factor^2 = L L^T) and log_norm = sum log
    diag(L) - d/2 log(2 pi) of (..., d, S) samples.  Where the inverse or
    the factor does not exist, L is NaN, as the JAX package's
    ``jnp.linalg`` gives it."""
    d, s = dataset.shape[-2:]
    w = _safe_norm_weights(weights, dataset.shape[:-2] + (s,), dataset.dtype,
                           dataset.device)
    factor = bw_factor(1.0 / torch.sum(w * w, dim=-1), d, bw_method)
    inv_cov, info_inv = torch.linalg.inv_ex(_weighted_cov(dataset, w))
    whitening, info = torch.linalg.cholesky_ex(
        inv_cov / (factor * factor)[..., None, None])
    ok = ((info_inv == 0) & (info == 0))[..., None, None]
    whitening = torch.where(ok, whitening, torch.nan)
    log_norm = torch.sum(torch.log(torch.diagonal(whitening, dim1=-2, dim2=-1)),
                         dim=-1) - 0.5 * d * math.log(2 * math.pi)
    return w, whitening, log_norm


def _chi2_diff(pts_w: torch.Tensor, data_w: torch.Tensor) -> torch.Tensor:
    """||data_w[s] - pts_w[p]||^2 of (..., P, d) and (..., S, d) whitened
    points as an unrolled sum of squared differences — (..., P, S).  The
    expanded p^2 + s^2 - 2 p.s form cancels for nearby points, and at
    reduced matmul precision turned into large negative values (exp(+big) =
    inf) in the JAX package's localization pdfs."""
    chi2 = torch.zeros(pts_w.shape[:-1] + data_w.shape[-2:-1],
                       dtype=pts_w.dtype, device=pts_w.device)
    for k in range(pts_w.shape[-1]):
        diff = pts_w[..., :, k, None] - data_w[..., None, :, k]
        chi2 = chi2 + diff * diff
    return chi2


def gaussian_kde_nd(dataset: torch.Tensor, points: torch.Tensor,
                    weights: torch.Tensor | None = None, bw_method=None,
                    in_log: bool = False) -> torch.Tensor:
    """Weighted d-dimensional Gaussian KDE, batched over leading axes
    (``chimera_tpu/ops/kde.py::gaussian_kde_nd``).

    dataset (..., d, S) samples, points (..., d, P) evaluation points,
    weights (..., S) or None -> density (..., P), or its log through a
    logsumexp with ``in_log``.  The covariance carries the reference's
    small-sample correction 1 / (1 - sum w^2); the kernel is whitened with
    the Cholesky factor of the scaled inverse covariance (NaN where it does
    not exist).  The chi-square is summed in difference form
    (``_chi2_diff``).
    """
    w, whitening, log_norm = _whitening(dataset, weights, bw_method)
    pts_w = torch.einsum("...dp,...dk->...pk", points, whitening)
    data_w = torch.einsum("...ds,...dk->...sk", dataset, whitening)
    chi2 = _chi2_diff(pts_w, data_w)
    if in_log:
        return torch.logsumexp(log_norm[..., None, None] - 0.5 * chi2
                               + torch.log(w)[..., None, :], dim=-1)
    return torch.exp(log_norm)[..., None] * torch.sum(
        torch.exp(-0.5 * chi2) * w[..., None, :], dim=-1)


def gaussian_kde_nd_batch(dataset: torch.Tensor, points: torch.Tensor,
                          weights: torch.Tensor | None = None, bw_method=None,
                          in_log: bool = False) -> torch.Tensor:
    """:func:`gaussian_kde_nd` over a leading event axis: dataset (E, d, S),
    points (E, d, P), weights (E, S) -> (E, P)
    (``chimera_tpu/ops/kde.py::gaussian_kde_nd_batch``)."""
    return gaussian_kde_nd(dataset, points, weights, bw_method, in_log)


def _sample_chunks(data_w: torch.Tensor, w: torch.Tensor, chunk: int):
    """The whitened samples (..., S, d) and their weights (..., S) in
    chunks of ``chunk``, the last padded with zero-weight replicas of the
    first sample (the JAX package's padding)."""
    s = w.shape[-1]
    pad = -(-s // chunk) * chunk - s
    if pad:
        data_w = torch.cat([data_w, data_w[..., :1, :].expand(
            *data_w.shape[:-2], pad, data_w.shape[-1])], dim=-2)
        w = torch.cat([w, w.new_zeros(w.shape[:-1] + (pad,))], dim=-1)
    return [(data_w[..., i:i + chunk, :], w[..., i:i + chunk])
            for i in range(0, s + pad, chunk)]


def gaussian_kde_nd_stream(dataset: torch.Tensor, points: torch.Tensor,
                           weights: torch.Tensor | None = None, bw_method=None,
                           in_log: bool = False, sample_chunk: int = 512
                           ) -> torch.Tensor:
    """:func:`gaussian_kde_nd` with the sample axis streamed in chunks of
    ``sample_chunk`` (``chimera_tpu/ops/kde.py::gaussian_kde_nd_stream``):
    no (..., P, S) tensor is held, only (..., P, sample_chunk).  ``in_log``
    carries a running (max, scaled sum) pair, a streamed logsumexp."""
    w, whitening, log_norm = _whitening(dataset, weights, bw_method)
    pts_w = torch.einsum("...dp,...dk->...pk", points, whitening)
    data_w = torch.einsum("...ds,...dk->...sk", dataset, whitening)
    chunks = _sample_chunks(data_w, w, sample_chunk)
    if not in_log:
        acc = 0.0
        for dw, wc in chunks:
            acc = acc + torch.sum(torch.exp(-0.5 * _chi2_diff(pts_w, dw))
                                  * wc[..., None, :], dim=-1)
        return torch.exp(log_norm)[..., None] * acc
    neg_inf = torch.tensor(-torch.inf, dtype=dataset.dtype, device=dataset.device)
    m = neg_inf.expand(pts_w.shape[:-1])
    t = torch.zeros(pts_w.shape[:-1], dtype=dataset.dtype, device=dataset.device)
    for dw, wc in chunks:
        logw = torch.where(wc > 0, torch.log(torch.where(wc > 0, wc, 1.0)),
                           neg_inf)
        vals = -0.5 * _chi2_diff(pts_w, dw) + logw[..., None, :]   # (..., P, Sc)
        m_new = torch.maximum(m, torch.amax(vals, dim=-1))
        # rescale the running sum and the chunk onto the new max
        # (finite-guarded: -inf - -inf would NaN an all-empty row)
        ok = torch.isfinite(m_new)
        scale = torch.where(ok & torch.isfinite(m), torch.exp(m - m_new), 0.0)
        sub = torch.where(ok[..., None], vals - m_new[..., None], neg_inf)
        t = t * scale + torch.sum(torch.exp(sub), dim=-1)
        m = m_new
    return log_norm[..., None] + m + torch.log(t)


def gaussian_kde_3d_lattice(dataset: torch.Tensor, ra_pix: torch.Tensor,
                            dec_pix: torch.Tensor, z_grid: torch.Tensor,
                            weights: torch.Tensor | None = None,
                            bw_method=None, sample_chunk: int = 512,
                            z_block=0) -> torch.Tensor:
    """The 3-D Gaussian KDE of (z, ra, dec) samples on the product lattice
    of z-grid points and pixel centres, batched over leading axes
    (``chimera_tpu/ops/kde.py::gaussian_kde_3d_lattice``).

    dataset (..., 3, S) rows (z, ra, dec); ra_pix, dec_pix (..., P);
    z_grid (..., G); weights (..., S) (normalized here) -> (..., P, G).
    ``z_block`` is the block length K of the uniform-z recurrence, an int
    or an integer tensor of the leading shape (one K per row): 0 is the
    dense z sweep.

    The whitening L is lower-triangular, so the whitened lattice point
    carries z only in its first component and

        chi2[p, g, s] = (L00 z_g + t[p, s])^2 + q1[p, s]^2 + q2[p, s]^2,

    t, q1, q2 independent of the grid: exp(-(q1^2 + q2^2) / 2) folds into a
    per-(pixel, sample) weight e and the KDE becomes a 1-D Gaussian sweep
    along z.  The dense sweep takes one exp a term.  On a uniform grid
    (step h in whitened units) the recurrence refreshes v = e exp(-u0^2/2)
    and r = exp(-h u0 - h^2/2) exactly at the start of each K-point block
    and then steps v <- v r, r <- r exp(-h^2): two exps per (pixel, block,
    sample).  The grid is padded to whole blocks by continuing its uniform
    spacing; a refresh value below the dtype's smallest normal flushes both
    v and r to 0 (a subnormal start would amplify its quantization, and r
    is +inf for dead pairs far left of the grid).  The caller keeps K h
    small enough that no flushed block rises to a significant value (the
    'full' likelihood's plan: K h <= 5.5).  Samples are streamed in chunks
    of ``sample_chunk`` (zero-weight replicas pad the last), and rows in
    groups that keep each (rows, P, G or blocks, chunk) intermediate near
    ``2**25`` elements.  The arithmetic follows the JAX package's order on
    the raw coordinates.
    """
    lead = dataset.shape[:-2]
    w, whitening, log_norm = _whitening(dataset, weights, bw_method)
    if not isinstance(z_block, torch.Tensor):
        z_block = torch.full(lead, int(z_block), dtype=torch.int64,
                             device=dataset.device)
    n_pix, n_grid = ra_pix.shape[-1], z_grid.shape[-1]
    # every input as rows (B, ...) over the flattened leading axes
    rows = [t.expand(*lead, *t.shape[t.dim() - k:]).reshape(-1, *t.shape[t.dim() - k:])
            for t, k in ((dataset, 2), (ra_pix, 1), (dec_pix, 1), (z_grid, 1),
                         (w, 1), (whitening, 2))]
    blocks = z_block.expand(lead).reshape(-1)
    out = []
    order = []
    for k in torch.unique(blocks).tolist():
        idx = torch.nonzero(blocks == k).reshape(-1)
        step = max(1, (1 << 25) // (n_pix * n_grid * sample_chunk))
        for i in range(0, idx.numel(), step):
            sel = idx[i:i + step]
            out.append(_lattice_rows(*(t[sel] for t in rows), int(k),
                                     sample_chunk))
            order.append(sel)
    acc = torch.cat(out)[torch.argsort(torch.cat(order))]
    acc = acc.reshape(*lead, n_pix, n_grid)
    return torch.exp(log_norm)[..., None, None] * acc


def _lattice_rows(dataset, ra_pix, dec_pix, z_grid, w, whitening, k_block: int,
                  sample_chunk: int) -> torch.Tensor:
    """The lattice sums of rows (B, ...) with one block length: (B, P, G),
    before the normalization exp(log_norm)."""
    data_w = torch.einsum("bds,bdk->bsk", dataset, whitening)      # (B, S, 3)
    ll = whitening
    c0 = ll[:, 1, 0, None] * ra_pix + ll[:, 2, 0, None] * dec_pix  # (B, P)
    c1 = ll[:, 1, 1, None] * ra_pix + ll[:, 2, 1, None] * dec_pix
    c2 = ll[:, 2, 2, None] * dec_pix
    l00 = ll[:, 0, 0]
    zl = l00[:, None] * z_grid                                     # (B, G)
    n_grid = z_grid.shape[-1]
    if k_block > 0:
        k_blk = min(k_block, n_grid)
        n_blk = -(-n_grid // k_blk)
        hl = l00 * (z_grid[:, -1] - z_grid[:, 0]) / max(n_grid - 1, 1)
        starts = torch.arange(n_blk, device=z_grid.device) * k_blk
        zl0 = zl[:, :1] + starts * hl[:, None]                     # (B, J)
        rho = torch.exp(-hl * hl)[:, None, None, None]
        h4 = hl[:, None, None, None]
        tiny = torch.finfo(dataset.dtype).tiny
    acc = 0.0
    for dw, wc in _sample_chunks(data_w, w, sample_chunk):
        q1 = c1[:, :, None] - dw[:, None, :, 1]                    # (B, P, Sc)
        q2 = c2[:, :, None] - dw[:, None, :, 2]
        e = wc[:, None, :] * torch.exp(-0.5 * (q1 * q1 + q2 * q2))
        t = c0[:, :, None] - dw[:, None, :, 0]                     # (B, P, Sc)
        if k_block == 0:
            u = zl[:, None, :, None] + t[:, :, None, :]            # (B, P, G, Sc)
            acc = acc + torch.sum(e[:, :, None, :] * torch.exp(-0.5 * u * u),
                                  dim=-1)
            continue
        u0 = zl0[:, None, :, None] + t[:, :, None, :]              # (B, P, J, Sc)
        v = e[:, :, None, :] * torch.exp(-0.5 * u0 * u0)           # exact refresh
        r = torch.exp(-h4 * u0 - 0.5 * h4 * h4)
        alive = v >= tiny
        v = torch.where(alive, v, 0.0)
        r = torch.where(alive, r, 0.0)
        outs = []
        for j in range(k_blk):
            outs.append(torch.sum(v, dim=-1))                      # (B, P, J)
            if j + 1 < k_blk:
                v = v * r
                r = r * rho
        block = torch.stack(outs, dim=-1)                          # (B, P, J, K)
        acc = acc + block.reshape(*block.shape[:2], n_blk * k_blk)[..., :n_grid]
    return acc
