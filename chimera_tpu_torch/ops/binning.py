"""Weighted 1-D binning, the sample compression of the binned KDE path
(counterpart of ``chimera_tpu/ops/binning.py``, its 'scatter' method).

Each row's samples go into ``num_bins`` equal-width bins over the row's
[min, max]; a bin stands for its centre with the sum of its weights, so the
KDE contraction is (grid x bins) instead of (grid x samples).
"""

from __future__ import annotations

import torch

from chimera_tpu_torch.ops.integrate import linspace


def binning1d(dataset: torch.Tensor, weights: torch.Tensor, num_bins: int = 200
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Bin centres and bin weights (..., num_bins) of the rows of ``dataset``
    and ``weights`` (..., S), by one accumulating ``index_put_`` over the
    flattened (row, bin) index: on CUDA it sorts the indices and sums each
    bin's weights in sample order, so equal inputs give equal bits (a
    ``scatter_add_`` sums by atomics, in an order that changes between
    runs, and a sampler on the binned path would not repeat its chains).

    A row whose span is 0 (all samples at one z, e.g. a pixel row of
    fillers only) gives (z - lo) / 0 = NaN; XLA converts that to bin 0 and
    torch has no defined conversion (on CUDA the index would fall outside the
    output), so a non-finite position is mapped to bin 0 here.  The weights
    of such rows are 0 in the likelihood, so their sums are unchanged."""
    lo = torch.amin(dataset, dim=-1)
    hi = torch.amax(dataset, dim=-1)
    edges = linspace(lo, hi, num_bins + 1)
    centers = 0.5 * (edges[..., :-1] + edges[..., 1:])
    # a sample's bin is piecewise constant in the data (no slope): its
    # index is computed outside the autograd graph
    with torch.no_grad():
        pos = (dataset - lo[..., None]) / (hi - lo)[..., None] * num_bins
        pos = torch.where(torch.isfinite(pos), torch.floor(pos), 0.0)
        idx = pos.clamp_(0, num_bins - 1).long()
        rows = dataset.numel() // dataset.shape[-1]
        idx = idx.reshape(rows, -1)
        idx += torch.arange(rows, device=idx.device)[:, None] * num_bins
    counts = torch.zeros(rows * num_bins, dtype=weights.dtype,
                         device=weights.device)
    counts.index_put_((idx.reshape(-1),), weights.reshape(-1), accumulate=True)
    return centers, counts.reshape(centers.shape)
