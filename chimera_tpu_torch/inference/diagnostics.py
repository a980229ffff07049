"""Sampler diagnostics: effective sample size and split-R-hat (counterpart
of ``chimera_tpu/inference/diagnostics.py``): Geyer's initial positive
sequence for the ESS, the BDA3 split-R-hat, with FFT autocorrelations."""

from __future__ import annotations

import math

import torch


def _autocovariance(x: torch.Tensor) -> torch.Tensor:
    """Biased autocovariance per chain via FFT.  x: (S, C) -> (S, C)."""
    s = x.shape[0]
    xc = x - torch.mean(x, dim=0, keepdim=True)
    n_fft = 2 * s  # zero-pad to avoid circular wrap
    f = torch.fft.rfft(xc, n=n_fft, dim=0)
    acov = torch.fft.irfft(f * torch.conj(f), n=n_fft, dim=0)[:s]
    return acov / s


def effective_sample_size(chains: torch.Tensor) -> torch.Tensor:
    """ESS of (S, C) or (S, C, D) post-warm-up chains, pooled over chains —
    (D,).

    The classic estimator without rank normalization: the mean-of-chains
    autocovariance combined with the between-chain variance (Vehtari et
    al. 2021, eq. 10), truncated by Geyer's initial positive-pair rule as a
    masked cumulative sum."""
    if chains.dim() == 2:
        chains = chains[:, :, None]
    s, c, d = chains.shape

    def per_dim(x):                                        # (S, C)
        mean_acov = torch.mean(_autocovariance(x), dim=1)  # (S,)
        within = mean_acov[0] * s / (s - 1.0)
        between = torch.var(torch.mean(x, dim=0), correction=1) if c > 1 else 0.0
        var_plus = within * (s - 1.0) / s + between
        rho = 1.0 - (within - mean_acov) / var_plus        # (S,)
        # Geyer pairs rho[2k] + rho[2k+1], kept while positive
        n_pairs = s // 2
        pair = rho[: 2 * n_pairs].reshape(n_pairs, 2).sum(dim=1)
        keep = torch.cumprod((pair > 0.0).to(pair.dtype), dim=0)
        tau = -1.0 + 2.0 * torch.sum(pair * keep)
        tau = torch.clamp_min(tau, 1.0 / math.log10(s + 1.0))
        return s * c / tau

    return torch.stack([per_dim(chains[:, :, i]) for i in range(d)])


def rhat(chains: torch.Tensor) -> torch.Tensor:
    """Split-R-hat of (S, C) or (S, C, D) chains (BDA3 eq. 11.4) — (D,)."""
    if chains.dim() == 2:
        chains = chains[:, :, None]
    s2 = (chains.shape[0] // 2) * 2
    # split each chain in half -> 2C chains of length S/2
    halves = torch.cat([chains[: s2 // 2], chains[s2 // 2: s2]], dim=1)
    n = halves.shape[0]
    chain_means = torch.mean(halves, dim=0)                # (2C, D)
    chain_vars = torch.var(halves, dim=0, correction=1)    # (2C, D)
    b = n * torch.var(chain_means, dim=0, correction=1)    # (D,)
    w = torch.mean(chain_vars, dim=0)                      # (D,)
    var_hat = (n - 1.0) / n * w + b / n
    return torch.sqrt(var_hat / w)
