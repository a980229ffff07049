"""Fused detector->source map + population weights + weighted KDE for a λ
batch, on the analysis grids (counterpart of
``chimera_tpu/ops/pallas/fused.py::fused_weights_kde`` in analysis-grid mode
with ``den_scale='norms'``).

Per (λ, event e), with S samples and G grid points:

    z_s  = z_from_dgw(cosmo_λ, dL_es)
    w_s  = p_m1m2(mass_λ, m1det_es/(1+z_s), m2det_es/(1+z_s)) * inv_pe_prior_es
    h    = bw_factor(N_eff) * std(z),  N_eff = (sum w)^2 / sum w^2
    den  = sum_s w_s K((grid_eg - z_s)/h) / (h S)

``fused_weights_kde`` runs the hand-written CUDA kernel
(``chimera_tpu_torch/csrc/fused_kde.cu``) on CUDA tensors and the plain
PyTorch version ``fused_weights_kde_plain`` on CPU tensors; on CUDA it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from chimera_tpu_torch.models.cosmology import FLRW, z_from_dgw
from chimera_tpu_torch.models.mass import PowerLawPeak, p_m1m2
from chimera_tpu_torch.ops.cuda import build
from chimera_tpu_torch.ops.kde import KERNELS, bw_factor

STAT_NAMES = ("lo", "ub", "norms", "neff", "bandwidth", "sum_w", "sum_w2")
# per-λ PowerLawPeak scalars packed between the cosmology and the CDF window
# fit; the order is the kernel's (csrc/fused_kde.cu, struct MassScalars)
MASS_SCALARS = ("m_low", "m_high", "alpha", "beta", "delta_m", "lambda_peak",
                "mu_g", "sigma_g", "peak_norm", "norm_p_m1", "m_join",
                "cdf_at_join")
# largest dynamic shared memory a block may opt into on Hopper (227 KB),
# less room for the kernel's static reduction scratch
_SMEM_LIMIT = 232448 - 1024
# elements of one (L, events, G, S) intermediate in the plain version
_PLAIN_BUDGET = 1 << 25


def _stats_dict(stats: torch.Tensor) -> dict:
    return {k: stats[..., i] for i, k in enumerate(STAT_NAMES)}


def _bw_code(bw_method) -> tuple[int, float]:
    if bw_method is None or bw_method == "scott":
        return 0, 0.0
    if bw_method == "silverman":
        return 1, 0.0
    if isinstance(bw_method, str):
        raise ValueError("bw_method must be 'scott', 'silverman', or a scalar")
    return 2, float(bw_method)


def fused_weights_kde_plain(m1det, m2det, dl, inv_pe_prior, cosmo, mass,
                            grids, kernel: str = "epan", bw_method=None):
    """Plain PyTorch version with the safe-math row statistics of
    ``chimera_tpu/ops/pallas/fused.py::_reference_impl``; chunked over events
    so that no (L, E, G, S) tensor is ever materialized.

    Returns den (L, E, G) and a dict of (L, E) stats."""
    e, s = dl.shape
    g = grids.shape[1]
    n = max(cosmo.L, mass.L)
    dt = dl.dtype
    kfn = KERNELS[kernel]
    tiny = torch.finfo(dt).tiny
    den = torch.empty((n, e, g), dtype=dt, device=dl.device)
    stats = torch.zeros((n, e, 8), dtype=dt, device=dl.device)
    chunk = max(1, _PLAIN_BUDGET // (n * g * s))
    for e0 in range(0, e, chunk):
        rows = slice(e0, min(e, e0 + chunk))
        z = z_from_dgw(cosmo, dl[None, rows]).expand(n, -1, -1)     # (n, c, S)
        inv1pz = 1.0 / (1.0 + z)
        w = p_m1m2(mass, m1det[None, rows] * inv1pz,
                   m2det[None, rows] * inv1pz) * inv_pe_prior[None, rows]
        sum_w = torch.sum(w, dim=-1)
        sum_w2 = torch.sum(w * w, dim=-1)
        z_mean = torch.mean(z, dim=-1)
        z_var = torch.mean((z - z_mean[..., None]) ** 2, dim=-1)
        # dead rows (zero weight, zero spread) get finite stats; on live rows
        # both clamps are exact no-ops
        z_sig = torch.sqrt(torch.clamp_min(z_var, math.sqrt(tiny)))
        neff = torch.clamp(sum_w * sum_w / torch.where(sum_w2 > 0, sum_w2, 1.0),
                           1.0, float(s))
        h = bw_factor(neff, 1, bw_method) * z_sig
        u = (grids[None, rows, :, None] - z[:, :, None, :]) / h[..., None, None]
        d = torch.sum(w[:, :, None, :] * kfn(u), dim=-1)
        den[:, rows] = d / h[..., None] / s
        st = stats[:, rows]
        st[..., 2] = sum_w / s
        st[..., 3] = neff
        st[..., 4] = h
        st[..., 5] = sum_w
        st[..., 6] = sum_w2
        st[..., 7] = z_sig
    return den, _stats_dict(stats)


def pack_params(cosmo: FLRW, mass: PowerLawPeak, n: int) -> torch.Tensor:
    """Per-λ model state as one contiguous (n, P) tensor at the kernel's
    offsets: cheb_logh[cheb_deg], dgw_lo, dgw_max, the MASS_SCALARS, then
    cheb_cdf_window[window_deg]."""
    cols = [cosmo.cheb_logh.expand(n, -1),
            cosmo.dgw_lo.expand(n)[:, None], cosmo.dgw_max.expand(n)[:, None]]
    cols += [getattr(mass, k).expand(n)[:, None] for k in MASS_SCALARS]
    cols.append(mass.cheb_cdf_window.expand(n, -1))
    return torch.cat(cols, dim=1).contiguous()


def fused_weights_kde(m1det, m2det, dl, inv_pe_prior, cosmo, mass, grids,
                      kernel: str = "epan", bw_method=None):
    """Fused hot loop of the spectral-siren likelihood for a λ batch.

    Args:
      m1det, m2det, dl, inv_pe_prior: (E, S) detector-frame PE samples.
      cosmo, mass: λ-batched ``FLRW`` (chebyshev engine) and
        ``PowerLawPeak`` (analytic CDF engine).
      grids: (E, G) analysis grids the densities are evaluated on.

    Returns:
      den (L, E, G) — densities times the KDE norm sum(w)/S — and a dict of
      (L, E) stats: lo, ub (zeros: no effective grid), norms, neff,
      bandwidth, sum_w, sum_w2.

    CPU tensors take the plain version.  CUDA tensors launch the kernel and
    raise on anything it does not take; the kernel's row statistics are the
    raw formulas (a dead row gives NaN where the plain version clamps — the
    N_eff gate and nan_to_num downstream treat both alike).
    """
    if dl.device.type == "cpu":
        return fused_weights_kde_plain(m1det, m2det, dl, inv_pe_prior, cosmo,
                                       mass, grids, kernel, bw_method)
    if dl.device.type != "cuda":
        raise ValueError(f"fused_weights_kde: unsupported device {dl.device}")
    if type(cosmo) is not FLRW or cosmo.interp_method != "chebyshev":
        raise NotImplementedError(
            "the fused CUDA kernel covers FLRW with the chebyshev engine")
    if type(mass) is not PowerLawPeak or mass.cdf_engine != "analytic":
        raise NotImplementedError(
            "the fused CUDA kernel covers PowerLawPeak with the analytic CDF")
    if kernel not in ("epan", "gauss"):
        raise ValueError(f"unknown KDE kernel {kernel!r}")
    bw_mode, bw_value = _bw_code(bw_method)
    dt = dl.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"fused_weights_kde takes float32 or float64, not {dt}")
    e, s = dl.shape
    g = grids.shape[1]
    for name, t in (("m1det", m1det), ("m2det", m2det),
                    ("inv_pe_prior", inv_pe_prior)):
        if t.shape != (e, s) or t.dtype != dt or t.device != dl.device:
            raise ValueError(f"{name} must be ({e}, {s}) {dt} on {dl.device}")
    if grids.shape != (e, g) or grids.dtype != dt or grids.device != dl.device:
        raise ValueError(f"grids must be ({e}, G) {dt} on {dl.device}")
    n = max(cosmo.L, mass.L)
    params = pack_params(cosmo, mass, n).to(device=dl.device, dtype=dt)
    p = params.shape[1]
    smem = s * 2 * dl.element_size() + p * dl.element_size()
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"S = {s} samples need {smem} bytes of shared memory per block "
            f"(z and w of every sample), over the {_SMEM_LIMIT}-byte limit")
    inputs = [t.contiguous() for t in (m1det, m2det, dl, inv_pe_prior, grids)]
    den = torch.empty((n, e, g), dtype=dt, device=dl.device)
    stats = torch.empty((n, e, 8), dtype=dt, device=dl.device)

    lib = build.load("fused_kde")  # nvcc at first use
    fn = lib.chimera_fused_kde_f32 if dt == torch.float32 else lib.chimera_fused_kde_f64
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 8 + [i32] * 9 + [ctypes.c_double, ptr]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dl.device):
        stream = torch.cuda.current_stream(dl.device).cuda_stream
        err = fn(*(t.data_ptr() for t in inputs), params.data_ptr(),
                 den.data_ptr(), stats.data_ptr(),
                 n, e, s, g, p, cosmo.cheb_deg, mass.window_deg,
                 0 if kernel == "epan" else 1, bw_mode, bw_value, stream)
    if err != 0:
        raise RuntimeError(f"fused_kde kernel launch failed: cudaError {err}")
    fused_weights_kde.launches += 1
    return den, _stats_dict(stats)


fused_weights_kde.launches = 0
