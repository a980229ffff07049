"""Fused detector->source map + population weights (+ weighted KDE) for a
λ batch: the counterpart of ``chimera_tpu/ops/pallas/fused.py::
fused_weights_kde`` in the two modes the port's main paths run.

Per (λ, row), with S samples and G grid points:

    z_s  = z_from_dgw(cosmo_λ, dL_s)
    w_s  = p_m1m2(mass_λ, m1det_s/(1+z_s), m2det_s/(1+z_s)) * inv_pe_prior_s
    h    = bw_factor(N_eff) * std(z),  N_eff = (sum w)^2 / sum w^2
    den  = sum_s w_s K((grid_g - z_s)/h) / (h S)

* ``fused_weights_kde`` (K1a): the densities on the analysis grids with
  ``den_scale='norms'`` — the spectral-siren hot loop.
* ``fused_row_stats`` (K1c): the row statistics only, of the *logical* rows
  of the dark-siren per-pixel layout (``n_real``, ``dl_fill``,
  ``logical_s``: each row is one pixel's samples followed by zero-weight
  fillers at ``dl_fill``, standing for the event's ``logical_s`` samples
  with the out-of-pixel ones at the filler z).

* ``fused_weights_kde_adjoint`` (K3): the backward of ``fused_weights_kde``
  in the hyper-parameters — given cotangents of (den, stats), the gradients
  of the two packed per-λ rows of ``pack_params``.

They run the hand-written CUDA kernels (``chimera_tpu_torch/csrc/
fused_kde.cu``, ``fused_kde_adjoint.cu``) on CUDA tensors and the plain
PyTorch versions ``fused_weights_kde_plain`` and
``fused_weights_kde_adjoint_plain`` on CPU tensors; on CUDA they launch the
kernel or raise.

Gradients.  On CPU tensors ``fused_weights_kde`` is its plain version and
autograd differentiates it.  On CUDA tensors the K1a launch sits in a
``torch.autograd.Function`` whose backward returns gradients for the packed
rows only (the PE data and grids get none: samplers differentiate
hyper-parameters) by launching K3.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from chimera_tpu_torch.models.cosmology import FLRW, z_from_dgw
from chimera_tpu_torch.models.mass import PowerLawPeak, p_m1m2
from chimera_tpu_torch.ops.cuda import build
from chimera_tpu_torch.ops.kde import KERNELS, bw_factor

STAT_NAMES = ("lo", "ub", "norms", "neff", "bandwidth", "sum_w", "sum_w2")
# per-λ PowerLawPeak scalars, the kernels' mass row, in the order of the
# Model constructor (csrc/population.cuh)
MASS_SCALARS = ("m_low", "m_high", "alpha", "beta", "delta_m", "lambda_peak",
                "mu_g", "sigma_g", "peak_norm", "norm_p_m1", "m_join",
                "cdf_at_join")
# largest dynamic shared memory a block may opt into on Hopper (227 KB),
# less room for the kernel's static reduction scratch
_SMEM_LIMIT = 232448 - 1024
# elements of one (L, events, G, S) intermediate in the plain version
_PLAIN_BUDGET = 1 << 25
# largest Chebyshev degree of either series in the adjoint kernel (its
# per-thread coefficient accumulators, csrc/fused_kde_adjoint.cu), and room
# for its static shared memory (block-sum scratch and the dual mass model)
_ADJOINT_MAX_DEG = 64
_ADJOINT_STATIC_SMEM = 8192


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
                            grids=None, kernel: str = "epan", bw_method=None,
                            n_real=None, dl_fill=None, logical_s=None,
                            cut_grid=None, stats_only: bool = False):
    """Plain PyTorch version with the safe-math row statistics of
    ``chimera_tpu/ops/pallas/fused.py::_reference_impl``; chunked over rows
    so that no (L, E, G, S) tensor is ever materialized.

    ``n_real`` (E,), ``dl_fill`` (E,) and ``logical_s`` give the row
    statistics of the logical rows of the per-pixel layout, in the TPU
    kernel's form (fused.py:127-137); ``cut_grid`` fills the lo, ub stats
    from the z range.  ``stats_only`` skips the KDE (den is None): the only
    mode that takes the logical-row or cut_grid arguments here.

    Returns den (L, E, G) and a dict of (L, E) stats."""
    if not stats_only and (logical_s is not None or cut_grid is not None):
        raise NotImplementedError(
            "densities of the logical per-pixel rows or on effective grids "
            "(K1 modes b, d) are ROADMAP.md §1 items 8 and 12")
    if logical_s is not None and (n_real is None or dl_fill is None):
        raise ValueError("logical_s requires n_real and dl_fill")
    e, s = dl.shape
    g = 1 if stats_only else grids.shape[1]
    n = max(cosmo.L, mass.L)
    dt = dl.dtype
    sl = float(s if logical_s is None else logical_s)
    tiny = torch.finfo(dt).tiny
    den = None if stats_only else torch.empty((n, e, g), dtype=dt, device=dl.device)
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
        z_min, z_max = torch.amin(z, dim=-1), torch.amax(z, dim=-1)
        if logical_s is None:
            z_mean = torch.mean(z, dim=-1)
            z_var = torch.mean((z - z_mean[..., None]) ** 2, dim=-1)
        else:
            nr = n_real[rows].to(dt)
            f_pp = float(s) - nr                                    # fillers present
            f_log = sl - nr                                         # fillers logical
            zf = z_from_dgw(cosmo, dl_fill[None, rows]).expand(n, -1)
            z_mean = (torch.sum(z, dim=-1) - f_pp * zf + f_log * zf) / sl
            ss_pp = torch.sum((z - z_mean[..., None]) ** 2, dim=-1)
            z_var = (ss_pp + (f_log - f_pp) * (zf - z_mean) ** 2) / sl
            z_min, z_max = torch.minimum(z_min, zf), torch.maximum(z_max, zf)
        # dead rows (zero weight, zero spread) get finite stats; on live rows
        # both clamps are exact no-ops
        z_sig = torch.sqrt(torch.clamp_min(z_var, math.sqrt(tiny)))
        neff = torch.clamp(sum_w * sum_w / torch.where(sum_w2 > 0, sum_w2, 1.0),
                           1.0, sl)
        h = bw_factor(neff, 1, bw_method) * z_sig
        st = stats[:, rows]
        if cut_grid is not None:
            lo = z_min - cut_grid * z_sig
            st[..., 0] = torch.where(lo > 0.0, lo, 1e-8)
            st[..., 1] = z_max + cut_grid * z_sig
        st[..., 2] = sum_w / sl
        st[..., 3] = neff
        st[..., 4] = h
        st[..., 5] = sum_w
        st[..., 6] = sum_w2
        st[..., 7] = z_sig
        if not stats_only:
            u = (grids[None, rows, :, None] - z[:, :, None, :]) / h[..., None, None]
            d = torch.sum(w[:, :, None, :] * KERNELS[kernel](u), dim=-1)
            den[:, rows] = d / h[..., None] / s
    return den, _stats_dict(stats)


def pack_params(cosmo: FLRW, mass: PowerLawPeak, n: int, dtype
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-λ model state as two contiguous rows at the kernels' offsets
    (csrc/population.cuh, Model): the two Chebyshev series in float64,
    (n, cheb_deg + 2 + window_deg) = cheb_logh, dgw_lo, dgw_max,
    cheb_cdf_window; and the mass scalars in ``dtype``, (n, 12) = the
    MASS_SCALARS."""
    f64 = torch.float64
    series = torch.cat([cosmo.cheb_logh.to(f64).expand(n, -1),
                        cosmo.dgw_lo.to(f64).expand(n)[:, None],
                        cosmo.dgw_max.to(f64).expand(n)[:, None],
                        mass.cheb_cdf_window.to(f64).expand(n, -1)], dim=1)
    cols = [getattr(mass, k).expand(n)[:, None] for k in MASS_SCALARS]
    return series.contiguous(), torch.cat(cols, dim=1).to(dtype).contiguous()


def smem_bytes(series: torch.Tensor, sum_size: int, params: torch.Tensor,
               n_values: int) -> int:
    """Dynamic shared memory of a block: the series row in the kernel's
    summation type of ``sum_size`` bytes (rounded up to 16 bytes), then
    ``n_values`` working-dtype values and the mass scalars
    (csrc/population.cuh, series_bytes)."""
    head = (series.shape[1] * sum_size + 15) // 16 * 16
    return head + (n_values + params.shape[1]) * params.element_size()


def check_cuda_call(name: str, cosmo, mass, dl, others: dict) -> None:
    """What every kernel wrapper checks before a launch: CUDA tensors of
    float32 or float64, FLRW-chebyshev and PowerLawPeak-analytic models, and
    ``others`` ({name: tensor}) of ``dl``'s shape, dtype and device."""
    if dl.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dl.device}")
    if type(cosmo) is not FLRW or cosmo.interp_method != "chebyshev":
        raise NotImplementedError(
            f"{name}: the CUDA kernels cover FLRW with the chebyshev engine")
    if type(mass) is not PowerLawPeak or mass.cdf_engine != "analytic":
        raise NotImplementedError(
            f"{name}: the CUDA kernels cover PowerLawPeak with the analytic CDF")
    dt = dl.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"{name} takes float32 or float64, not {dt}")
    for key, t in others.items():
        if t.shape != dl.shape or t.dtype != dt or t.device != dl.device:
            raise ValueError(f"{key} must be {tuple(dl.shape)} {dt} on {dl.device}")


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would record a kernel launch that has no
    backward: its outputs would come back as constants and the gradient be
    silently short of their part."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward on CUDA tensors: the dark-siren gradient "
            "is ROADMAP.md §1 item 9")


def launch(lib_name: str, symbol: str, dtype, device, args) -> None:
    """Call ``<symbol>_f32`` or ``<symbol>_f64`` of ``csrc/<lib_name>.cu`` on
    the current stream; each arg is a tensor (its pointer), an int or a
    float.  Raises on a refused launch."""
    lib = build.load(lib_name)  # nvcc at first use
    fn = getattr(lib, f"{symbol}_{'f32' if dtype == torch.float32 else 'f64'}")
    fn.argtypes = [ctypes.c_void_p if isinstance(a, torch.Tensor) else
                   ctypes.c_double if isinstance(a, float) else ctypes.c_int
                   for a in args] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                   for a in args), stream)
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: cudaError {err}")


def _launch_fused_kde(series, params, m1det, m2det, dl, inv_pe_prior, grids,
                      cosmo, mass, kernel, bw_method):
    """Launch K1a on checked inputs; returns den (L, E, G) and the stats
    tensor (L, E, 8)."""
    bw_mode, bw_value = _bw_code(bw_method)
    dt = dl.dtype
    e, s = dl.shape
    n, g = series.shape[0], grids.shape[1]
    den = torch.empty((n, e, g), dtype=dt, device=dl.device)
    stats = torch.empty((n, e, 8), dtype=dt, device=dl.device)
    launch("fused_kde", "chimera_fused_kde", dt, dl.device,
           [m1det, m2det, dl, inv_pe_prior, grids, series, params, den, stats,
            n, e, s, g, cosmo.cheb_deg, mass.window_deg,
            0 if kernel == "epan" else 1, bw_mode, float(bw_value)])
    fused_weights_kde.launches += 1
    return den, stats


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
    N_eff gate and nan_to_num downstream treat both alike).  Where a model
    tensor requires grad, the backward on CUDA tensors is the adjoint kernel
    (``fused_weights_kde_adjoint``).
    """
    if dl.device.type == "cpu":
        return fused_weights_kde_plain(m1det, m2det, dl, inv_pe_prior, cosmo,
                                       mass, grids, kernel, bw_method)
    check_cuda_call("fused_weights_kde", cosmo, mass, dl,
                    {"m1det": m1det, "m2det": m2det, "inv_pe_prior": inv_pe_prior})
    if kernel not in ("epan", "gauss"):
        raise ValueError(f"unknown KDE kernel {kernel!r}")
    dt = dl.dtype
    e, s = dl.shape
    g = grids.shape[1]
    if grids.shape != (e, g) or grids.dtype != dt or grids.device != dl.device:
        raise ValueError(f"grids must be ({e}, G) {dt} on {dl.device}")
    n = max(cosmo.L, mass.L)
    series, params = (t.to(dl.device) for t in pack_params(cosmo, mass, n, dt))
    # K1a sums the Chebyshev series in the working dtype
    smem = smem_bytes(series, dl.element_size(), params, 2 * s)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"S = {s} samples need {smem} bytes of shared memory per block "
            f"(z and w of every sample), over the {_SMEM_LIMIT}-byte limit")
    inputs = [t.contiguous() for t in (m1det, m2det, dl, inv_pe_prior, grids)]
    if torch.is_grad_enabled() and (series.requires_grad or params.requires_grad):
        den, stats = _FusedKDE.apply(series, params, *inputs, cosmo, mass,
                                     kernel, bw_method)
    else:
        den, stats = _launch_fused_kde(series, params, *inputs, cosmo, mass,
                                       kernel, bw_method)
    return den, _stats_dict(stats)


fused_weights_kde.launches = 0


def unpack_params(cosmo: FLRW, mass: PowerLawPeak, series: torch.Tensor,
                  params: torch.Tensor) -> tuple[FLRW, PowerLawPeak]:
    """The inverse of ``pack_params``: ``cosmo`` and ``mass`` with the
    packed fields replaced by the rows' columns (the other fields, which
    the fused pass does not read, stay)."""
    cd = cosmo.cheb_deg
    cosmo = dataclasses.replace(
        cosmo, cheb_logh=series[:, :cd], dgw_lo=series[:, cd],
        dgw_max=series[:, cd + 1])
    mass = dataclasses.replace(
        mass, cheb_cdf_window=series[:, cd + 2:],
        **{k: params[:, i] for i, k in enumerate(MASS_SCALARS)})
    return cosmo, mass


def fused_weights_kde_adjoint_plain(m1det, m2det, dl, inv_pe_prior, grids,
                                    series, params, ct_den, ct_stats,
                                    cosmo, mass, kernel: str = "epan",
                                    bw_method=None):
    """Plain PyTorch version of ``fused_weights_kde_adjoint``: the
    vector-Jacobian product of ``fused_weights_kde_plain`` in the packed
    rows, by autograd, one chunk of events at a time so that no
    (L, E, G, S) graph is ever held."""
    e, s = dl.shape
    n, g = series.shape[0], grids.shape[1]
    series = series.detach().requires_grad_()
    params = params.detach().requires_grad_()
    d_series = torch.zeros_like(series)
    d_params = torch.zeros_like(params)
    chunk = max(1, _PLAIN_BUDGET // (n * g * s))
    with torch.enable_grad():
        for e0 in range(0, e, chunk):
            rows = slice(e0, min(e, e0 + chunk))
            cos, mas = unpack_params(cosmo, mass, series, params)
            den, stats = fused_weights_kde_plain(
                m1det[rows], m2det[rows], dl[rows], inv_pe_prior[rows], cos,
                mas, grids[rows], kernel, bw_method)
            out = torch.sum(den * ct_den[:, rows])
            for i, k in enumerate(STAT_NAMES):
                if i >= 2:  # lo, ub are constants on analysis grids
                    out = out + torch.sum(stats[k] * ct_stats[:, rows, i])
            gs, gp = torch.autograd.grad(out, (series, params))
            d_series += gs
            d_params += gp
    return d_series, d_params


def fused_weights_kde_adjoint(m1det, m2det, dl, inv_pe_prior, grids, series,
                              params, ct_den, ct_stats, cosmo, mass,
                              kernel: str = "epan", bw_method=None):
    """Backward of ``fused_weights_kde`` in the hyper-parameters (K3).

    Args:
      m1det, m2det, dl, inv_pe_prior, grids: the forward's data.
      series, params: the packed per-λ rows of ``pack_params``.
      ct_den (L, E, G), ct_stats (L, E, 8): cotangents of the forward's
        densities and of its stats in the order of ``STAT_NAMES`` (slots 0,
        1 and 7 are not read: lo and ub are constants on analysis grids).
      cosmo, mass: the models the rows were packed from (their degrees and
        engines; the plain version rebuilds them around the rows).

    Returns d_series (L, cheb_deg + 2 + window_deg) float64 and d_params
    (L, 12), summed over events in a fixed order: equal inputs give equal
    bits.  The row statistics are differentiated in their safe-math form
    (variance floored, N_eff clamped to [1, S]), so a dead row with zero
    cotangents adds exact zeros.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise.
    """
    if dl.device.type == "cpu":
        return fused_weights_kde_adjoint_plain(
            m1det, m2det, dl, inv_pe_prior, grids, series, params, ct_den,
            ct_stats, cosmo, mass, kernel, bw_method)
    check_cuda_call("fused_weights_kde_adjoint", cosmo, mass, dl,
                    {"m1det": m1det, "m2det": m2det, "inv_pe_prior": inv_pe_prior})
    if kernel not in ("epan", "gauss"):
        raise ValueError(f"unknown KDE kernel {kernel!r}")
    bw_mode, bw_value = _bw_code(bw_method)
    dt = dl.dtype
    e, s = dl.shape
    g = grids.shape[1]
    n, q = series.shape
    if cosmo.cheb_deg > _ADJOINT_MAX_DEG or mass.window_deg > _ADJOINT_MAX_DEG:
        raise ValueError(
            f"the adjoint kernel takes Chebyshev degrees up to {_ADJOINT_MAX_DEG}")
    expect = {"grids": ((e, g), dt), "series": ((n, cosmo.cheb_deg + 2
                                                 + mass.window_deg), torch.float64),
              "params": ((n, len(MASS_SCALARS)), dt),
              "ct_den": ((n, e, g), dt), "ct_stats": ((n, e, 8), dt)}
    given = {"grids": grids, "series": series, "params": params,
             "ct_den": ct_den, "ct_stats": ct_stats}
    for key, (shape, dtype) in expect.items():
        t = given[key]
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dl.device:
            raise ValueError(f"{key} must be {shape} {dtype} on {dl.device}")
    # z, w and their cotangents of every sample, the grid with its scaled
    # cotangents, the model rows
    smem = smem_bytes(series, dl.element_size(), params, 4 * s + 2 * g)
    if smem > _SMEM_LIMIT - _ADJOINT_STATIC_SMEM:
        raise ValueError(
            f"S = {s} samples need {smem} bytes of shared memory per block "
            f"(z, w, dz and dw of every sample), over the "
            f"{_SMEM_LIMIT - _ADJOINT_STATIC_SMEM}-byte limit")
    inputs = [t.contiguous() for t in (m1det, m2det, dl, inv_pe_prior, grids,
                                       series, params, ct_den, ct_stats)]
    partials = torch.empty((n, e, q + len(MASS_SCALARS)), dtype=torch.float64,
                           device=dl.device)
    d_series = torch.empty((n, q), dtype=torch.float64, device=dl.device)
    d_params = torch.empty((n, len(MASS_SCALARS)), dtype=dt, device=dl.device)
    launch("fused_kde_adjoint", "chimera_fused_kde_adjoint", dt, dl.device,
           [*inputs, partials, d_series, d_params, n, e, s, g, cosmo.cheb_deg,
            mass.window_deg, 0 if kernel == "epan" else 1, bw_mode,
            float(bw_value)])
    fused_weights_kde_adjoint.launches += 1
    return d_series, d_params


fused_weights_kde_adjoint.launches = 0


class _FusedKDE(torch.autograd.Function):
    """K1a forward on CUDA tensors with K3 as the backward in the packed
    rows."""

    @staticmethod
    def forward(ctx, series, params, m1det, m2det, dl, inv_pe_prior, grids,
                cosmo, mass, kernel, bw_method):
        ctx.save_for_backward(series, params, m1det, m2det, dl, inv_pe_prior,
                              grids)
        ctx.cfg = (cosmo, mass, kernel, bw_method)
        return _launch_fused_kde(series, params, m1det, m2det, dl,
                                 inv_pe_prior, grids, cosmo, mass, kernel,
                                 bw_method)

    @staticmethod
    def backward(ctx, ct_den, ct_stats):
        series, params, *data = ctx.saved_tensors
        cosmo, mass, kernel, bw_method = ctx.cfg
        d_series, d_params = fused_weights_kde_adjoint(
            *data, series, params, ct_den.contiguous(), ct_stats.contiguous(),
            cosmo, mass, kernel, bw_method)
        return (d_series, d_params) + (None,) * 9


def fused_row_stats_plain(m1det, m2det, dl, inv_pe_prior, cosmo, mass,
                          n_real, dl_fill, logical_s: int, cut_grid: float = 2.0,
                          bw_method=None) -> dict:
    """Plain PyTorch version of ``fused_row_stats`` (``_reference_impl`` in
    its stats-only mode)."""
    return fused_weights_kde_plain(
        m1det, m2det, dl, inv_pe_prior, cosmo, mass, bw_method=bw_method,
        n_real=n_real, dl_fill=dl_fill, logical_s=logical_s,
        cut_grid=cut_grid, stats_only=True)[1]


def fused_row_stats(m1det, m2det, dl, inv_pe_prior, cosmo, mass, n_real,
                    dl_fill, logical_s: int, cut_grid: float = 2.0,
                    bw_method=None) -> dict:
    """Row statistics of a λ batch with no KDE (the stats-only mode of the
    TPU kernel, K1c): the first pass of the dark-siren 'marginalized' path.

    Args:
      m1det, m2det, dl, inv_pe_prior: (B, S) rows, each holding its
        ``n_real[b]`` samples first and zero-weight fillers at ``dl_fill[b]``
        after them (``data.pixelize.compact_samples_by_pixel``).
      n_real, dl_fill, logical_s: (B,) int, (B,) and int — the statistics
        are those of the logical row of ``logical_s`` samples, the
        ``logical_s - n_real`` missing ones at z(dl_fill) with zero weight.
      cut_grid: lo, ub = the z range -/+ cut_grid sigma (lo floored at
        1e-8), as the TPU kernel computes them.

    Returns a dict of (L, B) stats: lo, ub, norms (sum_w / logical_s), neff,
    bandwidth, sum_w, sum_w2.  CPU tensors take the plain version (the TPU
    kernel's safe-math); on CUDA the kernel keeps the raw formulas (NaN
    neff and bandwidth on a zero-weight row).
    """
    if dl.device.type == "cpu":
        return fused_row_stats_plain(m1det, m2det, dl, inv_pe_prior, cosmo,
                                     mass, n_real, dl_fill, logical_s,
                                     cut_grid, bw_method)
    check_cuda_call("fused_row_stats", cosmo, mass, dl,
                    {"m1det": m1det, "m2det": m2det, "inv_pe_prior": inv_pe_prior})
    bw_mode, bw_value = _bw_code(bw_method)
    dt = dl.dtype
    b, s = dl.shape
    if n_real.shape != (b,) or dl_fill.shape != (b,):
        raise ValueError(f"n_real and dl_fill must be ({b},)")
    n = max(cosmo.L, mass.L)
    series, params = (t.to(dl.device) for t in pack_params(cosmo, mass, n, dt))
    refuse_grad("fused_row_stats", series, params)
    # the dark-siren kernels sum the Chebyshev series in float64
    smem = smem_bytes(series, 8, params, s)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"S = {s} samples need {smem} bytes of shared memory per block "
            f"(z of every sample), over the {_SMEM_LIMIT}-byte limit")
    inputs = [t.contiguous() for t in (m1det, m2det, dl, inv_pe_prior)]
    stats = torch.empty((n, b, 8), dtype=dt, device=dl.device)
    launch("fused_kde", "chimera_row_stats", dt, dl.device,
           [*inputs, n_real.to(device=dl.device, dtype=torch.int64).contiguous(),
            dl_fill.to(device=dl.device, dtype=dt).contiguous(), series, params,
            stats, n, b, s, cosmo.cheb_deg, mass.window_deg, int(logical_s),
            bw_mode, float(bw_value), float(cut_grid)])
    fused_row_stats.launches += 1
    return _stats_dict(stats)


fused_row_stats.launches = 0
