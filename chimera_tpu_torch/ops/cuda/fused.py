"""Fused detector->source map + population weights (+ weighted KDE) for a
λ batch: the counterpart of ``chimera_tpu/ops/pallas/fused.py::
fused_weights_kde`` in the modes the port's paths run.

Per (λ, row), with S samples and G grid points:

    z_s  = z_from_dgw(cosmo_λ, dL_s)
    w_s  = p_m1m2(mass_λ, m1det_s/(1+z_s), m2det_s/(1+z_s)) * inv_pe_prior_s
    h    = bw_factor(N_eff) * std(z),  N_eff = (sum w)^2 / sum w^2
    den  = sum_s w_s K((grid_g - z_s)/h) / (h S)       (den_scale='norms')
        or sum_s w_s K((grid_g - z_s)/h) / (h sum w)   (den_scale='unit')

* ``fused_weights_kde``: the densities, on
  - the analysis grids (K1a, ``grids``) — the spectral-siren hot loop;
  - an effective grid per (λ, row), ``n_grid`` points over
    [z_min - c σ, z_max + c σ] (K1b, ``cut_grid``);
  - an effective grid over given bounds (K1d, ``ext_bounds``), on the
    logical rows of the dark-siren per-pixel layout (``n_real``,
    ``dl_fill``, ``logical_s``: each row is one pixel's samples followed by
    zero-weight fillers at ``dl_fill``, standing for the event's
    ``logical_s`` samples with the out-of-pixel ones at the filler z);
  - or, with ``contract`` (K1e), the unit-mass densities of those logical
    rows on the analysis grids contracted in the kernel against the
    dark-siren factors: r (L, B, 2) in place of the densities.
* ``fused_row_stats`` (K1c): the row statistics only, of logical rows or of
  plain ones.
* ``fused_weights_kde_adjoint`` (K3): the backward of ``fused_weights_kde``
  and ``fused_row_stats`` in the hyper-parameters, in every mode — given
  cotangents of (den, stats), the gradients of the two packed per-λ rows of
  ``pack_params`` (and of ``ext_bounds``).

They run the hand-written CUDA kernels (``chimera_tpu_torch/csrc/
fused_kde.cu``, ``fused_kde_adjoint.cu``) on CUDA tensors and the plain
PyTorch versions ``fused_weights_kde_plain`` and
``fused_weights_kde_adjoint_plain`` on CPU tensors; on CUDA they launch the
kernel or raise.  ``fused_weights_kde.launches`` counts K1a launches,
``.launches_b`` K1b, ``.launches_d`` K1d and ``.launches_e`` K1e;
``fused_weights_kde_adjoint``
counts K3 by the forward's mode the same way (``.launches`` on analysis
grids, ``.launches_b``, ``.launches_c`` stats only, ``.launches_d``).

Models.  The kernels evaluate FLRW and MGFLRW with the Chebyshev engine (the
same inverse series) and the mass models of ``MASS_KINDS`` with the analytic
CDF, one library a mass model (``csrc/population.cuh``, CHIMERA_MASS_KIND);
each model's scalars form its own packed row (``MODEL_SCALARS``,
``pack_params``).  Anything else raises by name on CUDA tensors.

Gradients.  On CPU tensors every mode is its plain version and autograd
differentiates it.  On CUDA tensors each K1 launch whose model rows (or
``ext_bounds``) require grad sits in a ``torch.autograd.Function`` whose
backward launches K3 in the same mode and returns gradients for the packed
rows and ``ext_bounds`` only (the PE data and grids get none: samplers
differentiate hyper-parameters), PowerLawSpline's coefficients included
(their columns of the packed row).  K1e has no adjoint kernel: on CUDA
tensors that require grad it raises (ROADMAP.md §1 item 15).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from chimera_tpu_torch.models.cosmology import FLRW, MGFLRW, z_from_dgw
from chimera_tpu_torch.models.mass import BaseMassModel, PowerLawSpline, p_m1m2
from chimera_tpu_torch.ops.cuda import build
from chimera_tpu_torch.ops.kde import (MAX_FORM_KERNELS, bw_factor, clip,
                                       var_floor)

STAT_NAMES = ("lo", "ub", "norms", "neff", "bandwidth", "sum_w", "sum_w2")
# the mass models the kernels evaluate, by class name: CHIMERA_MASS_KIND of
# their build (csrc/population.cuh, MassKind)
MASS_KINDS = {"PowerLawPeak": 0, "TruncatedPowerLaw": 1, "BrokenPowerLaw": 2,
              "PowerLawTwoPeaks": 3, "PowerLawSpline": 4}
# per-λ PowerLawPeak scalars, the kernels' mass row, in the order of its
# MassModel (csrc/population.cuh)
MASS_SCALARS = ("m_low", "m_high", "alpha", "beta", "delta_m", "lambda_peak",
                "mu_g", "sigma_g", "peak_norm", "norm_p_m1", "m_join",
                "cdf_at_join")
# every model's scalars; PowerLawSpline's row continues with num_knots and
# its coefficients, padded to _MAX_KNOTS (csrc/population.cuh, kMaxKnots)
MODEL_SCALARS = {
    "PowerLawPeak": MASS_SCALARS,
    "TruncatedPowerLaw": ("m_low", "m_high", "alpha", "beta", "norm_p_m1"),
    "BrokenPowerLaw": ("m_low", "m_high", "alpha_1", "alpha_2", "beta",
                       "delta_m", "break_fraction", "norm_p_m1", "m_join",
                       "cdf_at_join"),
    "PowerLawTwoPeaks": ("m_low", "m_high", "alpha", "beta", "delta_m",
                         "lambda_peak", "lambda1", "mu1_g", "sigma1_g", "mu2_g",
                         "sigma2_g", "peak1_norm", "peak2_norm", "norm_p_m1",
                         "m_join", "cdf_at_join"),
    "PowerLawSpline": ("m_low", "m_high", "alpha", "beta", "delta_m",
                       "norm_p_m1", "m_join", "cdf_at_join"),
}
_MAX_KNOTS = 23
# largest dynamic shared memory a block may opt into on Hopper (227 KB),
# less room for the kernel's static reduction scratch
_SMEM_LIMIT = 232448 - 1024
# elements of one (L, events, G, S) intermediate in the plain version
_PLAIN_BUDGET = 1 << 25
# largest Chebyshev degree of either series in the adjoint kernel (its
# projections run in two chunks of 32 coefficients, csrc/adjoint.cuh), and
# room for its static shared memory (block-sum scratch of up to 8 warps)
_ADJOINT_MAX_DEG = 64
_ADJOINT_STATIC_SMEM = 12288
# the tile widths of the pruned Epanechnikov pair loops (csrc/kde.cuh
# kTileS, kTileG, kK4bTile; csrc/adjoint.cuh kGridTile): samples a tile
# and grid points a warp's run in K1a, K1b, K1d, K1e, K2 and K2b's pass 1 (and
# K4's runs), grid points a tile
# in K2b's pass 2 and in K3b's and K3d's phase B, bins or grid points a tile
# in K4b's two sweeps; each tile's (lo, hi) takes two values of shared
# memory
_TILE_S = 32
_TILE_G = 32
_GRID_TILE = 32
_K4B_TILE = 16
# bins a tile of K4's pruned pair loop (csrc/kde.cuh kK4Tile)
_K4_TILE = 32
# warps a block of K1c and K1d on logical rows, each with a row's z (K1c)
# or (z, w) pairs and tiles' bounds (K1d) in shared memory (csrc/kde.cuh
# kStatsWarps)
_STATS_WARPS = 1
# the per-λ record of the adjoint kernels' prologue past the mass scalars,
# by model: its derived fields, their Jacobian in the scalars where they
# carry a cotangent and the reverse sweep's constants (csrc/adjoint.cuh,
# kRecordValues): PowerLawPeak's 4 derived fields, (2, 12) Jacobian, 12
# constants
_RECORD_EXTRA = {"PowerLawPeak": 4 + 2 * 12 + 12, "TruncatedPowerLaw": 1 + 6,
                 "BrokenPowerLaw": 4 + 2 * 10 + 10,
                 "PowerLawTwoPeaks": 6 + 3 * 16 + 14,
                 "PowerLawSpline": 3 + 2 * (9 + _MAX_KNOTS) + 9}


def packed_width(mass: BaseMassModel) -> int:
    """Columns of the mass model's packed row (``pack_params``): its
    MODEL_SCALARS, for PowerLawSpline then num_knots and _MAX_KNOTS
    coefficients."""
    n = len(MODEL_SCALARS[type(mass).__name__])
    return n + 1 + _MAX_KNOTS if isinstance(mass, PowerLawSpline) else n


def stash_rows(mass: BaseMassModel) -> int:
    """Values a sample of the adjoint kernels' phase-D stash
    (csrc/adjoint.cuh, kStashRows): the two series' points, and
    PowerLawSpline's knots' point."""
    return 6 if isinstance(mass, PowerLawSpline) else 4


def plain_budget(t: torch.Tensor) -> int:
    """Elements of one (L, rows, G, S) intermediate a plain version holds at
    a time: 8x more on the card, whose 80 GB hold it and where the launches
    of many small chunks bound the plain versions' time."""
    return _PLAIN_BUDGET * (1 if t.device.type == "cpu" else 8)


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
                            cut_grid=None, stats_only: bool = False,
                            n_grid=None, ext_bounds=None,
                            den_scale: str = "norms", contract=None):
    """Plain PyTorch version with the safe-math row statistics of
    ``chimera_tpu/ops/pallas/fused.py::_reference_impl``; chunked over rows
    so that no (L, E, G, S) tensor is ever materialized.

    The grid is ``grids`` (E, G); or, with ``cut_grid``, ``n_grid`` points
    over [z_min - c σ (floored at 1e-8), z_max + c σ] of each (λ, row); or,
    with ``ext_bounds`` (L, E, 2), ``n_grid`` points over the given bounds.
    ``n_real`` (E,), ``dl_fill`` (E,) and ``logical_s`` give the row
    statistics of the logical rows of the per-pixel layout, in the TPU
    kernel's form (fused.py:127-137).  ``stats_only`` skips the KDE (den is
    None); ``cut_grid`` then only fills the lo, ub stats.

    ``contract`` = (s1, s2, f1, f2): the contract epilogue of the
    ``npix`` branch of ``_reference_impl`` (fused.py:462-482), on the
    analysis grids with ``den_scale='unit'``: the rows are E_ev events of
    npix = E / E_ev rows each, s1, s2 (E, G) per-row factors and f1, f2
    (L, E_ev, G) per-(λ, event) ones; in place of den it returns
    r (L, E, 2) = (sum_g den s1 f1, sum_g den s2 f2), a dead row exactly 0.

    Returns den (L, E, G) (or r) and a dict of (L, E) stats."""
    if logical_s is not None and (n_real is None or dl_fill is None):
        raise ValueError("logical_s requires n_real and dl_fill")
    if not stats_only and ext_bounds is None and (cut_grid is None) == (grids is None):
        raise ValueError("pass grids exactly when cut_grid is None")
    if den_scale not in ("norms", "unit"):
        raise ValueError(f"den_scale must be 'norms' or 'unit', not {den_scale!r}")
    e, s = dl.shape
    if contract is not None:
        s1, s2, f1, f2 = contract
        npix = e // f1.shape[1]
        if grids is None or ext_bounds is not None or stats_only \
                or den_scale != "unit" or npix * f1.shape[1] != e:
            raise ValueError("contract takes the analysis grids, "
                             "den_scale='unit' and E_ev x npix rows")
    on_grids = ext_bounds is None and cut_grid is None
    g = 1 if stats_only else grids.shape[1] if on_grids else int(n_grid)
    n = max(cosmo.L, mass.L)
    dt = dl.dtype
    sl = float(s if logical_s is None else logical_s)
    tiny = torch.finfo(dt).tiny
    dens, stats = [], []
    chunk = max(1, plain_budget(dl) // (n * g * s))
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
        z_sig = torch.sqrt(var_floor(z_var))
        neff = clip(sum_w * sum_w / torch.where(sum_w2 > 0, sum_w2, 1.0), 1.0, sl)
        h = bw_factor(neff, 1, bw_method) * z_sig
        if ext_bounds is not None:
            lo, ub = ext_bounds[:, rows, 0], ext_bounds[:, rows, 1]
        elif cut_grid is not None:
            lo = z_min - cut_grid * z_sig
            lo = torch.where(lo > 0.0, lo, 1e-8)
            ub = z_max + cut_grid * z_sig
        else:
            lo = ub = torch.zeros_like(h)
        stats.append(torch.stack([lo, ub, sum_w / sl, neff, h, sum_w, sum_w2,
                                  z_sig], dim=-1))
        if stats_only:
            continue
        if on_grids:
            grid = grids[None, rows]                                # (1, c, G)
        else:
            delta = (ub - lo) / (g - 1)
            grid = lo[..., None] + delta[..., None] * torch.arange(
                g, dtype=dt, device=dl.device)                      # (n, c, G)
        u = (grid[..., None] - z[:, :, None, :]) / h[..., None, None]
        d = torch.sum(w[:, :, None, :] * MAX_FORM_KERNELS[kernel](u),
                      dim=-1) / h[..., None]
        if den_scale == "norms":
            dens.append(d / sl)
        else:
            # rows below sqrt(tiny) total weight are defined as 0 (the
            # reference's select, fused.py:459-468)
            ok = sum_w > math.sqrt(tiny)
            d = torch.where(ok[..., None],
                            d / torch.where(ok, sum_w, 1.0)[..., None], 0.0)
            if contract is not None:
                ev = torch.arange(rows.start, rows.stop,
                                  device=dl.device) // npix
                d = torch.stack([torch.sum(d * s1[rows] * f1[:, ev], dim=-1),
                                 torch.sum(d * s2[rows] * f2[:, ev], dim=-1)],
                                dim=-1)
            dens.append(d)
    den = None if stats_only else torch.cat(dens, dim=1)
    return den, _stats_dict(torch.cat(stats, dim=1))


def mass_kind(mass: BaseMassModel) -> int:
    """The mass model's library (CHIMERA_MASS_KIND)."""
    return MASS_KINDS[type(mass).__name__]


def window_degree(mass: BaseMassModel) -> int:
    """Terms of the window series in the packed row: 0 for a model without
    one (TruncatedPowerLaw)."""
    return 0 if mass.cheb_cdf_window is None else mass.window_deg


def pack_params(cosmo: FLRW, mass: BaseMassModel, n: int, dtype
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-λ model state as two contiguous rows at the kernels' offsets
    (csrc/population.cuh, Model): the two Chebyshev series in float64,
    (n, cheb_deg + 2 + window_deg) = cheb_logh, dgw_lo, dgw_max,
    cheb_cdf_window (none without a window series); and the mass scalars in
    ``dtype``, (n, P) = the model's MODEL_SCALARS, for PowerLawSpline then
    num_knots and the coefficients, zero-padded to _MAX_KNOTS."""
    f64 = torch.float64
    parts = [cosmo.cheb_logh.to(f64).expand(n, -1),
             cosmo.dgw_lo.to(f64).expand(n)[:, None],
             cosmo.dgw_max.to(f64).expand(n)[:, None]]
    if window_degree(mass):
        parts.append(mass.cheb_cdf_window.to(f64).expand(n, -1))
    cols = [getattr(mass, k).expand(n)[:, None]
            for k in MODEL_SCALARS[type(mass).__name__]]
    if isinstance(mass, PowerLawSpline):
        c = mass.spline_coeffs.expand(n, -1)
        cols += [torch.full_like(c[:, :1], float(mass.num_knots)), c,
                 torch.zeros_like(c[:, :1]).expand(n, _MAX_KNOTS - c.shape[1])]
    return (torch.cat(parts, dim=1).contiguous(),
            torch.cat(cols, dim=1).to(dtype).contiguous())


def smem_bytes(series: torch.Tensor, sum_size: int, params: torch.Tensor,
               n_values: int) -> int:
    """Dynamic shared memory of a block: the series row in the kernel's
    summation type of ``sum_size`` bytes (rounded up to 16 bytes), then
    ``n_values`` working-dtype values and the mass scalars
    (csrc/population.cuh, series_bytes)."""
    head = (series.shape[1] * sum_size + 15) // 16 * 16
    return head + (n_values + params.shape[1]) * params.element_size()


def adjoint_scratch(n: int, rows: int, series: torch.Tensor, sum_size: int,
                    params: torch.Tensor, mass: BaseMassModel) -> torch.Tensor:
    """The adjoint kernels' ``partials`` scratch (K3, K2b): a row of the
    packed rows' gradients per (λ, row), then, on a 16-byte boundary, each
    λ's record of their prologue: the series in the summation type of
    ``sum_size`` bytes, the mass fields and the Jacobian of the derived ones
    (csrc/adjoint.cuh, records_offset and record_bytes)."""
    p = series.shape[1] + params.shape[1]
    record = ((series.shape[1] * sum_size + 15) // 16 * 16
              + (params.shape[1] + _RECORD_EXTRA[type(mass).__name__])
              * params.element_size())
    return torch.empty((n * rows * p + 1) // 2 * 2 + n * record // 8,
                       dtype=torch.float64, device=params.device)


def on_card(t: torch.Tensor) -> bool:
    """Whether a wrapper given ``t`` launches its kernel (a CUDA tensor) or
    runs its plain version (a CPU tensor)."""
    return t.device.type != "cpu"


def check_cuda_call(name: str, cosmo, mass, dl, others: dict) -> None:
    """What every kernel wrapper checks before a launch: CUDA tensors of
    float32 or float64, a cosmology and a mass model the kernels evaluate
    (FLRW or MGFLRW with the chebyshev engine, a model of MASS_KINDS with
    the analytic CDF), and ``others`` ({name: tensor}) of ``dl``'s shape,
    dtype and device."""
    if dl.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dl.device}")
    if type(cosmo) not in (FLRW, MGFLRW) or cosmo.interp_method != "chebyshev":
        raise NotImplementedError(
            f"{name}: the CUDA kernels cover FLRW and MGFLRW with the chebyshev "
            f"engine, not {type(cosmo).__name__} with "
            f"interp_method={cosmo.interp_method!r}")
    kind = type(mass).__name__
    if kind not in MASS_KINDS or mass.cdf_engine != "analytic":
        raise NotImplementedError(
            f"{name}: the CUDA kernels cover {', '.join(MASS_KINDS)} with the "
            f"analytic CDF, not {kind} with cdf_engine={mass.cdf_engine!r}")
    if isinstance(mass, PowerLawSpline) and mass.num_knots > _MAX_KNOTS:
        raise NotImplementedError(
            f"{name}: the CUDA kernels take PowerLawSpline with up to "
            f"{_MAX_KNOTS} knots, not {mass.num_knots}")
    dt = dl.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"{name} takes float32 or float64, not {dt}")
    for key, t in others.items():
        if t.shape != dl.shape or t.dtype != dt or t.device != dl.device:
            raise ValueError(f"{key} must be {tuple(dl.shape)} {dt} on {dl.device}")


def refuse_grad(name: str, why: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would record a kernel launch that has no
    backward: its outputs would come back as constants and the gradient be
    silently short of their part."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward on CUDA tensors: {why}")


def launch(lib_name: str, symbol: str, dtype, device, args,
           mass_kind: int = 0) -> None:
    """Call ``<symbol>_f32`` or ``<symbol>_f64`` of ``csrc/<lib_name>.cu``,
    built for the mass model ``mass_kind`` (MASS_KINDS), on the current
    stream; each arg is a tensor (its pointer), None (a null pointer), an
    int or a float.  Raises on a refused launch."""
    lib = build.load(lib_name, mass_kind)  # nvcc at first use
    fn = getattr(lib, f"{symbol}_{'f32' if dtype == torch.float32 else 'f64'}")
    fn.argtypes = [ctypes.c_void_p if a is None or isinstance(a, torch.Tensor)
                   else ctypes.c_double if isinstance(a, float) else ctypes.c_int
                   for a in args] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                   for a in args), stream)
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: cudaError {err}")


# the kernel's modes (csrc/kde.cuh, FusedMode)
_ANALYSIS_GRID, _EFFECTIVE_GRID, _EXTERNAL_BOUNDS, _STATS_ONLY, _CONTRACT = \
    range(5)


def _launch_k1(mode: int, series, params, m1det, m2det, dl, inv_pe_prior,
               grids, cosmo, mass, kernel="epan", bw_method=None, n_grid=0,
               ext_bounds=None, n_real=None, dl_fill=None, logical_s=None,
               cut_grid=None, den_scale="norms", contract=None):
    """Launch ``csrc/fused_kde.cu`` in ``mode`` on checked, contiguous
    inputs; returns den (L, B, G) (None in the stats-only mode, r (L, B, 2)
    in the contract mode) and the stats tensor (L, B, 8)."""
    bw_mode, bw_value = _bw_code(bw_method)
    dt = dl.dtype
    b, s = dl.shape
    n = series.shape[0]
    g = grids.shape[1] if mode in (_ANALYSIS_GRID, _CONTRACT) \
        else 0 if mode == _STATS_ONLY else n_grid
    den = None if mode == _STATS_ONLY else torch.empty(
        (n, b, 2 if mode == _CONTRACT else g), dtype=dt, device=dl.device)
    stats = torch.empty((n, b, 8), dtype=dt, device=dl.device)
    s1, s2, f1, f2 = (None,) * 4 if contract is None else contract
    launch("fused_kde", "chimera_fused_kde", dt, dl.device,
           [m1det, m2det, dl, inv_pe_prior, grids, ext_bounds, n_real, dl_fill,
            series, params, s1, s2, f1, f2, den, stats, n, b, s, g,
            cosmo.cheb_deg, window_degree(mass),
            0 if logical_s is None else int(logical_s), mode,
            0 if kernel == "epan" else 1, bw_mode, float(bw_value),
            float(cut_grid or 0.0), int(den_scale == "unit"),
            0 if f1 is None else b // f1.shape[1]], mass_kind(mass))
    return den, stats


def _checked_rows(name, m1det, m2det, dl, inv_pe_prior, cosmo, mass, n_real,
                  dl_fill, logical_s, sum_size, tiles=False, stats_only=False,
                  warp_kde=False):
    """The checks every launch of ``csrc/fused_kde.cu`` shares: returns the
    packed rows and the contiguous PE arrays, logical-row arrays.  ``tiles``:
    the launch takes the pruned pair loop, whose sample tiles' bounds take
    shared memory too.  On logical rows ``stats_only`` (K1c) and
    ``warp_kde`` (K1d, Epanechnikov) launches take the warp-a-row kernels,
    whose block keeps for each of its _STATS_WARPS rows the z (K1c) or the
    (z, w) pairs and tiles' bounds (K1d) of the row."""
    check_cuda_call(name, cosmo, mass, dl,
                    {"m1det": m1det, "m2det": m2det, "inv_pe_prior": inv_pe_prior})
    dt, dev = dl.dtype, dl.device
    b, s = dl.shape
    if logical_s is not None:
        if n_real is None or dl_fill is None:
            raise ValueError("logical_s requires n_real and dl_fill")
        if n_real.shape != (b,) or dl_fill.shape != (b,):
            raise ValueError(f"n_real and dl_fill must be ({b},)")
        n_real = n_real.to(device=dev, dtype=torch.int64).contiguous()
        dl_fill = dl_fill.to(device=dev, dtype=dt).contiguous()
    else:
        n_real = dl_fill = None
    n = max(cosmo.L, mass.L)
    series, params = (t.to(dev) for t in pack_params(cosmo, mass, n, dt))
    by_warp = (stats_only or warp_kde) and n_real is not None
    # the kernels pad the mass scalars to 16 bytes before the tiles' bounds
    row = (s if stats_only and by_warp else 2 * s) \
        + (2 * -(-s // _TILE_S) + (-params.shape[1]) % 4 if tiles else 0)
    smem = smem_bytes(series, sum_size, params,
                      (_STATS_WARPS if by_warp else 1) * row)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"S = {s} samples need {smem} bytes of shared memory per block "
            + ("(z" if stats_only and by_warp else "(z and w")
            + (f" of {_STATS_WARPS} rows" if by_warp else "")
            + f" of every sample), over the {_SMEM_LIMIT}-byte limit")
    pe = [t.contiguous() for t in (m1det, m2det, dl, inv_pe_prior)]
    return series, params, pe, n_real, dl_fill


def fused_weights_kde(m1det, m2det, dl, inv_pe_prior, cosmo, mass, grids=None,
                      kernel: str = "epan", bw_method=None, *, cut_grid=None,
                      n_grid=None, ext_bounds=None, n_real=None, dl_fill=None,
                      logical_s=None, den_scale: str = "norms", contract=None):
    """Fused weights + KDE of a λ batch.

    Args:
      m1det, m2det, dl, inv_pe_prior: (B, S) detector-frame PE rows.
      cosmo, mass: λ-batched ``FLRW`` or ``MGFLRW`` (chebyshev engine) and
        a mass model of ``MASS_KINDS`` (analytic CDF engine).
      grids: (B, G) analysis grids the densities are evaluated on (K1a); or
      cut_grid, n_grid: ``n_grid`` points over [z_min - c σ, z_max + c σ]
        of each (λ, row), lo floored at 1e-8 (K1b); or
      ext_bounds, n_grid: (L, B, 2) bounds of each (λ, row)'s ``n_grid``
        points (K1d).
      n_real, dl_fill, logical_s: the rows are logical rows of the
        per-pixel layout (see ``fused_row_stats``).
      den_scale: 'norms' (1 / (h S)) or 'unit' (1 / (h sum w)).
      contract: (s1, s2, f1, f2), with ``grids`` and ``den_scale='unit'``
        (K1e): the dark-siren epilogue in the kernel.  The B rows are E_ev
        events of B / E_ev (event, pixel) rows; s1, s2 (B, G) per-row and
        f1, f2 (L, E_ev, G) per-(λ, event) factors.

    Returns:
      den (L, B, G) — with ``contract`` r (L, B, 2) = (sum_g den s1 f1,
      sum_g den s2 f2), 0 on a row below sqrt(tiny) weight — and a dict of
      (L, B) stats: lo, ub (the grid's bounds; zeros on analysis grids),
      norms, neff, bandwidth, sum_w, sum_w2.

    CPU tensors take the plain version.  CUDA tensors launch the kernel and
    raise on anything it does not take; the kernel's row statistics are the
    raw formulas (a dead row gives NaN where the plain version clamps — the
    N_eff gate and nan_to_num downstream treat both alike).  Where a model
    tensor or ``ext_bounds`` requires grad, the backward on CUDA tensors is
    the adjoint kernel (``fused_weights_kde_adjoint``) in the same mode;
    with ``contract`` (K1e, no adjoint kernel) it raises.
    """
    if not on_card(dl):
        return fused_weights_kde_plain(
            m1det, m2det, dl, inv_pe_prior, cosmo, mass, grids, kernel,
            bw_method, n_real, dl_fill, logical_s, cut_grid, n_grid=n_grid,
            ext_bounds=ext_bounds, den_scale=den_scale, contract=contract)
    if kernel not in ("epan", "gauss"):
        raise ValueError(f"unknown KDE kernel {kernel!r}")
    if den_scale not in ("norms", "unit"):
        raise ValueError(f"den_scale must be 'norms' or 'unit', not {den_scale!r}")
    dt, dev = dl.dtype, dl.device
    b, s = dl.shape
    n = max(cosmo.L, mass.L)
    if ext_bounds is not None:
        mode = _EXTERNAL_BOUNDS
        if ext_bounds.shape != (n, b, 2) or ext_bounds.dtype != dt \
                or ext_bounds.device != dev:
            raise ValueError(f"ext_bounds must be ({n}, {b}, 2) {dt} on {dev}")
        ext_bounds = ext_bounds.contiguous()
    elif (cut_grid is None) == (grids is None):
        raise ValueError("pass grids exactly when cut_grid is None")
    else:
        mode = _ANALYSIS_GRID if grids is not None else _EFFECTIVE_GRID
    if contract is not None:
        if mode != _ANALYSIS_GRID or den_scale != "unit":
            raise ValueError("contract takes the analysis grids and "
                             "den_scale='unit'")
        mode = _CONTRACT
    if mode in (_ANALYSIS_GRID, _CONTRACT):
        g = grids.shape[1]
        if grids.shape != (b, g) or grids.dtype != dt or grids.device != dev:
            raise ValueError(f"grids must be ({b}, G) {dt} on {dev}")
        grids = grids.contiguous()
    elif n_grid is None or int(n_grid) < 2:
        raise ValueError("an effective grid takes n_grid >= 2 points")
    if contract is not None:
        contract = _checked_contract(contract, n, b, g, dt, dev)
    # the dark-siren modes (d, e) sum the Chebyshev series in float64, the
    # spectral modes (a, b) in the working dtype
    series, params, pe, n_real, dl_fill = _checked_rows(
        "fused_weights_kde", m1det, m2det, dl, inv_pe_prior, cosmo, mass,
        n_real, dl_fill, logical_s,
        8 if mode in (_EXTERNAL_BOUNDS, _CONTRACT) else dl.element_size(),
        tiles=mode != _STATS_ONLY and kernel == "epan",
        warp_kde=mode == _EXTERNAL_BOUNDS and kernel == "epan")
    kw = dict(kernel=kernel, bw_method=bw_method,
              n_grid=0 if n_grid is None else int(n_grid), logical_s=logical_s,
              cut_grid=cut_grid, den_scale=den_scale)
    if mode == _CONTRACT:
        refuse_grad("fused_weights_kde with contract (K1e)",
                    "K1e's adjoint is ROADMAP.md §1 item 15", series, params,
                    *contract)
        den, stats = _launch_k1(mode, series, params, *pe, grids, cosmo, mass,
                                n_real=n_real, dl_fill=dl_fill,
                                contract=contract, **kw)
    else:
        den, stats = _run_k1(mode, series, params, ext_bounds, cosmo, mass, pe,
                             grids, n_real, dl_fill, **kw)
    counter = {_ANALYSIS_GRID: "launches", _EFFECTIVE_GRID: "launches_b",
               _EXTERNAL_BOUNDS: "launches_d", _CONTRACT: "launches_e"}[mode]
    setattr(fused_weights_kde, counter,
            getattr(fused_weights_kde, counter) + 1)
    return den, _stats_dict(stats)


fused_weights_kde.launches = 0
fused_weights_kde.launches_b = 0
fused_weights_kde.launches_d = 0
fused_weights_kde.launches_e = 0


def _checked_contract(contract, n: int, b: int, g: int, dt, dev):
    """K1e's factors, checked and contiguous: s1, s2 (B, G); f1, f2
    (L, E_ev, G) with B a multiple of E_ev."""
    s1, s2, f1, f2 = contract
    e_ev = f1.shape[1] if f1.dim() == 3 else 0
    if e_ev <= 0 or b % e_ev:
        raise ValueError(f"f1 must be ({n}, E_ev, {g}) with {b} rows a "
                         "multiple of E_ev")
    for key, t, shape in (("s1", s1, (b, g)), ("s2", s2, (b, g)),
                          ("f1", f1, (n, e_ev, g)), ("f2", f2, (n, e_ev, g))):
        if tuple(t.shape) != shape or t.dtype != dt or t.device != dev:
            raise ValueError(f"{key} must be {shape} {dt} on {dev}")
    return tuple(t.contiguous() for t in contract)


def unpack_params(cosmo: FLRW, mass: BaseMassModel, series: torch.Tensor,
                  params: torch.Tensor) -> tuple[FLRW, BaseMassModel]:
    """The inverse of ``pack_params``: ``cosmo`` and ``mass`` with the
    packed fields replaced by the rows' columns (the other fields, which
    the fused pass does not read, stay)."""
    cd = cosmo.cheb_deg
    cosmo = dataclasses.replace(
        cosmo, cheb_logh=series[:, :cd], dgw_lo=series[:, cd],
        dgw_max=series[:, cd + 1])
    names = MODEL_SCALARS[type(mass).__name__]
    fields = {k: params[:, i] for i, k in enumerate(names)}
    if window_degree(mass):
        fields["cheb_cdf_window"] = series[:, cd + 2:]
    if isinstance(mass, PowerLawSpline):
        p = len(names) + 1
        fields["spline_coeffs"] = params[:, p:p + mass.num_knots]
    return cosmo, dataclasses.replace(mass, **fields)


def _mode_of(grids, ext_bounds, stats_only: bool) -> int:
    if stats_only:
        return _STATS_ONLY
    if ext_bounds is not None:
        return _EXTERNAL_BOUNDS
    return _ANALYSIS_GRID if grids is not None else _EFFECTIVE_GRID


def fused_weights_kde_adjoint_plain(m1det, m2det, dl, inv_pe_prior, grids,
                                    series, params, ct_den, ct_stats,
                                    cosmo, mass, kernel: str = "epan",
                                    bw_method=None, *, cut_grid=None,
                                    n_grid=None, ext_bounds=None, n_real=None,
                                    dl_fill=None, logical_s=None,
                                    den_scale: str = "norms",
                                    stats_only: bool = False):
    """Plain PyTorch version of ``fused_weights_kde_adjoint``: the
    vector-Jacobian product of ``fused_weights_kde_plain`` (of its
    stats-only mode with ``stats_only``) in the packed rows and
    ``ext_bounds``, by autograd, one chunk of rows at a time so that no
    (L, E, G, S) graph is ever held.  Returns (d_series, d_params, d_ext),
    d_ext None without ``ext_bounds``."""
    e, s = dl.shape
    mode = _mode_of(grids, ext_bounds, stats_only)
    n = series.shape[0]
    g = 1 if stats_only else grids.shape[1] if mode == _ANALYSIS_GRID else int(n_grid)
    series = series.detach().requires_grad_()
    params = params.detach().requires_grad_()
    wrt = [series, params]
    if ext_bounds is not None:
        ext_bounds = ext_bounds.detach().requires_grad_()
        wrt.append(ext_bounds)
    grads = [torch.zeros_like(t) for t in wrt]

    def part(t, rows, axis=0):
        return None if t is None else t[(slice(None),) * axis + (rows,)]

    chunk = max(1, plain_budget(dl) // (n * g * s))
    with torch.enable_grad():
        for e0 in range(0, e, chunk):
            rows = slice(e0, min(e, e0 + chunk))
            cos, mas = unpack_params(cosmo, mass, series, params)
            den, stats = fused_weights_kde_plain(
                m1det[rows], m2det[rows], dl[rows], inv_pe_prior[rows], cos,
                mas, part(grids, rows), kernel, bw_method,
                n_real=part(n_real, rows), dl_fill=part(dl_fill, rows),
                logical_s=logical_s, cut_grid=cut_grid, stats_only=stats_only,
                n_grid=n_grid, ext_bounds=part(ext_bounds, rows, 1),
                den_scale=den_scale)
            out = 0.0 if stats_only else torch.sum(den * ct_den[:, rows])
            for i, k in enumerate(STAT_NAMES):
                # lo, ub are constants on analysis grids
                if i >= 2 or mode != _ANALYSIS_GRID:
                    out = out + torch.sum(stats[k] * ct_stats[:, rows, i])
            for acc, gr in zip(grads, torch.autograd.grad(out, wrt,
                                                          allow_unused=True)):
                if gr is not None:
                    acc += gr
    return (*grads, None) if ext_bounds is None else tuple(grads)


def fused_weights_kde_adjoint(m1det, m2det, dl, inv_pe_prior, grids, series,
                              params, ct_den, ct_stats, cosmo, mass,
                              kernel: str = "epan", bw_method=None, *,
                              cut_grid=None, n_grid=None, ext_bounds=None,
                              n_real=None, dl_fill=None, logical_s=None,
                              den_scale: str = "norms", stats_only: bool = False):
    """Backward of ``fused_weights_kde`` (and, with ``stats_only``, of
    ``fused_row_stats``) in the hyper-parameters (K3), in the forward's mode.

    Args:
      m1det, m2det, dl, inv_pe_prior, grids: the forward's data (``grids``
        on analysis grids only).
      series, params: the packed per-λ rows of ``pack_params``.
      ct_den (L, E, G) (None with ``stats_only``), ct_stats (L, E, 8):
        cotangents of the forward's densities and of its stats in the order
        of ``STAT_NAMES`` (slot 7 is not read, nor are 0 and 1 on analysis
        grids, where lo and ub are constants).
      cosmo, mass: the models the rows were packed from (their degrees and
        engines; the plain version rebuilds them around the rows).
      cut_grid, n_grid, ext_bounds, n_real, dl_fill, logical_s, den_scale,
        stats_only: the forward's mode, as ``fused_weights_kde`` and
        ``fused_row_stats`` take it.

    Returns d_series (L, cheb_deg + 2 + window_deg) float64 and d_params
    (L, P), P the packed row's columns (``packed_width``: PowerLawSpline's
    num_knots column 0, its coefficients' cotangents after it), summed over rows in a fixed order (equal inputs give equal
    bits), and d_ext (L, E, 2), whose slots take the cotangents of the lo,
    ub stats they pass through (None without ``ext_bounds``).  The row
    statistics are differentiated in their safe-math form (variance floored,
    N_eff clamped to [1, S] with ``jnp.clip``'s slopes), so a dead row with
    zero cotangents adds exact zeros.  CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise.
    """
    mode_kw = dict(cut_grid=cut_grid, n_grid=n_grid, ext_bounds=ext_bounds,
                   n_real=n_real, dl_fill=dl_fill, logical_s=logical_s,
                   den_scale=den_scale, stats_only=stats_only)
    if not on_card(dl):
        return fused_weights_kde_adjoint_plain(
            m1det, m2det, dl, inv_pe_prior, grids, series, params, ct_den,
            ct_stats, cosmo, mass, kernel, bw_method, **mode_kw)
    check_cuda_call("fused_weights_kde_adjoint", cosmo, mass, dl,
                    {"m1det": m1det, "m2det": m2det, "inv_pe_prior": inv_pe_prior})
    if kernel not in ("epan", "gauss"):
        raise ValueError(f"unknown KDE kernel {kernel!r}")
    if den_scale not in ("norms", "unit"):
        raise ValueError(f"den_scale must be 'norms' or 'unit', not {den_scale!r}")
    mode = _mode_of(grids, ext_bounds, stats_only)
    bw_mode, bw_value = _bw_code(bw_method)
    dt, dev = dl.dtype, dl.device
    e, s = dl.shape
    n, q = series.shape
    if mode == _ANALYSIS_GRID:
        g = grids.shape[1]
    elif mode == _STATS_ONLY:
        g = 0
    elif n_grid is None or int(n_grid) < 2:
        raise ValueError("an effective grid takes n_grid >= 2 points")
    else:
        g = int(n_grid)
    wd = window_degree(mass)
    if cosmo.cheb_deg > _ADJOINT_MAX_DEG or wd > _ADJOINT_MAX_DEG:
        raise ValueError(
            f"the adjoint kernel takes Chebyshev degrees up to {_ADJOINT_MAX_DEG}")
    n_params = packed_width(mass)
    expect = {"series": (series, (n, cosmo.cheb_deg + 2 + wd), torch.float64),
              "params": (params, (n, n_params), dt),
              "ct_stats": (ct_stats, (n, e, 8), dt)}
    if mode == _ANALYSIS_GRID:
        expect["grids"] = (grids, (e, g), dt)
    if mode != _STATS_ONLY:
        expect["ct_den"] = (ct_den, (n, e, g), dt)
    if mode == _EXTERNAL_BOUNDS:
        expect["ext_bounds"] = (ext_bounds, (n, e, 2), dt)
    for key, (t, shape, dtype) in expect.items():
        if t is None or tuple(t.shape) != shape or t.dtype != dtype \
                or t.device != dev:
            raise ValueError(f"{key} must be {shape} {dtype} on {dev}")
    if logical_s is not None:
        if n_real is None or dl_fill is None:
            raise ValueError("logical_s requires n_real and dl_fill")
        if n_real.shape != (e,) or dl_fill.shape != (e,):
            raise ValueError(f"n_real and dl_fill must be ({e},)")
        n_real = n_real.to(device=dev, dtype=torch.int64).contiguous()
        dl_fill = dl_fill.to(device=dev, dtype=dt).contiguous()
    else:
        n_real = dl_fill = None
    # the λ's record (the series, the mass fields and the Jacobian of the
    # derived ones), z, w and their cotangents of every sample, the grid with
    # its scaled cotangents; the dark-siren modes (c, d) sum the Chebyshev
    # series in float64 as their forward does
    dense = mode in (_EXTERNAL_BOUNDS, _STATS_ONLY)
    tiles = -(-g // _GRID_TILE) if mode in (_EFFECTIVE_GRID, _EXTERNAL_BOUNDS) \
        and kernel == "epan" else 0  # K3b's, K3d's pruned phase B: tile bounds
    smem = smem_bytes(series, 8 if dense else dl.element_size(), params,
                      stash_rows(mass) * s + 2 * g + 2 * tiles
                      + _RECORD_EXTRA[type(mass).__name__])
    if smem > _SMEM_LIMIT - _ADJOINT_STATIC_SMEM:
        raise ValueError(
            f"S = {s} samples need {smem} bytes of shared memory per block "
            f"(z, w, dz and dw of every sample and their stash), over the "
            f"{_SMEM_LIMIT - _ADJOINT_STATIC_SMEM}-byte limit")
    inputs = [None if t is None else t.contiguous() for t in (
        m1det, m2det, dl, inv_pe_prior, grids if mode == _ANALYSIS_GRID else None,
        ext_bounds, n_real, dl_fill, series, params,
        None if mode == _STATS_ONLY else ct_den, ct_stats)]
    partials = adjoint_scratch(n, e, series, 8 if dense else dl.element_size(),
                               params, mass)
    d_series = torch.empty((n, q), dtype=torch.float64, device=dev)
    d_params = torch.empty((n, n_params), dtype=dt, device=dev)
    d_ext = None if ext_bounds is None else torch.empty((n, e, 2), dtype=dt,
                                                        device=dev)
    launch("fused_kde_adjoint", "chimera_fused_kde_adjoint", dt, dev,
           [*inputs, partials, d_series, d_params, d_ext, n, e, s, g,
            cosmo.cheb_deg, wd, 0 if logical_s is None else int(logical_s),
            mode, 0 if kernel == "epan" else 1, bw_mode, float(bw_value),
            float(cut_grid or 0.0), int(den_scale == "unit")], mass_kind(mass))
    counter = {_ANALYSIS_GRID: "launches", _EFFECTIVE_GRID: "launches_b",
               _STATS_ONLY: "launches_c", _EXTERNAL_BOUNDS: "launches_d"}[mode]
    setattr(fused_weights_kde_adjoint, counter,
            getattr(fused_weights_kde_adjoint, counter) + 1)
    return d_series, d_params, d_ext


fused_weights_kde_adjoint.launches = 0
fused_weights_kde_adjoint.launches_b = 0
fused_weights_kde_adjoint.launches_c = 0
fused_weights_kde_adjoint.launches_d = 0


class _FusedKDE(torch.autograd.Function):
    """K1 in any mode on CUDA tensors, with K3 in the same mode as the
    backward in the packed rows and ``ext_bounds``."""

    @staticmethod
    def forward(ctx, series, params, ext_bounds, mode, cosmo, mass, kw,
                m1det, m2det, dl, inv_pe_prior, grids, n_real, dl_fill):
        ctx.save_for_backward(series, params, ext_bounds, m1det, m2det, dl,
                              inv_pe_prior, grids, n_real, dl_fill)
        ctx.cfg = (mode, cosmo, mass, kw)
        return _launch_k1(mode, series, params, m1det, m2det, dl, inv_pe_prior,
                          grids, cosmo, mass, ext_bounds=ext_bounds,
                          n_real=n_real, dl_fill=dl_fill, **kw)

    @staticmethod
    def backward(ctx, ct_den, ct_stats):
        series, params, ext, m1, m2, dl, invp, grids, n_real, dl_fill = \
            ctx.saved_tensors
        mode, cosmo, mass, kw = ctx.cfg
        n, b = params.shape[0], dl.shape[0]
        if ct_stats is None:
            ct_stats = torch.zeros((n, b, 8), dtype=dl.dtype, device=dl.device)
        if ct_den is None and mode != _STATS_ONLY:
            g = grids.shape[1] if mode == _ANALYSIS_GRID else kw["n_grid"]
            ct_den = torch.zeros((n, b, g), dtype=dl.dtype, device=dl.device)
        d_series, d_params, d_ext = fused_weights_kde_adjoint(
            m1, m2, dl, invp, grids, series, params,
            None if ct_den is None else ct_den.contiguous(),
            ct_stats.contiguous(), cosmo, mass, kw["kernel"], kw["bw_method"],
            cut_grid=kw["cut_grid"], n_grid=kw["n_grid"], ext_bounds=ext,
            n_real=n_real, dl_fill=dl_fill, logical_s=kw["logical_s"],
            den_scale=kw["den_scale"], stats_only=mode == _STATS_ONLY)
        return (d_series, d_params, d_ext) + (None,) * 11


def _run_k1(mode, series, params, ext_bounds, cosmo, mass, pe, grids, n_real,
            dl_fill, **kw):
    """Launch K1 in ``mode``: inside ``_FusedKDE`` where autograd records
    the launch (a model row or ``ext_bounds`` requires grad), else bare."""
    if torch.is_grad_enabled() and (
            series.requires_grad or params.requires_grad
            or (ext_bounds is not None and ext_bounds.requires_grad)):
        return _FusedKDE.apply(series, params, ext_bounds, mode, cosmo, mass,
                               kw, *pe, grids, n_real, dl_fill)
    return _launch_k1(mode, series, params, *pe, grids, cosmo, mass,
                      ext_bounds=ext_bounds, n_real=n_real, dl_fill=dl_fill, **kw)


def fused_row_stats_plain(m1det, m2det, dl, inv_pe_prior, cosmo, mass,
                          n_real=None, dl_fill=None, logical_s=None,
                          cut_grid: float = 2.0, bw_method=None) -> dict:
    """Plain PyTorch version of ``fused_row_stats`` (``_reference_impl`` in
    its stats-only mode)."""
    return fused_weights_kde_plain(
        m1det, m2det, dl, inv_pe_prior, cosmo, mass, bw_method=bw_method,
        n_real=n_real, dl_fill=dl_fill, logical_s=logical_s,
        cut_grid=cut_grid, stats_only=True)[1]


def fused_row_stats(m1det, m2det, dl, inv_pe_prior, cosmo, mass, n_real=None,
                    dl_fill=None, logical_s=None, cut_grid: float = 2.0,
                    bw_method=None) -> dict:
    """Row statistics of a λ batch with no KDE (the stats-only mode of the
    TPU kernel, K1c): the first pass of the dark-siren 'marginalized' path.

    Args:
      m1det, m2det, dl, inv_pe_prior: (B, S) rows.  With ``logical_s`` each
        row holds its ``n_real[b]`` samples first and zero-weight fillers at
        ``dl_fill[b]`` after them (``data.pixelize.compact_samples_by_pixel``).
      n_real, dl_fill, logical_s: (B,) int, (B,) and int, or None — the
        statistics are those of the logical row of ``logical_s`` samples,
        the ``logical_s - n_real`` missing ones at z(dl_fill) with zero
        weight; without them, of the rows as they are.
      cut_grid: lo, ub = the z range -/+ cut_grid sigma (lo floored at
        1e-8), as the TPU kernel computes them.

    Returns a dict of (L, B) stats: lo, ub, norms (sum_w / logical_s), neff,
    bandwidth, sum_w, sum_w2.  CPU tensors take the plain version (the TPU
    kernel's safe-math); on CUDA the kernel keeps the raw formulas (NaN
    neff and bandwidth on a zero-weight row), and where a model tensor
    requires grad its backward is K3 in the stats-only mode.
    """
    if not on_card(dl):
        return fused_row_stats_plain(m1det, m2det, dl, inv_pe_prior, cosmo,
                                     mass, n_real, dl_fill, logical_s,
                                     cut_grid, bw_method)
    # the dark-siren kernels sum the Chebyshev series in float64
    series, params, pe, n_real, dl_fill = _checked_rows(
        "fused_row_stats", m1det, m2det, dl, inv_pe_prior, cosmo, mass,
        n_real, dl_fill, logical_s, 8, stats_only=True)
    _, stats = _run_k1(_STATS_ONLY, series, params, None, cosmo, mass, pe, None,
                       n_real, dl_fill, kernel="epan", bw_method=bw_method,
                       n_grid=0, logical_s=logical_s, cut_grid=cut_grid,
                       den_scale="norms")
    fused_row_stats.launches += 1
    return _stats_dict(stats)


fused_row_stats.launches = 0
