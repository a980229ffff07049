"""On-card check of the PyTorch port: builds the CUDA kernels from this
checkout, holds each against its plain PyTorch version, and drives three
paths end to end through the entry points a user calls:

* phases 3-6, the spectral-siren hyper-likelihood batch at the headline
  width (1000 events x 4096 PE samples x 500-point z-grids, 2 000 000
  generated injections, a batch of 16 H0 values): the fused weights+KDE
  kernel (K1a);
* phases 7-10, the dark-siren 'marginalized' batch at the flagship width
  (1000 events x 1024 samples, nside {8, 16}, 15 pixels asked per event,
  50 000 background galaxies, 500 000 generated injections, 16 H0 values):
  the stats-only kernel (K1c) and the rows-contract kernel (K2);
* phases 11-14, hyper-parameter gradients and the HMC / ChEES samplers on
  the spectral headline likelihood (16 chains in H0, Om0, mu_g; every
  leapfrog step one batch forward through K1a and one backward through the
  adjoint kernel K3).

Each likelihood path checks float32 against float64, elementwise against the repo's
1e-6 bar (the dark path on the repo's own precision mock,
tests/data/f32_parity_dark.npz), and is timed.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; imports no JAX.  Any failed phase raises and
the script exits non-zero.  The last line of standard output is
{"ok": true, "device": {...}}; the line before it lists each kernel with its
launch count on its end-to-end run, its error against the plain version,
both times and the least time the card could take for the same work.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

SEED = 20261016
PARITY_DARK = Path(__file__).resolve().parent / "tests" / "data" / "f32_parity_dark.npz"
DEV = torch.device("cuda", 0)
F32, F64 = torch.float32, torch.float64
# published peaks of one H100 SXM at 700 W: HBM bytes/s and FP32 FLOP/s
# outside the tensor cores (an FMA counts 2)
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
# FP32 operations of one KDE term: (g - z), * 1/h, u*u, 1 - u^2, max, fma;
# of one Clenshaw coefficient: fma and subtract
KDE_OPS, CHEB_OPS = 7, 3
# of one term of the KDE adjoint: (g - z), * 1/h, u*u, 1 - u^2, compare and
# select, then fma, mul, add, fma into the three sums; of one coefficient
# of the adjoint's Clenshaw work: the forward's recurrence, then value with
# derivative (3 + 4) and the T_k projection (fma, sub, fma)
ADJ_KDE_OPS, ADJ_CHEB_OPS = 11, 3 + 7 + 4


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time (ms) for moving n_bytes and doing n_ops FP32
    operations on the card, and which of the two bounds it."""
    t_b, t_o = n_bytes / PEAK_BYTES, n_ops / PEAK_FP32
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def phase(n: int, name: str, msg: str) -> None:
    print(f"[phase {n}] {name}: {msg}", flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> list[float]:
    """Per-call milliseconds of ``fn`` from CUDA events, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(DEV)
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(DEV)
        out.append(start.elapsed_time(end))
    return out


def med_mad(xs: list[float]) -> tuple[float, float]:
    med = statistics.median(xs)
    return med, statistics.median(abs(x - med) for x in xs)


def population(dtype, gal_cat=None, device=None):
    from chimera_tpu_torch.models import (FLRW, MadauDickinsonRate, Population,
                                          PowerLawPeak)

    device = DEV if device is None else device
    return Population.create(
        FLRW.create(H0=70.0, Om0=0.25, device=device, dtype=dtype),
        PowerLawPeak.create(device=device, dtype=dtype),
        MadauDickinsonRate.create(device=device, dtype=dtype), gal_cat=gal_cat)


def mock(n_events, n_samples, n_inj, z_res, oversample, seed):
    """Port-generated float64 mock catalog, injections and z-grids, drawn on
    the card at H0 = 70."""
    from chimera_tpu_torch.data.mock import make_mock_catalog, make_mock_injections
    from chimera_tpu_torch.models import compute_z_grids

    pop = population(F64)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    cat = make_mock_catalog(gen, pop, n_events=n_events, n_samples=n_samples,
                            snr_threshold=12.0, oversample=oversample)
    inj, n_gen = make_mock_injections(gen, pop, n_generated=n_inj,
                                      snr_threshold=12.0)
    z_grids = compute_z_grids(pop.cosmo, cat, cosmo_prior={"H0": [40.0, 120.0]},
                              z_int_res=z_res)
    return cat, inj, n_gen, z_grids


def likelihood(data, dtype, kernel="epan"):
    from chimera_tpu_torch import HyperLikelihood, SelectionFunction

    cat, inj, n_gen, z_grids = data
    return HyperLikelihood.create(cat, z_grids, population(dtype),
                                  SelectionFunction.create(inj, n_gen),
                                  kernel=kernel, binning=False, cut_grid=None)


def kernel_inputs(hl, h0s):
    pop_b = hl.population.update_batch({"H0": h0s})
    return (hl.m1det, hl.m2det, hl.dL, hl.inv_pe_prior, pop_b.cosmo,
            pop_b.mass, hl.z_grids)


def compare(args, den_tol, stat_tol):
    """Kernel vs plain version on the same inputs; returns the errors."""
    from chimera_tpu_torch.ops.cuda.fused import (fused_weights_kde,
                                                  fused_weights_kde_plain)

    den_k, st_k = fused_weights_kde(*args)
    den_p, st_p = fused_weights_kde_plain(*args)
    torch.cuda.synchronize(DEV)
    live = st_p["sum_w"] > 0
    if live.float().mean() < 0.9:
        raise AssertionError(f"only {int(live.sum())} live (λ, event) rows")
    row_max = den_p.abs().amax(dim=-1, keepdim=True).clamp_min(1e-300)
    den_rel = ((den_k - den_p).abs() / row_max)[live].max().item()
    den_abs = (den_k - den_p).abs()[live].max().item()
    stat_rel = max(((st_k[k] - st_p[k]).abs() / st_p[k].abs())[live].max().item()
                   for k in ("norms", "neff", "bandwidth", "sum_w", "sum_w2"))
    if not (den_rel <= den_tol and stat_rel <= stat_tol):
        raise AssertionError(
            f"kernel vs plain: den {den_rel:.3e} (tol {den_tol:.0e}) of the row "
            f"max, stats {stat_rel:.3e} (tol {stat_tol:.0e}) relative")
    return den_rel, den_abs, stat_rel


def spectral(smi: str) -> tuple[dict, tuple]:
    """Phases 3-6: K1a against its plain version, the spectral batch end to
    end at the headline width, float32 vs float64, timing.  Returns the
    kernel's entry of the kernels line and the headline data."""
    from chimera_tpu_torch.ops.cuda.fused import (fused_weights_kde,
                                                  fused_weights_kde_plain)

    # ---- 3. kernel vs plain at 64 x 4096 x 500, L = 4 --------------------
    small = mock(64, 4096, 200_000, 500, 300, SEED + 3)
    h0s4 = torch.linspace(60.0, 80.0, 4, device=DEV)
    for dtype, den_tol, stat_tol in ((F64, 1e-10, 1e-10), (F32, 1e-4, 1e-5)):
        args = kernel_inputs(likelihood(small, dtype), h0s4.to(dtype))
        den_rel, den_abs, stat_rel = compare(args, den_tol, stat_tol)
        k_ms = statistics.median(cuda_ms(lambda: fused_weights_kde(*args), 5))
        p_ms = statistics.median(cuda_ms(lambda: fused_weights_kde_plain(*args), 2))
        phase(3, f"kernel vs plain {dtype}",
              f"den max err {den_rel:.3e} of row max ({den_abs:.3e} abs), "
              f"stats max rel err {stat_rel:.3e}; kernel {k_ms:.3f} ms, "
              f"plain {p_ms:.3f} ms per call [{smi}]")
    del small

    # ---- 4. end to end at full width, float32 ----------------------------
    t0 = time.perf_counter()
    full = mock(1000, 4096, 2_000_000, 500, 200, SEED)
    hl = likelihood(full, F32)
    torch.cuda.synchronize(DEV)
    setup_s = time.perf_counter() - t0
    h0s = torch.linspace(55.0, 95.0, 16, device=DEV)
    batch = {"H0": h0s.to(F32)}
    fused_weights_kde.launches = 0
    ll = hl.log_like_batch(batch)
    torch.cuda.synchronize(DEV)
    launches = fused_weights_kde.launches
    check_log_like(ll, h0s, {"fused_weights_kde": launches})
    phase(4, "end to end", f"{hl.n_events} events x {hl.dL.shape[1]} samples x "
          f"{hl.z_grids.shape[1]} grid, {hl.selection.dL.shape[0]} detected "
          f"injections of 2000000, setup {setup_s:.1f} s; kernel launches "
          f"{launches}; H0 argmax {h0s[int(torch.argmax(ll))].item():.2f}; "
          f"log L = {[round(v, 4) for v in ll.tolist()]} [{smi}]")

    # ---- 5. precision: float32 vs float64 through the kernel -------------
    par = mock(64, 1024, 200_000, 300, 300, SEED + 5)
    h0s7 = torch.linspace(58.0, 100.0, 7, device=DEV)
    rel, diff, n_fin = f32_vs_f64(likelihood(par, F64), likelihood(par, F32),
                                  h0s7)
    phase(5, "precision", f"float32 vs float64 log L: max rel err {rel:.3e} "
          f"(bar 1e-6), max abs {diff:.3e}, over {n_fin} of 7 H0 values [{smi}]")
    del par

    # ---- 6. timing at full width -----------------------------------------
    reps = 17
    total = cuda_ms(lambda: hl.log_like_batch(batch), reps)
    rebuild = cuda_ms(lambda: hl.population.update_batch(batch), reps)
    args = kernel_inputs(hl, batch["H0"])
    kern = cuda_ms(lambda: fused_weights_kde(*args), reps)
    plain = cuda_ms(lambda: fused_weights_kde_plain(*args), 3)
    den_rel, den_abs, stat_rel = compare(args, 1e-4, 1e-5)
    n = len(h0s)
    t_med, t_mad = med_mad([t / n for t in total])
    r_med, r_mad = med_mad([t / n for t in rebuild])
    k_med, k_mad = med_mad([t / n for t in kern])
    phase(6, "timing", f"[{smi}] per λ over {reps} batches of {n}: total "
          f"{t_med:.4f} ± {t_mad:.4f} ms (median ± MAD); table rebuild "
          f"{r_med:.4f} ± {r_mad:.4f} ms; kernel {k_med:.4f} ± {k_mad:.4f} ms; "
          f"rest {t_med - r_med - k_med:.4f} ms")
    k_call, p_call = statistics.median(kern), statistics.median(plain)
    e, s = hl.dL.shape
    g, p = hl.z_grids.shape[1], 12 + args[5].window_deg
    bound_ms, bound_by = bound(
        4 * ((4 * e * s + e * g) + n * p + n * e * (g + 8))
        + 8 * n * (args[4].cheb_deg + 2),
        n * e * s * (CHEB_OPS * args[4].cheb_deg + KDE_OPS * g))
    phase(6, "kernel vs plain", f"[{smi}] at 1000 x 4096 x 500, L = 16: kernel "
          f"{k_call:.3f} ms, plain {p_call:.3f} ms per call "
          f"({p_call / k_call:.1f}x), bound {bound_ms:.3f} ms ({bound_by}); "
          f"den max err {den_rel:.3e} of row max, stats {stat_rel:.3e}")
    return {"name": "fused_weights_kde", "route": "cuda",
            "source": "chimera_tpu_torch/csrc/fused_kde.cu",
            "replaces": "chimera_tpu/ops/pallas/fused.py:71",
            "launches": launches, "max_abs_err": den_abs, "ms": k_call,
            "plain_ms": p_call, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}, full


def check_log_like(ll, h0s, launches: dict) -> None:
    """An end-to-end batch: one finite-or--inf value per H0, every kernel
    of the path launched, the maximum near the mock's H0 = 70."""
    if ll.shape != h0s.shape:
        raise AssertionError(f"log-likelihood shape {tuple(ll.shape)}")
    if torch.isnan(ll).any() or torch.isposinf(ll).any():
        raise AssertionError(f"NaN or +inf log-likelihoods: {ll.tolist()}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"the main path never launched {name}")
    h0_best = h0s[int(torch.argmax(ll))].item()
    if not 60.0 <= h0_best <= 80.0:
        raise AssertionError(f"H0 argmax {h0_best} outside [60, 80]")


def f32_vs_f64(hl64, hl32, h0s) -> tuple[float, float, int]:
    """Float32 against float64 log L over an H0 batch, elementwise relative,
    held to the repo's 1e-6 bar (BASELINE.md, tests/test_f32_parity.py).
    Returns the largest relative and absolute differences and the number
    of finite values."""
    ll64 = hl64.log_like_batch({"H0": h0s})
    ll32 = hl32.log_like_batch({"H0": h0s.to(F32)}).double()
    fin = torch.isfinite(ll64)
    if not fin.any() or not torch.equal(fin, torch.isfinite(ll32)):
        raise AssertionError(f"non-finite log L: f64 {ll64.tolist()}, "
                             f"f32 {ll32.tolist()}")
    diff = (ll32 - ll64).abs()[fin]
    rel = (diff / ll64[fin].abs()).max().item()
    if rel > 1e-6:
        raise AssertionError(f"float32 vs float64: {rel:.3e} > 1e-6 "
                             f"(f64 {ll64.tolist()}, f32 {ll32.tolist()})")
    return rel, diff.max().item(), int(fin.sum())


# ---------------------------------------------------------------------------
# the dark-siren 'marginalized' path
# ---------------------------------------------------------------------------

def dark_mock(n_events, n_samples, n_pix, z_res, n_inj, n_background, seed):
    """Port-generated float64 dark-siren data on the card at H0 = 70: PE
    samples with sky positions (sigma_sky 0.03 rad) and their pixelization
    (nside {8, 16}, sky_conf 0.9), z-grids (H0 prior [40, 120]), hosts plus
    background galaxies and their pixelated prior (step completeness on
    (0, 3), z_err 0.01), injections.  Returns the data and the setup
    seconds of each stage."""
    from chimera_tpu_torch.catalog import DVdzCompleteness
    from chimera_tpu_torch.catalog.build import build_pixelated_catalog
    from chimera_tpu_torch.data.mock import (make_mock_catalog,
                                             make_mock_galaxies,
                                             make_mock_injections)
    from chimera_tpu_torch.data.pixelize import pixelize_gw_catalog
    from chimera_tpu_torch.models import compute_z_grids

    times = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        torch.cuda.synchronize(DEV)
        times[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    pop = population(F64)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    cat, truths = make_mock_catalog(
        gen, pop, n_events=n_events, n_samples=n_samples, snr_threshold=12.0,
        sigma_sky_rad=0.03, oversample=max(100, 4 * 50_000 // n_events),
        return_truths=True)
    inj, n_gen = make_mock_injections(gen, pop, n_generated=n_inj,
                                      snr_threshold=12.0)
    gal = make_mock_galaxies(gen, pop, truths, n_background=n_background)
    lap("mock")
    cat = pixelize_gw_catalog(cat, nside_list=[8, 16],
                              mean_npixels_event=n_pix, sky_conf=0.9)
    z_grids = compute_z_grids(pop.cosmo, cat, cosmo_prior={"H0": [40.0, 120.0]},
                              z_int_res=z_res)
    lap("pixelize")
    compl = DVdzCompleteness.create(z_range=(0.0, 3.0), kind="step",
                                    device=DEV, dtype=F64)
    gal_cat = build_pixelated_catalog(gal, cat, z_grids, pop.cosmo, compl,
                                      z_err=0.01)
    lap("catalog")
    return (cat, z_grids, gal_cat, inj, n_gen), times


def parity_dark_mock(device):
    """The repo's dark-siren float32 precision mock, the data of
    tests/test_f32_parity.py::test_f32_dark_siren_parity (16 events x 512
    samples, nside {8, 16}, 6 pixels asked, 200-point grids, 10 000
    background galaxies, step completeness on (0, 3), 100 000 generated
    injections), as tests/test_torch_f32_parity.py writes it: the data of
    ``dark_likelihood`` on ``device`` in float64."""
    import numpy as np

    from chimera_tpu_torch.catalog import DVdzCompleteness, PixelatedCatalog
    from chimera_tpu_torch.data.structs import ThetaInjDet, ThetaPEDet

    d = np.load(PARITY_DARK)

    def arr(key, dtype=F64):
        return torch.as_tensor(d[key], device=device).to(dtype)

    i64, mask = torch.int64, arr("pmask", torch.bool)
    cat = ThetaPEDet(
        m1det=arr("m1"), m2det=arr("m2"), dL=arr("dl"), pe_prior=arr("prior"),
        ra=arr("ra"), dec=arr("dec"), opt_nsides=arr("opt_nsides", i64),
        pixels_opt_nsides=arr("pixels", i64), ra_pix=arr("ra_pix"),
        dec_pix=arr("dec_pix"), gw_loc2d_pdf=arr("loc2d"),
        pixels_pe_opt_nside=arr("pix_pe", i64), pixel_mask=mask)
    gal_cat = PixelatedCatalog(
        p_cat=arr("p_cat"), P_compl=arr("P_compl"), pixel_mask=mask,
        n_gal=arr("n_gal", i64), completeness=DVdzCompleteness.create(
            z_range=(0.0, 3.0), kind="step", device=device, dtype=F64))
    inj = ThetaInjDet(m1det=arr("im1"), m2det=arr("im2"), dL=arr("idl"),
                      p_draw=arr("ipd"))
    return cat, arr("zg"), gal_cat, inj, float(d["n_gen"])


def dark_likelihood(data, dtype):
    from chimera_tpu_torch import HyperLikelihood, SelectionFunction

    cat, z_grids, gal_cat, inj, n_gen = data
    return HyperLikelihood.create(cat, z_grids,
                                  population(dtype, gal_cat, z_grids.device),
                                  SelectionFunction.create(inj, n_gen),
                                  kind="marginalized", binning=False,
                                  cut_grid=None)


def dark_kernel_inputs(hl, h0s):
    """The two kernels' inputs on the main path for an H0 batch: the stats
    pass's arguments, and the rows pass's with (1/h, scale) from the plain
    stats (both kernels are compared on the same inputs)."""
    from chimera_tpu_torch.ops.cuda.fused import fused_row_stats_plain

    pop_b = hl.population.update_batch({"H0": h0s})
    stats_args = (hl.pix_m1det, hl.pix_m2det, hl.pix_dL, hl.pix_inv_pe_prior,
                  pop_b.cosmo, pop_b.mass, hl.pix_n_real, hl.pix_dl_fill,
                  hl.n_samples, 2.0)
    f1, f2, _ = hl.lambda_factors(pop_b)
    rows_args = (hl.row_m1det, hl.row_m2det, hl.row_dL, hl.row_inv_pe_prior,
                 pop_b.cosmo, pop_b.mass, hl.z_grids,
                 hl.row_scales(fused_row_stats_plain(*stats_args)),
                 hl.row_s1, hl.row_s2, f1, f2)
    return stats_args, rows_args


def dark_compare(stats_args, rows_args, stat_tol, r_tol):
    """K1c and K2 against their plain versions on the same inputs: stats
    relative on the pixel rows with weight (lo, ub relative to the largest
    ub), r relative to each λ's largest |r| on the rows with a scale.
    Returns (stats rel, stats abs, r rel, r abs)."""
    from chimera_tpu_torch.ops.cuda.fused import (fused_row_stats,
                                                  fused_row_stats_plain)
    from chimera_tpu_torch.ops.cuda.rows import (fused_rows_contract,
                                                 fused_rows_contract_plain)

    st_k, st_p = fused_row_stats(*stats_args), fused_row_stats_plain(*stats_args)
    r_k = fused_rows_contract(*rows_args)
    r_p = fused_rows_contract_plain(*rows_args)
    torch.cuda.synchronize(DEV)
    live = st_p["sum_w"] > 0
    if live.float().mean() < 0.5:
        raise AssertionError(f"only {int(live.sum())} live (λ, pixel) rows")
    stat_rel = stat_abs = 0.0
    ub_max = st_p["ub"].abs().max()
    for k in ("lo", "ub", "norms", "neff", "bandwidth", "sum_w", "sum_w2"):
        ref = ub_max if k in ("lo", "ub") else st_p[k].abs()
        err = (st_k[k] - st_p[k]).abs()[live]
        stat_rel = max(stat_rel, (err / ref.expand_as(st_p[k])[live]).max().item())
        stat_abs = max(stat_abs, err.max().item())
    scaled = rows_args[7][..., 1] > 0
    r_max = r_p.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-300)
    r_err = (r_k - r_p).abs()
    r_rel = (r_err / r_max)[scaled].max().item()
    r_abs = r_err[scaled].max().item()
    if not torch.all(r_k[~scaled] == 0):
        raise AssertionError("a row with scale 0 did not come out as 0")
    if not (stat_rel <= stat_tol and r_rel <= r_tol):
        raise AssertionError(
            f"kernels vs plain: stats {stat_rel:.3e} (tol {stat_tol:.0e}) "
            f"relative, r {r_rel:.3e} (tol {r_tol:.0e}) of the per-λ max")
    return stat_rel, stat_abs, r_rel, r_abs


def dark(smi: str) -> list[dict]:
    """Phases 7-10: K1c and K2 against their plain versions, the dark-siren
    batch end to end at the flagship width, float32 vs float64, timing.
    Returns the two kernels' entries of the kernels line."""
    from chimera_tpu_torch.ops.cuda.fused import (fused_row_stats,
                                                  fused_row_stats_plain)
    from chimera_tpu_torch.ops.cuda.rows import (fused_rows_contract,
                                                 fused_rows_contract_plain)

    # ---- 7. kernels vs plain at 64 x 1024 x 500, L = 4 -------------------
    small, _ = dark_mock(64, 1024, 15, 500, 100_000, 10_000, SEED + 7)
    h0s4 = torch.linspace(60.0, 80.0, 4, device=DEV)
    for dtype, stat_tol, r_tol in ((F64, 1e-10, 1e-10), (F32, 1e-5, 1e-4)):
        hl = dark_likelihood(small, dtype)
        stats_args, rows_args = dark_kernel_inputs(hl, h0s4.to(dtype))
        stat_rel, _, r_rel, _ = dark_compare(stats_args, rows_args, stat_tol, r_tol)
        k1 = statistics.median(cuda_ms(lambda: fused_row_stats(*stats_args), 5))
        p1 = statistics.median(cuda_ms(lambda: fused_row_stats_plain(*stats_args), 2))
        k2 = statistics.median(cuda_ms(lambda: fused_rows_contract(*rows_args), 5))
        p2 = statistics.median(cuda_ms(lambda: fused_rows_contract_plain(*rows_args), 2))
        phase(7, f"kernels vs plain {dtype}",
              f"stats max rel err {stat_rel:.3e}, r max err {r_rel:.3e} of the "
              f"per-λ max; K1c {k1:.3f} ms (plain {p1:.3f}), K2 {k2:.3f} ms "
              f"(plain {p2:.3f}) per call [{smi}]")
    del small

    # ---- 8. end to end at build_dark's width, float32 --------------------
    data, times = dark_mock(1000, 1024, 15, 500, 500_000, 50_000, SEED + 8)
    t0 = time.perf_counter()
    hl = dark_likelihood(data, F32)
    torch.cuda.synchronize(DEV)
    times["create"] = time.perf_counter() - t0
    h0s = torch.linspace(55.0, 95.0, 16, device=DEV)
    batch = {"H0": h0s.to(F32)}
    fused_row_stats.launches = fused_rows_contract.launches = 0
    ll = hl.log_like_batch(batch)
    torch.cuda.synchronize(DEV)
    launches = {"fused_row_stats": fused_row_stats.launches,
                "fused_rows_contract": fused_rows_contract.launches}
    check_log_like(ll, h0s, launches)
    n_real = int(hl.pix_n_real.sum())
    b, s_pp = hl.pix_dL.shape
    r_rows, chunk = hl.row_dL.shape
    phase(8, "end to end", f"{hl.n_events} events x {hl.n_samples} samples x "
          f"{hl.z_grids.shape[1]} grid: P = {hl.n_pixels}, S_pp = {s_pp}, "
          f"C = {hl.rows_per_event}, R = {r_rows} rows of {chunk}; "
          f"{n_real} real samples in {b * s_pp} slots; "
          f"{hl.selection.dL.shape[0]} detected injections of 500000; setup "
          + ", ".join(f"{k} {v:.3f} s" for k, v in times.items())
          + f"; launches {launches}; H0 argmax "
          f"{h0s[int(torch.argmax(ll))].item():.2f}; "
          f"log L = {[round(v, 4) for v in ll.tolist()]} [{smi}]")

    # ---- 9. precision: float32 vs float64 through the kernels, on the ----
    # repo's dark-siren precision mock
    par = parity_dark_mock(DEV)
    h0s7 = torch.linspace(58.0, 100.0, 7, device=DEV)
    rel, diff, n_fin = f32_vs_f64(dark_likelihood(par, F64),
                                  dark_likelihood(par, F32), h0s7)
    phase(9, "precision", f"float32 vs float64 log L on {PARITY_DARK.name}: "
          f"max rel err {rel:.3e} (bar 1e-6), max abs {diff:.3e}, over "
          f"{n_fin} of 7 H0 values [{smi}]")
    del par

    # ---- 10. timing at full width ----------------------------------------
    reps = 17
    total = cuda_ms(lambda: hl.log_like_batch(batch), reps)
    rebuild = cuda_ms(lambda: hl.population.update_batch(batch), reps)
    stats_args, rows_args = dark_kernel_inputs(hl, batch["H0"])
    k1 = cuda_ms(lambda: fused_row_stats(*stats_args), reps)
    k2 = cuda_ms(lambda: fused_rows_contract(*rows_args), reps)
    p1 = cuda_ms(lambda: fused_row_stats_plain(*stats_args), 3)
    p2 = cuda_ms(lambda: fused_rows_contract_plain(*rows_args), 3)
    stat_rel, stat_abs, r_rel, r_abs = dark_compare(stats_args, rows_args,
                                                    1e-5, 1e-4)
    n = len(h0s)
    t_med, t_mad = med_mad([t / n for t in total])
    r_med, r_mad = med_mad([t / n for t in rebuild])
    a_med, a_mad = med_mad([t / n for t in k1])
    c_med, c_mad = med_mad([t / n for t in k2])
    phase(10, "timing", f"[{smi}] per λ over {reps} batches of {n}: total "
          f"{t_med:.4f} ± {t_mad:.4f} ms (median ± MAD); table rebuild "
          f"{r_med:.4f} ± {r_mad:.4f} ms; K1c {a_med:.4f} ± {a_mad:.4f} ms; "
          f"K2 {c_med:.4f} ± {c_mad:.4f} ms; rest "
          f"{t_med - r_med - a_med - c_med:.4f} ms")

    cosmo, mass = stats_args[4], stats_args[5]
    e, g = hl.z_grids.shape
    p = 12 + mass.window_deg
    inv_bytes = 8 * n * (cosmo.cheb_deg + 2)
    cheb = CHEB_OPS * cosmo.cheb_deg
    scaled = rows_args[7][..., 1] > 0
    weighted = (hl.row_inv_pe_prior > 0).any(dim=1)
    live_pairs = int((scaled & weighted[None]).sum())
    k1_bound = bound(4 * (4 * n_real + 3 * b + n * p + 8 * n * b) + inv_bytes,
                     n * n_real * cheb)
    k2_bound = bound(4 * (4 * r_rows * chunk + e * g + 2 * r_rows * g
                          + 2 * n * e * g + 4 * n * r_rows + n * p) + inv_bytes,
                     live_pairs * chunk * (cheb + KDE_OPS * g))
    entries = []
    for name, src, line, kern, plain, (b_ms, b_by), err in (
            ("fused_row_stats", "fused_kde.cu", 71, k1, p1, k1_bound, stat_abs),
            ("fused_rows_contract", "rows_contract.cu", 495, k2, p2, k2_bound,
             r_abs)):
        k_call, p_call = statistics.median(kern), statistics.median(plain)
        phase(10, f"{name} vs plain", f"[{smi}] at the flagship, L = {n}: "
              f"kernel {k_call:.3f} ms, plain {p_call:.3f} ms per call "
              f"({p_call / k_call:.1f}x), bound {b_ms:.4f} ms ({b_by}); max "
              f"abs err {err:.3e}")
        entries.append({
            "name": name, "route": "cuda",
            "source": f"chimera_tpu_torch/csrc/{src}",
            "replaces": f"chimera_tpu/ops/pallas/fused.py:{line}",
            "launches": launches[name], "max_abs_err": err, "ms": k_call,
            "plain_ms": p_call, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None})
    phase(10, "errors", f"stats max rel {stat_rel:.3e}, r max {r_rel:.3e} of "
          f"the per-λ max; {live_pairs} of {n * r_rows} (λ, row) pairs carry "
          f"KDE work [{smi}]")
    return entries


# ---------------------------------------------------------------------------
# gradients and samplers on the spectral headline
# ---------------------------------------------------------------------------

PARAMS = ("H0", "Om0", "mu_g")
BOUNDS = {"H0": (40.0, 120.0), "Om0": (0.05, 0.6), "mu_g": (25.0, 45.0)}
INIT = {"H0": 70.0, "Om0": 0.25, "mu_g": 34.0}


def chain_points(n: int, dtype) -> torch.Tensor:
    """(n, 3) hyper-parameter points (H0, Om0, mu_g) scattered around the
    mock's truth, from a fixed seed."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 12)
    noise = torch.randn((n, 3), generator=gen, device=DEV, dtype=F64)
    centre = torch.tensor([INIT[p] for p in PARAMS], device=DEV, dtype=F64)
    scale = torch.tensor([3.0, 0.02, 0.5], device=DEV, dtype=F64)
    return (centre + scale * noise).to(dtype)


def log_like(hl, x: torch.Tensor) -> torch.Tensor:
    """log L (n,) at the points ``x`` (n, 3)."""
    return hl.log_like_batch({p: x[:, i] for i, p in enumerate(PARAMS)})


def value_and_grad(hl, x: torch.Tensor):
    """log L (n,) and d log L / dλ (n, 3) at the points ``x``."""
    x = x.detach().requires_grad_()
    ll = log_like(hl, x)
    return ll.detach(), torch.autograd.grad(ll.sum(), x)[0]


def column_rel(got: torch.Tensor, expect: torch.Tensor) -> float:
    """Largest error of an (n, 3) gradient relative to the largest entry
    of its parameter's column."""
    err = (got.double() - expect.double()).abs()
    return (err / expect.double().abs().amax(dim=0)).max().item()


def adjoint_inputs(hl, x: torch.Tensor, seed: int):
    """K3's arguments at the points ``x``, with random cotangents for den
    and for the stats."""
    from chimera_tpu_torch.ops.cuda.fused import pack_params

    pop_b = hl.population.update_batch({p: x[:, i] for i, p in enumerate(PARAMS)})
    n, dt = x.shape[0], hl.dL.dtype
    series, params = pack_params(pop_b.cosmo, pop_b.mass, n, dt)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    e, g = hl.z_grids.shape
    ct_den = torch.randn((n, e, g), generator=gen, device=DEV, dtype=F64).to(dt)
    ct_stats = torch.randn((n, e, 8), generator=gen, device=DEV, dtype=F64).to(dt)
    return (hl.m1det, hl.m2det, hl.dL, hl.inv_pe_prior, hl.z_grids, series,
            params, ct_den, ct_stats, pop_b.cosmo, pop_b.mass)


def main_path_cotangents(hl, x: torch.Tensor):
    """The cotangents that the backward of ``log_like_batch`` hands K3 at
    the points ``x``: d(sum log L)/d den from the likelihood's own tail,
    and zeros for the stats (they only gate)."""
    from chimera_tpu_torch.ops.cuda.fused import fused_weights_kde

    with torch.no_grad():
        pop_b = hl.population.update_batch(
            {p: x[:, i] for i, p in enumerate(PARAMS)})
        den, stats = fused_weights_kde(hl.m1det, hl.m2det, hl.dL,
                                       hl.inv_pe_prior, pop_b.cosmo, pop_b.mass,
                                       hl.z_grids, kernel=hl.kernel)
    den = den.requires_grad_()
    num = hl.numerators_from_densities(pop_b, den, stats)
    total = torch.nan_to_num(torch.log(num), nan=-torch.inf).sum()
    ct_den = torch.autograd.grad(total, den)[0]
    return ct_den.contiguous(), torch.zeros(
        (*ct_den.shape[:2], 8), dtype=ct_den.dtype, device=ct_den.device)


def adjoint_compare(args, kernel: str, tol: float):
    """K3 against its plain version on the same inputs: the largest error
    of each gradient row relative to the row's largest entry, and the
    largest absolute error."""
    from chimera_tpu_torch.ops.cuda.fused import (fused_weights_kde_adjoint,
                                                  fused_weights_kde_adjoint_plain)

    got = fused_weights_kde_adjoint(*args, kernel)
    again = fused_weights_kde_adjoint(*args, kernel)
    expect = fused_weights_kde_adjoint_plain(*args, kernel)
    torch.cuda.synchronize(DEV)
    rel = abs_err = 0.0
    for g, a, e in zip(got, again, expect):
        if not torch.equal(g, a):
            raise AssertionError("K3 gave different bits on the same inputs")
        if not torch.all(torch.isfinite(g)):
            raise AssertionError("K3 returned a non-finite gradient")
        err = (g.double() - e.double()).abs()
        row_max = e.double().abs().amax(dim=1, keepdim=True).clamp_min(1e-300)
        rel = max(rel, (err / row_max).max().item())
        abs_err = max(abs_err, err.max().item())
    if not rel <= tol:
        raise AssertionError(f"K3 vs plain ({kernel}): {rel:.3e} of the row "
                             f"max (tol {tol:.0e})")
    return rel, abs_err


def cut_events(data, n: int):
    """The first ``n`` events of a spectral mock."""
    import dataclasses

    cat, inj, n_gen, z_grids = data
    per_event = {f.name: getattr(cat, f.name)[:n] for f in dataclasses.fields(cat)
                 if isinstance(getattr(cat, f.name), torch.Tensor)}
    return cat.update(**per_event), inj, n_gen, z_grids[:n]


def counting_prior(counter: list):
    """A flat extra prior that counts the log-density evaluations."""
    def prior(lam):
        counter[0] += 1
        return torch.zeros_like(lam[PARAMS[0]])
    return prior


def check_samples(name: str, samples: dict, n_steps: int, n_chains: int) -> None:
    for p in PARAMS:
        x = samples[p]
        lo, hi = BOUNDS[p]
        if x.shape != (n_steps, n_chains) or not torch.all(torch.isfinite(x)):
            raise AssertionError(f"{name}: {p} samples {tuple(x.shape)} not finite")
        if not torch.all((x > lo) & (x < hi)):
            raise AssertionError(f"{name}: {p} samples outside ({lo}, {hi})")
    if torch.equal(samples["H0"][0], samples["H0"][-1]):
        raise AssertionError(f"{name}: no chain moved while sampling")


def sampler(smi: str, full) -> dict:
    """Phases 11-14: K3 against its plain version, the gradient of the
    headline log L against the CPU's and against finite differences, HMC
    and ChEES end to end, timing.  Returns K3's entry of
    the kernels line."""
    from chimera_tpu_torch.inference import (sample_hyperposterior,
                                             sample_hyperposterior_chees)
    from chimera_tpu_torch.ops.cuda.fused import (fused_weights_kde,
                                                  fused_weights_kde_adjoint,
                                                  fused_weights_kde_adjoint_plain)

    # ---- 11. K3 vs plain at 64 x 4096 x 500, L = 4 -----------------------
    small = mock(64, 4096, 200_000, 500, 300, SEED + 3)
    for dtype, tol in ((F64, 1e-9), (F32, 1e-3)):
        hl = likelihood(small, dtype)
        args = adjoint_inputs(hl, chain_points(4, dtype), SEED + 11)
        for kernel in ("epan", "gauss"):
            rel, abs_err = adjoint_compare(args, kernel, tol)
            k_ms = statistics.median(cuda_ms(
                lambda: fused_weights_kde_adjoint(*args, kernel), 5))
            p_ms = statistics.median(cuda_ms(
                lambda: fused_weights_kde_adjoint_plain(*args, kernel), 1, 0))
            phase(11, f"K3 vs plain {dtype} {kernel}",
                  f"max err {rel:.3e} of each gradient row's max ({abs_err:.3e} "
                  f"abs), equal bits on a second launch; kernel {k_ms:.3f} ms, "
                  f"plain {p_ms:.3f} ms per call [{smi}]")
    del small

    # ---- 12. d log L / dλ for 16 chains ----------------------------------
    # On 64 events of the headline data: the card's gradient (K1a forward,
    # K3 backward) against plain autograd on the CPU in float64 (the first
    # 4 chains: the CPU takes ~2 s per chain and event), and float32 against
    # float64 on the card.  The Epanechnikov slope is itself
    # discontinuous: K' jumps by 1.5 at the support's edge, and the sum over
    # (grid point, sample) pairs cancels to a small part of its terms.  In
    # float32 a pair within an ulp of the edge falls on either side of it by
    # the rounding of z, and a few such pairs move the slope by ~1e-3; the
    # Gaussian kernel has no edge and shows the arithmetic alone.
    n = 16
    cut = cut_events(full, 64)
    x = chain_points(n, F64)
    for kernel, tol32 in (("epan", 1e-2), ("gauss", 1e-3)):
        hl64 = likelihood(cut, F64, kernel)
        fused_weights_kde.launches = fused_weights_kde_adjoint.launches = 0
        ll, g64 = value_and_grad(hl64, x)
        launched = (fused_weights_kde.launches, fused_weights_kde_adjoint.launches)
        t0 = time.perf_counter()
        ll_cpu, g_cpu = value_and_grad(copy.deepcopy(hl64).to("cpu"), x[:4].cpu())
        seconds = time.perf_counter() - t0
        _, g32 = value_and_grad(likelihood(cut, F32, kernel), x.to(F32))
        rel, rel32 = column_rel(g64[:4].cpu(), g_cpu), column_rel(g32, g64)
        rel_ll = ((ll[:4].cpu() - ll_cpu).abs() / ll_cpu.abs()).max().item()
        if launched != (1, 1):
            raise AssertionError(f"gradient {kernel}: K1a, K3 launches {launched}")
        if not (torch.all(torch.isfinite(g64)) and torch.all(torch.isfinite(g32))
                and rel <= 1e-9 and rel_ll <= 1e-10 and rel32 <= tol32):
            raise AssertionError(
                f"gradient {kernel}: card vs CPU {rel:.3e} (tol 1e-9), log L "
                f"{rel_ll:.3e} (tol 1e-10), float32 vs float64 {rel32:.3e} "
                f"(tol {tol32:.0e}) of each parameter's largest slope")
        phase(12, f"card vs CPU {kernel}", f"d log L/d(H0, Om0, mu_g), {n} chains, "
              f"64 events of the headline data, float64: K1a + K3 on the card "
              f"vs plain autograd on the CPU (4 chains, {seconds:.1f} s) max err {rel:.3e} "
              f"of each parameter's largest slope (tol 1e-9), log L {rel_ll:.3e}; "
              f"float32 vs float64 on the card {rel32:.3e} (tol {tol32:.0e}) "
              f"[{smi}]")
    # Central differences of the float64 log L in H0 at full width.  log L
    # itself jumps where a sample's or an injection's source mass crosses a
    # hard edge of the mass model (m_high, the peak's 5 sigma cut): with 4
    # million samples some edge is crossed inside almost any step, and a
    # difference across a jump is not the slope.  log N_exp jumps too, but
    # with 61 100 injections only a step of 1e-4 meets an edge (one chain of
    # 16 then reads 0.9 off): at 1e-6 it is held chain by chain, and the
    # whole log L at the smallest step that rounding allows, by its median
    # and its largest error.
    hl64 = likelihood(full, F64)
    _, g64 = value_and_grad(hl64, x)

    def log_n_exp(x):
        pop_b = hl64.population.update_batch(
            {p: x[:, i] for i, p in enumerate(PARAMS)})
        return torch.log(hl64.selection.n_exp(pop_b))

    def differences(fn, h):
        step = torch.zeros_like(x)
        step[:, 0] = h
        up, down = x + step, x - step
        with torch.no_grad():
            return (fn(up) - fn(down)) / (up - down)[:, 0]

    xg = x.clone().requires_grad_()
    g_exp = torch.autograd.grad(log_n_exp(xg).sum(), xg)[0][:, 0]
    fd_exp = differences(log_n_exp, 1e-6)
    fd = differences(lambda x: log_like(hl64, x), 1e-7)
    torch.cuda.synchronize(DEV)
    exp_errs = (g_exp - fd_exp).abs() / fd_exp.abs()
    exp_err = exp_errs.max().item()
    fd_err = (g64[:, 0] - fd).abs() / fd.abs()
    rel, rel_max = fd_err.median().item(), fd_err.max().item()
    if not (torch.all(torch.isfinite(g64)) and exp_err <= 1e-6 and rel <= 1e-4
            and rel_max <= 1e-3):
        raise AssertionError(
            f"float64 gradient vs central differences in H0: log N_exp "
            f"{exp_err:.3e} (tol 1e-6 in every chain), log L median {rel:.3e} "
            f"(tol 1e-4), max {rel_max:.3e} (tol 1e-3); log N_exp by chain "
            f"{exp_errs.tolist()}; log L {g64[:, 0].tolist()} vs {fd.tolist()}")
    hl = likelihood(full, F32)
    _, g32 = value_and_grad(hl, x.to(F32))
    rel32 = column_rel(g32, g64)
    if not (torch.all(torch.isfinite(g32)) and rel32 <= 1e-2):
        raise AssertionError(f"float32 vs float64 gradient: {rel32:.3e}")
    phase(12, "full width", f"{n} chains at 1000 x 4096 x 500: float64 "
          f"d/dH0 vs central differences, log N_exp (step 1e-6) max rel err "
          f"{exp_err:.3e} (tol 1e-6), log L (step 1e-7) median {rel:.3e} (tol "
          f"1e-4), max {rel_max:.3e} (tol 1e-3), "
          f"{int((fd_err > 1e-4).sum())} chains over 1e-4; float32 vs float64 "
          f"gradient max err {rel32:.3e} of each parameter's largest slope (tol "
          f"1e-2, Epanechnikov); no NaN [{smi}]")

    # ---- 13. HMC and ChEES on the headline likelihood, float32 -----------
    counts = {}
    for name, run in (
            ("hmc", lambda gen, prior: sample_hyperposterior(
                gen, hl, list(PARAMS), BOUNDS, INIT, n_chains=n, n_warmup=4,
                n_samples=4, n_leapfrog=4, init_step_size=0.03,
                extra_log_prior=prior)),
            ("chees", lambda gen, prior: sample_hyperposterior_chees(
                gen, hl, list(PARAMS), BOUNDS, INIT, n_chains=n, n_warmup=4,
                n_samples=4, max_steps=4, init_step_size=0.03,
                extra_log_prior=prior))):
        runs = []
        for _ in range(2):
            evals = [0]
            fused_weights_kde.launches = fused_weights_kde_adjoint.launches = 0
            t0 = time.perf_counter()
            samples, stats = run(torch.Generator(device=DEV).manual_seed(SEED + 13),
                                 counting_prior(evals))
            torch.cuda.synchronize(DEV)
            seconds = time.perf_counter() - t0
            launched = (fused_weights_kde.launches,
                        fused_weights_kde_adjoint.launches)
            runs.append(samples)
            check_samples(name, samples, 4, n)
            if evals[0] < 9 or launched != (evals[0], evals[0]):
                raise AssertionError(
                    f"{name}: {evals[0]} gradient evaluations but K1a, K3 "
                    f"launches {launched}")
        if not all(torch.equal(runs[0][p], runs[1][p]) for p in PARAMS):
            raise AssertionError(f"{name}: a second run under the same "
                                 "generator seed gave other samples")
        counts[name] = launched
        phase(13, name, f"{n} chains x (4 warm-up + 4 sampling steps) in "
              f"{PARAMS}: {evals[0]} gradient evaluations = K1a launches "
              f"{launched[0]} = K3 launches {launched[1]}, {seconds:.2f} s; "
              f"samples finite and inside the bounds, equal bits on a second "
              f"run; accept {float(stats['accept'].mean()):.2f}, step size "
              f"{float(stats['step_size']):.4f}, H0 mean "
              f"{float(samples['H0'].mean()):.2f} [{smi}]")

    # ---- 14. timing at the headline, L = 16, float32 ---------------------
    reps = 17
    x = chain_points(n, F32)
    batch = {p: x[:, i] for i, p in enumerate(PARAMS)}
    total = cuda_ms(lambda: value_and_grad(hl, x), reps)
    forward = cuda_ms(lambda: hl.log_like_batch(batch), reps)
    one = cuda_ms(lambda: value_and_grad(hl, x[:1]), reps)
    # K3 on what the sampler's backward hands it at these points
    args = list(adjoint_inputs(hl, x, SEED + 14))
    args[7], args[8] = main_path_cotangents(hl, x)
    kern = cuda_ms(lambda: fused_weights_kde_adjoint(*args, "epan"), reps)
    plain = cuda_ms(lambda: fused_weights_kde_adjoint_plain(*args, "epan"), 1, 0)
    rel, abs_err = adjoint_compare(args, "epan", 1e-3)
    x64 = chain_points(n, F64)
    args64 = list(adjoint_inputs(hl64, x64, SEED + 14))
    args64[7], args64[8] = main_path_cotangents(hl64, x64)
    rel64, _ = adjoint_compare(args64, "epan", 1e-9)
    del hl64, args64
    t_med, t_mad = med_mad([t / n for t in total])
    f_med, f_mad = med_mad([t / n for t in forward])
    k_med, k_mad = med_mad([t / n for t in kern])
    o_med, o_mad = med_mad(one)
    phase(14, "timing", f"[{smi}] per λ over {reps} batches of {n}: value and "
          f"gradient {t_med:.4f} ± {t_mad:.4f} ms (median ± MAD); forward "
          f"{f_med:.4f} ± {f_mad:.4f} ms; K3 {k_med:.4f} ± {k_mad:.4f} ms; glue "
          f"backward (rest) {t_med - f_med - k_med:.4f} ms; a batch of one "
          f"chain {o_med:.3f} ± {o_mad:.3f} ms per call")
    k_call, p_call = statistics.median(kern), plain[0]
    e, s = hl.dL.shape
    g = hl.z_grids.shape[1]
    cosmo, mass = args[9], args[10]
    q = cosmo.cheb_deg + 2 + mass.window_deg
    bound_ms, bound_by = bound(
        4 * (4 * e * s + e * g + n * e * (g + 8) + 2 * n * 12) + 8 * 2 * n * q,
        n * e * s * (ADJ_KDE_OPS * g + ADJ_CHEB_OPS * cosmo.cheb_deg))
    phase(14, "K3 vs plain", f"[{smi}] at 1000 x 4096 x 500, L = {n}: kernel "
          f"{k_call:.3f} ms, plain {p_call:.3f} ms per call "
          f"({p_call / k_call:.1f}x), bound {bound_ms:.3f} ms ({bound_by}); on "
          f"the cotangents of log L, max err {rel:.3e} of each gradient row's "
          f"max (tol 1e-3), {abs_err:.3e} abs; in float64 {rel64:.3e} (tol "
          f"1e-9)")
    return {"name": "fused_weights_kde_adjoint", "route": "cuda",
            "source": "chimera_tpu_torch/csrc/fused_kde_adjoint.cu",
            "replaces": "chimera_tpu/ops/pallas/fused.py:713",
            "launches": counts["hmc"][1], "max_abs_err": abs_err, "ms": k_call,
            "plain_ms": p_call, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def main() -> None:
    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    phase(1, "device", f"{torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}")

    from chimera_tpu_torch.ops.cuda import build

    # ---- 2. kernel builds, one nvcc per source, in parallel --------------
    t0 = time.perf_counter()
    names = ["fused_kde", "rows_contract", "fused_kde_adjoint"]
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(build.load, names))
    for name in names:
        info = build.build_info.get(name, {})
        ptxas = [ln.split("ptxas info    :")[-1].strip()
                 for ln in info.get("log", "").splitlines()
                 if "entry function" in ln or "registers" in ln]
        phase(2, f"kernel build {name}", f"nvcc {info.get('seconds', 0.0):.2f} s; "
              + " | ".join(ptxas) + f" [{smi}]")
    phase(2, "kernel builds", f"{time.perf_counter() - t0:.2f} s in all [{smi}]")

    k1a, full = spectral(smi)
    kernels = [k1a, *dark(smi), sampler(smi, full)]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
