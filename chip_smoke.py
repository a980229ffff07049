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
  adjoint kernel K3);
* phases 15-18, the reference's default configuration (binning=True,
  num_bins=200, cut_grid=2.0: the batched KDE K4) at both widths, the
  unbinned effective-grid paths (K1b; the event stats pass K1c and the
  per-pixel KDE on the event's bounds K1d) and kind 'approximate';
* phases 19-22, the dark-siren and effective-grid gradients: the adjoint
  kernel K3 in the modes of K1b (K3b), K1c (K3c) and K1d (K3d) and the
  rows-contraction adjoint K2b against their plain versions, the card's
  gradient of the three unbinned paths against the CPU's and against
  finite differences, value-and-gradient timing at full width, and HMC /
  ChEES on the dark flagship;
* phase 23, the contract path ('marginalized', cut_grid=None, on a
  per-pixel layout without chunk rows) at the flagship width: the contract
  pass K1e against its plain version and the rows path, one K1e launch a
  batch, float32 vs float64, timing next to the rows path;
* phases 24-25, the gradient of the reference's defaults (binned,
  cut_grid=2.0) for '1d' and 'marginalized': K4's adjoint K4b against its
  plain version, the card's gradient against the CPU's, one K4 and one K4b
  a gradient call, value-and-gradient timing and peak memory at full
  width; HMC / ChEES on the binned spectral headline;
* phases 26-27, kind 'full' (cut_grid=2.0) on the dark flagship's data:
  the 3-D lattice KDE K5 against its plain version at 128 events, one K5
  launch a batch at full width, float32 vs float64, timing split into K5
  and the glue and into the stages of the batch, K5's bound on the
  refreshes its flush keeps (beside the bound on every weighted sample's),
  a gradient call that must raise;
* phase 28, the ensemble sampler (32 walkers in H0, Om0, two half-steps of
  16 a step) on the spectral headline (K1a) and on 'full' (K5);
* phase 29, every kernel in every mode with each mass model beside
  PowerLawPeak (TruncatedPowerLaw, BrokenPowerLaw, PowerLawTwoPeaks,
  PowerLawSpline: each a library of its own, CHIMERA_MASS_KIND) at 64
  events against its plain version, float32 gradients against float64,
  PowerLawSpline's gradient refused;
* phases 30-32, the other population models and engines at full width:
  MGFLRW + BrokenPowerLaw + PowerLawRate on the spectral headline (K1a,
  K3), PowerLawTwoPeaks + TruncatedMadauDickinsonRate on the dark flagship
  (K1c + K2, K3c + K2b), both 'table' engines unbinned on the spectral
  headline (K4 on the raw rows, K4b, each against its plain version and
  timed; HMC twice for equal bits) and on the dark flagship's per-pixel
  rows, each timed forward and value-and-gradient, float32 log L and
  d log L / dλ against float64;
* phase 33, distribution over ranks (``chimera_tpu_torch/parallel``): a
  1 x 1 mesh under NCCL in this process gives log_like_batch's bits on the
  spectral headline; 2 and 4 gloo ranks sharing the card (one process
  each, the data saved once by this process) shard the spectral headline
  (K1a), the dark flagship (K1c + K2) and the binned defaults (K4) on
  1 x 2 and 2 x 1 meshes, those and kind 'full' (K5) on 2 x 2: float32
  against this process's float32 batch (the same bits on 2 x 1, where the
  λ batch alone is split, else 1e-6) and float64 batch (the float32 bar),
  float64 at 63 events and all injections but the last, which pads a
  shard of a data = 2 mesh (the same bits on 2 x 1, else 1e-12), every
  rank the same bits, a repeat the same bits,
  each kernel of the path once a batch on every rank, ms per λ beside the
  single process's (ranks sharing one card: not a scaling figure); then
  ``dryrun_multichip(4)`` on the card.

Each likelihood path checks float32 against float64, elementwise against the
repo's 1e-6 bar or, binned, against BINNED_F32_BAR (the precision mocks:
64 x 1024 x 300 spectral, the dark tests/data/f32_parity_dark.npz), and is
timed; each batch of a path launches exactly its kernels, once each.

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
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

SEED = 20261016
PARITY_DARK = Path(__file__).resolve().parent / "tests" / "data" / "f32_parity_dark.npz"
GRAD_SPECTRAL = Path(__file__).resolve().parent / "tests" / "data" / "f32_grad_spectral.npz"
DEV = torch.device("cuda", 0)
F32, F64 = torch.float32, torch.float64
# published peaks of one H100 SXM at 700 W (NVIDIA's H100 data sheet): HBM
# bytes/s, FP32 and FP64 FLOP/s outside the tensor cores (an FMA counts 2)
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_FP64 = 34e12
# the MUFU pipe (exp2, rcp, ...): 16 results per clock per SM at compute
# capability 9.0 (the CUDA C++ Programming Guide's table of arithmetic
# instruction throughput) x 132 SMs x the 1.98 GHz boost clock of the H100
# SXM (NVIDIA's H100 data sheet)
PEAK_MUFU = 16 * 132 * 1.98e9
# FP32 operations of one KDE term: (g - z), * 1/h, u*u, 1 - u^2, max, fma;
# of one Clenshaw coefficient: fma and subtract
KDE_OPS, CHEB_OPS = 7, 3
# of one term of the KDE adjoint: (g - z), * 1/h, u*u, 1 - u^2, compare and
# select, then fma, mul, add, fma into the three sums; of one coefficient
# of the adjoint's Clenshaw work: the sums, one recurrence of the value with
# its derivative (3 + 4, which gives both z and dz/dt), in the series'
# summation type; and the T_k projection (fma, sub, fma), in the working
# dtype
ADJ_KDE_OPS, ADJ_CHEB_SUM_OPS, ADJ_CHEB_PROJ_OPS = 11, 3 + 4, 4
# the mass model per real sample: p_m1m2's forward (~90: the clip, the
# window's t or the closed form above m_join, primary's power law, peak and
# smoothing window, secondary's, the divisions), in the adjoints with its
# reverse sweep's backward (~110), a transcendental counted as one
# operation; the sweep's recompute of the forward is not counted
MASS_FWD_OPS = 90
MASS_OPS = MASS_FWD_OPS + 110
# on a linear grid one more sum (the bound's: mul, fma)
ADJ_LIN_KDE_OPS = 13
# K2b's least work: one sweep over the (grid point, weighted sample) terms of
# a live row forms u, K and K' once for the density's fma and the three
# adjoint sums; per (live row, grid point) the factor products: t1, t2, a_g
# (mul, fma), the scale's sum (fma), d_f1 and d_f2 (mul, fma each), c_g, den
K2B_TERM_OPS, K2B_GRID_OPS = ADJ_KDE_OPS + 2, 15
# K2's per (live row, grid point) products: den s1, then f1 into r1's sum
# (mul, fma), the same for r2
K2_GRID_OPS = 4
# The float32 bar of the reference-default configuration (binning=True,
# cut_grid=2.0): max(1e-6, 2 x the JAX package's own float32-vs-float64 gap
# on the repo's precision mocks, as measured by
# `PYTHONPATH=. python tests/test_torch_f32_parity.py --reference-gap`).
# Binning moves a sample to the neighbouring bin where its float32 z lies
# within rounding of a bin edge.
# Kind 'full' (cut_grid=2.0, binning ignored) on the dark mock: 6.6e-7,
# held to the repo's 1e-6 where 2 x its gap is wider.
REFERENCE_F32_GAP = {"1d": 1.2995178314968518e-07,
                     "marginalized": 3.932049027578433e-05,
                     "full": 6.617836419533271e-07}
BINNED_F32_BAR = {k: max(1e-6, 2.0 * REFERENCE_F32_GAP[k])
                  for k in ("1d", "marginalized")}
FULL_F32_BAR = min(1e-6, 2.0 * REFERENCE_F32_GAP["full"])
# The float32 gradient bar of the spectral configurations on
# tests/data/f32_grad_spectral.npz (``grad_cases``: phase 29's spectral
# paths of each mass model with a card gradient, phases 30 and 32's
# models): d log L / dλ held to max(1e-2, 2 x the JAX package's own
# float32-vs-float64 gap of its jax.grad on the same data and points, as
# measured by
# `PYTHONPATH=. python tests/test_torch_f32_parity.py --reference-grad-gap`).
# An event's log numerator is piecewise smooth in λ (the Epanechnikov
# kernel's support edges, the resampling's nodes): where a kink lies within
# float32 rounding of a point, float32 and float64 take different one-sided
# slopes.
REFERENCE_F32_GRAD_GAP = {
    "TruncatedPowerLaw spectral": 0.005744014319988896,
    "TruncatedPowerLaw spectral_cut": 0.0015705056511772398,
    "BrokenPowerLaw spectral": 0.0036521558130975396,
    "BrokenPowerLaw spectral_cut": 0.001082054846655325,
    "PowerLawTwoPeaks spectral": 0.001341921672713701,
    "PowerLawTwoPeaks spectral_cut": 0.00033370365994347663,
    "MGFLRW + BrokenPowerLaw": 0.006859269493858738,
    # the JAX package's float32 jax.grad is NaN at points 2 and 3 (and at
    # H0 = 68, 70, 72 with Om0 = 0.25 alone): the port's own float32 path
    # with K4 and K4b replaced by their plain versions sets the bar
    # (``grad_case_f32``)
    "table engines": float("nan")}
# the spectral float32 precision mock (``mock``'s arguments): the shape of
# tests/test_f32_parity.py::test_f32_loglike_parity, 64 events x 1024
# samples x 300-point grids, 200 000 generated injections
PRECISION_MOCK = (64, 1024, 200_000, 300, 300, SEED + 5)


def bound(n_bytes: float, n_ops: float, n_ops64: float = 0.0,
          n_mufu: float = 0.0) -> tuple[float, str]:
    """The least time (ms) for moving n_bytes and doing n_ops FP32 and
    n_ops64 FP64 operations and n_mufu MUFU results (exps) on the card, and
    which of the two bounds it.  An FP64 operation takes a dispatch slot as
    an FP32 one does (FP32 at its peak fills every slot) and the FP64 pipes
    run at half the FP32 rate; the MUFU pipe runs beside them: the
    operations take max((n_ops + n_ops64) / PEAK_FP32, n_ops64 / PEAK_FP64,
    n_mufu / PEAK_MUFU)."""
    t_b = n_bytes / PEAK_BYTES
    t_o = max((n_ops + n_ops64) / PEAK_FP32, n_ops64 / PEAK_FP64,
              n_mufu / PEAK_MUFU)
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


def population(dtype, gal_cat=None, device=None, cfg=None):
    """FLRW (H0 = 70, Om0 = 0.25), PowerLawPeak and Madau-Dickinson, or the
    models ``cfg`` names: {"cosmo" | "mass" | "rate": (class name, create's
    keywords)}."""
    from chimera_tpu_torch import models
    from chimera_tpu_torch.models import Population

    device = DEV if device is None else device
    cfg = {"cosmo": ("FLRW", {}), "mass": ("PowerLawPeak", {}),
           "rate": ("MadauDickinsonRate", {}), **(cfg or {})}
    made = {part: getattr(models, name).create(
        **({"H0": 70.0, "Om0": 0.25} if part == "cosmo" else {}), **kw,
        device=device, dtype=dtype) for part, (name, kw) in cfg.items()}
    return Population.create(made["cosmo"], made["mass"], made["rate"],
                             gal_cat=gal_cat)


def mock(n_events, n_samples, n_inj, z_res, oversample, seed, device=None,
         cfg=None):
    """Port-generated float64 mock catalog, injections and z-grids, drawn on
    the card (or ``device``) at H0 = 70 from ``population(cfg=cfg)``."""
    from chimera_tpu_torch.data.mock import make_mock_catalog, make_mock_injections
    from chimera_tpu_torch.models import compute_z_grids

    device = DEV if device is None else device
    pop = population(F64, device=device, cfg=cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    cat = make_mock_catalog(gen, pop, n_events=n_events, n_samples=n_samples,
                            snr_threshold=12.0, oversample=oversample)
    inj, n_gen = make_mock_injections(gen, pop, n_generated=n_inj,
                                      snr_threshold=12.0)
    z_grids = compute_z_grids(pop.cosmo, cat, cosmo_prior={"H0": [40.0, 120.0]},
                              z_int_res=z_res)
    return cat, inj, n_gen, z_grids


def likelihood(data, dtype, kernel="epan", cfg=None, **config):
    """The spectral likelihood of a mock (``population(cfg=cfg)``'s models);
    unbinned on the analysis grids unless ``config`` says otherwise."""
    from chimera_tpu_torch import HyperLikelihood, SelectionFunction

    cat, inj, n_gen, z_grids = data
    config = {"binning": False, "cut_grid": None, **config}
    return HyperLikelihood.create(cat, z_grids,
                                  population(dtype, device=z_grids.device,
                                             cfg=cfg),
                                  SelectionFunction.create(inj, n_gen),
                                  kernel=kernel, **config)


def kernel_inputs(hl, h0s):
    pop_b = hl.population.update_batch({"H0": h0s})
    return (hl.m1det, hl.m2det, hl.dL, hl.inv_pe_prior, pop_b.cosmo,
            pop_b.mass, hl.z_grids)


def compare(args, den_tol, stat_tol, min_live=0.9, **kw):
    """K1 (``fused_weights_kde``: ``args`` and keywords ``kw``, any mode)
    against its plain version on the same inputs, on the rows with weight:
    densities relative to each row's largest value, stats relative (lo and
    ub to the largest ub).  Returns (den rel, den abs, stats rel)."""
    from chimera_tpu_torch.ops.cuda.fused import (fused_weights_kde,
                                                  fused_weights_kde_plain)

    den_k, st_k = fused_weights_kde(*args, **kw)
    den_p, st_p = fused_weights_kde_plain(*args, **kw)
    torch.cuda.synchronize(DEV)
    # errors in float64: a float32 floor of 1e-300 would be 0
    den_k, den_p = den_k.double(), den_p.double()
    st_k = {k: v.double() for k, v in st_k.items()}
    st_p = {k: v.double() for k, v in st_p.items()}
    live = st_p["sum_w"] > 0
    if live.float().mean() < min_live:
        raise AssertionError(f"only {int(live.sum())} live (λ, row) pairs")
    row_max = den_p.abs().amax(dim=-1, keepdim=True).clamp_min(1e-300)
    den_rel = ((den_k - den_p).abs() / row_max)[live].max().item()
    den_abs = (den_k - den_p).abs()[live].max().item()
    ub_max = st_p["ub"].abs().max().clamp_min(1e-300)
    stat_rel = max(((st_k[k] - st_p[k]).abs() / (
        ub_max if k in ("lo", "ub") else st_p[k].abs()))[live].max().item()
        for k in ("lo", "ub", "norms", "neff", "bandwidth", "sum_w", "sum_w2"))
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
        pairs = k1a_pairs(args)
        phase(3, f"kernel vs plain {dtype}",
              f"den max err {den_rel:.3e} of row max ({den_abs:.3e} abs), "
              f"stats max rel err {stat_rel:.3e}; kernel {k_ms:.3f} ms, "
              f"plain {p_ms:.3f} ms per call; live pairs "
              f"{pairs['live'] / pairs['all']:.4%} of all, the pruned loop "
              f"evaluates {pairs['tiled'] / pairs['all']:.4%} [{smi}]")
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
    par = mock(*PRECISION_MOCK)
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
    pairs = k1a_pairs(args)
    bound_ms, bound_by = k1a_bound(args, pairs)
    all_ms, all_by = k1a_bound(args)
    phase(6, "kernel vs plain", f"[{smi}] at 1000 x 4096 x 500, L = 16: kernel "
          f"{k_call:.3f} ms, plain {p_call:.3f} ms per call "
          f"({p_call / k_call:.1f}x), bound {bound_ms:.4f} ms ({bound_by}, "
          f"{100 * bound_ms / k_call:.1f} % of it; on every pair {all_ms:.3f} "
          f"ms, {all_by}); live pairs {pairs['live']} of {pairs['all']} "
          f"({pairs['live'] / pairs['all']:.4%}), the pruned loop evaluates "
          f"{pairs['tiled'] / pairs['all']:.4%}; den max err {den_rel:.3e} of "
          f"row max, stats {stat_rel:.3e}")
    return {"name": "fused_weights_kde (K1a)", "route": "cuda",
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


def f32_vs_f64(hl64, hl32, h0s, bar: float = 1e-6) -> tuple[float, float, int]:
    """Float32 against float64 log L over an H0 batch, elementwise relative,
    held to ``bar``: the repo's 1e-6 (BASELINE.md, tests/test_f32_parity.py)
    unless given.  Returns the largest relative and absolute differences
    and the number of finite values."""
    ll64 = hl64.log_like_batch({"H0": h0s})
    ll32 = hl32.log_like_batch({"H0": h0s.to(F32)}).double()
    fin = torch.isfinite(ll64)
    if not fin.any() or not torch.equal(fin, torch.isfinite(ll32)):
        raise AssertionError(f"non-finite log L: f64 {ll64.tolist()}, "
                             f"f32 {ll32.tolist()}")
    diff = (ll32 - ll64).abs()[fin]
    rel = (diff / ll64[fin].abs()).max().item()
    if rel > bar:
        raise AssertionError(f"float32 vs float64: {rel:.3e} > {bar:.3e} "
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


def dark_likelihood(data, dtype, cfg=None, **config):
    """The dark-siren likelihood of a mock (``population(cfg=cfg)``'s
    models); 'marginalized', unbinned on the analysis grids unless
    ``config`` says otherwise."""
    from chimera_tpu_torch import HyperLikelihood, SelectionFunction

    cat, z_grids, gal_cat, inj, n_gen = data
    config = {"kind": "marginalized", "binning": False, "cut_grid": None,
              **config}
    return HyperLikelihood.create(cat, z_grids,
                                  population(dtype, gal_cat, z_grids.device,
                                             cfg),
                                  SelectionFunction.create(inj, n_gen), **config)


def dark_kernel_inputs(hl, h0s):
    """The two kernels' inputs on the main path for an H0 batch (or a batch
    {name: values}): the stats pass's arguments, and the rows pass's with
    (1/h, scale) from the plain stats (both kernels are compared on the
    same inputs)."""
    from chimera_tpu_torch.ops.cuda.fused import fused_row_stats_plain

    pop_b = hl.population.update_batch(h0s if isinstance(h0s, dict)
                                       else {"H0": h0s})
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


def dark(smi: str) -> tuple[list[dict], tuple]:
    """Phases 7-10: K1c and K2 against their plain versions, the dark-siren
    batch end to end at the flagship width, float32 vs float64, timing.
    Returns the two kernels' entries of the kernels line and the flagship
    data."""
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

    pairs = k2_pairs(rows_args)
    bounds = {"K1c": (k1c_bound(stats_args), k1c_bound(stats_args, False)[0]),
              "K2": (k2_bound(rows_args, pairs), k2_bound(rows_args)[0])}
    entries = []
    for name, src, line, kern, plain, err in (
            ("fused_row_stats", "fused_kde.cu", 71, k1, p1, stat_abs),
            ("fused_rows_contract", "rows_contract.cu", 495, k2, p2, r_abs)):
        kid = "K1c" if name == "fused_row_stats" else "K2"
        (b_ms, b_by), old_ms = bounds[kid]
        k_call, p_call = statistics.median(kern), statistics.median(plain)
        phase(10, f"{name} vs plain", f"[{smi}] at the flagship, L = {n}: "
              f"kernel {k_call:.3f} ms, plain {p_call:.3f} ms per call "
              f"({p_call / k_call:.1f}x), bound {b_ms:.4f} ms ({b_by}, "
              f"{100 * b_ms / k_call:.1f} % of it; the all-slots count "
              f"{old_ms:.4f} ms); max abs err {err:.3e}")
        entries.append({
            "name": f"{name} ({kid})", "route": "cuda",
            "source": f"chimera_tpu_torch/csrc/{src}",
            "replaces": f"chimera_tpu/ops/pallas/fused.py:{line}",
            "launches": launches[name], "max_abs_err": err, "ms": k_call,
            "plain_ms": p_call, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "redesigned": 9})
    phase(10, "errors", f"stats max rel {stat_rel:.3e}, r max {r_rel:.3e} of "
          f"the per-λ max [{smi}]")
    phase(10, "K2 work", f"{pairs['mapped']} of {n * r_rows} (λ, row) pairs "
          f"have a scale and are mapped in phase A, {pairs['mapped_dead']} "
          f"({pairs['mapped_dead'] / pairs['mapped']:.2%}) of them without "
          f"weight (written as zeros); {pairs['live_rows']} live, "
          f"{pairs['samples']} weighted samples; density terms "
          f"{pairs['density']} of {pairs['all']} ({pairs['density'] / pairs['all']:.4%}), "
          f"the pruned loop evaluates {pairs['tiled']} "
          f"({pairs['tiled'] / pairs['all']:.4%}) [{smi}]")
    return entries, data


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


def batch_of(x: torch.Tensor) -> dict:
    """The batch {name: (n,)} of the points ``x`` (n, 3)."""
    return {p: x[:, i] for i, p in enumerate(PARAMS)}


def log_like(hl, x: torch.Tensor) -> torch.Tensor:
    """log L (n,) at the points ``x`` (n, 3)."""
    return hl.log_like_batch(batch_of(x))


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

    pop_b = hl.population.update_batch(batch_of(x))
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
        pop_b = hl.population.update_batch(batch_of(x))
        den, stats = fused_weights_kde(hl.m1det, hl.m2det, hl.dL,
                                       hl.inv_pe_prior, pop_b.cosmo, pop_b.mass,
                                       hl.z_grids, kernel=hl.kernel)
    den = den.requires_grad_()
    num = hl.numerators_from_densities(pop_b, den, stats)
    total = torch.nan_to_num(torch.log(num), nan=-torch.inf).sum()
    ct_den = torch.autograd.grad(total, den)[0]
    return ct_den.contiguous(), torch.zeros(
        (*ct_den.shape[:2], 8), dtype=ct_den.dtype, device=ct_den.device)


def cut_events(data, n: int):
    """The first ``n`` events of a spectral mock."""
    import dataclasses

    cat, inj, n_gen, z_grids = data
    per_event = {f.name: getattr(cat, f.name)[:n] for f in dataclasses.fields(cat)
                 if isinstance(getattr(cat, f.name), torch.Tensor)}
    return cat.update(**per_event), inj, n_gen, z_grids[:n]


def cut_dark_events(data, n: int):
    """The first ``n`` events of a dark-siren mock: its PE data, z-grids and
    the catalog's event fields."""
    import dataclasses

    cat, z_grids, gal_cat, inj, n_gen = data
    per_event = {f.name: getattr(cat, f.name)[:n] for f in dataclasses.fields(cat)
                 if isinstance(getattr(cat, f.name), torch.Tensor)}
    return (cat.update(**per_event), z_grids[:n],
            gal_cat.take_events(torch.arange(n, device=z_grids.device)), inj, n_gen)


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
            rel, abs_err = grad_compare(
                "K3", fused_weights_kde_adjoint, fused_weights_kde_adjoint_plain,
                (*args, kernel), {}, tol)
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
        pop_b = hl64.population.update_batch(batch_of(x))
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
    batch = batch_of(x)
    total = cuda_ms(lambda: value_and_grad(hl, x), reps)
    forward = cuda_ms(lambda: hl.log_like_batch(batch), reps)
    one = cuda_ms(lambda: value_and_grad(hl, x[:1]), reps)
    # K3 on what the sampler's backward hands it at these points
    args = list(adjoint_inputs(hl, x, SEED + 14))
    args[7], args[8] = main_path_cotangents(hl, x)
    kern = cuda_ms(lambda: fused_weights_kde_adjoint(*args, "epan"), reps)
    plain = cuda_ms(lambda: fused_weights_kde_adjoint_plain(*args, "epan"), 1, 0)
    k3 = (fused_weights_kde_adjoint, fused_weights_kde_adjoint_plain)
    rel, abs_err = grad_compare("K3", *k3, (*args, "epan"), {}, 1e-3)
    x64 = chain_points(n, F64)
    args64 = list(adjoint_inputs(hl64, x64, SEED + 14))
    args64[7], args64[8] = main_path_cotangents(hl64, x64)
    rel64, _ = grad_compare("K3", *k3, (*args64, "epan"), {}, 1e-9)
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
    bound_ms, bound_by = k3_bound((*args, "epan"), {})
    phase(14, "K3 vs plain", f"[{smi}] at 1000 x 4096 x 500, L = {n}: kernel "
          f"{k_call:.3f} ms, plain {p_call:.3f} ms per call "
          f"({p_call / k_call:.1f}x), bound {bound_ms:.3f} ms ({bound_by}); on "
          f"the cotangents of log L, max err {rel:.3e} of each gradient row's "
          f"max (tol 1e-3), {abs_err:.3e} abs; in float64 {rel64:.3e} (tol "
          f"1e-9)")
    return {"name": "fused_weights_kde_adjoint (K3)", "route": "cuda",
            "source": "chimera_tpu_torch/csrc/fused_kde_adjoint.cu",
            "replaces": "chimera_tpu/ops/pallas/fused.py:713",
            "launches": counts["hmc"][1], "max_abs_err": abs_err, "ms": k_call,
            "plain_ms": p_call, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "redesigned": 7}


# ---------------------------------------------------------------------------
# the reference-default configuration and the effective-grid paths
# ---------------------------------------------------------------------------

def counted(fn, expect: dict):
    """Run ``fn`` with every launch count set to 0 just before; the counts
    just after must be ``expect`` ({kernel id: launches}, 0 for the rest).
    Returns fn's result and the counts."""
    from chimera_tpu_torch.ops.cuda import launch_counters, launch_counts

    for wrapper, attr in launch_counters().values():
        setattr(wrapper, attr, 0)
    out = fn()
    torch.cuda.synchronize(DEV)
    got = launch_counts()
    if got != {k: expect.get(k, 0) for k in got}:
        raise AssertionError(f"launches {got}, expected {expect}")
    return out, got


class _Spy:
    """A kernel wrapper that records its calls; its attributes (the launch
    counters, which the wrapper bumps through its own module-level name)
    are the wrapper's."""

    def __init__(self, real):
        object.__setattr__(self, "real", real)
        object.__setattr__(self, "calls", [])

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        return self.real(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.real, name)

    def __setattr__(self, name, value):
        setattr(self.real, name, value)


def calls_of(module, name: str, fn) -> list:
    """Run ``fn`` with ``module.name`` (a kernel wrapper) recording its
    calls; returns the (args, kwargs) of every call."""
    real = getattr(module, name)
    spy = _Spy(real)
    setattr(module, name, spy)
    try:
        fn()
    finally:
        setattr(module, name, real)
    return spy.calls


def captured(name: str, fn):
    """Run ``fn`` with the likelihood module's ``name`` (a kernel wrapper)
    recording its calls; returns the (args, kwargs) of the last call: the
    inputs the main path hands the kernel."""
    from chimera_tpu_torch import likelihood as module

    return calls_of(module, name, fn)[-1]


def kde_compare(args, kw, tol):
    """K4 against its plain version on the same inputs: the largest error
    relative to each row's largest density, over the rows with density;
    returns (rel, abs)."""
    from chimera_tpu_torch.ops.cuda.kde import kde1d_grid, kde1d_grid_plain

    got, expect = kde1d_grid(*args, **kw), kde1d_grid_plain(*args, **kw)
    torch.cuda.synchronize(DEV)
    got, expect = got.double(), expect.double()
    row_max = expect.abs().amax(dim=-1, keepdim=True)
    rows = row_max[:, 0] > 0
    if rows.float().mean() < 0.5:
        raise AssertionError(f"only {int(rows.sum())} rows with density")
    err = (got - expect).abs()
    rel = (err / row_max.clamp_min(1e-300))[rows].max().item()
    if not rel <= tol:
        raise AssertionError(f"K4 vs plain: {rel:.3e} of the row max (tol {tol:.0e})")
    if not torch.all(err[~rows] == 0):
        raise AssertionError("K4 gave density where the plain version has none")
    return rel, err.max().item()


def accumulation_ms(dataset, weights, num_bins=200, reps=17):
    """Per-call ms of the bin sums of ``binning1d`` on its inputs: the
    sorted ``index_put_`` it makes, whose order is fixed, and an atomic
    ``scatter_add_`` of the same index, whose order is not (medians)."""
    lo = torch.amin(dataset, dim=-1, keepdim=True)
    span = torch.amax(dataset, dim=-1, keepdim=True) - lo
    pos = torch.nan_to_num(torch.floor((dataset - lo) / span * num_bins))
    rows = dataset.numel() // dataset.shape[-1]
    idx = (pos.clamp(0, num_bins - 1).long().reshape(rows, -1)
           + torch.arange(rows, device=dataset.device)[:, None] * num_bins
           ).reshape(-1)
    w = weights.reshape(-1)
    out = torch.zeros(rows * num_bins, dtype=w.dtype, device=w.device)
    return (statistics.median(cuda_ms(
                lambda: out.zero_().index_put_((idx,), w, accumulate=True), reps)),
            statistics.median(cuda_ms(
                lambda: out.zero_().scatter_add_(0, idx, w), reps)))


def k4_pairs(args, widths=None) -> dict:
    """K4's pair terms on its inputs ``args`` (z, w, grids, h: the binned
    path's bin centres and weights): 'all' (row, grid point, bin); 'live',
    those with |g - z| < h and w != 0, the terms of the Epanechnikov density
    that are not exactly 0; per bin-tile width t (``widths``, the
    kernel's _K4_TILE by default): 'tiled{t}', those the pruned loop
    evaluates in t-bin tiles x _TILE_G-point runs (_tiled_terms: an empty
    bin bounds nothing, a row without weight runs no tile)."""
    from chimera_tpu_torch.ops.cuda.fused import _K4_TILE

    z, w, grids, h = (a.double() for a in args[:4])
    (b, s), g = z.shape, grids.shape[1]
    rows = 16384  # a chunk's rows
    out = {"all": b * g * s, "live": 0}
    with torch.no_grad():
        for r0 in range(0, b, rows):
            zz, ww, gg, hh = (t[r0:r0 + rows] for t in (z, w, grids, h))
            out["live"] += _in_support(zz, ww != 0, hh, gg, False)
            for t in widths or (_K4_TILE,):
                out[f"tiled{t}"] = out.get(f"tiled{t}", 0) + _tiled_terms(
                    zz, ww, hh, gg, t)
    return out


def k4_bound(args, pairs: dict | None = None) -> tuple[float, str]:
    """The least time of K4 on these inputs: z, w, the grids and h read
    once, the densities written once, bytes; operations, the density terms
    that are not exactly 0 (``pairs['live']`` of k4_pairs) and each
    density's scale, or every (row, grid point, bin) term where ``pairs``
    is None (the all-pairs count)."""
    z, _, grids, _ = args
    b, s = z.shape
    g = grids.shape[1]
    n_bytes = z.element_size() * (2 * b * s + 2 * b * g + b)
    if pairs is None:
        return bound(n_bytes, b * g * s * KDE_OPS)
    return bound(n_bytes, KDE_OPS * pairs["live"] + b * g)


def reference_defaults(smi: str, full, dark_data) -> list[dict]:
    """Phases 15-18: K4, K1b and K1d against their plain versions; the
    reference-default configuration (binning=True, num_bins=200,
    cut_grid=2.0) end to end at the spectral headline and the dark flagship
    width; the unbinned effective-grid paths and kind 'approximate' there.
    Returns the three kernels' entries of the kernels line."""
    from chimera_tpu_torch.data.structs import ThetaPEDet
    from chimera_tpu_torch.models import theta_src_and_weights
    from chimera_tpu_torch.ops.binning import binning1d
    from chimera_tpu_torch.ops.cuda.fused import (_K4_TILE, fused_row_stats,
                                                  fused_weights_kde,
                                                  fused_weights_kde_plain)
    from chimera_tpu_torch.ops.cuda.kde import kde1d_grid, kde1d_grid_plain

    binned = {"binning": True, "num_bins": 200, "cut_grid": 2.0}
    h0s = torch.linspace(55.0, 95.0, 16, device=DEV)
    h0s4 = torch.linspace(60.0, 80.0, 4, device=DEV)
    batch = {"H0": h0s.to(F32)}
    n, reps = len(h0s), 17

    # ---- 15. kernels vs plain --------------------------------------------
    for dtype, tol in ((F64, 1e-10), (F32, 1e-4)):
        hl = dark_likelihood(dark_data, dtype, **binned)
        args, kw = captured("kde1d_grid",
                            lambda: hl.log_like_batch({"H0": h0s.to(dtype)}))
        rel, _ = kde_compare(args, kw, tol)
        b, s = args[0].shape
        phase(15, f"K4 vs plain {dtype}", f"{b} rows x {s} bins x "
              f"{args[2].shape[1]} grid (the binned dark flagship, L = {n}): "
              f"max err {rel:.3e} of the row max (tol {tol:.0e}) [{smi}]")
        del hl, args
    small = mock(64, 4096, 200_000, 500, 300, SEED + 3)
    for dtype, tol in ((F64, 1e-10), (F32, 1e-4)):
        hl = likelihood(small, dtype, cut_grid=2.0)
        args, kw = captured("fused_weights_kde",
                            lambda: hl.log_like_batch({"H0": h0s4.to(dtype)}))
        den_rel, _, stat_rel = compare(args, tol, tol, **kw)
        phase(15, f"K1b vs plain {dtype}", f"{args[2].shape[0]} x "
              f"{args[2].shape[1]} x {kw['n_grid']}, L = 4: "
              f"den max err {den_rel:.3e} of the row max, stats {stat_rel:.3e} "
              f"(tol {tol:.0e}) [{smi}]")
    del small
    small, _ = dark_mock(64, 1024, 15, 500, 100_000, 10_000, SEED + 7)
    for dtype, tol in ((F64, 1e-10), (F32, 1e-4)):
        hl = dark_likelihood(small, dtype, cut_grid=2.0)
        args, kw = captured("fused_weights_kde",
                            lambda: hl.log_like_batch({"H0": h0s4.to(dtype)}))
        den_rel, _, stat_rel = compare(args, tol, tol, min_live=0.3, **kw)
        phase(15, f"K1d vs plain {dtype}", f"{hl.n_events} events, {args[2].shape[0]} "
              f"pixel rows x {args[2].shape[1]} slots x {kw['n_grid']}, L = 4: "
              f"den max err {den_rel:.3e} of the row max, stats {stat_rel:.3e} "
              f"(tol {tol:.0e}) [{smi}]")
    del small

    # ---- 16. and 17. the reference's defaults end to end -----------------
    entries = {}
    for num, name, data, make, kind, prec in (
            (16, "spectral", full, likelihood, "1d", mock(*PRECISION_MOCK)),
            (17, "dark", dark_data, dark_likelihood, "marginalized",
             parity_dark_mock(DEV))):
        hl = make(data, F32, **binned)
        torch.cuda.reset_peak_memory_stats(DEV)
        ll, _ = counted(lambda: hl.log_like_batch(batch), {"K4": 1})
        peak = torch.cuda.max_memory_allocated(DEV) / 2**30
        check_log_like(ll, h0s, {"kde1d_grid": 1})
        rel, diff, n_fin = f32_vs_f64(make(prec, F64, **binned),
                                      make(prec, F32, **binned),
                                      torch.linspace(58.0, 100.0, 7, device=DEV),
                                      BINNED_F32_BAR[kind])
        total = cuda_ms(lambda: hl.log_like_batch(batch), reps)
        # the stages before K4: the table rebuild, z and weights of every
        # sample, the binning (of the masked-dense layout for the dark kind)
        pop_b = hl.population.update_batch(batch)
        theta = ThetaPEDet(m1det=hl.m1det, m2det=hl.m2det, dL=hl.dL,
                           pe_prior=hl.pe_prior)
        stages = {"table rebuild": cuda_ms(
            lambda: hl.population.update_batch(batch), reps),
            "z and weights": cuda_ms(
                lambda: theta_src_and_weights(pop_b, theta), reps)}
        b_args, b_kw = captured("binning1d", lambda: hl.log_like_batch(batch))
        stages["binning"] = cuda_ms(lambda: binning1d(*b_args, **b_kw), reps)
        acc = accumulation_ms(*b_args, **b_kw, reps=reps)
        del b_args, pop_b
        args, kw = captured("kde1d_grid", lambda: hl.log_like_batch(batch))
        stages["K4"] = kern = cuda_ms(lambda: kde1d_grid(*args, **kw), reps)
        plain = cuda_ms(lambda: kde1d_grid_plain(*args, **kw), 1)
        k_rel, k_abs = kde_compare(args, kw, 1e-4)
        t_med, t_mad = med_mad([t / n for t in total])
        split = {k: med_mad([t / n for t in v]) for k, v in stages.items()}
        rest = t_med - sum(m for m, _ in split.values())
        pairs = k4_pairs(args)
        b_ms, b_by = k4_bound(args, pairs)
        tiled = pairs[f"tiled{_K4_TILE}"]
        phase(num, f"reference defaults, {name}", f"{kind}, binning=True, "
              f"num_bins=200, cut_grid=2.0; {hl.n_events} events x "
              f"{hl.n_samples} samples x {hl.z_grids.shape[1]} grid; launches "
              f"K4 1, K1/K2 0; peak memory {peak:.2f} GiB; H0 argmax "
              f"{h0s[int(torch.argmax(ll))].item():.2f}; log L = "
              f"{[round(v, 4) for v in ll.tolist()]} [{smi}]")
        phase(num, "precision", f"float32 vs float64 log L on the precision "
              f"mock: max rel err {rel:.3e} (bar {BINNED_F32_BAR[kind]:.3e}), "
              f"max abs {diff:.3e}, over {n_fin} of 7 H0 values [{smi}]")
        phase(num, "timing", f"[{smi}] per λ over {reps} batches of {n}: total "
              f"{t_med:.4f} ± {t_mad:.4f} ms (median ± MAD); "
              + "; ".join(f"{k} {m:.4f} ± {d:.4f} ms" for k, (m, d) in split.items())
              + f"; rest {rest:.4f} ms; the binning's accumulation per call "
              f"{acc[0]:.3f} ms (sorted index_put_, equal bits), "
              f"{acc[1]:.3f} ms (atomic scatter_add_); K4 per call "
              f"{statistics.median(kern):.3f} ms at {args[0].shape[0]} rows x "
              f"{args[0].shape[1]} x {args[2].shape[1]}, plain {plain[0]:.3f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}; on every pair "
              f"{k4_bound(args)[0]:.4f} ms); live terms {pairs['live']} of "
              f"{pairs['all']} ({pairs['live'] / pairs['all']:.4%}), the "
              f"pruned loop evaluates {tiled} ({tiled / pairs['all']:.4%}); "
              f"max err {k_rel:.3e} of the row max")
        entries["K4"] = {
            "name": "kde1d_grid (K4)", "route": "cuda",
            "source": "chimera_tpu_torch/csrc/kde1d.cu",
            "replaces": "chimera_tpu/ops/pallas/kde.py:37", "launches": 1,
            "max_abs_err": k_abs, "ms": statistics.median(kern),
            "plain_ms": plain[0], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "redesigned": 12}
        del hl, args, prec

    # ---- 18. the unbinned effective-grid paths ---------------------------
    cut = {"binning": False, "cut_grid": 2.0}
    for name, data, make, kind, launched in (
            ("spectral", full, likelihood, "1d", {"K1b": 1}),
            ("dark", dark_data, dark_likelihood, "marginalized",
             {"K1c": 1, "K1d": 1})):
        hl = make(data, F32, **cut)
        ll, _ = counted(lambda: hl.log_like_batch(batch), launched)
        check_log_like(ll, h0s, {"fused_weights_kde": 1})
        total = cuda_ms(lambda: hl.log_like_batch(batch), reps)
        args, kw = captured("fused_weights_kde", lambda: hl.log_like_batch(batch))
        kern = cuda_ms(lambda: fused_weights_kde(*args, **kw), reps)
        plain = cuda_ms(lambda: fused_weights_kde_plain(*args, **kw), 1, 0)
        den_rel, den_abs, stat_rel = compare(
            args, 1e-4, 1e-4, min_live=0.9 if kind == "1d" else 0.3, **kw)
        t_med, t_mad = med_mad([t / n for t in total])
        k_med, k_mad = med_mad([t / n for t in kern])
        rest_ms = t_med - k_med
        if kind == "1d":
            kid, rest = "K1b", ""
            pairs = k1b_pairs(args, kw)
            b_ms, b_by = k1b_bound(args, kw, pairs)
            terms = (f"; on every pair {k1b_bound(args, kw)[0]:.4f} ms; live "
                     f"terms {pairs['live']} of {pairs['all']} "
                     f"({pairs['live'] / pairs['all']:.4%}), the pruned loop "
                     f"evaluates {pairs['tiled']} "
                     f"({pairs['tiled'] / pairs['all']:.4%})")
        else:
            b = args[2].shape[0]
            kid = "K1d"
            ev = captured("fused_row_stats", lambda: hl.log_like_batch(batch))
            k1c = med_mad([t / n for t in cuda_ms(
                lambda: fused_row_stats(*ev[0], **ev[1]), reps)])
            rest = f"K1c (on the events) {k1c[0]:.4f} ± {k1c[1]:.4f} ms; "
            rest_ms -= k1c[0]
            pairs = k1d_pairs(args, kw)
            b_ms, b_by = k1d_bound(args, kw, pairs)
            terms = (f"; on every pair {k1d_bound(args, kw)[0]:.4f} ms; live "
                     f"terms {pairs['live']} of {pairs['all']} "
                     f"({pairs['live'] / pairs['all']:.4%}), the pruned loop "
                     f"evaluates {pairs['tiled']} "
                     f"({pairs['tiled'] / pairs['all']:.4%}); (λ, row) pairs "
                     f"without a sample {pairs['empty_rows']} of {n * b}")
        prec = mock(*PRECISION_MOCK) if kind == "1d" else parity_dark_mock(DEV)
        rel, _, _ = f32_vs_f64(make(prec, F64, **cut), make(prec, F32, **cut),
                               torch.linspace(58.0, 100.0, 7, device=DEV))
        phase(18, f"unbinned cut_grid=2.0, {name}", f"{kind}: launches "
              f"{launched}; H0 argmax {h0s[int(torch.argmax(ll))].item():.2f}; "
              f"log L = {[round(v, 4) for v in ll.tolist()]}; float32 vs float64 "
              f"on the precision mock {rel:.3e} (bar 1e-6) [{smi}]")
        phase(18, "timing", f"[{smi}] per λ over {reps} batches of {n}: total "
              f"{t_med:.4f} ± {t_mad:.4f} ms (median ± MAD); {kid} "
              f"{k_med:.4f} ± {k_mad:.4f} ms; {rest}rest {rest_ms:.4f} ms; "
              f"{kid} per call "
              f"{statistics.median(kern):.3f} ms, plain {plain[0]:.3f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}){terms}; den max err {den_rel:.3e} of the "
              f"row max, stats {stat_rel:.3e}")
        entries[kid] = {
            "name": f"fused_weights_kde ({kid})", "route": "cuda",
            "source": "chimera_tpu_torch/csrc/fused_kde.cu",
            "replaces": "chimera_tpu/ops/pallas/fused.py:71", "launches": 1,
            "max_abs_err": den_abs, "ms": statistics.median(kern),
            "plain_ms": plain[0], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}
        entries[kid]["redesigned"] = 11 if kid == "K1b" else 13
        del hl, args, kw, prec
    for binning, launched in ((True, {"K4": 1}), (False, {"K1b": 1})):
        hl = dark_likelihood(dark_data, F32, kind="approximate", binning=binning,
                             cut_grid=2.0)
        ll, _ = counted(lambda: hl.log_like_batch(batch), launched)
        check_log_like(ll, h0s, {"kernel": 1})
        t_med, t_mad = med_mad([t / n for t in cuda_ms(
            lambda: hl.log_like_batch(batch), 5)])
        phase(18, f"approximate, binning={binning}", f"dark flagship data, "
              f"cut_grid=2.0: launches {launched}; H0 argmax "
              f"{h0s[int(torch.argmax(ll))].item():.2f}; {t_med:.4f} ± "
              f"{t_mad:.4f} ms per λ over 5 batches of {n}; log L = "
              f"{[round(v, 4) for v in ll.tolist()]} [{smi}]")
        del hl
    return [entries["K1b"], entries["K1d"], entries["K4"]]


# ---------------------------------------------------------------------------
# the dark-siren and effective-grid gradients
# ---------------------------------------------------------------------------

# the three unbinned gradient paths: (likelihood maker's config, the kernels
# one value-and-gradient call launches)
DARK = {"kind": "marginalized", "binning": False, "cut_grid": None}
DARK_CUT = {"kind": "marginalized", "binning": False, "cut_grid": 2.0}
APPROX_CUT = {"kind": "approximate", "binning": False, "cut_grid": 2.0}
GRAD_LAUNCHES = {"dark": {"K1c": 1, "K2": 1, "K3c": 1, "K2b": 1},
                 "dark_cut": {"K1c": 1, "K1d": 1, "K3c": 1, "K3d": 1},
                 "approx_cut": {"K1b": 1, "K3b": 1},
                 "spectral_cut": {"K1b": 1, "K3b": 1}}


def row_rel(got: torch.Tensor, expect: torch.Tensor, floor: float = 1e-300
            ) -> float:
    """The largest error of an output relative to its row's largest entry
    (a row is the last axis; the rows axis of an (L, N, 2) output), the
    row's scale floored at ``floor``."""
    g, e = got.double(), expect.double()
    if g.dim() == 3 and g.shape[-1] == 2:
        g, e = g.transpose(1, 2), e.transpose(1, 2)
    return ((g - e).abs() / e.abs().amax(dim=-1, keepdim=True).clamp_min(
        floor)).max().item()


def in_float64(args, kw):
    """A backward kernel's arguments with every float tensor and model in
    float64 (the integer n_real stays)."""
    import dataclasses

    from chimera_tpu_torch.pytree import tensor_map

    def f64(a):
        if isinstance(a, torch.Tensor):
            return a.double() if a.is_floating_point() else a
        if dataclasses.is_dataclass(a):  # a model
            return tensor_map(a, lambda t: t.double() if t.is_floating_point() else t)
        return a

    return [f64(a) for a in args], {k: f64(v) for k, v in kw.items()}


def grad_compare(name: str, fn, plain, args, kw, tol, expect=None):
    """A backward kernel (``fn``) against its plain version on the same
    inputs (or against ``expect``, the plain version's outputs): each
    output's largest error relative to its row's largest entry, and the
    largest absolute error; equal bits on a second launch.  In float32 an
    output further than ``tol`` from the float32 plain version is held to
    ``tol`` against the float64 plain version on the same inputs (the exact
    answer) instead, but for K3d's d_ext: it passes the stats' lo, ub
    cotangents through and adds the KDE's cotangent of the bounds, and on
    the dark cut_grid path the two nearly cancel (the resampled density
    hardly depends on where the grid lies), so its kernel's own term is held
    to 2x the float32 plain version's own error against float64.  Against
    float64 a row's scale is floored at float32's smallest normal number
    (the binned dark path hands K4b rows of cotangents so small that its
    outputs are float32 subnormals).  Returns (rel, abs): the largest error
    held to a bar (against float64 where the float32 plain version is
    further off) and the largest absolute error against the plain
    version."""
    got, again = fn(*args, **kw), fn(*args, **kw)
    expect = plain(*args, **kw) if expect is None else expect
    torch.cuda.synchronize(DEV)
    f32 = args[2].dtype == F32
    exact = None
    rel = abs_err = 0.0
    for i, (g, a, e) in enumerate(zip(got, again, expect)):
        if g is None:
            continue
        if not torch.equal(g, a):
            raise AssertionError(f"{name} gave different bits on the same inputs")
        if not torch.all(torch.isfinite(g)):
            raise AssertionError(f"{name} returned a non-finite gradient")
        r = row_rel(g, e)
        abs_err = max(abs_err, (g.double() - e.double()).abs().max().item())
        if r <= tol:
            rel = max(rel, r)
            continue
        if not f32:
            raise AssertionError(f"{name} vs plain: output {i} {r:.3e} of the "
                                 f"row max (tol {tol:.0e})")
        if exact is None:
            args64, kw64 = in_float64(args, kw)
            exact = plain(*args64, **kw64)
        # a row of float64 values below float32's smallest normal number
        # holds float32 subnormals, which keep 2^-149 absolute, no relative
        # accuracy: its scale is floored there
        x, bar, tiny = exact[i], tol, torch.finfo(F32).tiny
        if i == 2 and kw.get("ext_bounds") is not None:  # K3d's d_ext
            passed = args[8][..., :2]
            g, e, x = g - passed, e - passed, x - passed.double()
            bar = max(tol, 2 * row_rel(e, x, tiny))
        k_err, p_err = row_rel(g, x, tiny), row_rel(e, x, tiny)
        print(f"  {name} output {i} in float32: kernel vs plain {r:.3e} of the "
              f"row max; against the float64 plain version on the same inputs: "
              f"kernel {k_err:.3e} (bar {bar:.3e}), float32 plain {p_err:.3e}",
              flush=True)
        if k_err > bar:
            raise AssertionError(
                f"{name} vs plain: output {i} {r:.3e} of the row max (tol "
                f"{tol:.0e}); against float64 kernel {k_err:.3e} (bar "
                f"{bar:.3e}), float32 plain {p_err:.3e}")
        rel = max(rel, k_err)
    return rel, abs_err


def mode_inputs(hl, mode: str, lam: dict, seed: int, kernel=None,
                n_grid=None):
    """K3's arguments and keywords in the forward's ``mode`` on a
    likelihood's data at the batch ``lam``, on the data's device, with
    random cotangents: the stats pass of the logical pixel rows
    ('stats_logical') or of the events ('stats', lo and ub cotangents
    included), the events' analysis grids ('input'), their effective grids
    ('auto'), the pixel rows on the events' bounds ('ext', unit mass); ``n_grid`` points (the likelihood's
    by default) and ``kernel`` (the likelihood's by default).  A dead pixel
    row's bandwidth and bounds are rounding noise: they get no cotangent."""
    from chimera_tpu_torch.ops.cuda.fused import fused_row_stats_plain, pack_params

    pop_b = hl.population.update_batch(lam)
    dt, dev = hl.dL.dtype, hl.dL.device
    n_grid = hl.n_grid if n_grid is None else n_grid
    ev = (hl.m1det, hl.m2det, hl.dL, hl.inv_pe_prior)
    if mode in ("stats_logical", "ext"):
        data = (hl.pix_m1det, hl.pix_m2det, hl.pix_dL, hl.pix_inv_pe_prior)
        kw = {"n_real": hl.pix_n_real, "dl_fill": hl.pix_dl_fill,
              "logical_s": hl.n_samples}
    else:
        data, kw = ev, {}
    if mode == "input":  # the analysis grids (K3)
        n_grid = hl.z_grids.shape[1]
        kw["n_grid"] = n_grid
    elif mode in ("stats_logical", "stats"):
        kw.update(cut_grid=2.0, stats_only=True)
    elif mode == "auto":
        kw.update(cut_grid=2.0, n_grid=n_grid)
    else:
        st = fused_row_stats_plain(*ev, pop_b.cosmo, pop_b.mass)
        kw.update(n_grid=n_grid, den_scale="unit", ext_bounds=torch.stack(
            [st["lo"], st["ub"]], dim=-1).repeat_interleave(hl.n_pixels, dim=1))
    n, b = len(next(iter(lam.values()))), data[2].shape[0]
    series, params = pack_params(pop_b.cosmo, pop_b.mass, n, dt)
    gen = torch.Generator(device=dev).manual_seed(seed)
    ct_den = None if kw.get("stats_only") else torch.randn(
        (n, b, kw["n_grid"]), generator=gen, device=dev, dtype=F64).to(dt)
    ct_stats = torch.randn((n, b, 8), generator=gen, device=dev, dtype=F64).to(dt)
    if "n_real" in kw:
        for slot in (0, 1, 4):
            ct_stats[:, kw["n_real"] == 0, slot] = 0.0
    grids = None
    if mode == "input":
        grids = hl.z_grids
        del kw["n_grid"]
    return (*data, grids, series, params, ct_den, ct_stats, pop_b.cosmo,
            pop_b.mass, kernel or hl.kernel), kw


def rows_inputs(hl, lam: dict, seed: int, kernel=None):
    """K2b's arguments on the main path's K2 inputs at the batch ``lam``,
    on the data's device, with random cotangents of r."""
    from chimera_tpu_torch.ops.cuda.fused import fused_row_stats_plain, pack_params

    pop_b = hl.population.update_batch(lam)
    n, dt, dev = len(next(iter(lam.values()))), hl.dL.dtype, hl.dL.device
    st = fused_row_stats_plain(hl.pix_m1det, hl.pix_m2det, hl.pix_dL,
                               hl.pix_inv_pe_prior, pop_b.cosmo, pop_b.mass,
                               hl.pix_n_real, hl.pix_dl_fill, hl.n_samples)
    f1, f2, _ = hl.lambda_factors(pop_b)
    series, params = pack_params(pop_b.cosmo, pop_b.mass, n, dt)
    gen = torch.Generator(device=dev).manual_seed(seed)
    ct = torch.randn((n, hl.row_dL.shape[0], 2), generator=gen, device=dev,
                     dtype=F64).to(dt)
    return (hl.row_m1det, hl.row_m2det, hl.row_dL, hl.row_inv_pe_prior,
            hl.z_grids, series, params, hl.row_scales(st), hl.row_s1,
            hl.row_s2, f1, f2, ct, pop_b.cosmo, pop_b.mass, kernel or hl.kernel)


def backward_calls(hl, x):
    """One value-and-gradient call at the points ``x`` with the two backward
    kernels' wrappers recording their calls: {kernel id: [(args, kw)]}, the
    inputs (the main path's cotangents among them) the backward hands
    them."""
    from chimera_tpu_torch.ops.cuda import fused, rows

    out = {}

    def k2b():
        out["K2b"] = calls_of(rows, "fused_rows_contract_adjoint",
                              lambda: value_and_grad(hl, x))

    out["K3"] = calls_of(fused, "fused_weights_kde_adjoint", k2b)
    return out


def k3_id(kw) -> str:
    if kw.get("stats_only"):
        return "K3c"
    return "K3d" if kw.get("ext_bounds") is not None else \
        "K3b" if kw.get("cut_grid") is not None else "K3"


def window_pairs(cosmo, mass, m1det, dl, mask=None) -> int:
    """The (λ, sample) pairs, where ``mask`` ((B, S) or (L, B, S)) holds,
    whose source mass m1det / (1 + z) clipped to [m_low, m_high] lies at or
    below m_join: those that sum the conditional CDF's window series."""
    from chimera_tpu_torch.models.cosmology import z_from_dgw

    n = max(cosmo.L, mass.L)
    with torch.no_grad():
        z = z_from_dgw(cosmo, dl[None]).expand(n, -1, -1)
        col = [getattr(mass, k).expand(n)[:, None, None].to(z.dtype)
               for k in ("m_low", "m_high", "m_join")]
        m1c = torch.minimum(torch.maximum(m1det[None] / (1.0 + z), col[0]), col[1])
        inside = m1c <= col[2]
        if mask is not None:
            inside = inside & (mask if mask.dim() == 3 else mask[None])
        return int(inside.sum())


def adjoint_ops(dl, cosmo, mass, pairs: int, in_window: int, terms: int,
                dark: bool) -> tuple[float, float]:
    """The FP32 and FP64 operations of an adjoint kernel's per-sample work
    and its pair terms: ``pairs`` (λ, real sample) pairs of Clenshaw work on
    the distance series and the mass model (MASS_OPS), ``in_window`` of them
    on the window series too, and ``terms`` operations of KDE-adjoint
    terms; the series' sums in double where ``dark`` (the dark-siren modes
    and K2b) or in float64, the rest in the working dtype."""
    coefs = pairs * cosmo.cheb_deg + in_window * mass.window_deg
    sums = ADJ_CHEB_SUM_OPS * coefs
    rest = ADJ_CHEB_PROJ_OPS * coefs + MASS_OPS * pairs + terms
    if dl.dtype == F64:
        return 0.0, float(sums + rest)
    return (float(rest), float(sums)) if dark else (float(sums + rest), 0.0)


def k3_bound(args, kw, pairs: dict | None = None) -> tuple[float, str]:
    """The least time of K3 on these inputs: bytes — the PE rows of the real
    samples, the cotangents, the model rows and the gradients (the d_ext
    bounds too); operations — the pair terms of the KDE adjoint (none in
    the stats-only mode; where ``pairs`` is given, its 'live' terms, those
    that are not exactly 0: k3b_pairs) and each real sample's Clenshaw and
    mass-model work (adjoint_ops; the series summed in double in the
    dark-siren modes, K3c and K3d, priced at the FP64 rate)."""
    m1, dl, grids, ct_stats, cosmo, mass = (args[0], args[2], args[4], args[8],
                                            args[9], args[10])
    n, b = ct_stats.shape[:2]
    size = dl.element_size()
    mask = None
    if kw.get("n_real") is not None:
        mask = torch.arange(dl.shape[1], device=dl.device)[None] \
            < kw["n_real"].to(dl.device)[:, None]
    real = int(mask.sum()) if mask is not None else dl.numel()
    g = 0 if kw.get("stats_only") else grids.shape[1] if grids is not None \
        else int(kw["n_grid"])
    term_ops = ADJ_KDE_OPS if grids is not None else ADJ_LIN_KDE_OPS
    dark = bool(kw.get("stats_only")) or kw.get("ext_bounds") is not None
    terms = n * real * g if pairs is None else pairs["live"]
    ops = adjoint_ops(dl, cosmo, mass, n * real,
                      window_pairs(cosmo, mass, m1, dl, mask),
                      terms * term_ops, dark)
    q = args[5].shape[1] + 12
    n_bytes = (size * (4 * real + n * b * (g + 8)) + 2 * 8 * n * q
               + (size * b * g if grids is not None else 0)
               + (2 * 8 * b if kw.get("n_real") is not None else 0)
               + (2 * size * 2 * n * b if kw.get("ext_bounds") is not None else 0))
    return bound(n_bytes, *ops)


def _tile_bounds(x: torch.Tensor, valid: torch.Tensor, width: int):
    """The min and max of the valid entries of each tile of ``width``
    consecutive entries of the rows of x (N, n): (N, ceil(n / width)) each,
    +inf and -inf where a tile has none."""
    pad = (-x.shape[-1]) % width
    x = torch.nn.functional.pad(x, (0, pad)).unflatten(-1, (-1, width))
    valid = torch.nn.functional.pad(valid, (0, pad)).unflatten(-1, (-1, width))
    return (torch.where(valid, x, torch.inf).amin(-1),
            torch.where(valid, x, -torch.inf).amax(-1))


def _in_support(z, keep, h, grid, closed: bool) -> int:
    """The (row, grid point, sample) triples with |g - z| < h (<= h where
    ``closed``) and ``keep``: z, keep (N, S), h (N,), grid (N, G), counted
    with searchsorted on each row's sorted z (no (N, G, S) tensor)."""
    zs, order = torch.sort(z, dim=-1)
    c = torch.nn.functional.pad(torch.gather(keep, -1, order).cumsum(-1), (1, 0))
    hi = torch.searchsorted(zs, (grid + h[:, None]).contiguous(), right=closed)
    lo = torch.searchsorted(zs, (grid - h[:, None]).contiguous(), right=not closed)
    return int((c.gather(-1, hi) - c.gather(-1, lo)).sum())


def _tiled_terms(z, w, h, grid, tile_s: int | None = None, real=None) -> int:
    """The pair terms that the pruned density loop evaluates: _TILE_G grid
    points x ``tile_s`` (by default _TILE_S) samples a tile
    (ops/cuda/fused.py, the kernels' tile widths), less the tiles whose
    corner proves every |u| >= 1 (the kernels' test, here in float64) over
    the samples with weight.  ``real`` (N, S): the slots that hold samples
    (the first n_real of a logical row; a row with none runs no tile),
    every slot where None."""
    from chimera_tpu_torch.ops.cuda.fused import _TILE_G as TILE_G
    from chimera_tpu_torch.ops.cuda.fused import _TILE_S

    tile_s = tile_s or _TILE_S
    real = torch.ones_like(z, dtype=torch.bool) if real is None else real
    zlo, zhi = _tile_bounds(z, (w != 0) & real, tile_s)
    glo, ghi = _tile_bounds(grid, torch.ones_like(grid, dtype=torch.bool), TILE_G)
    inv_h = (1.0 / h)[:, None, None]
    dead = ((glo[:, :, None] - zhi[:, None]) * inv_h >= 1.0) \
        | ((ghi[:, :, None] - zlo[:, None]) * inv_h <= -1.0)
    n_g = torch.nn.functional.pad(torch.ones_like(grid), (0, (-grid.shape[-1]) % TILE_G)
                                  ).unflatten(-1, (-1, TILE_G)).sum(-1)
    n_s = torch.nn.functional.pad(real.to(z.dtype), (0, (-z.shape[-1]) % tile_s)
                                  ).unflatten(-1, (-1, tile_s)).sum(-1)
    return int((~dead * n_g[:, :, None] * n_s[:, None]).sum())


def _z_and_w(m1, m2, dl, invp, cosmo, mass):
    """z and w of every (λ, row, sample), float64 (the plain version's)."""
    from chimera_tpu_torch.models.cosmology import z_from_dgw
    from chimera_tpu_torch.models.mass import p_m1m2

    z = z_from_dgw(cosmo, dl[None])
    inv1pz = 1.0 / (1.0 + z)
    w = p_m1m2(mass, m1[None] * inv1pz, m2[None] * inv1pz) * invp[None]
    n = max(cosmo.L, mass.L)
    return z.expand(n, -1, -1).double(), w.expand(n, -1, -1).double()


def k1a_pairs(args) -> dict:
    """K1a's pair terms on its inputs ``args`` (kernel_inputs): 'all'
    (λ, row, grid point, sample); 'live', those with |g - z| < h and
    w != 0, the terms of the Epanechnikov density that are not exactly 0;
    'tiled', those the pruned loop evaluates."""
    from chimera_tpu_torch.ops.cuda.fused import fused_row_stats_plain

    m1, m2, dl, invp, cosmo, mass, grids = args
    with torch.no_grad():
        h = fused_row_stats_plain(m1, m2, dl, invp, cosmo, mass)["bandwidth"]
        z, w = _z_and_w(m1, m2, dl, invp, cosmo, mass)
        grid = grids.double()
        out = {"all": z.numel() * grid.shape[1], "live": 0, "tiled": 0}
        for l in range(z.shape[0]):
            out["live"] += _in_support(z[l], w[l] != 0, h[l].double(), grid, False)
            out["tiled"] += _tiled_terms(z[l], w[l], h[l].double(), grid)
    return out


def k2b_pairs(args) -> dict:
    """K2b's pair terms on its inputs ``args`` (rows_inputs' order): 'all'
    (λ, row, grid point, slot); 'live_rows', those of the rows with a
    scale, a cotangent and a weight (the rest K2b skips whole); 'density',
    those of the live rows with |g - z| < h and w != 0 (pass 1's non-zero
    terms); 'live', those with |g - z| <= h of a weighted sample (the
    adjoint sums' non-zero terms); 'pass1' and 'pass2', the terms the
    pruned passes evaluate (pass 2: the kernel's _GRID_TILE grid points a
    tile for each weighted sample, less the tiles its corners prove outside
    the closed support)."""
    from chimera_tpu_torch.ops.cuda.fused import _GRID_TILE as GRID_TILE

    m1, m2, dl, invp, grids, hs, ct, cosmo, mass = (
        args[0], args[1], args[2], args[3], args[4], args[7], args[12],
        args[13], args[14])
    (r_rows, chunk), (e, g) = dl.shape, grids.shape
    weighted = invp > 0
    live = (hs[..., 1] != 0) & (ct != 0).any(dim=-1) & weighted.any(dim=1)[None]
    out = {"all": hs.shape[0] * r_rows * chunk * g,
           "live_rows": int(live.sum()) * chunk * g,
           "density": 0, "live": 0, "pass1": 0, "pass2": 0}
    with torch.no_grad():
        z, w = _z_and_w(m1, m2, dl, invp, cosmo, mass)
        grid_rows = grids.double().repeat_interleave(r_rows // e, dim=0)
        for l in range(z.shape[0]):
            rows = live[l]
            zz, ww, gg = z[l][rows], w[l][rows], grid_rows[rows]
            hh, wt = 1.0 / hs[l, rows, 0].double(), weighted[rows]
            out["density"] += _in_support(zz, ww != 0, hh, gg, False)
            out["live"] += _in_support(zz, wt, hh, gg, True)
            out["pass1"] += _tiled_terms(zz, ww, hh, gg)
            glo, ghi = _tile_bounds(gg, torch.ones_like(gg, dtype=torch.bool),
                                    GRID_TILE)
            u_lo = (glo[:, :, None] - zz[:, None]) / hh[:, None, None]
            u_hi = (ghi[:, :, None] - zz[:, None]) / hh[:, None, None]
            kept = ~((u_lo > 1.0) | (u_hi < -1.0)) & wt[:, None]
            n_g = torch.full_like(glo, GRID_TILE)
            n_g[:, -1] = g - GRID_TILE * (glo.shape[1] - 1)
            out["pass2"] += int((kept * n_g[:, :, None]).sum())
    return out


def _adjoint_tiles(out_x, in_x, inv_h, width: int, grid_major: bool):
    """(N, O, T): whether a pruned adjoint loop (K4b's sweeps, K3b's phase
    B) keeps each tile of ``width`` consecutive entries of in_x (N, I) for
    each entry of out_x (N, O): not every u of the tile proved > 1, or
    every u < -1, at its corners (the kernels' test, here in float64).
    u = (g - z) inv_h, out_x the grid points g where ``grid_major``, else
    the samples z.  Tile bounds are over every entry."""
    lo, hi = _tile_bounds(in_x, torch.ones_like(in_x, dtype=torch.bool), width)
    o, ih = out_x[:, :, None], inv_h[:, None, None]
    if grid_major:
        u_min, u_max = (o - hi[:, None]) * ih, (o - lo[:, None]) * ih
    else:
        u_min, u_max = (lo[:, None] - o) * ih, (hi[:, None] - o) * ih
    return ~((u_min > 1.0) | (u_max < -1.0))


def _tile_terms(keep, n_in: int, width: int) -> tuple[int, int, int]:
    """The terms of a pruned loop whose outputs (N, O) take the tiles
    ``keep`` (N, O, T) of n_in entries, a warp 32 consecutive outputs:
    (each output's kept entries, 32 x each warp's most — the SIMT cost of
    lanes that each walk their own kept tiles —, 32 x each warp's union —
    the cost of a warp that walks in step the tiles any of its lanes
    keeps)."""
    t = keep.shape[-1]
    n_t = torch.full((t,), float(width), dtype=F64, device=keep.device)
    n_t[-1] = n_in - width * (t - 1)
    per = (keep * n_t).sum(-1)
    pad = (-per.shape[1]) % 32
    per = torch.nn.functional.pad(per, (0, pad)).unflatten(1, (-1, 32))
    union = torch.nn.functional.pad(keep, (0, 0, 0, pad)).unflatten(
        1, (-1, 32)).any(2)
    return (int(per.sum()), int(32 * per.amax(-1).sum()),
            int(32 * (union * n_t).sum()))


def _add_tile_terms(out: dict, keep, n_in: int, width: int) -> None:
    """Add _tile_terms of ``keep`` to out's kept{width}, warp{width} and
    union{width}."""
    for key, v in zip(("kept", "warp", "union"), _tile_terms(keep, n_in, width)):
        out[f"{key}{width}"] = out.get(f"{key}{width}", 0) + v


def k4b_pairs(args, widths=None) -> dict:
    """K4b's terms on its inputs ``args`` (z, w, grids, h, ...): 'all', the
    terms of the full loops' two sweeps, 2 (row, grid point, bin); 'live',
    the (row, grid point, bin) terms with |u| <= 1 (the closed support,
    where the slope factor is not 0: the adjoint's terms that are not
    exactly 0, each of which one sweep over the pairs would form once);
    per tile width w (``widths``, the kernel's _K4B_TILE by default):
    'kept{w}', 'warp{w}' and 'union{w}' of _tile_terms summed over the two
    pruned sweeps (a thread per grid point over tiles of bins, a thread per
    bin over tiles of grid points; a warp walks the union)."""
    from chimera_tpu_torch.ops.cuda.fused import _K4B_TILE

    z, grids, h = args[0].double(), args[2].double(), args[3].double()
    (b, s), g = z.shape, grids.shape[1]
    rows = 4096  # a chunk's rows: (rows, G, tiles) values at a time
    out = {"all": 2 * b * g * s, "live": 0}
    with torch.no_grad():
        for r0 in range(0, b, rows):
            zz, gg, hh = z[r0:r0 + rows], grids[r0:r0 + rows], h[r0:r0 + rows]
            out["live"] += _in_support(zz, torch.ones_like(zz, dtype=torch.bool),
                                       hh, gg, True)
            for w in widths or (_K4B_TILE,):
                _add_tile_terms(out, _adjoint_tiles(gg, zz, 1.0 / hh, w, True),
                                s, w)
                _add_tile_terms(out, _adjoint_tiles(zz, gg, 1.0 / hh, w, False),
                                g, w)
    return out


def k3b_pairs(args, kw, widths=None) -> dict:
    """K3b's pair terms on its inputs (fused_weights_kde_adjoint's, the
    effective-grid mode): 'all' (λ, row, sample, grid point); 'live', those
    with |u| <= 1, where the support weight is not 0; per tile width w
    (``widths``, the kernel's _GRID_TILE by default): 'kept{w}', 'warp{w}'
    and 'union{w}' of _tile_terms, a warp's 32 consecutive samples of one
    slot over tiles of the row's linear grid (the kernel walks the union:
    a ballot of the warp keeps a tile).  The grid, h and z are the plain
    stats pass's, in float64."""
    from chimera_tpu_torch.ops.cuda.fused import (_GRID_TILE,
                                                  fused_row_stats_plain)

    m1, m2, dl, invp, cosmo, mass = (args[0], args[1], args[2], args[3],
                                     args[9], args[10])
    g = int(kw["n_grid"])
    (b, s) = dl.shape
    rows = 125  # a chunk's rows: (rows, S, tiles) values at a time
    with torch.no_grad():
        st = fused_row_stats_plain(m1, m2, dl, invp, cosmo, mass,
                                   cut_grid=kw["cut_grid"])
        z, _ = _z_and_w(m1, m2, dl, invp, cosmo, mass)
        frac = torch.arange(g, dtype=F64, device=dl.device)
        out = {"all": z.shape[0] * b * s * g, "live": 0}
        for l in range(z.shape[0]):
            lo, ub = st["lo"][l].double(), st["ub"][l].double()
            h = st["bandwidth"][l].double()
            grid = lo[:, None] + ((ub - lo) / (g - 1))[:, None] * frac
            for r0 in range(0, b, rows):
                zz, gg, hh = (z[l, r0:r0 + rows], grid[r0:r0 + rows],
                              h[r0:r0 + rows])
                out["live"] += _in_support(
                    zz, torch.ones_like(zz, dtype=torch.bool), hh, gg, True)
                for w in widths or (_GRID_TILE,):
                    _add_tile_terms(out, _adjoint_tiles(zz, gg, 1.0 / hh, w,
                                                        False), g, w)
    return out


def _run_terms(keep, n_in: int, width: int) -> int:
    """32 x the entries of each warp's run of tiles: outputs (N, O) that
    take the tiles ``keep`` (N, O, T) of n_in entries, a warp 32
    consecutive outputs walking every tile from the first that any of its
    lanes keeps to the last."""
    t = keep.shape[-1]
    n_t = torch.full((t,), float(width), dtype=F64, device=keep.device)
    n_t[-1] = n_in - width * (t - 1)
    cum = torch.nn.functional.pad(n_t.cumsum(0), (1, 0))
    pad = (-keep.shape[1]) % 32
    union = torch.nn.functional.pad(keep, (0, 0, 0, pad)).unflatten(
        1, (-1, 32)).any(2)
    any_kept = union.any(-1)
    first = union.double().argmax(-1)
    last = t - 1 - union.flip(-1).double().argmax(-1)
    return int((32 * (cum[last + 1] - cum[first]) * any_kept).sum())


def k1b_pairs(args, kw) -> dict:
    """K1b's pair terms on its inputs (fused_weights_kde's, the
    effective-grid mode): 'all' (λ, row, grid point, sample); 'live', those
    with |g - z| < h and w != 0, the terms of the Epanechnikov density that
    are not exactly 0; 'tiled', those the pruned loop evaluates
    (_tiled_terms).  The grid, h and z are the plain stats pass's, in
    float64."""
    from chimera_tpu_torch.ops.cuda.fused import fused_row_stats_plain

    m1, m2, dl, invp, cosmo, mass = args[:6]
    g = int(kw["n_grid"])
    b = dl.shape[0]
    rows = 250
    with torch.no_grad():
        st = fused_row_stats_plain(m1, m2, dl, invp, cosmo, mass,
                                   cut_grid=kw["cut_grid"])
        z, w = _z_and_w(m1, m2, dl, invp, cosmo, mass)
        frac = torch.arange(g, dtype=F64, device=dl.device)
        out = {"all": z.numel() * g, "live": 0, "tiled": 0}
        for l in range(z.shape[0]):
            lo, ub = st["lo"][l].double(), st["ub"][l].double()
            h = st["bandwidth"][l].double()
            grid = lo[:, None] + ((ub - lo) / (g - 1))[:, None] * frac
            for r0 in range(0, b, rows):
                zz, ww, gg, hh = (z[l, r0:r0 + rows], w[l, r0:r0 + rows],
                                  grid[r0:r0 + rows], h[r0:r0 + rows])
                out["live"] += _in_support(zz, ww != 0, hh, gg, False)
                out["tiled"] += _tiled_terms(zz, ww, hh, gg)
    return out


def k1d_pairs(args, kw) -> dict:
    """K1d's pair terms on its inputs (fused_weights_kde's, the mode of
    given bounds on logical pixel rows): 'all' (λ, row, real sample, grid
    point), the pairs of K1d's all-pairs bound; 'empty_rows', the (λ, row)
    pairs whose row holds no real sample; 'live', the terms with
    |g - z| < h and w != 0, those of the Epanechnikov density that are not
    exactly 0; 'tiled', those the pruned loop evaluates (_tiled_terms on
    each row's real samples and its linear grid lo + δ g over the given
    (lo, ub)).  h, z and w are the plain stats pass's on the logical rows,
    in float64."""
    from chimera_tpu_torch.ops.cuda.fused import fused_row_stats_plain

    m1, m2, dl, invp, cosmo, mass = args[:6]
    g, ext = int(kw["n_grid"]), kw["ext_bounds"].double()
    b, s = dl.shape
    n_real = kw["n_real"].to(dl.device).clamp(0, s)
    real = torch.arange(s, device=dl.device)[None] < n_real[:, None]
    rows = 1000  # a chunk's rows
    with torch.no_grad():
        st = fused_row_stats_plain(m1, m2, dl, invp, cosmo, mass,
                                   n_real=kw["n_real"], dl_fill=kw["dl_fill"],
                                   logical_s=kw["logical_s"])
        z, w = _z_and_w(m1, m2, dl, invp, cosmo, mass)
        frac = torch.arange(g, dtype=F64, device=dl.device)
        n = z.shape[0]
        out = {"all": n * int(real.sum()) * g,
               "empty_rows": n * int((n_real == 0).sum()), "live": 0, "tiled": 0}
        for l in range(n):
            lo, ub = ext[l, :, 0], ext[l, :, 1]
            h = st["bandwidth"][l].double()
            grid = lo[:, None] + ((ub - lo) / (g - 1))[:, None] * frac
            for r0 in range(0, b, rows):
                sl = slice(r0, r0 + rows)
                zz, ww, gg, hh, rr = z[l, sl], w[l, sl], grid[sl], h[sl], real[sl]
                out["live"] += _in_support(zz, (ww != 0) & rr, hh, gg, False)
                out["tiled"] += _tiled_terms(zz, ww, hh, gg, real=rr)
    return out


def k1d_bound(args, kw, pairs: dict | None = None) -> tuple[float, str]:
    """The least time of K1d on these inputs: bytes, the PE rows of the real
    samples, the logical-row arrays, the given bounds, the model rows, the
    densities and the stats once each; operations, per (λ, real sample) the
    distance series' Clenshaw sum in double, the mass model's forward and,
    in the CDF's window, the window series in double, per (λ, logical row)
    the fillers' distance series, per (λ, row, grid point) the grid point
    and the density's scale, and the density terms that are not exactly 0
    (``pairs['live']`` of k1d_pairs).  Where ``pairs`` is None, the
    all-pairs count: each real sample's series and KDE terms on every grid
    point, FP32."""
    m1, dl, cosmo, mass = args[0], args[2], args[4], args[5]
    n, (b, s), g = max(cosmo.L, mass.L), dl.shape, int(kw["n_grid"])
    size = dl.element_size()
    n_real = kw["n_real"].to(dl.device).clamp(0, s)
    real = int(n_real.sum())
    q = 12 + mass.window_deg
    if pairs is None:
        return bound(size * (4 * real + b + 2 * n * b + n * q + n * b * (g + 8))
                     + 8 * b + 8 * n * (cosmo.cheb_deg + 2),
                     n * real * (CHEB_OPS * cosmo.cheb_deg + KDE_OPS * g))
    n_bytes = (size * (4 * real + b + 2 * n * b + n * q + n * b * (g + 8))
               + 8 * b + 8 * n * (cosmo.cheb_deg + 2 + mass.window_deg))
    mask = torch.arange(s, device=dl.device)[None] < n_real[:, None]
    ops64 = CHEB_OPS * (n * (real + b) * cosmo.cheb_deg
                        + window_pairs(cosmo, mass, m1, dl, mask) * mass.window_deg)
    ops = n * real * MASS_FWD_OPS + 2 * n * b * g + KDE_OPS * pairs["live"]
    return bound(n_bytes, 0.0, ops + ops64) if dl.dtype == F64 \
        else bound(n_bytes, ops, ops64)


def k3d_pairs(args, kw, widths=None) -> dict:
    """K3d's pair terms on its inputs (fused_weights_kde_adjoint's, the
    mode of given bounds on logical rows): 'all' (λ, row, real sample,
    grid point), the pairs of K3d's all-pairs bound; 'slots', the
    (slot, grid point) pairs of the 4-warp block a row (rounds of 512
    slots, a slot past the row's samples evaluated and dropped); 'live',
    the real samples' pairs with |u| <= 1, where the support weight is not
    0; per tile width w (``widths``, the kernel's _GRID_TILE by default):
    'kept{w}', 'warp{w}' and 'union{w}' of _tile_terms and 'run{w}'
    (_run_terms), a warp's 32 consecutive samples of one slot over tiles of
    the row's linear grid on the given (lo, ub).  h and z are the plain
    stats pass's on the logical rows, in float64."""
    from chimera_tpu_torch.ops.cuda.fused import (_GRID_TILE,
                                                  fused_row_stats_plain)

    m1, m2, dl, invp, cosmo, mass = (args[0], args[1], args[2], args[3],
                                     args[9], args[10])
    g, ext = int(kw["n_grid"]), kw["ext_bounds"].double()
    (b, s) = dl.shape
    n_real = kw["n_real"].to(dl.device).clamp(0, s)
    real = torch.arange(s, device=dl.device)[None] < n_real[:, None]
    rows = 500  # a chunk's rows: (rows, S, tiles) values at a time
    with torch.no_grad():
        st = fused_row_stats_plain(m1, m2, dl, invp, cosmo, mass,
                                   n_real=kw["n_real"], dl_fill=kw["dl_fill"],
                                   logical_s=kw["logical_s"])
        z, _ = _z_and_w(m1, m2, dl, invp, cosmo, mass)
        frac = torch.arange(g, dtype=F64, device=dl.device)
        n = z.shape[0]
        out = {"all": n * int(real.sum()) * g,
               "slots": n * int(((n_real + 511) // 512).sum()) * 512 * g,
               "live": 0}
        for l in range(n):
            lo, ub = ext[l, :, 0], ext[l, :, 1]
            h = st["bandwidth"][l].double()
            grid = lo[:, None] + ((ub - lo) / (g - 1))[:, None] * frac
            for r0 in range(0, b, rows):
                zz, gg, hh, rr = (z[l, r0:r0 + rows], grid[r0:r0 + rows],
                                  h[r0:r0 + rows], real[r0:r0 + rows])
                out["live"] += _in_support(zz, rr, hh, gg, True)
                for w in widths or (_GRID_TILE,):
                    keep = _adjoint_tiles(zz, gg, 1.0 / hh, w, False) & rr[..., None]
                    _add_tile_terms(out, keep, g, w)
                    out[f"run{w}"] = out.get(f"run{w}", 0) + _run_terms(keep, g, w)
    return out


def k1b_bound(args, kw, pairs: dict | None = None) -> tuple[float, str]:
    """The least time of K1b on these inputs: bytes, the PE rows read and
    the densities and stats written once; operations, per (λ, sample) the
    distance series' Clenshaw sum and the mass model's forward (and the
    window series where the source mass lies in its window), per (λ, row,
    grid point) the grid point and the density's scale, and the KDE's pair
    terms: those of ``pairs['live']`` (k1b_pairs: the terms that are not
    exactly 0), or every pair where ``pairs`` is None (the all-pairs count,
    which charges the series only)."""
    m1, dl, cosmo, mass = args[0], args[2], args[4], args[5]
    n, (e, s), g = max(cosmo.L, mass.L), dl.shape, int(kw["n_grid"])
    q = 12 + mass.window_deg
    n_bytes = (dl.element_size() * (4 * e * s + n * q + n * e * (g + 8))
               + 8 * n * (cosmo.cheb_deg + 2))
    if pairs is None:
        return bound(n_bytes, n * e * s * (CHEB_OPS * cosmo.cheb_deg + KDE_OPS * g))
    ops = (n * e * s * (CHEB_OPS * cosmo.cheb_deg + MASS_FWD_OPS)
           + CHEB_OPS * mass.window_deg * window_pairs(cosmo, mass, m1, dl)
           + 2 * n * e * g + KDE_OPS * pairs["live"])
    return bound(n_bytes, ops)


def k1a_bound(args, pairs: dict | None = None) -> tuple[float, str]:
    """The least time of K1a on these inputs: bytes, the PE rows and grids
    read and the densities and stats written once; operations, per
    (λ, sample) the distance series' Clenshaw sum and the mass model's
    forward (and the window series where the source mass lies in its
    window), per (λ, row, grid point) the density's scale, and the KDE's
    pair terms: those of ``pairs['live']`` (k1a_pairs: the terms that are
    not exactly 0), or every pair where ``pairs`` is None (the all-pairs
    count, which charges the series only)."""
    m1, dl, cosmo, mass, grids = args[0], args[2], args[4], args[5], args[6]
    n, (e, s), g = max(cosmo.L, mass.L), dl.shape, grids.shape[1]
    q = 12 + mass.window_deg
    n_bytes = (dl.element_size() * ((4 * e * s + e * g) + n * q + n * e * (g + 8))
               + 8 * n * (cosmo.cheb_deg + 2))
    if pairs is None:
        return bound(n_bytes, n * e * s * (CHEB_OPS * cosmo.cheb_deg + KDE_OPS * g))
    ops = (n * e * s * (CHEB_OPS * cosmo.cheb_deg + MASS_FWD_OPS)
           + CHEB_OPS * mass.window_deg * window_pairs(cosmo, mass, m1, dl)
           + n * e * g + KDE_OPS * pairs["live"])
    return bound(n_bytes, ops)


def k2b_bound(args, pairs: dict | None = None) -> tuple[float, str]:
    """The least time of K2b on these inputs, operations: on the live
    (λ, row) pairs only (a scale, a weight and a cotangent), the
    (grid point, weighted sample) terms of the closed support
    (``pairs['live']`` of k2b_pairs; every (grid point, weighted sample)
    term where ``pairs`` is None), the per-grid-point products and each
    weighted sample's Clenshaw and mass-model work (adjoint_ops, the
    series summed in double); bytes: the rows, static and per-λ factors,
    cotangents and gradients once each."""
    m1, dl, grids, hs, ct, cosmo, mass = (args[0], args[2], args[4], args[7],
                                          args[12], args[13], args[14])
    n, r_rows = hs.shape[:2]
    chunk = dl.shape[1]
    e, g = grids.shape
    size = dl.element_size()
    weighted = args[3] > 0
    live = (hs[..., 1] != 0) & (ct != 0).any(dim=-1) & weighted.any(dim=1)[None]
    samples = int((live * weighted.sum(dim=1)[None]).sum())
    terms = samples * g if pairs is None else pairs["live"]
    in_window = window_pairs(cosmo, mass, m1, dl,
                             weighted[None] & live[..., None])
    ops = adjoint_ops(dl, cosmo, mass, samples, in_window,
                      terms * K2B_TERM_OPS + int(live.sum()) * K2B_GRID_OPS * g,
                      True)
    q = args[5].shape[1] + 12
    n_bytes = (size * (4 * r_rows * chunk + e * g + 2 * r_rows * g
                       + 4 * n * e * g + 6 * n * r_rows) + 2 * 8 * n * q)
    return bound(n_bytes, *ops)


def k2_pairs(args) -> dict:
    """K2's work on its inputs ``args`` (fused_rows_contract's order): 'all'
    (λ, row, grid point, slot) terms; 'mapped', the (λ, row) pairs with a
    scale, whose slots K2 maps in phase A; 'mapped_dead', those of them
    without a sample of non-zero weight, which K2 then writes as exact
    zeros; 'live_rows', the (λ, row) pairs with a scale and a weight, and
    'samples', their weighted samples (phase A's least work);
    'in_window', those of them whose source mass lies in the CDF's window
    (window_pairs); 'density', the live rows' terms with |g - z| < h and
    w != 0 (the Epanechnikov density's terms that are not exactly 0);
    'tiled', the terms the pruned loop evaluates (_tiled_terms)."""
    m1, m2, dl, invp, cosmo, mass, grids, hs = args[:8]
    (r_rows, chunk), (e, g) = dl.shape, grids.shape
    scaled = hs[..., 1] != 0
    weighted = invp > 0
    out = {"all": hs.shape[0] * r_rows * chunk * g, "density": 0, "tiled": 0}
    with torch.no_grad():
        z, w = _z_and_w(m1, m2, dl, invp, cosmo, mass)
        has_w = (w != 0).any(dim=-1)
        live = scaled & has_w
        out.update(mapped=int(scaled.sum()),
                   mapped_dead=int((scaled & ~has_w).sum()),
                   live_rows=int(live.sum()),
                   samples=int((live * weighted.sum(dim=1)[None]).sum()),
                   in_window=window_pairs(cosmo, mass, m1, dl,
                                          weighted[None] & live[..., None]))
        grid_rows = grids.double().repeat_interleave(r_rows // e, dim=0)
        for l in range(z.shape[0]):
            rows = live[l]
            zz, ww, gg = z[l][rows], w[l][rows], grid_rows[rows]
            hh = 1.0 / hs[l, rows, 0].double()
            out["density"] += _in_support(zz, ww != 0, hh, gg, False)
            out["tiled"] += _tiled_terms(zz, ww, hh, gg)
    return out


def k2_bound(args, pairs: dict | None = None) -> tuple[float, str]:
    """The least time of K2 on these inputs: bytes, the rows, grids, static
    and per-λ factors, (1/h, scale), the model rows and r once each;
    operations, on the live (λ, row) pairs only (a scale and a weight), per
    weighted sample the distance series' Clenshaw sum in double, the mass
    model's forward and, where the source mass lies in the CDF's window,
    the window series in double; per grid point the two products into the
    two sums (K2_GRID_OPS); and the density terms that are not exactly 0
    (``pairs['density']`` of k2_pairs).  Where ``pairs`` is None, the
    all-slots count: every (grid point, slot) term of the rows with a scale
    and a weighted slot, and each slot's series in FP32."""
    m1, dl, cosmo, mass, grids, hs = args[0], args[2], args[4], args[5], \
        args[6], args[7]
    n, r_rows = hs.shape[:2]
    chunk = dl.shape[1]
    e, g = grids.shape
    size = dl.element_size()
    p = 12 + mass.window_deg
    n_bytes = (size * (4 * r_rows * chunk + e * g + 2 * r_rows * g + 2 * n * e * g
                       + 4 * n * r_rows + n * p) + 8 * n * (cosmo.cheb_deg + 2))
    weighted = args[3] > 0
    if pairs is None:
        rows = int(((hs[..., 1] > 0) & weighted.any(dim=1)[None]).sum())
        return bound(n_bytes, rows * chunk * (CHEB_OPS * cosmo.cheb_deg
                                              + KDE_OPS * g))
    ops64 = CHEB_OPS * (pairs["samples"] * cosmo.cheb_deg
                        + pairs["in_window"] * mass.window_deg)
    ops = (pairs["samples"] * MASS_FWD_OPS + KDE_OPS * pairs["density"]
           + pairs["live_rows"] * K2_GRID_OPS * g)
    return bound(n_bytes, 0.0, ops + ops64) if dl.dtype == F64 \
        else bound(n_bytes, ops, ops64)


def k1c_bound(args, per_sample: bool = True) -> tuple[float, str]:
    """The least time of K1c on its inputs ``args`` (fused_row_stats'
    order; logical rows where n_real is given, else every slot is real):
    bytes, the real samples' PE rows, the logical-row arrays, the model rows
    and the stats once each; operations, per (λ, real sample) the distance
    series' Clenshaw sum in double, the mass model's forward (MASS_FWD_OPS)
    and, in the CDF's window, the window series in double, and per (λ,
    logical row) the fillers' distance series.  ``per_sample`` False: the
    all-slots count, the distance series alone in FP32."""
    m1, dl, cosmo, mass = args[0], args[2], args[4], args[5]
    n_real = args[6] if len(args) > 6 else None
    n, (b, s) = max(cosmo.L, mass.L), dl.shape
    size = dl.element_size()
    mask = None
    if n_real is not None:
        mask = torch.arange(s, device=dl.device)[None] < n_real.to(dl.device)[:, None]
    real = int(mask.sum()) if mask is not None else b * s
    p = 12 + mass.window_deg
    n_bytes = (size * (4 * real + n * p + 8 * n * b) + 8 * n * (cosmo.cheb_deg + 2)
               + ((8 + size) * b if n_real is not None else 0))
    if not per_sample:
        return bound(n_bytes, n * real * CHEB_OPS * cosmo.cheb_deg)
    fill_rows = b if n_real is not None else 0
    ops64 = CHEB_OPS * (n * (real + fill_rows) * cosmo.cheb_deg
                        + window_pairs(cosmo, mass, m1, dl, mask) * mass.window_deg)
    ops = n * real * MASS_FWD_OPS
    return bound(n_bytes, 0.0, ops + ops64) if dl.dtype == F64 \
        else bound(n_bytes, ops, ops64)


def dark_gradients(smi: str, full, dark_data, forward_entries: list[dict]
                   ) -> list[dict]:
    """Phases 19-22: K3 in the modes of K1b, K1c and K1d and K2b against
    their plain versions; the card's gradient of the three unbinned paths
    against the CPU's, float32 against float64 and against finite
    differences; value-and-gradient timing at full width with the split by
    kernel; HMC and ChEES on the dark flagship.  Returns the new kernels'
    entries of the kernels line; the dark forward's entries
    (``forward_entries``:
    K1c's, K2's) take their launches from the same HMC run."""
    from chimera_tpu_torch.inference import (sample_hyperposterior,
                                             sample_hyperposterior_chees)
    from chimera_tpu_torch.ops.cuda import launch_counters, launch_counts
    from chimera_tpu_torch.ops.cuda.fused import (_GRID_TILE,
                                                  fused_weights_kde_adjoint,
                                                  fused_weights_kde_adjoint_plain)
    from chimera_tpu_torch.ops.cuda.rows import (fused_rows_contract_adjoint,
                                                 fused_rows_contract_adjoint_plain)

    k3 = (fused_weights_kde_adjoint, fused_weights_kde_adjoint_plain)
    k2b = (fused_rows_contract_adjoint, fused_rows_contract_adjoint_plain)

    def compare(kid, call, tol):
        fn, plain = k2b if kid == "K2b" else k3
        return grad_compare(kid, fn, plain, call[0], call[1], tol)

    # ---- 19. kernels vs plain on 64 events of each cell, L = 4 -----------
    dark64, _ = dark_mock(64, 1024, 15, 500, 100_000, 10_000, SEED + 7)
    spec64 = mock(64, 4096, 200_000, 500, 300, SEED + 3)
    for dtype, tol in ((F64, 1e-9), (F32, 1e-3)):
        x = chain_points(4, dtype)
        hl = dark_likelihood(dark64, dtype)
        lam = batch_of(x)
        cases = [(f"K3c {m}", mode_inputs(hl, m, lam, SEED + 19))
                 for m in ("stats_logical", "stats")]
        cases.append(("K2b", (rows_inputs(hl, lam, SEED + 19), {})))
        cases.append(("K3d ext", mode_inputs(dark_likelihood(dark64, dtype, **DARK_CUT),
                                             "ext", lam, SEED + 19)))
        cases.append(("K3b auto", mode_inputs(likelihood(spec64, dtype, cut_grid=2.0),
                                              "auto", lam, SEED + 19)))
        for name, call in cases:
            rel, abs_err = compare(name.split()[0], call, tol)
            phase(19, f"{name} vs plain {dtype}", f"random cotangents: max err "
                  f"{rel:.3e} of each gradient row's max ({abs_err:.3e} abs, tol "
                  f"{tol:.0e}), equal bits on a second launch [{smi}]")
        # the cotangents each path's own backward hands the kernels
        for path, make, data, cfg in (("dark", dark_likelihood, dark64, DARK),
                                      ("dark_cut", dark_likelihood, dark64, DARK_CUT),
                                      ("spectral_cut", likelihood, spec64,
                                       {"cut_grid": 2.0})):
            calls = backward_calls(make(data, dtype, **cfg), x)
            for kid, call in [(k3_id(c[1]), c) for c in calls["K3"]] + \
                    [("K2b", c) for c in calls["K2b"]]:
                rel, abs_err = compare(kid, call, tol)
                phase(19, f"{kid} on {path}'s cotangents {dtype}", f"max err "
                      f"{rel:.3e} of each gradient row's max ({abs_err:.3e} "
                      f"abs, tol {tol:.0e}) [{smi}]")
    del spec64

    # ---- 20. d log L / dλ of the three paths on 64 dark events -----------
    n = 16
    x = chain_points(n, F64)
    for path, cfg in (("dark", DARK), ("dark_cut", DARK_CUT),
                      ("approx_cut", APPROX_CUT)):
        hl64 = dark_likelihood(dark64, F64, **cfg)
        (ll, g64), _ = counted(lambda: value_and_grad(hl64, x), GRAD_LAUNCHES[path])
        t0 = time.perf_counter()
        ll_cpu, g_cpu = value_and_grad(copy.deepcopy(hl64).to("cpu"), x[:2].cpu())
        seconds = time.perf_counter() - t0
        rel, rel_ll = column_rel(g64[:2].cpu(), g_cpu), \
            ((ll[:2].cpu() - ll_cpu).abs() / ll_cpu.abs()).max().item()
        _, g32 = value_and_grad(dark_likelihood(dark64, F32, **cfg), x.to(F32))
        rel32 = column_rel(g32, g64)

        def log_n_exp(x):
            pop_b = hl64.population.update_batch(batch_of(x))
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
        exp_err = ((g_exp - fd_exp).abs() / fd_exp.abs()).max().item()
        fd = differences(lambda x: log_like(hl64, x), 1e-7)
        fd_err = (g64[:, 0] - fd).abs() / fd.abs()
        fd_med, fd_max = fd_err.median().item(), fd_err.max().item()
        if not (torch.all(torch.isfinite(g64)) and torch.all(torch.isfinite(g32))
                and rel <= 1e-9 and rel_ll <= 1e-10 and rel32 <= 1e-2
                and exp_err <= 1e-6 and fd_med <= 1e-4 and fd_max <= 1e-3):
            raise AssertionError(
                f"gradient {path}: card vs CPU {rel:.3e} (tol 1e-9), log L "
                f"{rel_ll:.3e} (tol 1e-10), float32 vs float64 {rel32:.3e} (tol "
                f"1e-2); d/dH0 vs differences: log N_exp {exp_err:.3e} (tol "
                f"1e-6), log L median {fd_med:.3e} (tol 1e-4), max {fd_max:.3e} "
                f"(tol 1e-3)")
        phase(20, f"gradient {path}", f"d log L/d(H0, Om0, mu_g), {n} chains, 64 "
              f"events of the dark flagship, float64: card vs plain autograd on "
              f"the CPU (2 chains, {seconds:.1f} s) max err {rel:.3e} of each "
              f"parameter's largest slope (tol 1e-9), log L {rel_ll:.3e}; float32 "
              f"vs float64 on the card {rel32:.3e}; d/dH0 vs central differences: "
              f"log N_exp (step 1e-6) {exp_err:.3e} (tol 1e-6), log L (step "
              f"1e-7) median {fd_med:.3e} (tol 1e-4), max {fd_max:.3e} (tol "
              f"1e-3), {int((fd_err > 1e-4).sum())} chains over 1e-4; launches "
              f"{GRAD_LAUNCHES[path]} [{smi}]")
        del hl64
    del dark64

    # ---- 21. value-and-gradient timing at full width, L = 16, float32 ----
    reps = 17
    x = chain_points(n, F32)
    batch = batch_of(x)
    entries = {}
    for path, make, data, cfg in (("dark", dark_likelihood, dark_data, DARK),
                                  ("dark_cut", dark_likelihood, dark_data, DARK_CUT),
                                  ("spectral_cut", likelihood, full,
                                   {"cut_grid": 2.0})):
        hl = make(data, F32, **cfg)
        _, launched = counted(lambda: value_and_grad(hl, x), GRAD_LAUNCHES[path])
        total = cuda_ms(lambda: value_and_grad(hl, x), reps)

        def forward():
            with torch.no_grad():
                hl.log_like_batch(batch)

        fwd = cuda_ms(forward, reps)
        calls = backward_calls(hl, x)
        kernels = [(k3_id(c[1]), c) for c in calls["K3"]] + \
            [("K2b", c) for c in calls["K2b"]]
        split = []
        for kid, (args, kw) in kernels:
            fn, plain = k2b if kid == "K2b" else k3
            kern = cuda_ms(lambda: fn(*args, **kw), reps)
            expect = []
            plain_ms = cuda_ms(lambda: expect.append(plain(*args, **kw)), 1, 0)[0]
            rel, abs_err = grad_compare(kid, fn, plain, args, kw, 1e-3, expect[0])
            extra = ""
            if kid == "K2b":
                pairs = k2b_pairs(args)
                b_ms, b_by = k2b_bound(args, pairs)
                all_ms = k2b_bound(args)[0]
                extra = (f"; on every pair of the live rows {all_ms:.4f} ms; "
                         f"live pairs {pairs['live']} of {pairs['all']} "
                         f"({pairs['live'] / pairs['all']:.4%}; "
                         f"{pairs['live'] / pairs['live_rows']:.4%} of the live "
                         f"rows'), density terms {pairs['density'] / pairs['all']:.4%}"
                         f"; the pruned passes evaluate "
                         f"{pairs['pass1'] / pairs['all']:.4%} and "
                         f"{pairs['pass2'] / pairs['all']:.4%}")
            elif kid == "K3b":
                pairs = k3b_pairs(args, kw)
                b_ms, b_by = k3_bound(args, kw, pairs)
                all_ms = k3_bound(args, kw)[0]
                kept = pairs[f"union{_GRID_TILE}"]
                extra = (f"; on every pair {all_ms:.4f} ms; live pairs "
                         f"{pairs['live']} of {pairs['all']} "
                         f"({pairs['live'] / pairs['all']:.4%}); the pruned "
                         f"phase B evaluates {kept} ({kept / pairs['all']:.4%}"
                         f", tiles of {_GRID_TILE} grid points a warp's slot)")
            elif kid == "K3d":
                pairs = k3d_pairs(args, kw)
                b_ms, b_by = k3_bound(args, kw, pairs)
                all_ms = k3_bound(args, kw)[0]
                kept = pairs[f"run{_GRID_TILE}"]
                extra = (f"; on every pair {all_ms:.4f} ms; live pairs "
                         f"{pairs['live']} of {pairs['all']} real "
                         f"({pairs['live'] / pairs['all']:.4%}); the 4-warp "
                         f"block's slots {pairs['slots']}; the pruned phase B "
                         f"evaluates {kept} ({kept / pairs['all']:.4%}, each "
                         f"warp's slot over its run of {_GRID_TILE}-point "
                         f"tiles; their union {pairs[f'union{_GRID_TILE}']})")
            else:
                b_ms, b_by = k3_bound(args, kw)
            k_call = statistics.median(kern)
            split.append((kid, med_mad([t / n for t in kern])))
            phase(21, f"{kid} on {path}", f"[{smi}] L = {n}: kernel {k_call:.3f} "
                  f"ms per call, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}, {100 * b_ms / k_call:.1f} % of it){extra}; on the "
                  f"path's cotangents max err {rel:.3e} of each gradient row's "
                  f"max ({abs_err:.3e} abs)")
            if kid not in entries:
                name = "fused_rows_contract_adjoint" if kid == "K2b" \
                    else "fused_weights_kde_adjoint"
                entries[kid] = {
                    "name": f"{name} ({kid})", "route": "cuda",
                    "source": "chimera_tpu_torch/csrc/" + (
                        "rows_contract_adjoint.cu" if kid == "K2b"
                        else "fused_kde_adjoint.cu"),
                    "replaces": "chimera_tpu/ops/pallas/fused.py:" + (
                        "605" if kid == "K2b" else "713"),
                    "launches": launched[kid], "max_abs_err": abs_err,
                    "ms": k_call, "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": None}
                if kid in ("K3c", "K3d"):
                    entries[kid]["redesigned"] = 7 if kid == "K3c" else 11
        del calls, kernels
        t_med, t_mad = med_mad([t / n for t in total])
        f_med, f_mad = med_mad([t / n for t in fwd])
        rest = t_med - f_med - sum(m for _, (m, _) in split)
        phase(21, f"timing {path}", f"[{smi}] per λ over {reps} calls of {n} "
              f"(after a warm-up), float32: value and gradient {t_med:.4f} ± "
              f"{t_mad:.4f} ms (median ± MAD); forward {f_med:.4f} ± {f_mad:.4f} "
              f"ms; " + "; ".join(f"{k} {m:.4f} ± {d:.4f} ms" for k, (m, d) in split)
              + f"; rest (glue backward) {rest:.4f} ms; launches per call "
              f"{ {k: v for k, v in launched.items() if v} }")
        del hl

    # ---- 22. HMC and ChEES on the dark flagship, float32 -----------------
    hl = dark_likelihood(dark_data, F32)
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
            for wrapper, attr in launch_counters().values():
                setattr(wrapper, attr, 0)
            t0 = time.perf_counter()
            samples, stats = run(torch.Generator(device=DEV).manual_seed(SEED + 22),
                                 counting_prior(evals))
            torch.cuda.synchronize(DEV)
            seconds = time.perf_counter() - t0
            got = launch_counts()
            runs.append(samples)
            check_samples(name, samples, 4, n)
            want = {k: evals[0] for k in ("K1c", "K2", "K3c", "K2b")}
            if evals[0] < 9 or got != {k: want.get(k, 0) for k in got}:
                raise AssertionError(f"{name}: {evals[0]} gradient evaluations "
                                     f"but launches {got}")
        if not all(torch.equal(runs[0][p], runs[1][p]) for p in PARAMS):
            raise AssertionError(f"{name}: a second run under the same "
                                 "generator seed gave other samples")
        if name == "hmc":  # the launches of the dark flagship's sampler run
            entries["K3c"]["launches"] = got["K3c"]
            entries["K2b"]["launches"] = got["K2b"]
            for kid, entry in zip(("K1c", "K2"), forward_entries):
                entry["launches"] = got[kid]
        phase(22, name, f"dark flagship, {n} chains x (4 warm-up + 4 sampling "
              f"steps) in {PARAMS}: {evals[0]} gradient evaluations = K1c = K2 "
              f"= K3c = K2b launches, {seconds:.2f} s; samples finite and inside "
              f"the bounds, equal bits on a second run; accept "
              f"{float(stats['accept'].mean()):.2f}, step size "
              f"{float(stats['step_size']):.4f}, H0 mean "
              f"{float(samples['H0'].mean()):.2f} [{smi}]")
    return [entries[k] for k in ("K3b", "K3c", "K3d", "K2b")]


# ---------------------------------------------------------------------------
# the contract pass (K1e) and the binned gradient (K4b)
# ---------------------------------------------------------------------------

BINNED = {"binning": True, "num_bins": 200, "cut_grid": 2.0}
# K4b's least work: one sweep over the (row, grid point, bin) terms forms u,
# the kernel and its slope once for the four adjoint sums (d_w, d_z, d_grid,
# d_h), two operations more than K3's term
K4B_TERM_OPS = ADJ_KDE_OPS + 2
# K1e's contraction per (λ, live row, grid point): two products into two sums
K1E_GRID_OPS = 4


def contract_likelihood(data, dtype, cfg=None):
    """The dark-siren likelihood of a mock on the contract path:
    'marginalized', unbinned, cut_grid=None, on a per-pixel layout without
    chunk rows (``chunk_rows=False``, as a JAX object whose ``compact`` has
    no 'rows'): one K1e launch a batch."""
    from chimera_tpu_torch import HyperLikelihood, SelectionFunction

    cat, z_grids, gal_cat, inj, n_gen = data
    return HyperLikelihood._create(
        cat, z_grids, population(dtype, gal_cat, z_grids.device, cfg),
        SelectionFunction.create(inj, n_gen), kind="marginalized",
        kernel="epan", bw_method=None, cut_grid=None, binning=False,
        num_bins=200, pe_neff=2.0, chunk_rows=False)


def contract_inputs(hl, lam: dict, kernel=None):
    """K1e's arguments and keywords on a contract-path likelihood's data at
    the batch ``lam``, as ``_numerators_marginalized_contract`` passes
    them."""
    pop_b = hl.population.update_batch(lam)
    f1, f2, _ = hl.lambda_factors(pop_b)
    args = (hl.pix_m1det, hl.pix_m2det, hl.pix_dL, hl.pix_inv_pe_prior,
            pop_b.cosmo, pop_b.mass,
            hl.z_grids.repeat_interleave(hl.n_pixels, dim=0))
    kw = {"kernel": kernel or hl.kernel, "n_real": hl.pix_n_real,
          "dl_fill": hl.pix_dl_fill, "logical_s": hl.n_samples,
          "den_scale": "unit", "contract": (hl.pix_s1, hl.pix_s2, f1, f2)}
    return args, kw


def contract_compare(args, kw, r_tol, stat_tol):
    """K1e against its plain version on the same inputs: r1 and r2 relative
    to their largest value over the rows of each λ, exact zeros on the rows
    without weight, the stats relative on the rows with weight.  Returns
    (r rel, r abs, stats rel)."""
    from chimera_tpu_torch.ops.cuda.fused import (fused_weights_kde,
                                                  fused_weights_kde_plain)

    r_k, st_k = fused_weights_kde(*args, **kw)
    r_p, st_p = fused_weights_kde_plain(*args, **kw)
    torch.cuda.synchronize(DEV)
    live = st_p["sum_w"] > 0
    if live.float().mean() < 0.3 or live.all():
        raise AssertionError(f"{int(live.sum())} of {live.numel()} (λ, row) "
                             "pairs with weight")
    if not (torch.all(r_k[~live] == 0) and torch.all(r_p[~live] == 0)):
        raise AssertionError("K1e: a row without weight did not give 0")
    r_rel = row_rel(r_k, r_p)
    r_abs = (r_k.double() - r_p.double()).abs().max().item()
    stat_rel = max(((st_k[k].double() - st_p[k].double()).abs()
                    / st_p[k].double().abs())[live].max().item()
                   for k in ("norms", "neff", "bandwidth", "sum_w", "sum_w2"))
    if not (r_rel <= r_tol and stat_rel <= stat_tol):
        raise AssertionError(
            f"K1e vs plain: r {r_rel:.3e} (tol {r_tol:.0e}) of the per-λ max, "
            f"stats {stat_rel:.3e} (tol {stat_tol:.0e}) relative")
    return r_rel, r_abs, stat_rel


def k1e_pairs(args, kw) -> dict:
    """K1e's pair terms on its inputs (fused_weights_kde's, the contract
    mode on logical pixel rows): 'all' (λ, row, grid point, real sample);
    'live_rows', the (λ, row) pairs whose weight is above sqrt(tiny)
    float32 (the others get r = 0 with no loop); 'live', those rows' terms
    with |g - z| < h and w != 0, the terms of the Epanechnikov density that
    are not exactly 0; 'tiled', those the pruned loop evaluates
    (_tiled_terms on each row's real samples).  h, z and w are the plain
    stats pass's on the logical rows, in float64."""
    from chimera_tpu_torch.ops.cuda.fused import fused_row_stats_plain

    m1, m2, dl, invp, cosmo, mass, grids = args[:7]
    (b, s), g = dl.shape, grids.shape[1]
    n_real = kw["n_real"].to(dl.device).clamp(0, s)
    real = torch.arange(s, device=dl.device)[None] < n_real[:, None]
    rows = 1000  # a chunk's rows
    with torch.no_grad():
        st = fused_row_stats_plain(m1, m2, dl, invp, cosmo, mass,
                                   n_real=kw["n_real"], dl_fill=kw["dl_fill"],
                                   logical_s=kw["logical_s"])
        z, w = _z_and_w(m1, m2, dl, invp, cosmo, mass)
        grid = grids.double()
        live_rows = st["sum_w"].double() > 1.0842021724855044e-19
        out = {"all": z.shape[0] * int(real.sum()) * g,
               "live_rows": int(live_rows.sum()), "live": 0, "tiled": 0}
        for l in range(z.shape[0]):
            h = st["bandwidth"][l].double()
            for r0 in range(0, b, rows):
                sl = slice(r0, r0 + rows)
                rr = real[sl] & live_rows[l, sl, None]
                zz, ww, gg, hh = z[l, sl], w[l, sl], grid[sl], h[sl]
                out["live"] += _in_support(zz, (ww != 0) & rr, hh, gg, False)
                out["tiled"] += _tiled_terms(zz, ww, hh, gg, real=rr)
    return out


def k1e_bound(args, kw, pairs: dict | None = None) -> tuple[float, str]:
    """The least time of K1e on these inputs: the PE rows of the real
    samples, the grids, the factors, the model rows, r and the stats,
    bytes; operations, per (λ, real sample) the distance series' Clenshaw
    sum in double, the mass model's forward and, in the CDF's window, the
    window series in double, per (λ, logical row) the fillers' distance
    series, the density terms that are not exactly 0 (``pairs['live']`` of
    k1e_pairs) and the contraction of each live (λ, row) (K1c's phase A,
    K1E_GRID_OPS a grid point).  Where ``pairs`` is None, the all-pairs
    count: each real sample's series and KDE terms on every
    grid point and the contraction of each row with samples, FP32."""
    m1, dl, cosmo, mass, grids = args[0], args[2], args[4], args[5], args[6]
    s1, _, f1, _ = kw["contract"]
    n, e_ev, g = f1.shape
    b, s = dl.shape
    size = dl.element_size()
    real = int(kw["n_real"].sum())
    live = int((kw["n_real"] > 0).sum())
    q = 12 + mass.window_deg
    n_bytes = (size * (4 * real + b + 3 * b * g + 2 * n * e_ev * g + n * q
                       + n * b * (2 + 8)) + 8 * b
               + 8 * n * (cosmo.cheb_deg + 2 + mass.window_deg))
    if pairs is None:
        return bound(n_bytes, n * real * (CHEB_OPS * cosmo.cheb_deg + KDE_OPS * g)
                     + n * live * g * K1E_GRID_OPS)
    mask = torch.arange(s, device=dl.device)[None] < kw["n_real"].to(dl.device)[:, None]
    ops64 = CHEB_OPS * (n * (real + b) * cosmo.cheb_deg
                        + window_pairs(cosmo, mass, m1, dl, mask) * mass.window_deg)
    ops = (n * real * MASS_FWD_OPS + KDE_OPS * pairs["live"]
           + pairs["live_rows"] * g * K1E_GRID_OPS)
    return bound(n_bytes, 0.0, ops + ops64) if dl.dtype == F64 \
        else bound(n_bytes, ops, ops64)


def k4b_bound(args, pairs: dict | None = None) -> tuple[float, str]:
    """The least time of K4b on these inputs: z, w, the grids, h, out and
    d_out read once, the four cotangents written once, bytes; operations,
    the (row, grid point, bin) terms that are not exactly 0
    (``pairs['live']`` of k4b_pairs), each formed once for the four sums, at
    the FP64 rate (the sums need double: kde.cuh, kde_row_adjoint); where
    ``pairs`` is None, every (row, grid point, bin) term as FP32 operations
    (the all-pairs count of PRs 6-9)."""
    z, grids = args[0], args[2]
    b, s = z.shape
    g = grids.shape[1]
    n_bytes = z.element_size() * (4 * b * s + 4 * b * g + 2 * b)
    if pairs is None:
        return bound(n_bytes, b * g * s * K4B_TERM_OPS)
    return bound(n_bytes, 0.0, pairs["live"] * K4B_TERM_OPS)


def contract_path(smi: str, dark_data) -> dict:
    """Phase 23: K1e against its plain version, the contract path against
    the rows path, end to end at the flagship width (one K1e launch a
    batch), float32 vs float64 on the dark precision mock, timing next to
    the rows path.  Returns K1e's entry of the kernels line."""
    from chimera_tpu_torch.ops.cuda.fused import (fused_weights_kde,
                                                  fused_weights_kde_plain)

    h0s = torch.linspace(55.0, 95.0, 16, device=DEV)
    h0s4 = torch.linspace(60.0, 80.0, 4, device=DEV)
    batch = {"H0": h0s.to(F32)}
    n, reps = len(h0s), 17

    # ---- 23. K1e vs plain at 64 events, L = 4; the two paths agree -------
    dark64, _ = dark_mock(64, 1024, 15, 500, 100_000, 10_000, SEED + 7)
    for dtype, tol in ((F64, 1e-10), (F32, 1e-4)):
        hl = contract_likelihood(dark64, dtype)
        lam = {"H0": h0s4.to(dtype)}
        args, kw = captured("fused_weights_kde", lambda: hl.log_like_batch(lam))
        r_rel, _, stat_rel = contract_compare(args, kw, tol, tol)
        ll_c = hl.log_like_batch(lam).double()
        ll_r = dark_likelihood(dark64, dtype).log_like_batch(lam).double()
        rel_paths = ((ll_c - ll_r).abs() / ll_r.abs()).max().item()
        # float64 holds the two paths to 1e-10; float32 is reported
        if dtype == F64 and not rel_paths <= 1e-10:
            raise AssertionError(f"contract vs rows path: log L {rel_paths:.3e}")
        phase(23, f"K1e vs plain {dtype}", f"{hl.n_events} events, "
              f"{args[2].shape[0]} pixel rows x {args[2].shape[1]} slots x "
              f"{args[6].shape[1]} grid, L = 4: r max err {r_rel:.3e} of the "
              f"per-λ max, stats {stat_rel:.3e} (tol {tol:.0e}); log L vs the "
              f"rows path (K1c + K2) {rel_paths:.3e} [{smi}]")
        del hl, args, kw
    del dark64

    # ---- 23. end to end at build_dark's width, float32 -------------------
    hl = contract_likelihood(dark_data, F32)
    torch.cuda.reset_peak_memory_stats(DEV)
    ll, _ = counted(lambda: hl.log_like_batch(batch), {"K1e": 1})
    peak = torch.cuda.max_memory_allocated(DEV) / 2**30
    check_log_like(ll, h0s, {"K1e": 1})
    par = parity_dark_mock(DEV)
    rel, diff, n_fin = f32_vs_f64(contract_likelihood(par, F64),
                                  contract_likelihood(par, F32),
                                  torch.linspace(58.0, 100.0, 7, device=DEV))
    del par
    b, s_pp = hl.pix_dL.shape
    phase(23, "contract path", f"'marginalized', cut_grid=None, no chunk rows: "
          f"{hl.n_events} events x {hl.n_samples} samples x "
          f"{hl.z_grids.shape[1]} grid, {b} pixel rows x {s_pp} slots, "
          f"{int(hl.pix_n_real.sum())} real samples; launches K1e 1, K1c/K2 0; "
          f"peak memory {peak:.2f} GiB; H0 argmax "
          f"{h0s[int(torch.argmax(ll))].item():.2f}; log L = "
          f"{[round(v, 4) for v in ll.tolist()]}; float32 vs float64 on "
          f"{PARITY_DARK.name}: {rel:.3e} (bar 1e-6), max abs {diff:.3e}, over "
          f"{n_fin} of 7 H0 values [{smi}]")

    # ---- 23. timing at full width, next to the rows path -----------------
    total = cuda_ms(lambda: hl.log_like_batch(batch), reps)
    args, kw = captured("fused_weights_kde", lambda: hl.log_like_batch(batch))
    kern = cuda_ms(lambda: fused_weights_kde(*args, **kw), reps)
    plain = cuda_ms(lambda: fused_weights_kde_plain(*args, **kw), 1, 0)
    r_rel, r_abs, stat_rel = contract_compare(args, kw, 1e-4, 1e-4)
    rows_hl = dark_likelihood(dark_data, F32)
    rows_total = cuda_ms(lambda: rows_hl.log_like_batch(batch), reps)
    del rows_hl
    t_med, t_mad = med_mad([t / n for t in total])
    k_med, k_mad = med_mad([t / n for t in kern])
    r_med, r_mad = med_mad([t / n for t in rows_total])
    pairs = k1e_pairs(args, kw)
    b_ms, b_by = k1e_bound(args, kw, pairs)
    k_call = statistics.median(kern)
    phase(23, "timing", f"[{smi}] per λ over {reps} batches of {n}: contract "
          f"path {t_med:.4f} ± {t_mad:.4f} ms (median ± MAD), K1e {k_med:.4f} ± "
          f"{k_mad:.4f} ms, rest {t_med - k_med:.4f} ms; rows path (K1c + K2) "
          f"{r_med:.4f} ± {r_mad:.4f} ms; K1e per call {k_call:.3f} ms, plain "
          f"{plain[0]:.3f} ms, bound {b_ms:.4f} ms ({b_by}, "
          f"{100 * b_ms / k_call:.1f} % of it; on every pair "
          f"{k1e_bound(args, kw)[0]:.4f} ms); live terms {pairs['live']} of "
          f"{pairs['all']} ({pairs['live'] / pairs['all']:.4%}), the pruned "
          f"loop evaluates {pairs['tiled']} ({pairs['tiled'] / pairs['all']:.4%}); "
          f"r max err {r_rel:.3e} of the per-λ max, stats {stat_rel:.3e}")
    return {"name": "fused_weights_kde contract (K1e)", "route": "cuda",
            "source": "chimera_tpu_torch/csrc/fused_kde.cu",
            "replaces": "chimera_tpu/ops/pallas/fused.py:192", "launches": 1,
            "max_abs_err": r_abs, "ms": k_call, "plain_ms": plain[0],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "redesigned": 12}


def binned_gradients(smi: str, full, dark_data) -> dict:
    """Phases 24-25: the gradient of the reference's defaults (binning=True,
    num_bins=200, cut_grid=2.0) for '1d' (the spectral headline) and
    'marginalized' (the dark flagship): K4b against its plain version on
    each path's own cotangents, the card's float64 gradient against the
    CPU's at 64 events, exactly one K4 and one K4b a gradient call,
    value-and-gradient timing and peak memory at full width; HMC and ChEES
    on the binned spectral headline.  Returns K4b's entry of the kernels
    line."""
    from chimera_tpu_torch.inference import (sample_hyperposterior,
                                             sample_hyperposterior_chees)
    from chimera_tpu_torch.ops.cuda import kde, launch_counters, launch_counts
    from chimera_tpu_torch.ops.cuda.fused import _K4B_TILE
    from chimera_tpu_torch.ops.cuda.kde import (kde1d_grid_adjoint,
                                                kde1d_grid_adjoint_plain)

    k4b = (kde1d_grid_adjoint, kde1d_grid_adjoint_plain)
    n, reps = 16, 17
    once = {"K4": 1, "K4b": 1}

    def k4b_call(hl, x):
        return calls_of(kde, "kde1d_grid_adjoint",
                        lambda: value_and_grad(hl, x))[-1]

    # ---- 24. 64 events: the card vs the CPU, K4b vs plain ----------------
    dark64, _ = dark_mock(64, 1024, 15, 500, 100_000, 10_000, SEED + 7)
    x = chain_points(n, F64)
    for name, make, data in (("spectral", likelihood, cut_events(full, 64)),
                             ("dark", dark_likelihood, dark64)):
        hl64 = make(data, F64, **BINNED)
        (ll, g64), _ = counted(lambda: value_and_grad(hl64, x), once)
        t0 = time.perf_counter()
        ll_cpu, g_cpu = value_and_grad(copy.deepcopy(hl64).to("cpu"), x[:4].cpu())
        seconds = time.perf_counter() - t0
        rel = column_rel(g64[:4].cpu(), g_cpu)
        rel_ll = ((ll[:4].cpu() - ll_cpu).abs() / ll_cpu.abs()).max().item()
        hl32 = make(data, F32, **BINNED)
        _, g32 = value_and_grad(hl32, x.to(F32))
        rel32 = column_rel(g32, g64)
        if not (torch.all(torch.isfinite(g64)) and torch.all(torch.isfinite(g32))
                and rel <= 1e-9 and rel_ll <= 1e-10):
            raise AssertionError(
                f"binned gradient {name}: card vs CPU {rel:.3e} (tol 1e-9), "
                f"log L {rel_ll:.3e} (tol 1e-10), float32 {rel32:.3e}")
        errs = [grad_compare("K4b", *k4b, *k4b_call(h, xx), tol)[0]
                for h, xx, tol in ((hl64, x, 1e-9), (hl32, x.to(F32), 1e-3))]
        phase(24, f"binned gradient {name}", f"d log L/d(H0, Om0, mu_g), {n} "
              f"chains, 64 events, binning=True, num_bins=200, cut_grid=2.0, "
              f"float64: K4 + K4b on the card vs plain autograd on the CPU "
              f"(4 chains, {seconds:.1f} s) max err {rel:.3e} of each "
              f"parameter's largest slope (tol 1e-9), log L {rel_ll:.3e}; "
              f"float32 vs float64 on the card {rel32:.3e}; K4b vs plain on the "
              f"path's cotangents {errs[0]:.3e} (float64, tol 1e-9), "
              f"{errs[1]:.3e} (float32, tol 1e-3); launches {once} [{smi}]")
        del hl64, hl32
    del dark64

    # ---- 24. value-and-gradient timing at full width, L = 16, float32 ----
    x = chain_points(n, F32)
    batch = batch_of(x)
    entry = None
    for name, make, data in (("spectral", likelihood, full),
                             ("dark", dark_likelihood, dark_data)):
        hl = make(data, F32, **BINNED)
        torch.cuda.reset_peak_memory_stats(DEV)
        counted(lambda: value_and_grad(hl, x), once)
        peak = torch.cuda.max_memory_allocated(DEV) / 2**30
        total = cuda_ms(lambda: value_and_grad(hl, x), reps)

        def forward():
            with torch.no_grad():
                hl.log_like_batch(batch)

        fwd = cuda_ms(forward, reps)
        args, kw = k4b_call(hl, x)
        kern = cuda_ms(lambda: kde1d_grid_adjoint(*args, **kw), reps)
        expect = []
        plain_ms = cuda_ms(lambda: expect.append(kde1d_grid_adjoint_plain(
            *args, **kw)), 1, 0)[0]
        rel, abs_err = grad_compare("K4b", *k4b, args, kw, 1e-3, expect[0])
        del expect
        t_med, t_mad = med_mad([t / n for t in total])
        f_med, f_mad = med_mad([t / n for t in fwd])
        k_med, k_mad = med_mad([t / n for t in kern])
        pairs = k4b_pairs(args)
        b_ms, b_by = k4b_bound(args, pairs)
        all_ms = k4b_bound(args)[0]
        kept = pairs[f"union{_K4B_TILE}"]
        k_call = statistics.median(kern)
        b, s = args[0].shape
        phase(24, f"timing binned {name}", f"[{smi}] per λ over {reps} calls "
              f"of {n}, float32: value and gradient {t_med:.4f} ± {t_mad:.4f} "
              f"ms (median ± MAD); forward {f_med:.4f} ± {f_mad:.4f} ms; K4b "
              f"{k_med:.4f} ± {k_mad:.4f} ms; rest (glue backward) "
              f"{t_med - f_med - k_med:.4f} ms; peak memory of one call "
              f"{peak:.2f} GiB; K4b per call {k_call:.3f} ms at {b} rows x {s} "
              f"bins x {args[2].shape[1]} grid, plain {plain_ms:.3f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}, {100 * b_ms / k_call:.1f} % of it; on "
              f"every pair {all_ms:.4f} ms); live terms {pairs['live']} of "
              f"{b * s * args[2].shape[1]} ({2 * pairs['live'] / pairs['all']:.4%}"
              f"), the pruned sweeps evaluate {kept} of the full sweeps' "
              f"{pairs['all']} ({kept / pairs['all']:.4%}, tiles of "
              f"{_K4B_TILE}); on the path's cotangents max err {rel:.3e} of "
              f"each row's max ({abs_err:.3e} abs)")
        entry = {"name": "kde1d_grid_adjoint (K4b)", "route": "cuda",
                 "source": "chimera_tpu_torch/csrc/kde1d.cu",
                 "replaces": "chimera_tpu/ops/kde.py:94", "launches": 1,
                 "max_abs_err": abs_err, "ms": k_call, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        del hl, args, kw

    # ---- 25. HMC and ChEES on the binned spectral headline, float32 ------
    hl = likelihood(full, F32, **BINNED)
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
            for wrapper, attr in launch_counters().values():
                setattr(wrapper, attr, 0)
            t0 = time.perf_counter()
            samples, stats = run(torch.Generator(device=DEV).manual_seed(SEED + 25),
                                 counting_prior(evals))
            torch.cuda.synchronize(DEV)
            seconds = time.perf_counter() - t0
            got = launch_counts()
            runs.append(samples)
            check_samples(name, samples, 4, n)
            want = {"K4": evals[0], "K4b": evals[0]}
            if evals[0] < 9 or got != {k: want.get(k, 0) for k in got}:
                raise AssertionError(f"{name}: {evals[0]} gradient evaluations "
                                     f"but launches {got}")
        if not all(torch.equal(runs[0][p], runs[1][p]) for p in PARAMS):
            raise AssertionError(f"{name}: a second run under the same "
                                 "generator seed gave other samples")
        if name == "hmc":
            entry["launches"] = evals[0]
        phase(25, name, f"binned spectral headline (binning=True, "
              f"num_bins=200, cut_grid=2.0), {n} chains x (4 warm-up + 4 "
              f"sampling steps) in {PARAMS}: {evals[0]} gradient evaluations = "
              f"K4 = K4b launches, {seconds:.2f} s; samples finite and inside "
              f"the bounds, equal bits on a second run; accept "
              f"{float(stats['accept'].mean()):.2f}, step size "
              f"{float(stats['step_size']):.4f}, H0 mean "
              f"{float(samples['H0'].mean()):.2f} [{smi}]")
    return entry


# ---------------------------------------------------------------------------
# kind 'full' (the 3-D lattice KDE, K5) and the ensemble sampler
# ---------------------------------------------------------------------------

FULL = {"kind": "full", "cut_grid": 2.0}
# K5's least work: a term of the dense z sweep (u = zl + t, -0.5 u u, the
# exp's scaling, the fma into the sum, an FMA counted 2) and of the
# recurrence (the add into the sum, v *= r, r *= rho); a refresh per
# (sample, K-point block): u0, -0.5 u0 u0, e times the exp, the r argument
# (an fma), the two exps' scalings, the flush's compare
K5_DENSE_OPS, K5_REC_OPS, K5_REFRESH_OPS = 6, 3, 9


def k5_terms(args, live: bool = False) -> dict:
    """K5's (λ, event, real pixel, grid point, sample) terms on a call's
    inputs: on every sample and on the samples with weight (the others'
    sky factor is exactly 0), split by the event's path (dense sweep,
    recurrence) and the recurrence's refreshes (per sample and K-point
    block of the padded grid); the plan's event counts per K; the (λ,
    real pixel) rows of the recurrence whose masks exceed the pruned walk's
    capacity (they run the unpruned walk, K5_MASK_WORDS).  With ``live``,
    also the refreshes that the kernel's flush keeps and the recurrence
    terms they carry (``k5_live``)."""
    _, w, _, _, _, _, mask, grids, z_block = args[:9]
    n, _, s = w.shape
    g = grids.shape[1]
    pix = mask.sum(dim=1).double()                                # (E,)
    live_s = (w > 0).sum(dim=-1).double()                         # (L, E)
    k = torch.clamp(z_block.long(), max=g)
    blocks = torch.where(k > 0, -(-g // torch.clamp(k, min=1)), 0).double()
    dense = (k == 0).double()
    out = {"all": float(n * s * g * pix.sum()),
           "live": float((live_s * pix).sum() * g),
           "dense": float((live_s * pix * dense).sum() * g),
           "refresh": float((live_s * pix * blocks).sum())}
    out["recurrence"] = out["live"] - out["dense"]
    out["plan"] = {int(t): int((z_block == t).sum()) for t in (32, 16, 8, 0)}
    over = (k > 0) & (blocks * -(-s // 32) > K5_MASK_WORDS)
    out["unpruned_rows"] = int(n * pix[over].sum())
    if live:
        out.update(k5_live(args))
    return out


# K5's pruned walk keeps its masks (a bit per (K-point block, sample)) in
# kde3d.cuh::kMaskWords 32-bit words
K5_MASK_WORDS = 2048


def k5_live(args, chunk: int = 8) -> dict:
    """About the refreshes of K5's recurrence (per λ, event, real pixel,
    K-point block, sample) that the kernel's flush keeps, v = e exp(-u0^2 /
    2) >= the working dtype's smallest normal: a PyTorch recount of that
    test on the card in the working dtype, ``chunk`` events at a time, with
    e, t and the block starts formed in double from coordinates centred on
    the weighted mean and then rounded, as ``kde3d.cuh`` forms them, but on
    the plain version's whitening (``ops/kde.py::_whitening``) and without
    the kernel's own order of roundings (``block_start``), so that it may
    count a refresh at the flush's edge that the kernel flushes, or the
    reverse; and the recurrence terms (grid points) of those refreshes: K a
    block, fewer in the padded last.  A (λ, event) without a whitening has
    none.  The bound's count, not the kernel's."""
    from chimera_tpu_torch.ops.kde import _whitening

    z, w, ra, dec, ra_pix, dec_pix, mask, grids, z_block = args[:9]
    dt, n = z.dtype, z.shape[0]
    tiny = torch.finfo(dt).tiny
    g = grids.shape[1]
    kk = torch.clamp(z_block.long(), max=g)
    refresh = terms = 0
    for k in sorted(set(kk.tolist()) - {0}):
        j_n = -(-g // k)
        starts = torch.arange(j_n, device=z.device, dtype=F64) * k
        width = torch.clamp(g - starts, max=k)                        # (J,)
        idx = torch.nonzero(kk == k).reshape(-1)
        for i in range(0, idx.numel(), chunk):
            sel = idx[i:i + chunk]
            zz = z[:, sel].double()                                   # (L, c, S)
            rr = ra[sel].double()[None].expand_as(zz)
            dd = dec[sel].double()[None].expand_as(zz)
            wn, wh, _ = _whitening(torch.stack([zz, rr, dd], dim=-2),
                                   w[:, sel].double(), None)
            mean = [torch.sum(wn * x, dim=-1, keepdim=True) for x in (zz, rr, dd)]
            l00, l10, l20 = wh[..., 0, 0, None], wh[..., 1, 0, None], wh[..., 2, 0, None]
            l11, l21, l22 = wh[..., 1, 1, None], wh[..., 2, 1, None], wh[..., 2, 2, None]
            rp = ra_pix[sel].double()[None] - mean[1]                 # (L, c, P)
            dp = dec_pix[sel].double()[None] - mean[2]
            c0, c1, c2 = l10 * rp + l20 * dp, l11 * rp + l21 * dp, l22 * dp
            dz, dr, dd = zz - mean[0], rr - mean[1], dd - mean[2]     # (L, c, S)
            q1 = c1[..., None] - (l11 * dr + l21 * dd)[:, :, None]    # (L, c, P, S)
            q2 = c2[..., None] - (l22 * dd)[:, :, None]
            e = (wn[:, :, None] * torch.exp(-0.5 * (q1 * q1 + q2 * q2))).to(dt)
            t = (c0[..., None] - (l00 * dz + l10 * dr + l20 * dd)[:, :, None]).to(dt)
            del q1, q2
            step = (grids[sel, -1].double() - grids[sel, 0].double()) / max(g - 1, 1)
            zl_start = l00 * (grids[sel, 0].double()[None, :, None] - mean[0])
            zl0 = (zl_start + starts * (l00 * step[None, :, None])).to(dt)  # (L, c, J)
            u0 = zl0[:, :, None, :, None] + t[:, :, :, None, :]       # (L, c, P, J, S)
            v = e[:, :, :, None, :] * torch.exp(torch.tensor(-0.5, dtype=dt) * u0 * u0)
            keep = (v >= tiny) & mask[sel][None, :, :, None, None]
            del u0, v
            per_block = keep.sum(dim=(0, 1, 2, 4)).double()           # (J,)
            refresh += int(per_block.sum())
            terms += int((per_block * width).sum())
    return {"refresh_live": float(refresh), "recurrence_live": float(terms)}


def k5_bound(args, terms: dict, live: bool = True) -> tuple[float, str]:
    """K5's least time on the card (float32): its inputs read once and its
    output written once, against the FP32 operations of its terms and the
    exps of the dense terms and of the refreshes at the MUFU rate.  With
    ``live`` (``terms`` from ``k5_terms(..., live=True)``) the recurrence
    counts only the refreshes its flush keeps and their terms (a flushed
    refresh adds exactly +0 to every sum), else every weighted sample's."""
    z, w, ra, dec, ra_pix, dec_pix, mask, grids, z_block = args[:9]
    size = z.element_size()
    n, e, _ = z.shape
    n_bytes = size * (z.numel() + w.numel() + ra.numel() + dec.numel()
                      + ra_pix.numel() + dec_pix.numel() + grids.numel()
                      + n * e * ra_pix.shape[1] * grids.shape[1]) \
        + mask.numel() + 4 * z_block.numel()
    rec, ref = ((terms["recurrence_live"], terms["refresh_live"]) if live
                else (terms["recurrence"], terms["refresh"]))
    ops = (K5_DENSE_OPS * terms["dense"] + K5_REC_OPS * rec
           + K5_REFRESH_OPS * ref)
    return bound(n_bytes, ops, n_mufu=terms["dense"] + 2 * ref)


def k5_compare(args, kw, tol: float):
    """K5 against its plain version on the same inputs, per (λ, event,
    pixel) row relative to the row's max, on the real pixels; a float32
    call against the plain version in float64 on the same (float32) inputs
    (the float32 plain version whitens raw coordinates, as the JAX package
    does, and cancels digits of L11 ra ~ 1e2, which the kernel's centred
    coordinates keep), rows below 1e-20 of their (λ, event)'s largest
    value held at that floor (float32 sky factors underflow there).  A
    (λ, event) whose whitening does not exist (a singular covariance, as
    of two samples with weight) is NaN in both, on the same real rows,
    and nowhere else is either not finite.  Returns (max rel, max abs, rows
    under the floor, NaN rows)."""
    from chimera_tpu_torch.ops.cuda.kde3d import lattice_kde3d, lattice_kde3d_plain

    got = lattice_kde3d(*args, **kw).double()
    wide = [a.double() if a.is_floating_point() else a for a in args]
    expect = lattice_kde3d_plain(*wide, **kw)
    torch.cuda.synchronize(DEV)
    real = args[6][None].expand(expect.shape[:3])
    if not torch.all(got[~real] == 0):
        raise AssertionError("a fake pixel's row is not 0")
    nan = torch.isnan(expect).all(dim=-1) & real
    if not (torch.equal(torch.isnan(got).all(dim=-1) & real, nan)
            and torch.isfinite(got[real & ~nan]).all()
            and torch.isfinite(expect[real & ~nan]).all()):
        raise AssertionError("K5 vs plain: their non-finite values differ")
    got, expect = (t.masked_fill(nan[..., None], 0.0) for t in (got, expect))
    row = expect.abs().amax(dim=-1, keepdim=True)
    floor = 0.0 if args[0].dtype == F64 else 1e-20
    event = row.amax(dim=2, keepdim=True)
    scale = torch.maximum(row, floor * event).clamp_min(1e-300)
    rel = ((got - expect).abs() / scale)[real]
    if not torch.all(torch.isfinite(rel)) or rel.max().item() > tol:
        raise AssertionError(f"K5 vs plain: {rel.max().item():.3e} of the row "
                             f"max > {tol:.0e}")
    under = int(((row < floor * event) & real[..., None]).sum())
    return (rel.max().item(), (got - expect).abs()[real].max().item(), under,
            int(nan.sum()))


FULL_STAGES = ("update_batch", "theta_src_and_weights", "norms and gate",
               "K5", "norm, z and pixel masks, gate with nan_to_num",
               "_integrate_pixels", "n_exp", "log and finish")


def full_stages(hl, batch: dict, reps: int = 17) -> dict:
    """A 'full' batch split into the stages of ``log_like_batch`` and
    ``p_gw_full`` (FULL_STAGES), a CUDA event after each: the
    median ms per λ of each stage over ``reps`` batches after a warm-up.
    The staged log L must be log_like_batch's bits."""
    from chimera_tpu_torch import likelihood as lk

    def staged(marks: list):
        def mark():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)

        mark()
        pop_b = hl.population.update_batch(batch)
        mark()
        theta = lk.ThetaPEDet(m1det=hl.m1det, m2det=hl.m2det, dL=hl.dL,
                              pe_prior=hl.pe_prior)
        th_src, w = lk.theta_src_and_weights(pop_b, theta)
        mark()
        z = th_src.z
        norms = torch.mean(w, dim=-1)
        sum_w, sum_w2 = torch.sum(w, dim=-1), torch.sum(w * w, dim=-1)
        gate = sum_w * sum_w / sum_w2 >= hl.pe_neff
        mark()
        p = lk.lattice_kde3d(z, w, hl.ra, hl.dec, hl.full_ra_pix,
                             hl.full_dec_pix, hl.pixel_mask, hl.z_grids,
                             hl.z_block, bw_method=hl.bw_method)
        mark()
        p = p * norms[..., None, None]
        c, zg = hl.cut_grid, hl.z_grids[None]
        sig = torch.std(z, dim=-1, correction=0, keepdim=True)
        z_mask = (zg <= torch.amax(z, dim=-1, keepdim=True) + c * sig) & (
            zg >= torch.amin(z, dim=-1, keepdim=True) - c * sig)
        p = p * z_mask[:, :, None, :]
        p = p * hl.pixel_mask[None, :, :, None]
        p = torch.where(gate[..., None, None], torch.nan_to_num(p), 0.0)
        mark()
        num = hl._integrate_pixels(pop_b, p)
        mark()
        n_exp = hl.selection.n_exp(pop_b)
        mark()
        out = hl.finish(pop_b, hl.sum_log_evs(num), n_exp, hl.n_events_real)
        mark()
        return out

    ll = staged([])
    torch.cuda.synchronize(DEV)
    if not same_bits(ll, hl.log_like_batch(batch)):
        raise AssertionError("the staged 'full' batch is not log_like_batch's")
    n = len(next(iter(batch.values())))
    times = {name: [] for name in FULL_STAGES}
    for _ in range(reps):
        marks = []
        staged(marks)
        torch.cuda.synchronize(DEV)
        for name, a, b in zip(FULL_STAGES, marks, marks[1:]):
            times[name].append(a.elapsed_time(b) / n)
    return {name: statistics.median(t) for name, t in times.items()}


def full_path(smi: str, dark_data) -> tuple[dict, object]:
    """Phases 26-27: K5 against its plain version on the 'full' path's
    inputs at 128 events of the dark width with a mixed plan, and kind
    'full' end to end at the dark width (cut_grid=2.0, L = 16): one K5
    launch a batch, K5 against the float64 plain version on the batch's
    own inputs, float32 vs float64 on the dark precision mock, timing split
    into K5 and the glue, the bound, the plan; a call that requires grad
    raises.  Returns
    K5's entry of the kernels line (its launches filled in by phase 28)
    and the float32 likelihood."""
    from chimera_tpu_torch.ops.cuda.kde3d import lattice_kde3d, lattice_kde3d_plain

    h0s = torch.linspace(55.0, 95.0, 16, device=DEV)
    batch = {"H0": h0s.to(F32)}
    n, reps = len(h0s), 17

    # ---- 26. K5 vs plain at 128 events of the dark width, L = 16 ---------
    small, _ = dark_mock(128, 1024, 15, 500, 100_000, 10_000, SEED + 26)
    for dtype, tol in ((F64, 1e-10), (F32, 1e-4)):
        hl = dark_likelihood(small, dtype, **FULL)
        if not bool((hl.z_block == 0).any()):
            # a mixed plan: the dense sweep is safe for every event
            hl.z_block[::4] = 0
        args, kw = captured("lattice_kde3d",
                            lambda: hl.log_like_batch({"H0": h0s.to(dtype)}))
        rel, _, under, _ = k5_compare(args, kw, tol)
        terms = k5_terms(args)
        if not (terms["plan"][0] > 0 and sum(terms["plan"].values()) > terms["plan"][0]):
            raise AssertionError(f"not a mixed plan: {terms['plan']}")
        k_ms = statistics.median(cuda_ms(lambda: lattice_kde3d(*args, **kw), 5))
        p_ms = cuda_ms(lambda: lattice_kde3d_plain(*args, **kw), 1, 0)[0]
        phase(26, f"K5 vs plain {dtype}", f"{hl.n_events} events x "
              f"{hl.n_samples} samples x {hl.n_pixels} pixel slots "
              f"({int(hl.pixel_mask.sum())} real) x {hl.z_grids.shape[1]} grid, "
              f"L = {n}; plan (events per K) {terms['plan']}: max err "
              f"{rel:.3e} of the row max (tol {tol:.0e}"
              + ("" if dtype == F64 else " against float64 plain")
              + f"; rows under 1e-20 of their event's max {under}); kernel "
              f"{k_ms:.3f} ms, plain {p_ms:.3f} ms per call [{smi}]")
        del hl, args
    del small

    # ---- 27. kind 'full' end to end at the dark width, float32 -----------
    t0 = time.perf_counter()
    hl = dark_likelihood(dark_data, F32, **FULL)
    torch.cuda.synchronize(DEV)
    setup_s = time.perf_counter() - t0
    ll, _ = counted(lambda: hl.log_like_batch(batch), {"K5": 1})
    check_log_like(ll, h0s, {"lattice_kde3d": 1})
    # (λ, event) pairs whose float32 numerator is 0 (log L = -FLT_MAX, as
    # the JAX package's nan_to_num gives it), against float64
    zero = hl.batch_numerators(hl.population.update_batch(batch)) == 0
    hl64 = dark_likelihood(dark_data, F64, **FULL)
    num64 = hl64.batch_numerators(hl64.population.update_batch({"H0": h0s.double()}))
    zeros = (f"{int(zero.sum())} (λ, event) numerators 0 in float32, at H0 "
             f"{sorted({round(v, 2) for v in h0s[zero.any(dim=1)].tolist()})}; "
             f"float64 gives {int((num64[zero] == 0).sum())} of them 0, the "
             f"largest {num64[zero].max().item() if zero.any() else 0.0:.3e} "
             f"(events' float64 numerators: median "
             f"{num64[num64 > 0].median().item():.3e})")
    del hl64, num64, zero
    try:
        hl.log_like_batch({"H0": h0s.to(F32).clone().requires_grad_()})
    except NotImplementedError as err:
        refused = str(err)
    else:
        raise AssertionError("a 'full' batch that requires grad did not raise")
    par = parity_dark_mock(DEV)
    prec64, prec32 = (dark_likelihood(par, dt, **FULL) for dt in (F64, F32))
    rel, diff, n_fin = f32_vs_f64(prec64, prec32,
                                  torch.linspace(58.0, 100.0, 7, device=DEV),
                                  FULL_F32_BAR)
    prec_plan = k5_terms(captured("lattice_kde3d", lambda: prec32.log_like_batch(
        {"H0": h0s[:1].to(F32)}))[0])["plan"]
    del par, prec64, prec32
    total = cuda_ms(lambda: hl.log_like_batch(batch), reps)
    args, kw = captured("lattice_kde3d", lambda: hl.log_like_batch(batch))
    kern = cuda_ms(lambda: lattice_kde3d(*args, **kw), reps)
    k_call = statistics.median(kern)
    # K5 on the path's own full-width inputs against the float64 plain
    # version, then the float32 plain version's time on the same inputs
    k_rel, k_abs, k_under, k_nan = k5_compare(args, kw, 1e-4)
    plain = cuda_ms(lambda: lattice_kde3d_plain(*args, **kw), 1, 0)[0]
    terms = k5_terms(args, live=True)
    b_ms, b_by = k5_bound(args, terms)
    b_all, _ = k5_bound(args, terms, live=False)
    t_med, t_mad = med_mad([t / n for t in total])
    k_med, k_mad = med_mad([t / n for t in kern])
    stages = full_stages(hl, batch, reps)
    phase(27, "kind 'full' end to end", f"{hl.n_events} events x "
          f"{hl.n_samples} samples x {hl.n_pixels} pixel slots "
          f"({int(hl.pixel_mask.sum())} real) x {hl.z_grids.shape[1]} grid, "
          f"cut_grid=2.0, setup {setup_s:.2f} s; launches K5 1, others 0; "
          f"plan (events per K) {terms['plan']}; H0 argmax "
          f"{h0s[int(torch.argmax(ll))].item():.2f}; log L = "
          f"{[round(v, 4) for v in ll.tolist()]}; {zeros}; requires_grad "
          f"raises: {refused} [{smi}]")
    phase(27, "K5 vs plain", f"the path's own inputs (L = {n}): max err "
          f"{k_rel:.3e} of the row max against float64 plain (tol 1e-4; rows "
          f"under 1e-20 of their event's max {k_under}), max abs {k_abs:.3e}; "
          f"{k_nan} real pixel rows NaN in both (a (λ, event) without a "
          f"whitening) [{smi}]")
    phase(27, "precision", f"float32 vs float64 log L on {PARITY_DARK.name} "
          f"(plan {prec_plan}): max rel err {rel:.3e} (bar {FULL_F32_BAR:.3e}), "
          f"max abs {diff:.3e}, over {n_fin} of 7 H0 values [{smi}]")
    phase(27, "timing", f"[{smi}] per λ over {reps} batches of {n}: total "
          f"{t_med:.4f} ± {t_mad:.4f} ms (median ± MAD); K5 {k_med:.4f} ± "
          f"{k_mad:.4f} ms; glue {t_med - k_med:.4f} ms; K5 per call "
          f"{k_call:.3f} ms, plain {plain:.1f} ms, bound {b_ms:.3f} ms "
          f"({b_by}, {100 * b_ms / k_call:.1f} % of it; every weighted "
          f"sample's terms {b_all:.3f} ms); terms (λ x real pixel x grid "
          f"point x sample) {terms['all']:.4e}, {terms['live']:.4e} on "
          f"samples with weight ({terms['dense']:.4e} dense, "
          f"{terms['recurrence']:.4e} in the recurrence with "
          f"{terms['refresh']:.4e} refreshes), of which the flush keeps "
          f"{terms['refresh_live']:.4e} refreshes "
          f"({100 * terms['refresh_live'] / terms['refresh']:.2f} %) carrying "
          f"{terms['recurrence_live']:.4e} terms; (λ, real pixel) rows on "
          f"the unpruned walk {terms['unpruned_rows']}")
    phase(27, "stages", f"[{smi}] ms per λ, medians over {reps} batches of "
          f"{n} (CUDA events between the stages of log_like_batch): "
          + "; ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + f"; sum {sum(stages.values()):.4f}")
    entry = {"name": "lattice_kde3d (K5)", "route": "cuda",
             "source": "chimera_tpu_torch/csrc/kde3d.cu",
             "replaces": "chimera_tpu/ops/kde.py:307", "launches": 1,
             "max_abs_err": k_abs, "ms": k_call, "plain_ms": plain,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    del args
    return entry, hl


def ensemble(smi: str, full, hl_full, k5: dict) -> dict:
    """Phase 28: the ensemble sampler, 32 walkers in (H0, Om0), 5 steps of
    two half-steps of 16 (L = 16 a batch), on the spectral headline (K1a)
    and on phase 27's 'full' likelihood (K5): one launch a half-step (and
    one of all 32 walkers at the start), every walker finite and in bounds,
    equal bits on a second run from the same generator seed.  Returns K5's
    entry with its launches on the 'full' run."""
    from chimera_tpu_torch.inference import (init_state, initialize_walkers,
                                             make_vector_log_prob, run)

    names, n_walkers, n_steps = ["H0", "Om0"], 32, 5
    bounds = {p: BOUNDS[p] for p in names}
    for name, hl, kid in (("spectral headline", likelihood(full, F32), "K1a"),
                          ("kind 'full'", hl_full, "K5")):
        f = make_vector_log_prob(hl, names, bounds)
        runs = []
        for _ in range(2):
            def go():
                gen = torch.Generator(device=DEV).manual_seed(SEED + 28)
                x0 = initialize_walkers(gen, INIT, n_walkers, names,
                                        bounds=bounds, dtype=F32)
                return run(gen, init_state(x0, f), f, n_steps)
            t0 = time.perf_counter()
            (state, hist), launched = counted(go, {kid: 1 + 2 * n_steps})
            seconds = time.perf_counter() - t0
            runs.append(hist)
            if not torch.all(torch.isfinite(hist["log_prob"])):
                raise AssertionError(f"{name}: non-finite walker log densities")
            for i, p in enumerate(names):
                x = hist["coords"][..., i]
                if not torch.all((x >= bounds[p][0]) & (x <= bounds[p][1])):
                    raise AssertionError(f"{name}: {p} walkers outside {bounds[p]}")
        if not all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0]):
            raise AssertionError(f"{name}: a second run under the same "
                                 "generator seed gave other walkers")
        acc = float(state.n_accepted.double().mean()) / state.iteration
        if kid == "K5":
            k5 = {**k5, "launches": launched[kid]}
        phase(28, f"ensemble, {name}", f"{n_walkers} walkers in {names} x "
              f"{n_steps} steps (half-steps of {n_walkers // 2}): {kid} "
              f"launches {launched[kid]} (1 + 2 a step), {seconds:.2f} s; "
              f"walkers finite and inside the bounds, equal bits on a second "
              f"run; acceptance {acc:.3f}; H0 mean "
              f"{float(hist['coords'][-1, :, 0].mean()):.2f} [{smi}]")
    return k5


# ---------------------------------------------------------------------------
# every population model and engine (phases 29-32)
# ---------------------------------------------------------------------------

# each mass model beside PowerLawPeak: create's keywords, the
# hyper-parameter a phase-29 batch varies beside H0, and its 4 values
MASS_MODELS = {
    "TruncatedPowerLaw": ({}, "alpha", (2.2, 2.5, 2.8, 3.1)),
    "BrokenPowerLaw": ({}, "alpha_1", (1.3, 1.6, 1.9, 2.2)),
    "PowerLawTwoPeaks": ({}, "mu2_g", (60.0, 66.0, 70.0, 74.0)),
    "PowerLawSpline": ({"num_knots": 10, "spline_coeffs": [
        0.3, -0.2, 0.5, 0.1, -0.4, 0.2, 0.0, 0.3, -0.1, 0.2]},
        "alpha", (3.0, 3.3, 3.6, 3.9)),
}
MODEL_H0S = (62.0, 68.0, 72.0, 78.0)
# the three full-width configurations of phases 30-32
MG_HEADLINE = {"cosmo": ("MGFLRW", {"Xi0": 1.5, "n": 2.0}),
               "mass": ("BrokenPowerLaw", {}), "rate": ("PowerLawRate", {})}
# the truncation at z = 4 lies beyond the dark mock's events (z <= 2.5)
TWO_PEAKS_DARK = {"mass": ("PowerLawTwoPeaks", {}),
                  "rate": ("TruncatedMadauDickinsonRate", {"zmax": 4.0})}
TABLES = {"cosmo": ("FLRW", {"interp_method": "table"}),
          "mass": ("PowerLawPeak", {"cdf_engine": "table"})}


# the points of phases 30 and 32's float32 gradient holds on the committed
# spectral mock
MG_POINTS = {"H0": (70.0, 72.0, 74.0, 76.0), "Xi0": (1.5, 1.45, 1.55, 1.5),
             "alpha_1": (1.55, 1.6, 1.65, 1.7)}
TABLE_POINTS = {"H0": (64.0, 68.0, 72.0, 76.0), "Om0": (0.22, 0.25, 0.27, 0.3)}


def grad_cases() -> dict:
    """The spectral configurations whose float32 d log L / dλ is held on
    tests/data/f32_grad_spectral.npz against REFERENCE_F32_GRAD_GAP: {name:
    (``population``'s cfg, cut_grid, {parameter: 4 points})}, phase 29's
    (each mass model with a card gradient, analysis grids and cut_grid=2.0)
    and phases 30 and 32's (MG_HEADLINE, TABLES)."""
    cases = {}
    for model in ("TruncatedPowerLaw", "BrokenPowerLaw", "PowerLawTwoPeaks"):
        kw, key, values = MASS_MODELS[model]
        for path, cut in (("spectral", None), ("spectral_cut", 2.0)):
            cases[f"{model} {path}"] = ({"mass": (model, kw)}, cut,
                                        {"H0": MODEL_H0S, key: values})
    cases["MGFLRW + BrokenPowerLaw"] = (MG_HEADLINE, None, MG_POINTS)
    cases["table engines"] = (TABLES, 2.0, TABLE_POINTS)
    return cases


def grad_bar(case: str) -> float:
    """The float32 gradient bar of a ``grad_cases`` case with a JAX gap."""
    return max(1e-2, 2.0 * REFERENCE_F32_GRAD_GAP[case])


def model_batch(model: str, dtype) -> dict:
    """Phase 29's batch of 4: H0 and the model's own hyper-parameter."""
    _, key, values = MASS_MODELS[model]
    return {"H0": torch.tensor(MODEL_H0S, device=DEV, dtype=dtype),
            key: torch.tensor(values, device=DEV, dtype=dtype)}


def grad_spectral_mock(device):
    """Phase 29's spectral data, tests/data/f32_grad_spectral.npz (the
    port's mock of 64 events x 1024 samples, 100 000 generated injections,
    500-point grids, drawn on the CPU from SEED + 29, as
    tests/test_torch_f32_parity.py writes it): ``mock``'s tuple on
    ``device`` in float64."""
    import numpy as np

    from chimera_tpu_torch.data.structs import ThetaInjDet, ThetaPEDet

    d = np.load(GRAD_SPECTRAL)

    def arr(key):
        return torch.as_tensor(d[key], device=device, dtype=F64)

    return (ThetaPEDet(m1det=arr("m1"), m2det=arr("m2"), dL=arr("dl"),
                       pe_prior=arr("prior")),
            ThetaInjDet(m1det=arr("im1"), m2det=arr("im2"), dL=arr("idl"),
                        p_draw=arr("ipd")),
            float(d["n_gen"]), arr("zg"))


def points(centre: dict, scale: dict, n: int, dtype, seed: int) -> torch.Tensor:
    """(n, k) points of the hyper-parameters ``centre`` names, scattered by
    ``scale`` from a fixed seed."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    noise = torch.randn((n, len(centre)), generator=gen, device=DEV, dtype=F64)
    c = torch.tensor(list(centre.values()), device=DEV, dtype=F64)
    s = torch.tensor([scale[k] for k in centre], device=DEV, dtype=F64)
    return (c + s * noise).to(dtype)


def named_value_and_grad(hl, names, x: torch.Tensor):
    """log L (n,) and d log L / dλ (n, k) at the points ``x`` of ``names``."""
    x = x.detach().requires_grad_()
    ll = hl.log_like_batch({p: x[:, i] for i, p in enumerate(names)})
    return ll.detach(), torch.autograd.grad(ll.sum(), x)[0]


def float32_hold(name: str, fn, plain, args, kw) -> str:
    """A float32 backward kernel and its float32 plain version on the same
    inputs, each against the float64 plain version: each output's largest
    error relative to its row's largest float64 entry, the kernel's held to
    max(1e-3, 2 x the float32 plain version's own), the bar of K3d's d_ext
    in ``grad_compare``: where a sum cancels (the distance bounds'
    cotangents, a sum over every sample), no float32 evaluation of it meets
    1e-3."""
    got, own = fn(*args, **kw), plain(*args, **kw)
    args64, kw64 = in_float64(args, kw)
    exact = plain(*args64, **kw64)
    torch.cuda.synchronize(DEV)
    tiny = torch.finfo(F32).tiny
    k_max = p_max = 0.0
    for i, (g, p, x) in enumerate(zip(got, own, exact)):
        if g is None:
            continue
        k_err, p_err = row_rel(g, x, tiny), row_rel(p, x, tiny)
        bar = max(1e-3, 2.0 * p_err)
        if not (torch.all(torch.isfinite(g)) and k_err <= bar):
            raise AssertionError(f"{name} float32 output {i}: {k_err:.3e} of "
                                 f"the row max from float64 (bar {bar:.3e}; "
                                 f"the float32 plain version {p_err:.3e})")
        k_max, p_max = max(k_max, k_err), max(p_max, p_err)
    return f"{name} {k_max:.2e} (plain {p_max:.2e})"


def paths(hl, hl_b, hl_d, hl_dc):
    """Phase 29's four unbinned paths by name."""
    return (("spectral", hl), ("spectral_cut", hl_b), ("dark", hl_d),
            ("dark_cut", hl_dc))


def x_of(lam: dict) -> torch.Tensor:
    """The (n, k) points of a batch {name: (n,)}."""
    return torch.stack(list(lam.values()), dim=1)


def model_backward_calls(hl, lam: dict, k3, k2b) -> list:
    """The backward kernels' calls of one value-and-gradient call of ``hl``
    at the batch ``lam`` (every entry differentiated): [(kernel id, (fn,
    plain, (args, kw)))] with K3 named by its mode."""
    from chimera_tpu_torch.ops.cuda import fused, rows

    out = []

    def run():
        x = {k: v.detach().clone().requires_grad_() for k, v in lam.items()}
        ll = hl.log_like_batch(x)
        torch.autograd.grad(ll.sum(), list(x.values()))

    def k2b_calls():
        out.extend(("K2b", (*k2b, c)) for c in
                   calls_of(rows, "fused_rows_contract_adjoint", run))

    out.extend((k3_id(c[1]), (*k3, c)) for c in
               calls_of(fused, "fused_weights_kde_adjoint", k2b_calls))
    return out


def model_modes(smi: str) -> None:
    """Phase 29: each mass model beside PowerLawPeak (its own library of
    every kernel) at 64 events (the spectral paths on
    tests/data/f32_grad_spectral.npz), L = 4 in H0 and one of its own
    hyper-parameters: K1a, K1b, K1c, K1d, K1e and K2 on the inputs each
    path hands them, K3 in the modes of K1a, K1b, K1c (logical and event
    rows) and K1d and K2b on random cotangents, against their plain
    versions on the bars of PERF.md §2, the backward kernels in float64;
    in float32 d log L / dλ of each path against float64 (1e-2, or 2 x
    the JAX package's own gap, REFERENCE_F32_GRAD_GAP) and each backward
    kernel on its path's cotangents (``float32_hold``); PowerLawSpline's
    gradient raises on the card (ROADMAP.md §1 item 17)."""
    from chimera_tpu_torch.ops.cuda.fused import (fused_weights_kde_adjoint,
                                                  fused_weights_kde_adjoint_plain)
    from chimera_tpu_torch.ops.cuda.rows import (fused_rows_contract_adjoint,
                                                 fused_rows_contract_adjoint_plain)

    k3 = (fused_weights_kde_adjoint, fused_weights_kde_adjoint_plain)
    k2b = (fused_rows_contract_adjoint, fused_rows_contract_adjoint_plain)
    t0 = time.perf_counter()
    spec64 = grad_spectral_mock(DEV)
    dark64, _ = dark_mock(64, 1024, 15, 500, 100_000, 10_000, SEED + 7)
    for model, (kw, _, _) in MASS_MODELS.items():
        cfg = {"mass": (model, kw)}
        g64 = {}  # each path's float64 d log L / dλ
        for dtype, tol, stat_tol, gtol in ((F64, 1e-10, 1e-10, 1e-9),
                                           (F32, 1e-4, 1e-5, 1e-3)):
            lam = model_batch(model, dtype)
            err = {}
            hl = likelihood(spec64, dtype, cfg=cfg)
            args, kwa = captured("fused_weights_kde", lambda: hl.log_like_batch(lam))
            err["K1a"] = compare(args, tol, stat_tol, **kwa)[0]
            hl_b = likelihood(spec64, dtype, cfg=cfg, cut_grid=2.0)
            args, kwa = captured("fused_weights_kde",
                                 lambda: hl_b.log_like_batch(lam))
            err["K1b"] = compare(args, tol, tol, **kwa)[0]
            hl_d = dark_likelihood(dark64, dtype, cfg)
            stats_args, rows_args = dark_kernel_inputs(hl_d, lam)
            err["K1c"], _, err["K2"], _ = dark_compare(
                stats_args, rows_args, stat_tol, tol)
            hl_dc = dark_likelihood(dark64, dtype, cfg, cut_grid=2.0)
            args, kwa = captured("fused_weights_kde",
                                 lambda: hl_dc.log_like_batch(lam))
            err["K1d"] = compare(args, tol, tol, min_live=0.3, **kwa)[0]
            args, kwa = contract_inputs(contract_likelihood(dark64, dtype, cfg), lam)
            err["K1e"] = contract_compare(args, kwa, tol, tol)[0]
            if model == "PowerLawSpline":
                x = {k: v.clone().requires_grad_() for k, v in lam.items()}
                try:
                    hl.log_like_batch(x)
                except NotImplementedError as e:
                    if "item 17" not in str(e):
                        raise
                    grads = "gradient refused on the card (ROADMAP.md §1 item 17)"
                else:
                    raise AssertionError("PowerLawSpline: a gradient call did "
                                         "not raise on the card")
            elif dtype == F64:
                for kid, (a, k) in (
                        ("K3", mode_inputs(hl, "input", lam, SEED + 29)),
                        ("K3b", mode_inputs(hl_b, "auto", lam, SEED + 29)),
                        ("K3c", mode_inputs(hl_d, "stats_logical", lam, SEED + 29)),
                        ("K3c", mode_inputs(hl_d, "stats", lam, SEED + 29)),
                        ("K3d", mode_inputs(hl_dc, "ext", lam, SEED + 29)),
                        ("K2b", (rows_inputs(hl_d, lam, SEED + 29), {}))):
                    fn, plain = k2b if kid == "K2b" else k3
                    rel, _ = grad_compare(kid, fn, plain, a, k, gtol)
                    err[kid] = max(err.get(kid, 0.0), rel)
                for name, path in paths(hl, hl_b, hl_d, hl_dc):
                    g64[name] = named_value_and_grad(path, list(lam), x_of(lam))[1]
                grads = f"gradients (tol {gtol:.0e} of each row's max)"
            else:
                # float32 gradients against float64: d log L / dλ of each
                # path (of each parameter's largest slope), held to 1e-2
                # (§2's Epanechnikov bar) or, on the spectral paths, to
                # 2 x the JAX package's own gap on the same data where
                # wider (REFERENCE_F32_GRAD_GAP); each backward kernel on
                # the cotangents its path's backward hands it (float32_hold)
                held = []
                for name, path in paths(hl, hl_b, hl_d, hl_dc):
                    g32 = named_value_and_grad(path, list(lam), x_of(lam))[1]
                    rel = column_rel(g32, g64[name])
                    case = f"{model} {name}"
                    bar = grad_bar(case) if case in REFERENCE_F32_GRAD_GAP else 1e-2
                    if not (torch.all(torch.isfinite(g32)) and rel <= bar):
                        raise AssertionError(
                            f"{model} {name}: float32 d log L/dλ {rel:.3e} "
                            f"from float64 (bar {bar:.3e})")
                    held.append(f"{name} d log L/dλ {rel:.2e} (bar {bar:.2e})")
                    for kid, (fn, plain, call) in model_backward_calls(
                            path, lam, k3, k2b):
                        held.append(f"{name} {float32_hold(kid, fn, plain, *call)}")
                grads = ("float32 gradients against float64, held (of each "
                         "parameter's or row's largest; kernels to max(1e-3, "
                         "2 x the float32 plain version's)): " + ", ".join(held))
            phase(29, f"{model} {dtype}", "kernel vs plain, max err: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
                  + f"; forward tol {tol:.0e}, {grads} [{smi}]")
    phase(29, "seconds", f"{time.perf_counter() - t0:.1f} s [{smi}]")


def grad_f32_vs_f64(make, data, names, x: torch.Tensor, bar: float = 1e-2
                    ) -> float:
    """Phases 30-32: d log L / dλ at the points ``x`` of ``names`` of the
    likelihood ``make(data, dtype)`` on 64 events, float32 against float64,
    held to ``bar`` of each parameter's largest slope (phase 12's check,
    §2's Epanechnikov bar 1e-2 or ``grad_bar``)."""
    _, g32 = named_value_and_grad(make(data, F32), names, x.float())
    _, g64 = named_value_and_grad(make(data, F64), names, x.double())
    rel = column_rel(g32, g64)
    if not rel <= bar:
        raise AssertionError(f"float32 d log L/d{names} {rel:.3e} from float64 "
                             f"(bar {bar:.3e})")
    return rel


def grad_case_f32(case: str) -> tuple[float, float]:
    """A ``grad_cases`` case on tests/data/f32_grad_spectral.npz, float32
    against float64, held to its ``grad_bar``, or where the JAX package's
    float32 gradient is NaN (the 'table' engines) to max(1e-2, 2 x the gap
    of the same path with K4 and K4b replaced by their plain versions, the
    path's only kernels): (rel, bar)."""
    from chimera_tpu_torch import likelihood as module
    from chimera_tpu_torch.ops.cuda.kde import kde1d_grid_plain

    cfg, cut, batch = grad_cases()[case]
    x = torch.tensor(list(batch.values()), device=DEV, dtype=F64).T
    data = grad_spectral_mock(DEV)

    def make(d, dt):
        return likelihood(d, dt, cfg=cfg, cut_grid=cut)

    if math.isnan(REFERENCE_F32_GRAD_GAP[case]):
        real = module.kde1d_grid
        module.kde1d_grid = kde1d_grid_plain
        try:
            _, g32 = named_value_and_grad(make(data, F32), list(batch), x.float())
            _, g64 = named_value_and_grad(make(data, F64), list(batch), x)
        finally:
            module.kde1d_grid = real
        bar = max(1e-2, 2.0 * column_rel(g32, g64))
    else:
        bar = grad_bar(case)
    return grad_f32_vs_f64(make, data, list(batch), x, bar), bar


def table_kernels(smi: str, name: str, hl, names, x: torch.Tensor,
                  timed: bool = False) -> None:
    """Phase 32: K4 on the raw rows of the 'table' engines (no binning) and
    K4b on the cotangents of a value-and-gradient call at the points ``x``
    of ``names``, each against its plain version on the same inputs (§2's
    bars: float64 1e-10 and 1e-9, float32 1e-4 and 1e-3), with their
    shared memory a block; ``timed``, their ms per call, plain ms and bound
    at this shape."""
    from chimera_tpu_torch.ops.cuda import kde
    from chimera_tpu_torch.ops.cuda.fused import _K4_TILE, _K4B_TILE
    from chimera_tpu_torch.ops.cuda.kde import (kde1d_grid, kde1d_grid_adjoint,
                                                kde1d_grid_adjoint_plain,
                                                kde1d_grid_plain)

    f64 = x.dtype == F64
    tol, gtol = (1e-10, 1e-9) if f64 else (1e-4, 1e-3)
    batch = {p: x[:, i] for i, p in enumerate(names)}
    args, kw = captured("kde1d_grid", lambda: hl.log_like_batch(batch))
    k_rel, k_abs = kde_compare(args, kw, tol)
    a_args, a_kw = calls_of(kde, "kde1d_grid_adjoint",
                            lambda: named_value_and_grad(hl, names, x))[-1]
    b_rel, b_abs = grad_compare("K4b", kde1d_grid_adjoint,
                                kde1d_grid_adjoint_plain, a_args, a_kw, gtol)
    (b, s), g = args[0].shape, args[2].shape[1]
    smem = (2 * s + 2 * -(-s // _K4_TILE)) * args[0].element_size()
    smem_b = 16 * (s + g + -(-s // _K4B_TILE) + -(-g // _K4B_TILE))
    msg = (f"{b} rows x {s} samples x {g} grid, {x.dtype}: K4 vs plain "
           f"{k_rel:.3e} of the row max (tol {tol:.0e}, {k_abs:.3e} abs), "
           f"{smem} B of shared memory a block; K4b vs plain on the path's "
           f"cotangents {b_rel:.3e} of each row's max (tol {gtol:.0e}, "
           f"{b_abs:.3e} abs), {smem_b} B")
    if timed:
        reps = 17
        k4_ms = statistics.median(cuda_ms(lambda: kde1d_grid(*args, **kw), reps))
        k4_plain = cuda_ms(lambda: kde1d_grid_plain(*args, **kw), 1)[0]
        pairs = k4_pairs(args)
        k4_bound_ms, k4_by = k4_bound(args, pairs)
        k4b_ms = statistics.median(cuda_ms(
            lambda: kde1d_grid_adjoint(*a_args, **a_kw), reps))
        k4b_plain = cuda_ms(lambda: kde1d_grid_adjoint_plain(*a_args, **a_kw),
                            1)[0]
        pairs_b = k4b_pairs(a_args)
        k4b_bound_ms, k4b_by = k4b_bound(a_args, pairs_b)
        msg += (f"; per call (median of {reps}): K4 {k4_ms:.4f} ms, plain "
                f"{k4_plain:.3f} ms, bound {k4_bound_ms:.4f} ms ({k4_by}; "
                f"live terms {pairs['live']} of {pairs['all']}, the pruned "
                f"loop evaluates {pairs[f'tiled{_K4_TILE}']}); K4b "
                f"{k4b_ms:.4f} ms, plain {k4b_plain:.3f} ms, bound "
                f"{k4b_bound_ms:.4f} ms ({k4b_by}; the pruned sweeps evaluate "
                f"{pairs_b[f'union{_K4B_TILE}']} of {pairs_b['all']})")
    phase(32, f"table engines, {name}: K4 and K4b on raw rows", f"{msg} [{smi}]")


def population_models(smi: str, full, dark_data) -> None:
    """Phases 30-32: the three full-width configurations of the other
    population models and engines, float32, L = 16:

    * 30: the spectral headline (1000 x 4096 x 500) drawn from MGFLRW (Xi0
      = 1.5, n = 2) + BrokenPowerLaw + PowerLawRate: the forward batch (one
      K1a), a value-and-gradient call in (H0, Xi0, alpha_1) (one K1a, one
      K3), each timed; float32 vs float64 log L on the precision mock of the
      same population; the float64 gradient in (H0, Xi0, n, alpha_1) on the
      card against the CPU's on 8 of its events;
    * 31: the dark flagship's data with PowerLawTwoPeaks +
      TruncatedMadauDickinsonRate: the forward batch (K1c + K2), a
      value-and-gradient call in (H0, lambda1, mu2_g) (K3c + K2b), timed;
      float32 vs float64 on the dark precision mock;
    * 32: both 'table' engines, unbinned with cut_grid=2.0, on the spectral
      headline's data: the forward batch (one K4 on the raw rows of 4 096
      samples), a value-and-gradient call (one K4, one K4b) repeated for
      equal bits, timed; K4 and K4b against their plain versions on those
      calls' inputs in float32 and float64, timed with their bounds; HMC,
      16 chains in (H0, Om0), 4 + 4 steps, twice for equal bits; float32
      vs float64 on the spectral precision mock; then the dark flagship's
      data ('marginalized', the per-pixel rows of the masked-dense layout):
      timed, K4 and K4b against their plain versions in float32, float32
      vs float64 on the dark precision mock.

    Phases 30 and 32 hold their models' float32 d log L / dλ to float64's
    on tests/data/f32_grad_spectral.npz (``grad_case_f32``), phase 31 on 64
    events of the dark flagship's shape at 1e-2 (``grad_f32_vs_f64``)."""
    from chimera_tpu_torch.inference import sample_hyperposterior

    t_all = time.perf_counter()
    reps, n = 17, 16

    def timing(num, name, hl, names, x, launches, grad_launches):
        batch = {p: x[:, i] for i, p in enumerate(names)}
        counted(lambda: hl.log_like_batch(batch), launches)
        (ll, g), _ = counted(lambda: named_value_and_grad(hl, names, x),
                             grad_launches)
        if not (torch.all(torch.isfinite(ll)) and torch.all(torch.isfinite(g))):
            raise AssertionError(f"{name}: non-finite log L or gradient: "
                                 f"{ll.tolist()}, {g.tolist()}")
        fwd = cuda_ms(lambda: hl.log_like_batch(batch), reps)
        vg = cuda_ms(lambda: named_value_and_grad(hl, names, x), reps)
        f_med, f_mad = med_mad([t / n for t in fwd])
        g_med, g_mad = med_mad([t / n for t in vg])
        phase(num, f"timing {name}", f"[{smi}] per λ over {reps} batches of "
              f"{n}: forward {f_med:.4f} ± {f_mad:.4f} ms (launches "
              f"{launches}), value and gradient in {names} {g_med:.4f} ± "
              f"{g_mad:.4f} ms (launches {grad_launches}) (median ± MAD)")
        return g

    # ---- 30. MGFLRW + BrokenPowerLaw + PowerLawRate, spectral headline ---
    t0 = time.perf_counter()
    mg = mock(1000, 4096, 2_000_000, 500, 200, SEED + 30, cfg=MG_HEADLINE)
    hl = likelihood(mg, F32, cfg=MG_HEADLINE)
    setup = time.perf_counter() - t0
    names = ["H0", "Xi0", "alpha_1"]
    x = points({"H0": 70.0, "Xi0": 1.5, "alpha_1": 1.6},
               {"H0": 3.0, "Xi0": 0.05, "alpha_1": 0.05}, n, F32, SEED + 30)
    timing(30, "MGFLRW + BrokenPowerLaw", hl, names, x, {"K1a": 1},
           {"K1a": 1, "K3": 1})
    del hl
    del mg
    g32_rel, g32_bar = grad_case_f32("MGFLRW + BrokenPowerLaw")
    prec = mock(*PRECISION_MOCK[:5], SEED + 31, cfg=MG_HEADLINE)
    h0s7 = torch.linspace(58.0, 100.0, 7, device=DEV)
    hl64 = likelihood(prec, F64, cfg=MG_HEADLINE)
    rel, diff, n_fin = f32_vs_f64(hl64, likelihood(prec, F32, cfg=MG_HEADLINE), h0s7)
    names4 = ["H0", "Xi0", "n", "alpha_1"]
    x4 = points({"H0": 70.0, "Xi0": 1.5, "n": 2.0, "alpha_1": 1.6},
                {"H0": 3.0, "Xi0": 0.05, "n": 0.1, "alpha_1": 0.05}, 2, F64,
                SEED + 32)
    cut = likelihood(cut_events(prec, 8), F64, cfg=MG_HEADLINE)
    (_, g_card), _ = counted(lambda: named_value_and_grad(cut, names4, x4),
                             {"K1a": 1, "K3": 1})
    _, g_cpu = named_value_and_grad(copy.deepcopy(cut).to("cpu"), names4, x4.cpu())
    g_rel = column_rel(g_card.cpu(), g_cpu)
    if not g_rel <= 1e-9:
        raise AssertionError(f"MGFLRW gradient: card vs CPU {g_rel:.3e} (tol 1e-9)")
    phase(30, "MGFLRW + BrokenPowerLaw", f"1000 x 4096 x 500 drawn from the "
          f"model (Xi0 = 1.5, n = 2), setup {setup:.1f} s; float32 vs float64 "
          f"log L on the precision mock: max rel err {rel:.3e} (bar 1e-6), max "
          f"abs {diff:.3e} over {n_fin} of 7 H0 values; d log L/d{names} on "
          f"{GRAD_SPECTRAL.name} at {MG_POINTS}, float32 vs float64 "
          f"{g32_rel:.3e} of each parameter's largest slope (bar "
          f"{g32_bar:.3e}); d log L/d(H0, Xi0, n, "
          f"alpha_1) on 8 events, float64, card (K1a + K3) vs CPU autograd "
          f"{g_rel:.3e} of each parameter's largest slope (tol 1e-9) [{smi}]")
    del prec, hl64, cut

    # ---- 31. PowerLawTwoPeaks + TruncatedMadauDickinson, dark flagship ---
    hl = dark_likelihood(dark_data, F32, TWO_PEAKS_DARK)
    names = ["H0", "lambda1", "mu2_g"]
    x = points({"H0": 70.0, "lambda1": 0.5, "mu2_g": 68.0},
               {"H0": 3.0, "lambda1": 0.05, "mu2_g": 1.0}, n, F32, SEED + 33)
    timing(31, "PowerLawTwoPeaks + TruncatedMadauDickinson", hl, names, x,
           {"K1c": 1, "K2": 1}, {"K1c": 1, "K2": 1, "K3c": 1, "K2b": 1})
    del hl
    dark64, _ = dark_mock(64, 1024, 15, 500, 100_000, 10_000, SEED + 7)
    g32_rel = grad_f32_vs_f64(lambda d, dt: dark_likelihood(d, dt, TWO_PEAKS_DARK),
                              dark64, names, x)
    del dark64
    par = parity_dark_mock(DEV)
    rel, diff, n_fin = f32_vs_f64(dark_likelihood(par, F64, TWO_PEAKS_DARK),
                                  dark_likelihood(par, F32, TWO_PEAKS_DARK), h0s7)
    phase(31, "PowerLawTwoPeaks + TruncatedMadauDickinson", f"dark flagship "
          f"data; float32 vs float64 log L on {PARITY_DARK.name}: max rel err "
          f"{rel:.3e} (bar 1e-6), max abs {diff:.3e} over {n_fin} of 7 H0 "
          f"values; d log L/d{names} on 64 events of the dark flagship's "
          f"shape, float32 vs float64 {g32_rel:.3e} of each parameter's "
          f"largest slope (tol 1e-2) [{smi}]")
    del par

    # ---- 32. the 'table' engines on the spectral headline ----------------
    hl = likelihood(full, F32, cfg=TABLES, cut_grid=2.0)
    names = ["H0", "Om0"]
    x = points({"H0": 70.0, "Om0": 0.25}, {"H0": 3.0, "Om0": 0.02}, n, F32,
               SEED + 34)
    g = timing(32, "table engines", hl, names, x, {"K4": 1},
               {"K4": 1, "K4b": 1})
    _, again = named_value_and_grad(hl, names, x)
    if not torch.equal(g, again):
        raise AssertionError("table engines: a second gradient call gave "
                             "other bits")
    table_kernels(smi, "spectral", hl, names, x, timed=True)
    bounds = {"H0": BOUNDS["H0"], "Om0": BOUNDS["Om0"]}
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        samples, stats = sample_hyperposterior(
            torch.Generator(device=DEV).manual_seed(SEED + 35), hl, names,
            bounds, {"H0": 70.0, "Om0": 0.25}, n_chains=n, n_warmup=4,
            n_samples=4, n_leapfrog=2, init_step_size=0.03)
        torch.cuda.synchronize(DEV)
        seconds = time.perf_counter() - t0
        for p in names:
            if not torch.all(torch.isfinite(samples[p])):
                raise AssertionError(f"table engines HMC: {p} not finite")
        runs.append(samples)
    if not all(torch.equal(runs[0][p], runs[1][p]) for p in names):
        raise AssertionError("table engines HMC: a second run under the same "
                             "generator seed gave other samples")
    del hl
    hl64 = likelihood(full, F64, cfg=TABLES, cut_grid=2.0)
    table_kernels(smi, "spectral", hl64, names, x.double())
    del hl64
    g_rel, g_bar = grad_case_f32("table engines")
    prec = mock(*PRECISION_MOCK)
    rel, diff, n_fin = f32_vs_f64(likelihood(prec, F64, cfg=TABLES, cut_grid=2.0),
                                  likelihood(prec, F32, cfg=TABLES, cut_grid=2.0),
                                  h0s7)
    del prec
    phase(32, "table engines", f"interp_method='table', cdf_engine='table', "
          f"binning=False, cut_grid=2.0 on the spectral headline's data: "
          f"float32 vs float64 log L on the precision mock: max rel err "
          f"{rel:.3e} (bar 1e-6), max abs {diff:.3e} over {n_fin} of 7 H0 "
          f"values; d log L/d{names} on {GRAD_SPECTRAL.name} at "
          f"{TABLE_POINTS}, float32 vs float64 {g_rel:.3e} of each "
          f"parameter's largest slope (bar {g_bar:.3e}); "
          f"gradient equal bits on a "
          f"second call; HMC {n} chains x (4 warm-up + 4 sampling steps, 2 "
          f"leapfrog steps) in {names}, {seconds:.2f} s a run, equal bits on "
          f"a second run, accept {float(stats['accept'].mean()):.2f}, H0 mean "
          f"{float(samples['H0'].mean()):.2f} [{smi}]")

    # ---- 32. the per-pixel layout of 'marginalized' with the tables ------
    hl = dark_likelihood(dark_data, F32, TABLES, cut_grid=2.0)
    timing(32, "table engines, marginalized", hl, names, x, {"K4": 1},
           {"K4": 1, "K4b": 1})
    table_kernels(smi, "marginalized", hl, names, x, timed=True)
    del hl
    par = parity_dark_mock(DEV)
    rel, diff, n_fin = f32_vs_f64(
        dark_likelihood(par, F64, TABLES, cut_grid=2.0),
        dark_likelihood(par, F32, TABLES, cut_grid=2.0), h0s7)
    del par
    phase(32, "table engines, marginalized", f"the dark flagship's data, "
          f"unbinned cut_grid=2.0, the (event, pixel) rows of the masked-dense "
          f"layout: float32 vs float64 log L on {PARITY_DARK.name}: max rel "
          f"err {rel:.3e} (bar 1e-6), max abs {diff:.3e} over {n_fin} of 7 H0 "
          f"values [{smi}]")
    phase(32, "seconds", f"phases 30-32 {time.perf_counter() - t_all:.1f} s "
          f"[{smi}]")


# The adjoint kernel in the tree it is run from, on the main paths' own
# cotangents, ms per call: K3 on analysis grids at the spectral headline
# (the samplers' backward); the stats-only mode on the same rows (phases A,
# C and D alone, the series summed in double); K3 on the first 2 points of
# the same grids (phases A, C and D as K3 runs them, the pair loop 1/250 of
# its work; K3 less either is the pair loop's marginal cost, not its time:
# other blocks' work hides in it); K3c on the dark flagship's logical pixel
# rows and on the dark cut_grid path's event rows.  Then the ptxas lines of
# the float32 Epanechnikov K3, K3b and K3d and the float32 K3c instantiations of a tree
# that builds them in that process.  It uses only helpers that chip_smoke.py has had
# since K3c was ported, so it runs in older trees.
K3_TIMING = r"""
import os, statistics, sys
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from chimera_tpu_torch.ops.cuda import build
from chimera_tpu_torch.ops.cuda.fused import fused_weights_kde_adjoint as k3

print(os.getcwd(), flush=True)

def report(name, fn):
    t = cs.cuda_ms(fn, 17, 3)
    print(f"  {name}: median {statistics.median(t):.4f} min {min(t):.4f} "
          f"max {max(t):.4f} ms per call", flush=True)

x = cs.chain_points(16, cs.F32)
full = cs.mock(1000, 4096, 2_000_000, 500, 200, cs.SEED)
hl = cs.likelihood(full, cs.F32)
args = list(cs.adjoint_inputs(hl, x, cs.SEED + 14))
args[7], args[8] = cs.main_path_cotangents(hl, x)
report("K3, spectral headline", lambda: k3(*args, "epan"))
stats = args[:4] + [None] + args[5:7] + [None] + args[8:]
report("stats-only mode on the same rows",
       lambda: k3(*stats, "epan", cut_grid=2.0, stats_only=True))
short = args[:4] + [args[4][:, :2].contiguous()] + args[5:7] \
    + [args[7][..., :2].contiguous()] + args[8:]
report("K3 on 2 grid points of the same rows", lambda: k3(*short, "epan"))
del hl, full, args, stats
data, _ = cs.dark_mock(1000, 1024, 15, 500, 500_000, 50_000, cs.SEED + 8)
for path, cfg in (("dark", cs.DARK), ("dark_cut", cs.DARK_CUT)):
    hl = cs.dark_likelihood(data, cs.F32, **cfg)
    for a, kw in cs.backward_calls(hl, x)["K3"]:
        if kw.get("stats_only"):
            rows = "logical pixel rows" if kw.get("n_real") is not None \
                else "event rows"
            report(f"K3c, {path} path's {rows}", lambda: k3(*a, **kw))
    del hl
log = build.build_info.get("fused_kde_adjoint", {}).get("log", "").splitlines()
for i, ln in enumerate(log):
    if "entry function" in ln and any(k in ln for k in (
            "IffLi0ELi0", "IffLi0ELi1", "IfdLi0ELi3", "IfdLi0ELi2",
            "stats_rows_kernelIf")):
        print("  ptxas:", " | ".join(
            m.split("ptxas info    :")[-1].strip() for m in log[i:i + 4]
            if "entry function" in m or "spill" in m or "registers" in m))
"""


# K1a, K2b, K2, K1c, K4, K4b, K1e, K3b, K1b, K3d, K1d and K5 in the tree it
# is run from, ms per call (with a second argument ``k5``, K5 alone):
# K1a at the spectral headline (16 λ, float32) and on the first 2 of its
# 500 grid points (phase A and the row stats; the pair loop 1/250 of its
# work); K4 on the binned spectral headline's and the binned dark
# flagship's forward inputs and K4b on their own cotangents (the
# reference's defaults, phases 16, 17, 24); K1e on the dark contract
# path's inputs at the flagship width (phase 23); K3b on
# the spectral cut_grid path's own cotangents (phase 21); K1b on the
# spectral cut_grid path's inputs (phase 18) at phase 14's points; K3d on
# the dark cut_grid path's own cotangents (phase 21); K1d on that path's
# inputs (phase 18) at phase 14's points; K2b on the dark
# flagship path's own cotangents and on 2 grid points of the same rows
# (phases A and D); K2 at the dark flagship on rows_inputs' rows ((1/h,
# scale) from the plain stats pass, so they do not depend on K1c); K1c on
# the flagship's logical pixel rows and on the events (the dark cut_grid
# path's rows); K5 on kind 'full''s batch at the dark flagship's width
# (phase 27), its prologue and main kernels by the profiler, with the
# refreshes its flush keeps.  End to end, ms per λ at the 16 points of
# phase 14: the
# spectral headline's value-and-gradient call and forward batch (phases 14
# and 6), the value-and-gradient calls of the binned spectral and dark
# paths (phase 24), of the spectral and dark cut_grid paths and of the dark
# flagship (phase 21), the spectral and dark cut_grid forward batches
# (phase 18), the contract path's forward batch (phase 23) and the 'full'
# forward batch (phase 27).
# The outputs of the kernel calls, of the Gaussian kernel's on the same
# inputs, and of float64 K1a (64 events, L = 4), K2b, K2, K1c, K4b, K1e,
# K3b, K1b, K3d, K1d and K5 (the same calls' inputs in float64; K3b also on
# mode_inputs' random cotangents), and those of K3 (the spectral headline's backward),
# K3c (the dark flagship's and the dark cut_grid path's) and K4 (both
# binned paths' forward) on their paths' own inputs, go to the file
# argv[1] with a hash of each call's inputs (an output of more than 2^22
# entries as a hash of its bytes), for --k3-ab to hold bit for bit against
# this tree's.  Then the live pairs
# (where the tree's chip_smoke.py counts them; K4b's and K3b's kept terms
# at tile widths 8, 16 and 32, K3d's and K4's at 16 and 32) and the ptxas
# lines of the float32 Epanechnikov K1a, K1b, K1c, K1d, K1e, K2, K2b, K3b,
# K3d, K4 and K4b of a tree that builds them in that process.  It uses only
# helpers that chip_smoke.py has had since K4b was ported, so it runs in
# older trees.
PAIR_TIMING = r"""
import hashlib, os, statistics, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from chimera_tpu_torch.ops.cuda import build, kde
from chimera_tpu_torch.ops.cuda.fused import fused_weights_kde as k1
from chimera_tpu_torch.ops.cuda.fused import fused_weights_kde_adjoint as k3
from chimera_tpu_torch.ops.cuda.fused import fused_row_stats as k1c
from chimera_tpu_torch.ops.cuda.kde import kde1d_grid_adjoint as k4b
from chimera_tpu_torch.ops.cuda.rows import fused_rows_contract as k2
from chimera_tpu_torch.ops.cuda.rows import fused_rows_contract_adjoint as k2b

print(os.getcwd(), flush=True)
saved = {}

def report(name, fn, n=1):
    t = [v / n for v in cs.cuda_ms(fn, 17, 3)]
    print(f"  {name}: median {statistics.median(t):.4f} min {min(t):.4f} "
          f"max {max(t):.4f} ms per " + ("λ" if n > 1 else "call"), flush=True)

def keep(name, inputs, out):
    # an output of more than 2^22 entries is kept as a hash of its bytes
    if isinstance(out[-1], dict):
        out = (out[0], *out[-1].values())
    saved[name] = [t.detach().cpu() if t.numel() <= 1 << 22 else
                   f"{t.dtype}, {tuple(t.shape)}, sha256 " + hashlib.sha256(
                       t.detach().cpu().contiguous().view(torch.uint8).numpy()
                   ).hexdigest() for t in out if t is not None]
    h = hashlib.sha256()
    for t in inputs:
        if torch.is_tensor(t):
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    saved[name + ", inputs"] = h.hexdigest()

def keep_call(name, fn, call, ckw, slot=None, kernels=("epan", "gauss")):
    # fn's outputs on the call and on its float64 cast, each KDE kernel (the
    # positional argument ``slot``, else the keyword)
    for dtype, (c, k) in (("float32", (list(call), ckw)),
                          ("float64", cs.in_float64(call, ckw))):
        for kernel in kernels:
            c = list(c)
            if slot is None:
                k = dict(k, kernel=kernel)
            else:
                c[slot] = kernel
            out = fn(*c, **k)
            keep(f"{name} {dtype} {kernel}", c, [out] if torch.is_tensor(out) else out)

def k5_block(data):
    # K5 on phase 27's inputs (kind 'full' at the dark flagship's width,
    # 16 λ) and on their float64 cast, and the 'full' forward batch
    from chimera_tpu_torch.ops.cuda.kde3d import lattice_kde3d as k5
    hl = cs.dark_likelihood(data, cs.F32, **cs.FULL)
    batch = {"H0": torch.linspace(55.0, 95.0, 16, device=cs.DEV).to(cs.F32)}
    args, kw = cs.captured("lattice_kde3d", lambda: hl.log_like_batch(batch))
    report("kind 'full' forward batch", lambda: hl.log_like_batch(batch), 16)
    report("K5, kind 'full'", lambda: k5(*args, **kw))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            k5(*args, **kw)
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if "kde3d" in ev.key:
            t = getattr(ev, "device_time_total", None) or ev.cuda_time_total
            name = "prologue" if "kde3d_prologue" in ev.key else "main kernel"
            print(f"  K5's {name}: {t / 5e3:.4f} ms per call (profiler, 5 "
                  "calls)", flush=True)
    if hasattr(cs, "k5_live"):
        print(f"  K5 terms: {cs.k5_terms(args, live=True)}", flush=True)
    for dtype in (cs.F32, cs.F64):
        call = [a.to(dtype) if torch.is_tensor(a) and a.is_floating_point()
                else a for a in args]
        keep(f"K5 {dtype}", call, [k5(*call, **kw)])
    # 500 events on 800-point grids, where the plan takes K = 32 for most:
    # timed and kept on that plan, and kept on a plan whose block lengths
    # cycle through 0, 5, 8, 13, 16, 32, capped at the plan's (the dense
    # sweep, J >= 128, tiers 8 and 16, a K of no tier, tier 32)
    long = cs.dark_mock(500, 1024, 15, 800, 250_000, 25_000, cs.SEED + 15)[0]
    hl = cs.dark_likelihood(long, cs.F32, **cs.FULL)
    args, kw = cs.captured("lattice_kde3d", lambda: hl.log_like_batch(batch))
    del hl, long
    z_block = args[8]
    print("  800-point grids, events per K: "
          f"{dict(zip(*[t.tolist() for t in z_block.unique(return_counts=True)]))}",
          flush=True)
    report("K5, 800-point grids", lambda: k5(*args, **kw))
    keep("K5 800-point grids torch.float32", args, [k5(*args, **kw)])
    cycle = torch.tensor([0, 5, 8, 13, 16, 32], dtype=z_block.dtype,
                         device=z_block.device).repeat(len(z_block) // 6 + 1)
    args = list(args)
    args[8] = torch.minimum(cycle[:len(z_block)], z_block)
    for dtype in (cs.F32, cs.F64):
        call = [a.to(dtype) if torch.is_tensor(a) and a.is_floating_point()
                else a for a in args]
        keep(f"K5 800-point grids, cycled K {dtype}", call, [k5(*call, **kw)])

def ptxas(keys):
    for name, key in keys:
        log = build.build_info.get(name, {}).get("log", "").splitlines()
        for i, ln in enumerate(log):
            if "entry function" in ln and key in ln:
                print("  ptxas:", " | ".join(
                    m.split("ptxas info    :")[-1].strip() for m in log[i:i + 4]
                    if "entry function" in m or "spill" in m or "registers" in m))

if sys.argv[2:3] == ["k5"]:
    k5_block(cs.dark_mock(1000, 1024, 15, 500, 500_000, 50_000, cs.SEED + 8)[0])
    torch.save(saved, sys.argv[1])
    ptxas([("kde3d", "kde3d_kernelIf")])
    sys.exit(0)

def k2b_two_points(a):
    a = list(a)
    for i in (4, 8, 9, 10, 11):  # grids, s1, s2, f1, f2
        a[i] = a[i][..., :2].contiguous()
    return a

def k4b_block(name, hl):
    a, kw = cs.calls_of(kde, "kde1d_grid_adjoint",
                        lambda: cs.value_and_grad(hl, x))[-1]
    k4_args, k4_kw = cs.captured("kde1d_grid",
                                 lambda: hl.log_like_batch(cs.batch_of(x)))
    keep_call(f"K4 {name}", kde.kde1d_grid, k4_args, k4_kw)
    report(f"K4, {name}", lambda: kde.kde1d_grid(*k4_args, **k4_kw))
    if hasattr(cs, "k4_pairs"):
        print(f"  K4 terms, {name}: {cs.k4_pairs(k4_args, (16, 32))}", flush=True)
    report(f"{name} value and gradient", lambda: cs.value_and_grad(hl, x), 16)
    report(f"K4b, {name}", lambda: k4b(*a, **kw))
    if hasattr(cs, "k4b_pairs"):
        print(f"  K4b terms, {name}: {cs.k4b_pairs(a, (8, 16, 32))}", flush=True)
    for dtype, call in (("float32", list(a)), ("float64", cs.in_float64(a, kw)[0])):
        for kernel in ("epan", "gauss"):
            c = [*call[:6], kernel]
            keep(f"K4b {name} {dtype} {kernel}", c, k4b(*c))

def k3b_block(hl):
    (a, kw), = cs.backward_calls(hl, x)["K3"]
    report("spectral cut_grid value and gradient",
           lambda: cs.value_and_grad(hl, x), 16)
    report("K3b, spectral cut_grid", lambda: k3(*a, **kw))
    if hasattr(cs, "k3b_pairs"):
        print(f"  K3b terms: {cs.k3b_pairs(a, kw, (8, 16, 32))}", flush=True)
    rand = cs.mode_inputs(hl, "auto", cs.batch_of(x), cs.SEED + 21)
    for src, (args, kws) in (("path", (a, kw)), ("random", rand)):
        for dtype, (call, ckw) in (("float32", (list(args), kws)),
                                   ("float64", cs.in_float64(args, kws))):
            for kernel in ("epan", "gauss"):
                call = list(call)
                call[11] = kernel
                keep(f"K3b {src} {dtype} {kernel}", call, k3(*call, **ckw)[:2])

def k1b_block(hl):
    args, kw = cs.captured("fused_weights_kde",
                           lambda: hl.log_like_batch(cs.batch_of(x)))
    report("spectral cut_grid forward batch",
           lambda: hl.log_like_batch(cs.batch_of(x)), 16)
    report("K1b, spectral cut_grid", lambda: k1(*args, **kw))
    if hasattr(cs, "k1b_pairs"):
        print(f"  K1b pair terms: {cs.k1b_pairs(args, kw)}", flush=True)
    for dtype, (call, ckw) in (("float32", (list(args), kw)),
                               ("float64", cs.in_float64(args, kw))):
        for kernel in ("epan", "gauss"):
            keep(f"K1b {dtype} {kernel}", call, k1(*call, **dict(ckw, kernel=kernel)))

def k3d_block(hl):
    calls = cs.backward_calls(hl, x)["K3"]
    (a, kw), = [c for c in calls if c[1].get("ext_bounds") is not None]
    (ac, kwc), = [c for c in calls if c[1].get("stats_only")]
    keep_call("K3c event rows", k3, ac, kwc, slot=11, kernels=("epan",))
    d_args, d_kw = cs.captured("fused_weights_kde",
                               lambda: hl.log_like_batch(cs.batch_of(x)))
    keep_call("K1d", k1, d_args, d_kw)
    report("K1d, dark cut_grid", lambda: k1(*d_args, **d_kw))
    if hasattr(cs, "k1d_pairs"):
        print(f"  K1d pair terms: {cs.k1d_pairs(d_args, d_kw)}", flush=True)
    report("dark cut_grid forward batch",
           lambda: hl.log_like_batch(cs.batch_of(x)), 16)
    report("dark cut_grid value and gradient",
           lambda: cs.value_and_grad(hl, x), 16)
    report("K3d, dark cut_grid", lambda: k3(*a, **kw))
    if hasattr(cs, "k3d_pairs"):
        print(f"  K3d terms: {cs.k3d_pairs(a, kw, (16, 32))}", flush=True)
    for dtype, (call, ckw) in (("float32", (list(a), kw)),
                               ("float64", cs.in_float64(a, kw))):
        for kernel in ("epan", "gauss"):
            call = list(call)
            call[11] = kernel
            keep(f"K3d {dtype} {kernel}", call, k3(*call, **ckw))

full = cs.mock(1000, 4096, 2_000_000, 500, 200, cs.SEED)
hl = cs.likelihood(full, cs.F32)
args = cs.kernel_inputs(hl, torch.linspace(55.0, 95.0, 16, device=cs.DEV).to(cs.F32))
short = args[:6] + (args[6][:, :2].contiguous(),)
report("K1a, spectral headline", lambda: k1(*args))
report("K1a on 2 grid points of the same rows", lambda: k1(*short))
for kernel in ("epan", "gauss"):
    keep(f"K1a float32 {kernel}", args, k1(*args, kernel=kernel))
if hasattr(cs, "k1a_pairs"):
    print(f"  K1a pair terms: {cs.k1a_pairs(args)}", flush=True)
x = cs.chain_points(16, cs.F32)
report("spectral value and gradient", lambda: cs.value_and_grad(hl, x), 16)
report("spectral forward batch", lambda: hl.log_like_batch(cs.batch_of(x)), 16)
(a, kw), = cs.backward_calls(hl, x)["K3"]
keep_call("K3 spectral headline", k3, a, kw, slot=11)
del hl, args, short, a, kw
k4b_block("binned spectral", cs.likelihood(full, cs.F32, **cs.BINNED))
hl = cs.likelihood(full, cs.F32, cut_grid=2.0)
k3b_block(hl)
k1b_block(hl)
del full, hl
small = cs.mock(64, 4096, 200_000, 500, 300, cs.SEED + 3)
args = cs.kernel_inputs(cs.likelihood(small, cs.F64),
                        torch.linspace(60.0, 80.0, 4, device=cs.DEV).double())
for kernel in ("epan", "gauss"):
    keep(f"K1a float64 {kernel}", args, k1(*args, kernel=kernel))
del small, args
data, _ = cs.dark_mock(1000, 1024, 15, 500, 500_000, 50_000, cs.SEED + 8)
hl = cs.dark_likelihood(data, cs.F32)
calls = cs.backward_calls(hl, x)
(a, kw), = calls["K2b"]
(a3, kw3), = calls["K3"]
keep_call("K3c pixel rows", k3, a3, kw3, slot=11, kernels=("epan",))
del calls, a3, kw3
report("dark flagship value and gradient", lambda: cs.value_and_grad(hl, x), 16)
report("K2b, dark flagship", lambda: k2b(*a, **kw))
report("K2b on 2 grid points of the same rows", lambda: k2b(*k2b_two_points(a), **kw))
if hasattr(cs, "k2b_pairs"):
    print(f"  K2b pair terms: {cs.k2b_pairs(a)}", flush=True)
for dtype, call in (("float32", list(a)), ("float64", cs.in_float64(a, kw)[0])):
    for kernel in ("epan", "gauss"):
        call[15] = kernel
        keep(f"K2b {dtype} {kernel}", call, k2b(*call))
del a, kw
h0s = torch.linspace(55.0, 95.0, 16, device=cs.DEV).to(cs.F32)
r = cs.rows_inputs(hl, {"H0": h0s}, cs.SEED + 9)

def k1e_block(data):
    hl = cs.contract_likelihood(data, cs.F32)
    args, kw = cs.captured("fused_weights_kde",
                           lambda: hl.log_like_batch(cs.batch_of(x)))
    report("contract path forward batch",
           lambda: hl.log_like_batch(cs.batch_of(x)), 16)
    report("K1e, contract path", lambda: k1(*args, **kw))
    if hasattr(cs, "k1e_pairs"):
        print(f"  K1e pair terms: {cs.k1e_pairs(args, kw)}", flush=True)
    for dtype, (call, ckw) in (("float32", (list(args), kw)),
                               ("float64", cs.in_float64(args, kw))):
        ckw = dict(ckw, contract=tuple(t.to(call[2].dtype) for t in kw["contract"]))
        for kernel in ("epan", "gauss"):
            keep(f"K1e {dtype} {kernel}", call, k1(*call, **dict(ckw, kernel=kernel)))

def k2_call(r, kernel):
    return (*r[:4], r[13], r[14], r[4], *r[7:12], kernel)

report("K2, dark flagship", lambda: k2(*k2_call(r, "epan")))
if hasattr(cs, "k2_pairs"):
    print(f"  K2 work: {cs.k2_pairs(k2_call(r, 'epan'))}", flush=True)
for dtype, call in (("float32", r), ("float64", cs.in_float64(r, {})[0])):
    for kernel in ("epan", "gauss"):
        c = k2_call(call, kernel)
        keep(f"K2 {dtype} {kernel}", c, [k2(*c)])
del r
stats_args, _ = cs.dark_kernel_inputs(hl, h0s)
pop_b = hl.population.update_batch({"H0": h0s})
ev = (hl.m1det, hl.m2det, hl.dL, hl.inv_pe_prior, pop_b.cosmo, pop_b.mass)
report("K1c, dark flagship's logical pixel rows", lambda: k1c(*stats_args))
report("K1c, dark cut_grid path's event rows", lambda: k1c(*ev))
for dtype, call in (("float32", stats_args),
                    ("float64", cs.in_float64(stats_args, {})[0])):
    keep(f"K1c {dtype} pixel rows", call, list(k1c(*call).values()))
del hl, stats_args, pop_b, ev
k1e_block(data)
k3d_block(cs.dark_likelihood(data, cs.F32, **cs.DARK_CUT))
k4b_block("binned dark", cs.dark_likelihood(data, cs.F32, **cs.BINNED))
k5_block(data)
torch.save(saved, sys.argv[1])
ptxas([("fused_kde", "fused_kde_kernelIffLi0ELi0E"),
       ("fused_kde", "fused_kde_kernelIffLi0ELi1E"),
       ("fused_kde", "fused_kde_kernelIfdLi0ELi3E"),
       ("fused_kde", "logical_stats_kernelIf"),
       ("rows_contract", "rows_contract_kernelIfLi0E"),
       ("rows_contract_adjoint", "rows_adjoint_kernelIfLi0E"),
       ("fused_kde_adjoint", "fused_kde_adjoint_kernelIffLi0ELi1E"),
       ("fused_kde_adjoint", "fused_kde_adjoint_kernelIfdLi0ELi2E"),
       ("fused_kde", "fused_kde_kernelIfdLi0ELi4E"),
       ("fused_kde", "fused_kde_kernelIfdLi0ELi2E"),
       ("fused_kde", "logical_kde_kernelIf"),
       ("kde1d", "kde1d_kernelIfLi0E"),
       ("kde1d", "kde1d_adjoint_kernelIfLi0E"),
       ("kde3d", "kde3d_kernelIf")])
"""


def same_bits(a, b) -> bool:
    """Whether two tensors hold the same bits (NaNs and signed zeros too);
    a tensor PAIR_TIMING kept as a hash of its bytes, the same hash."""
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    view = torch.int64 if a.element_size() == 8 else torch.int32
    return torch.equal(a.contiguous().view(view), b.contiguous().view(view))


def k3_ab(others: list[str], variants: list[str], only_k5: bool = False) -> None:
    """The adjoint kernel (K3_TIMING) and K1a, K2b, K2, K1c, K4, K4b, K1e,
    K3b, K1b, K3d, K1d and K5 (PAIR_TIMING) in the trees ``others`` (the parent, unpacked with ``git
    archive``) and ``variants`` (trees that change timing only,
    tools/k3_variants.py) and in this one, in one call on one card, in the
    order others, variants, this, this, variants reversed, others reversed:
    ``python3 chip_smoke.py --k3-ab DIR ... [--only-k5] [--variants DIR
    ...]``.  Fails
    unless every tree of ``others`` gives K1a, K2b, K2, K1c, K4b, K3b, K1b,
    K3d, K3, K3c, K1d, K4, K1e and K5 outputs of the same bits as this tree
    on the same inputs; a variant's are reported.  With ``only_k5``
    (``--only-k5``) each run times and keeps K5 alone (PAIR_TIMING's
    ``k5`` mode, no K3_TIMING)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card only")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    here = str(Path(__file__).resolve().parent)
    out_dir = Path(here) / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    trees = (*others, *variants)
    runs = []
    for i, tree in enumerate((*trees, here, here, *trees[::-1])):
        pair = (PAIR_TIMING, [str(out_dir / f"run{i}.pt")] + ["k5"] * only_k5)
        for script, extra in ([pair] if only_k5 else [(K3_TIMING, []), pair]):
            out = subprocess.run([sys.executable, "-c", script, *extra], cwd=tree,
                                 capture_output=True, text=True)
            print(out.stdout.strip(), flush=True)
            if out.returncode != 0:
                raise RuntimeError(f"{tree}: {out.stderr[-4000:]}")
        runs.append((tree, out_dir / f"run{i}.pt"))
    ref = torch.load(runs[len(trees)][1])
    failed = []
    for tree, path in runs:
        got = torch.load(path)
        for key, expect in ref.items():
            if isinstance(expect, str):
                ok = got[key] == expect
                diff = "" if ok else "the inputs differ"
            else:
                ok = all(same_bits(g, e) for g, e in zip(got[key], expect))
                diff = "" if ok else "max abs diff " + ", ".join(
                    f"{(g.double() - e.double()).abs().max().item():.3e}"
                    if torch.is_tensor(g) else "(hashed)"
                    for g, e in zip(got[key], expect))
            print(f"  {tree}: {key}: " + ("same bits as this tree" if ok
                                          else "DIFFERS, " + diff), flush=True)
            if not ok and tree not in variants:
                failed.append(f"{tree}: {key}")
    if failed:
        raise AssertionError(f"outputs differ from this tree's: {failed}")


# ---------------------------------------------------------------------------
# distribution (phase 33)
# ---------------------------------------------------------------------------

# phase 33's configurations: the data, the likelihood's keywords, the
# kernels of its path (each launched once a batch on every rank) and the
# float32 bar against float64
DIST_CONFIGS = {
    "spectral headline": ("spectral", {}, {"K1a": 1}, 1e-6),
    "dark flagship": ("dark", DARK, {"K1c": 1, "K2": 1}, 1e-6),
    "binned defaults": ("spectral", BINNED, {"K4": 1}, BINNED_F32_BAR["1d"]),
    "kind 'full'": ("dark", FULL, {"K5": 1}, FULL_F32_BAR),
}
# per world size of gloo ranks sharing the card: the (params, data) meshes
# and the configurations run on them
DIST_RUNS = {2: ([(1, 2), (2, 1)], ["spectral headline", "dark flagship",
                                    "binned defaults"]),
             4: ([(2, 2)], list(DIST_CONFIGS))}
DIST_RANK = "chip_smoke:distribution_rank"
DIST_REPS = 5
# the float64 cut: an event count and an injection count (all but the last)
# that a data size of 2 does not divide, so that a padding event and a
# padding injection run through every kernel of the path
DIST_F64_EVENTS = 63


def dist_likelihood(data: dict, name: str, dtype, n_events: int | None = None):
    """Phase 33's likelihood ``name`` on ``data`` ({"spectral": headline
    mock, "dark": flagship mock}); given ``n_events``, on its first
    ``n_events`` and on every injection but the last."""
    import dataclasses

    which, config, _, _ = DIST_CONFIGS[name]
    d = data[which]
    if n_events is not None:
        d = (cut_events if which == "spectral" else cut_dark_events)(d, n_events)
        i = 1 if which == "spectral" else 3
        d = (*d[:i], dataclasses.replace(d[i], **{
            f.name: getattr(d[i], f.name)[:-1] for f in dataclasses.fields(d[i])}),
            *d[i + 1:])
    if which == "spectral":
        return likelihood(d, dtype, **config)
    return dark_likelihood(d, dtype, **config)


def dist_batch(dtype) -> dict:
    return {"H0": torch.linspace(60.0, 80.0, 16, device=DEV).to(dtype)}


def distribution_rank(data_dir: str, meshes: list, names: list) -> dict:
    """One rank of phase 33, in a process of its own (gloo, the card shared
    with the other ranks): the data the parent saved, each configuration's
    float32 likelihood at full width and float64 at ``DIST_F64_EVENTS``
    events, sharded over each (params, data) mesh.  Per (configuration, mesh): the float32 batch
    with its launches counted (each kernel of the path once), a repeat,
    ms per λ, the float64 batch."""
    from chimera_tpu_torch.parallel import (log_like_batch_sharded, make_mesh,
                                            shard_hyperlikelihood)

    data = {k: torch.load(Path(data_dir, f"{k}.pt"), map_location=DEV,
                          weights_only=False) for k in ("spectral", "dark")}
    out = {}
    for name in names:
        hl32, hl64 = dist_likelihood(data, name, F32), dist_likelihood(
            data, name, F64, n_events=DIST_F64_EVENTS)
        for params, n_data in meshes:
            mesh = make_mesh(params=params, data=n_data, devices=DEV)
            s32 = shard_hyperlikelihood(hl32, mesh)
            b32 = dist_batch(F32)

            def batch():
                return log_like_batch_sharded(s32, b32, mesh)

            ll, launched = counted(batch, DIST_CONFIGS[name][2])
            again = batch()
            ms = cuda_ms(batch, DIST_REPS)
            ll64 = log_like_batch_sharded(shard_hyperlikelihood(hl64, mesh),
                                          dist_batch(F64), mesh)
            out[f"{name} {params}x{n_data}"] = {
                "ll": ll.cpu(), "repeat_same": same_bits(ll, again),
                "launches": launched, "ms_per_lam": statistics.median(ms) / 16,
                "ll64": ll64.cpu(), "events": s32.local.n_events,
                "data": n_data}
        del hl32, hl64
    return out


def rel_hold(got, expect, bar: float, what: str) -> float:
    """Elementwise relative difference, finite where ``expect`` is, held
    to ``bar``."""
    got, expect = got.double().cpu(), expect.double().cpu()
    fin = torch.isfinite(expect)
    if not fin.any() or not torch.equal(fin, torch.isfinite(got)):
        raise AssertionError(f"{what}: non-finite log L: {got.tolist()} "
                             f"against {expect.tolist()}")
    rel = ((got - expect).abs()[fin] / expect.abs()[fin]).max().item()
    if rel > bar:
        raise AssertionError(f"{what}: {rel:.3e} > {bar:.0e}")
    return rel


def distribution(smi: str, full, dark_data) -> None:
    """Phase 33: the distribution layer (``chimera_tpu_torch/parallel``).
    A 1 x 1 mesh under NCCL in this process gives log_like_batch's bits on
    the spectral headline; then 2 and 4 gloo ranks sharing the card (NCCL
    refuses two ranks on one card) shard the spectral headline, the dark
    flagship and the binned defaults on 1 x 2 and 2 x 1 meshes, those and
    kind 'full' on 2 x 2: float32 against the single process's float32
    (the same bits where data = 1, else 1e-6) and float64 (the float32
    bar), float64 at 63 events and all injections but the last (a padding
    event and injection on each data = 2 mesh) against the single
    process's (the same bits where data = 1, else 1e-12), every rank the
    same bits, a repeat the same bits, each kernel of the path once a batch
    on every rank; then dryrun_multichip(4) on the card.  A rank that fails
    or outlasts its timeout fails the phase."""
    import tempfile

    import torch.distributed as dist

    from chimera_tpu_torch.entry import dryrun_multichip
    from chimera_tpu_torch.parallel import (init_distributed,
                                            log_like_batch_sharded, make_mesh,
                                            shard_hyperlikelihood)
    from chimera_tpu_torch.parallel.spawn import run_ranks

    t_phase = time.perf_counter()
    data = {"spectral": full, "dark": dark_data}
    b32, b64 = dist_batch(F32), dist_batch(F64)
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed(require=True, backend="nccl",
                         init_method=f"file://{tmp}/store", rank=0,
                         world_size=1, timeout=120)
        try:
            mesh = make_mesh(params=1, data=1, devices=DEV)
            hl = dist_likelihood(data, "spectral headline", F32)
            shard = shard_hyperlikelihood(hl, mesh)
            got, launched = counted(
                lambda: log_like_batch_sharded(shard, b32, mesh), {"K1a": 1})
            if not same_bits(got, hl.log_like_batch(b32)):
                raise AssertionError("1 x 1 mesh: not log_like_batch's bits")
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
        del hl, shard
    phase(33, "1 x 1 mesh", f"spectral headline, {backend} world size 1: "
          f"log_like_batch's bits, launches "
          f"{ {k: v for k, v in launched.items() if v} } [{smi}]")

    refs = {}
    for name in DIST_CONFIGS:
        hl32 = dist_likelihood(data, name, F32)
        refs[name] = {"ll": hl32.log_like_batch(b32),
                      "ms": statistics.median(cuda_ms(
                          lambda: hl32.log_like_batch(b32), DIST_REPS)) / 16}
        del hl32
        refs[name]["ll64_full"] = dist_likelihood(data, name, F64).log_like_batch(b64)
        refs[name]["ll64"] = dist_likelihood(
            data, name, F64, n_events=DIST_F64_EVENTS).log_like_batch(b64)
        rel_hold(refs[name]["ll"], refs[name]["ll64_full"], DIST_CONFIGS[name][3],
                 f"{name}, one process: float32 vs float64")

    with tempfile.TemporaryDirectory() as tmp:
        torch.save(full, Path(tmp, "spectral.pt"))
        torch.save(dark_data, Path(tmp, "dark.pt"))
        for world, (meshes, names) in DIST_RUNS.items():
            t0 = time.perf_counter()
            ranks = run_ranks(DIST_RANK, world, {"data_dir": tmp, "meshes": meshes,
                                                 "names": names}, timeout=240.0)
            seconds = time.perf_counter() - t0
            for key, res in ranks[0].items():
                name = key.rsplit(" ", 1)[0]
                ref, bar = refs[name], DIST_CONFIGS[name][3]
                for r, other in enumerate(ranks[1:], 1):
                    if not (same_bits(other[key]["ll"], res["ll"])
                            and same_bits(other[key]["ll64"], res["ll64"])):
                        raise AssertionError(f"{key}: rank {r}'s log L is not rank 0's")
                if not all(o[key]["repeat_same"] for o in ranks):
                    raise AssertionError(f"{key}: a repeat gave other bits")
                if res["data"] == 1:
                    # the λ batch split alone: the single process's bits
                    for got, want, what in ((res["ll"], ref["ll"], "float32"),
                                            (res["ll64"], ref["ll64"], "float64")):
                        if not same_bits(got, want.cpu()):
                            raise AssertionError(f"{key}: {what} is not the one "
                                                 "process's bits")
                    held = "the same bits", "the same bits"
                else:
                    held = (f"{rel_hold(res['ll'], ref['ll'], 1e-6, key):.3e} "
                            "(bar 1e-6)",
                            f"{rel_hold(res['ll64'], ref['ll64'], 1e-12, key):.3e} "
                            "(bar 1e-12)")
                rel64 = rel_hold(res["ll"], ref["ll64_full"], bar,
                                 f"{key}: float32 vs one process's float64")
                ms = [o[key]["ms_per_lam"] for o in ranks]
                phase(33, f"{key} mesh", f"{world} gloo ranks sharing one card, "
                      f"{res['events']} events a rank: float32 vs one process: "
                      f"{held[0]}, vs its float64 {rel64:.3e} (bar {bar:.0e}); "
                      f"float64 at {DIST_F64_EVENTS} events vs one process: "
                      f"{held[1]}; every rank the same bits, a repeat the same bits; "
                      f"launches a batch on each rank "
                      f"{ {k: v for k, v in res['launches'].items() if v} }; ms per λ "
                      f"(ranks sharing one card) {min(ms):.4f}-{max(ms):.4f}, one "
                      f"process {ref['ms']:.4f} [{smi}]")
            phase(33, f"{world} ranks", f"{seconds:.1f} s with the ranks' start "
                  f"and builds [{smi}]")

    t0 = time.perf_counter()
    states = dryrun_multichip(4)
    phase(33, "dryrun_multichip(4)", f"4 gloo ranks sharing the card, 2 x 2: "
          f"every rank the same finite walkers and log-probs after one step "
          f"(spectral: {len(states[0]['spectral']['log_prob'])} walkers, dark "
          f"'marginalized'), {time.perf_counter() - t0:.1f} s; phase 33 "
          f"{time.perf_counter() - t_phase:.1f} s [{smi}]")


# ---------------------------------------------------------------------------
# phase 34: data, precompute and the run surface
# ---------------------------------------------------------------------------

# galaxies of the flagship (bench.py::build_dark) and the scale the catalog
# build's docstring names (chimera_tpu/catalog/build.py:155-158)
SURFACE_GALAXIES = (50_000, 1_600_000)
# K-band absolute magnitudes of the mock galaxies and the survey's
# apparent-magnitude limit
SURFACE_MAGS = (-20.5, 1.0, 23.0)
# HEALPix on the card: every power-of-2 nside to 2^13, random points each
HPX_NSIDES = tuple(2 ** k for k in range(14))
HPX_POINTS = 200_000


def surface_galaxies(gen, pop, cat, n_gal: int) -> dict:
    """n_gal mock galaxies on the card: a host at each event's first PE
    sample (z from that sample's distance) and an isotropic background with
    p(z) ∝ dV_C/dz to z = 1.5, each with a K-band absolute magnitude
    (luminosity weight) and its apparent magnitude."""
    from chimera_tpu_torch.data.mock import make_mock_galaxies
    from chimera_tpu_torch.models.cosmology import dl_at_z, z_from_dgw
    from chimera_tpu_torch.utils import apparent_magnitude

    truths = {"z": z_from_dgw(pop.cosmo, cat.dL[None, :, 0])[0],
              "ra": cat.ra[:, 0], "dec": cat.dec[:, 0]}
    gal = make_mock_galaxies(gen, pop, truths, n_background=n_gal - cat.ra.shape[0])
    mu, sig, _ = SURFACE_MAGS
    gal["M"] = mu + sig * torch.randn(gal["z"].shape, generator=gen,
                                      dtype=gal["z"].dtype, device=DEV)
    gal["m"] = apparent_magnitude(gal["M"], dl_at_z(pop.cosmo, gal["z"][None])[0])
    return gal


def surface_completeness(gal, pop, n_background: int):
    """The homogeneous completeness of the galaxies brighter than the
    apparent-magnitude limit against a constant theoretical density (twice
    the background's over its comoving volume to z = 1.5, full sky: the
    catalog at most half complete, so that an event whose host the limit
    removed keeps p_gal = (1 - P_compl) p_bkg > 0), on a table to z = 3
    (tests/test_likelihood_pixelated.py::test_homogeneous_completeness)."""
    from chimera_tpu_torch.catalog import HomogeneousCompleteness
    from chimera_tpu_torch.models.cosmology import comoving_volume

    v_mpc3 = 1e9 * comoving_volume(pop.cosmo, torch.full((1, 1), 1.5, dtype=F64,
                                                         device=DEV)).item()
    density = 2.0 * n_background / v_mpc3
    seen = gal["m"] < SURFACE_MAGS[2]
    return HomogeneousCompleteness.create(
        gal["z"][seen], lambda z: torch.full_like(z, density), pop.cosmo,
        sky_area_deg2=41252.96, z_range=(0.001, 3.0), n_bins=60)


def nest_vs_ring(cat_r, gal_r, cat_n, gal_n) -> tuple[float, int]:
    """Each physical pixel's p_cat row of a NESTED build against the RING
    build's (pixels matched through nest2ring), relative to the row's
    largest value; the events' n_gal equal.  Returns (max rel err, rows)."""
    from chimera_tpu_torch.ops import healpix as hpx

    if not torch.equal(gal_r.n_gal, gal_n.n_gal):
        raise AssertionError("NEST and RING builds count different galaxies")
    if not torch.equal(cat_r.opt_nsides, cat_n.opt_nsides) or not torch.equal(
            cat_r.pixel_mask.sum(1), cat_n.pixel_mask.sum(1)):
        raise AssertionError("NEST and RING pixelizations differ")
    ring_of_nest = cat_n.pixels_opt_nsides.clone()
    for ns in cat_n.opt_nsides.unique().tolist():
        sel = cat_n.opt_nsides == ns
        ring_of_nest[sel] = hpx.nest2ring(int(ns), cat_n.pixels_opt_nsides[sel]
                                          .clamp_min(0))
    big = torch.iinfo(torch.int64).max
    key_n = torch.where(cat_n.pixel_mask, ring_of_nest, big)
    key_r = torch.where(cat_r.pixel_mask, cat_r.pixels_opt_nsides, big)
    key_n, order_n = torch.sort(key_n, dim=1)
    key_r, order_r = torch.sort(key_r, dim=1)
    if not torch.equal(key_n, key_r):
        raise AssertionError("NEST and RING pixel sets differ")
    rows = torch.sort(cat_r.pixel_mask.long(), dim=1, descending=True)[0].bool()
    p_n = torch.take_along_dim(gal_n.p_cat, order_n[..., None], dim=1)[rows]
    p_r = torch.take_along_dim(gal_r.p_cat, order_r[..., None], dim=1)[rows]
    row_max = p_r.abs().amax(dim=-1, keepdim=True).clamp_min(1e-300)
    return ((p_n - p_r).abs() / row_max).max().item(), int(rows.sum())


def surface_kde(hl, dtype, n_grad_events: int = 64) -> dict:
    """``kde1d_batch`` on the dark rows' source-frame redshifts and weights
    at H0 = 70 on each row's event grid (500 points): ONE K4 launch for all
    rows, held to its plain version (float32 within 1e-4, float64 within
    1e-10 of each live row's largest value); under autograd on the first
    ``n_grad_events`` events' rows one K4 and one K4b, their d/dz and d/dw
    held the same way (float32 against the float64 plain version on the
    same inputs)."""
    from chimera_tpu_torch.ops import kde
    from chimera_tpu_torch.ops.cuda.kde import kde1d_grid_plain

    pop = hl.population
    z, w = _z_and_w(hl.row_m1det, hl.row_m2det, hl.row_dL, hl.row_inv_pe_prior,
                    pop.cosmo, pop.mass)
    n_rows = hl.rows_per_event
    z, w = z[0].to(dtype), w[0].to(dtype)
    grids = hl.z_grids.repeat_interleave(n_rows, dim=0).to(dtype)
    live = w.sum(-1) > 0
    tol = 1e-4 if dtype == F32 else 1e-10

    def plain(z, grids, w):
        wn, h = kde.kde1d_params(z, w, None)
        return kde1d_grid_plain(z, wn, grids, h)

    def row_err(got, expect, rows):
        got, expect = got.double()[rows], expect.double()[rows]
        scale = expect.abs().amax(dim=-1, keepdim=True).clamp_min(1e-300)
        return ((got - expect).abs() / scale).max().item()

    out, launched = counted(lambda: kde.kde1d_batch(z, grids, w), {"K4": 1})
    fwd = row_err(out, plain(z, grids, w), live)
    ms = statistics.median(cuda_ms(lambda: kde.kde1d_batch(z, grids, w), 5))
    p_ms = statistics.median(cuda_ms(lambda: plain(z, grids, w), 2))

    cut = n_grad_events * n_rows
    zs, ws, gs = z[:cut].clone(), w[:cut].clone(), grids[:cut]
    ct = torch.randn(gs.shape, generator=torch.Generator(device=DEV).manual_seed(
        SEED + 34), dtype=dtype, device=DEV)

    def grads(fn, zs, ws):
        zs, ws = zs.requires_grad_(), ws.requires_grad_()
        return torch.autograd.grad((fn(zs, gs.to(zs.dtype), ws)
                                    * ct.to(zs.dtype)).sum(), (zs, ws))

    card, _ = counted(lambda: grads(kde.kde1d_batch, zs, ws), {"K4": 1, "K4b": 1})
    ref = grads(plain, zs.detach().double(), ws.detach().double())
    rows = live[:cut]
    bwd = max(row_err(a, b, rows) for a, b in zip(card, ref))
    if not (fwd <= tol and bwd <= tol):
        raise AssertionError(f"kde1d_batch {dtype}: K4 {fwd:.3e}, K4b {bwd:.3e} "
                             f"(tol {tol:.0e}) of the row max")
    return {"rows": int(live.sum()), "of": live.numel(), "fwd": fwd, "bwd": bwd,
            "ms": ms, "plain_ms": p_ms, "launches": launched["K4"]}


def surface_healpix() -> dict:
    """HEALPix on the card against the port's C++ oracle: for every nside
    to 2^13, random points, the poles, phi = 0 and 2 pi, the caps' edges
    and random pixels' corners pulled 1e-6 of the way to their centres;
    ang2pix and pix2ang in both schemes, ring2nest / nest2ring and
    convert_pixelization (the oracle's through the pixel centres),
    boundaries; indices equal, angles within 1e-15."""
    import numpy as np

    from chimera_tpu_torch import native
    from chimera_tpu_torch.ops import healpix as hpx

    rng = np.random.default_rng(SEED + 34)
    worst, n_idx = 0.0, 0
    for nside in HPX_NSIDES:
        npix = 12 * nside * nside
        theta = np.concatenate([np.arccos(rng.uniform(-1.0, 1.0, HPX_POINTS)),
                                [0.0, np.pi, 0.5 * np.pi, 0.5 * np.pi,
                                 np.arccos(2 / 3), np.arccos(-2 / 3)]])
        phi = np.concatenate([rng.uniform(0.0, 2.0 * np.pi, HPX_POINTS),
                              [0.0, 2.0 * np.pi, 0.0, 2.0 * np.pi, 1.0, 2.0]])
        pix = np.unique(np.concatenate([rng.integers(0, npix, 2000), [0, npix - 1]]))
        for nest in (False, True):
            bt, bp = native.boundaries(nside, pix, 2, nest)
            ct, cp = native.pix2ang(nside, pix, nest)
            dphi = np.remainder(bp - cp[:, None] + np.pi, 2 * np.pi) - np.pi
            th_in = bt + (ct[:, None] - bt) * 1e-6
            ph_in = np.remainder(cp[:, None] + dphi * (1 - 1e-6), 2 * np.pi)
            th_all = np.concatenate([theta, th_in.ravel()])
            ph_all = np.concatenate([phi, ph_in.ravel()])
            got = hpx.ang2pix(nside, torch.tensor(th_all, device=DEV),
                              torch.tensor(ph_all, device=DEV), nest).cpu().numpy()
            expect = native.ang2pix(nside, th_all, ph_all, nest)
            corners = expect[theta.size:].reshape(th_in.shape)
            if not (np.array_equal(got, expect)
                    and np.array_equal(corners, np.broadcast_to(pix[:, None],
                                                                corners.shape))):
                raise AssertionError(f"ang2pix nside {nside} nest={nest}")
            n_idx += got.size
            pix_t = torch.tensor(expect, device=DEV)
            for a, b in zip(hpx.pix2ang(nside, pix_t, nest),
                            native.pix2ang(nside, expect, nest)):
                worst = max(worst, np.abs(a.cpu().numpy() - b).max())
            for a, b in zip(hpx.boundaries(nside, torch.tensor(pix, device=DEV), 3,
                                           nest),
                            native.boundaries(nside, pix, 3, nest)):
                worst = max(worst, np.abs(a.cpu().numpy() - b).max())
            other = hpx.ring2nest if not nest else hpx.nest2ring
            expect_other = native.ang2pix(nside, *native.pix2ang(nside, expect, nest),
                                          not nest)
            if not np.array_equal(other(nside, pix_t).cpu().numpy(), expect_other):
                raise AssertionError(f"{other.__name__} nside {nside}")
            out = max(1, nside // 2)
            conv = hpx.convert_pixelization(pix_t, nside, out, nest, not nest)
            if not np.array_equal(conv.cpu().numpy(), native.ang2pix(
                    out, *native.pix2ang(nside, expect, nest), not nest)):
                raise AssertionError(f"convert_pixelization nside {nside}")
    if worst > 1e-15:
        raise AssertionError(f"HEALPix angles on the card {worst:.3e} from the "
                             "C++ oracle (tol 1e-15)")
    return {"indices": n_idx, "angle_err": worst}


SURFACE_TOML = """[cosmology]
model = "flrw"
H0 = 70.0
Om0 = 0.25

[mass]
model = "plp"

[rate]
model = "madau_dickinson"

[likelihood]
kind = "marginalized"
binning = false

[catalog]
completeness = "dvdz"
z_range = [0.0, 3.0]
kind = "step"
z_err = 0.01

[pixelization]
nside_list = [8, 16, 32]
mean_npixels_event = 8
sky_conf = 0.9

[prior.H0]
range = [40.0, 120.0]

[data]
events = 1000
samples = 1024
galaxies = 50000
injections = 500000
z_int_res = 500
seed = 1
"""


def surface(smi: str, dark_data) -> None:
    """Phase 34: the data, precompute and run surface on the dark
    flagship's events (1000 x 1024, 500-point grids, 500 000 generated
    injections): the pixelization in RING and NEST, the homogeneous
    completeness and the catalog build with luminosity weights, an
    apparent-magnitude mask, sumgauss='pbkg' and the z reshuffle at 50 000
    and 1 600 000 galaxies (setup seconds per stage, peak device memory),
    NEST held to RING; kind 'marginalized' on that catalog (K1c and K2
    once a batch, float32 vs float64, timing beside the step
    completeness' catalog); ``kde1d_batch`` through K4 and K4b; HEALPix
    against the C++ oracle; a TOML run through ``runconfig`` with the
    ensemble sampler; localization on the card against the CPU; the HDF5
    round trips where h5py imports."""
    import importlib.util
    import tempfile

    from chimera_tpu_torch import HyperLikelihood, SelectionFunction, runconfig
    from chimera_tpu_torch.catalog.build import build_pixelated_catalog
    from chimera_tpu_torch.data.localization import (localization_areas,
                                                     localization_volumes)
    from chimera_tpu_torch.data.pixelize import pixelize_gw_catalog
    from chimera_tpu_torch.inference import (init_state, initialize_walkers,
                                             make_vector_log_prob, run)
    from chimera_tpu_torch.models import FLRW
    from chimera_tpu_torch.utils import StageTimer, mag2lum

    t_phase = time.perf_counter()
    cat0, z_grids, _, inj, n_gen = dark_data
    timer = StageTimer()
    pop = population(F64)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 34)

    # ---- precompute in both schemes at both galaxy counts ----------------
    cats = {}
    for nest in (False, True):
        cats[nest] = timer.time_fn(
            f"pixelize {'NEST' if nest else 'RING'}", pixelize_gw_catalog, cat0,
            nside_list=[8, 16], mean_npixels_event=15, sky_conf=0.9, nest=nest)
    built = {}
    for n_gal in SURFACE_GALAXIES:
        torch.cuda.reset_peak_memory_stats(DEV)
        gal = timer.time_fn(f"galaxies {n_gal}", surface_galaxies, gen, pop, cat0,
                            n_gal)
        compl = timer.time_fn(f"completeness {n_gal}", surface_completeness, gal,
                              pop, n_gal - cat0.ra.shape[0])
        weights = mag2lum(gal["M"], "K")
        mask = gal["m"] < SURFACE_MAGS[2]
        for nest in (False, True):
            name = f"catalog {n_gal} {'NEST' if nest else 'RING'}"
            built[n_gal, nest] = timer.time_fn(
                name, build_pixelated_catalog, gal, cats[nest], z_grids, pop.cosmo,
                compl, z_err=0.01, weights=weights, mask=mask, sumgauss="pbkg",
                nest=nest, z_reshuffle_seed=SEED + 34)
        peak = torch.cuda.max_memory_allocated(DEV) / 2 ** 30
        rel, rows = nest_vs_ring(cats[False], built[n_gal, False], cats[True],
                                 built[n_gal, True])
        if rel > 1e-12:
            raise AssertionError(f"NEST vs RING p_cat {rel:.3e} of the row max")
        seconds = {k: v for k, v in timer.times.items() if str(n_gal) in k}
        phase(34, f"precompute {n_gal} galaxies", f"{int(mask.sum())} brighter "
              f"than m = {SURFACE_MAGS[2]}; setup "
              + ", ".join(f"{k} {v:.3f} s" for k, v in seconds.items())
              + f"; peak device memory {peak:.2f} GiB; NEST vs RING p_cat max "
              f"{rel:.3e} of the row max over {rows} pixel rows (tol 1e-12), "
              f"n_gal equal ({int(built[n_gal, False].n_gal.sum())} voxel "
              f"galaxies) [{smi}]")
        del gal
    cat, gal_cat = cats[False], built[SURFACE_GALAXIES[0], False]
    del built

    # ---- the likelihood on the homogeneous completeness -------------------
    # (above H0 = 60: phase 8's batch gates its two lowest H0 values to the
    # dtype's lowest number, which a float32-vs-float64 ratio cannot hold)
    h0s = torch.linspace(62.0, 92.0, 16, device=DEV)
    hls = {dtype: timer.time_fn(
        f"create {dtype}", lambda dtype=dtype: HyperLikelihood.create(
            cat, z_grids, population(dtype, gal_cat),
            SelectionFunction.create(inj, n_gen), kind="marginalized",
            binning=False, cut_grid=None)) for dtype in (F64, F32)}
    for dtype, hl in hls.items():
        ll, _ = counted(lambda hl=hl, dtype=dtype: hl.log_like_batch(
            {"H0": h0s.to(dtype)}), {"K1c": 1, "K2": 1})
        check_log_like(ll.double(), h0s, {"K1c": 1, "K2": 1})
    rel, diff, n_fin = f32_vs_f64(hls[F64], hls[F32], h0s)
    reps, n = 17, len(h0s)
    per_l = {}
    dvdz = dark_likelihood(dark_data, F32)
    for name, hl, dtype in (("homogeneous f64", hls[F64], F64),
                            ("homogeneous f32", hls[F32], F32),
                            ("step completeness f32", dvdz, F32)):
        batch = {"H0": h0s.to(dtype)}
        per_l[name] = med_mad([t / n for t in cuda_ms(
            lambda hl=hl, batch=batch: hl.log_like_batch(batch), reps)])
    del dvdz
    phase(34, "homogeneous completeness", f"'marginalized' on the "
          f"{SURFACE_GALAXIES[0]}-galaxy catalog (luminosity weights, the "
          f"magnitude mask, sumgauss='pbkg'): "
          f"K1c and K2 once a batch; float32 vs float64 log L max rel err "
          f"{rel:.3e} (bar 1e-6), max abs {diff:.3e} over {n_fin} of {n} H0 "
          f"values; per λ over {reps} batches of {n} (median ± MAD): "
          + ", ".join(f"{k} {m:.4f} ± {d:.4f} ms" for k, (m, d) in per_l.items())
          + f" (the step completeness' catalog on the same events: a note, not "
          f"a claim) [{smi}]")

    # ---- kde1d_batch through K4 and K4b -----------------------------------
    for dtype, hl in hls.items():
        r = surface_kde(hl, dtype)
        phase(34, f"kde1d_batch {dtype}", f"{r['rows']} live of {r['of']} dark "
              f"rows x 128 samples x 500 grid points: one K4 launch, max err "
              f"{r['fwd']:.3e} of the row max; under autograd one K4 + one K4b, "
              f"d/dz and d/dw max err {r['bwd']:.3e}; kernel {r['ms']:.3f} ms, "
              f"plain {r['plain_ms']:.3f} ms per call [{smi}]")
    del hls

    # ---- HEALPix against the C++ oracle -----------------------------------
    r = timer.time_fn("healpix vs oracle", surface_healpix)
    phase(34, "HEALPix", f"nside 1 to {HPX_NSIDES[-1]}, {HPX_POINTS} random "
          f"points each plus the poles, phi = 0 and 2 pi, the caps' edges and "
          f"pixel corners: {r['indices']} ang2pix indices, ring2nest, "
          f"nest2ring, convert_pixelization equal to the C++ oracle; pix2ang "
          f"and boundaries max {r['angle_err']:.3e} rad (tol 1e-15) [{smi}]")

    # ---- the run surface: TOML -> runconfig -> ensemble -------------------
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp, "dark_siren.toml")
        path.write_text(SURFACE_TOML)
        cfg = runconfig.RunConfig.load(str(path))
    d = cfg.data
    if (d["events"], d["samples"], d["z_int_res"]) != (
            cat0.dL.shape[0], cat0.dL.shape[1], z_grids.shape[1]):
        raise AssertionError("the TOML's [data] is not the flagship's width")
    cat_cfg = timer.time_fn("runconfig pixelize", pixelize_gw_catalog, cat0,
                            **runconfig.pixelization_kwargs(cfg))
    gal = surface_galaxies(gen, pop, cat0, d["galaxies"])
    cfg_cat = timer.time_fn(
        "runconfig catalog", build_pixelated_catalog, gal, cat_cfg, z_grids,
        pop.cosmo, runconfig.build_completeness(cfg, device=DEV, dtype=F64),
        z_err=cfg.catalog["z_err"])
    hl = timer.time_fn("runconfig likelihood", runconfig.build_likelihood, cfg,
                       cat_cfg, z_grids,
                       runconfig.build_population(cfg, cfg_cat, device=DEV,
                                                  dtype=F32),
                       SelectionFunction.create(inj, n_gen))
    bounds = runconfig.prior_bounds(cfg)
    names = list(bounds)
    log_prob = make_vector_log_prob(hl, names, bounds)
    chains = []
    for _ in range(2):
        g = torch.Generator(device=DEV).manual_seed(SEED + 341)
        x0 = initialize_walkers(g, {"H0": 70.0}, 32, names, bounds=bounds,
                                dtype=F32)
        state, hist = timer.time_fn("ensemble 5 steps x 32 walkers", run, g,
                                    init_state(x0, log_prob), log_prob, 5)
        chains.append((hist["coords"], hist["log_prob"]))
    x, lp = chains[0]
    lo, hi = bounds["H0"]
    if not (same_bits(x, chains[1][0]) and same_bits(lp, chains[1][1])
            and torch.all(torch.isfinite(x)) and torch.all(torch.isfinite(lp))
            and torch.all((x > lo) & (x < hi))):
        raise AssertionError("the TOML run's ensemble: not finite, out of bounds "
                             "or not the same bits on a repeat")
    phase(34, "run surface", f"TOML ({len(SURFACE_TOML.splitlines())} lines, "
          f"dark_siren.toml's sections, [data] at the flagship's width) -> "
          f"runconfig: nside {cfg.pixelization['nside_list']}, P = "
          f"{hl.n_pixels}, kind {hl.kind}, cut_grid {hl.cut_grid}; ensemble "
          f"{x.shape[1]} walkers x {x.shape[0]} steps, acceptance "
          f"{state.n_accepted.float().mean().item() / x.shape[0]:.2f}, H0 "
          f"{x[-1].mean().item():.2f} ± {x[-1].std().item():.2f}, the same bits "
          f"on a repeat [{smi}]")
    del hl, cfg_cat, gal

    # ---- localization on the card against the CPU --------------------------
    theta, phi, dl = 0.5 * math.pi - cat0.dec, cat0.ra, cat0.dL
    lo_c, hi_c = (FLRW.create(H0=h, device=DEV, dtype=F64) for h in (120.0, 40.0))
    lo_p, hi_p = (FLRW.create(H0=h, device="cpu", dtype=F64) for h in (120.0, 40.0))
    errs = []
    for card, cpu in (
            (localization_areas(theta, phi), localization_areas(theta.cpu(), phi.cpu())),
            (localization_volumes(theta, phi, dl, lo_c, hi_c),
             localization_volumes(theta.cpu(), phi.cpu(), dl.cpu(), lo_p, hi_p))):
        errs.append(((card.cpu() - cpu).abs() / cpu.abs()).max().item())
    if max(errs) > 1e-12:
        raise AssertionError(f"localization on the card vs the CPU: {errs}")
    phase(34, "localization", f"{theta.shape[0]} events: areas max rel err "
          f"{errs[0]:.3e}, volumes {errs[1]:.3e} (tol 1e-12) [{smi}]")

    # ---- HDF5 ---------------------------------------------------------------
    if importlib.util.find_spec("h5py") is None:
        phase(34, "HDF5", "h5py is not installed here: the HDF5 round trips "
              "(catalogs, PE samples, injections, galaxies, chains, HMC "
              "checkpoints) are held on the CPU by tests/test_torch_io.py")
    else:
        from chimera_tpu_torch.catalog.build import (load_pixelated_catalog,
                                                     save_pixelated_catalog)
        from chimera_tpu_torch.data import io

        with tempfile.TemporaryDirectory() as tmp:
            save_pixelated_catalog(f"{tmp}/cat.h5", gal_cat)
            back = load_pixelated_catalog(f"{tmp}/cat.h5", gal_cat.completeness,
                                          device=DEV, dtype=F64)
            io.save_pixelated_gw_catalog(cat, f"{tmp}/pix.h5")
            pix = io.load_pixelated_gw_catalog(f"{tmp}/pix.h5", device=DEV)
        if not (same_bits(back.p_cat, gal_cat.p_cat)
                and torch.equal(pix.pixels_opt_nsides[cat.pixel_mask],
                                cat.pixels_opt_nsides[cat.pixel_mask])):
            raise AssertionError("HDF5 round trip on the card")
        phase(34, "HDF5", f"catalog and pixelization round trips equal [{smi}]")
    phase(34, "stages", timer.report() + f"; phase 34 in "
          f"{time.perf_counter() - t_phase:.1f} s [{smi}]")



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

    # ---- 2. kernel builds, one nvcc per source and mass model, in parallel
    from chimera_tpu_torch.ops.cuda.fused import MASS_KINDS

    t0 = time.perf_counter()
    libs = [(name, kind) for name in ("fused_kde", "rows_contract",
                                      "fused_kde_adjoint",
                                      "rows_contract_adjoint")
            for model, kind in MASS_KINDS.items()
            if "adjoint" not in name or model != "PowerLawSpline"]
    libs += [("kde1d", 0), ("kde3d", 0)]
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: build.load(*lib), libs))
    for name in (build.lib_name(*lib) for lib in libs):
        info = build.build_info.get(name, {})
        ptxas = [ln.split("ptxas info    :")[-1].strip()
                 for ln in info.get("log", "").splitlines()
                 if "entry function" in ln or "registers" in ln
                 or "spill" in ln]
        phase(2, f"kernel build {name}", f"nvcc {info.get('seconds', 0.0):.2f} s; "
              + " | ".join(ptxas) + f" [{smi}]")
    phase(2, "kernel builds", f"{time.perf_counter() - t0:.2f} s in all [{smi}]")

    k1a, full = spectral(smi)
    dark_entries, dark_data = dark(smi)
    kernels = [k1a, *dark_entries, sampler(smi, full),
               *reference_defaults(smi, full, dark_data),
               *dark_gradients(smi, full, dark_data, dark_entries),
               contract_path(smi, dark_data),
               binned_gradients(smi, full, dark_data)]
    k5, hl_full = full_path(smi, dark_data)
    kernels.append(ensemble(smi, full, hl_full, k5))
    del hl_full
    model_modes(smi)
    population_models(smi, full, dark_data)
    distribution(smi, full, dark_data)
    surface(smi, dark_data)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--k3-ab"]:
        dirs = [d for d in sys.argv[2:] if d != "--only-k5"]
        cut = dirs.index("--variants") if "--variants" in dirs else len(dirs)
        k3_ab(dirs[:cut], dirs[cut + 1:], "--only-k5" in sys.argv)
    else:
        main()
