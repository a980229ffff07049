"""On-card check of the PyTorch port: builds the CUDA kernel from this
checkout, holds it against its plain PyTorch version, drives the
spectral-siren hyper-likelihood batch end to end at the headline width
(1000 events x 4096 PE samples x 500-point z-grids, 2 000 000 generated
injections, a batch of 16 H0 values), checks float32 against float64, and
times the batch.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; imports no JAX.  Any failed phase raises and
the script exits non-zero.  The last line of standard output is
{"ok": true, "device": {...}}; the line before it lists each kernel with its
launch count on the end-to-end run, its error against the plain version and
both times.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

SEED = 20261016
DEV = torch.device("cuda", 0)
F32, F64 = torch.float32, torch.float64


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


def population(dtype):
    from chimera_tpu_torch.models import (FLRW, MadauDickinsonRate, Population,
                                          PowerLawPeak)

    return Population.create(
        FLRW.create(H0=70.0, Om0=0.25, device=DEV, dtype=dtype),
        PowerLawPeak.create(device=DEV, dtype=dtype),
        MadauDickinsonRate.create(device=DEV, dtype=dtype))


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


def likelihood(data, dtype):
    from chimera_tpu_torch import HyperLikelihood, SelectionFunction

    cat, inj, n_gen, z_grids = data
    return HyperLikelihood.create(cat, z_grids, population(dtype),
                                  SelectionFunction.create(inj, n_gen),
                                  binning=False, cut_grid=None)


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
    from chimera_tpu_torch.ops.cuda.fused import (fused_weights_kde,
                                                  fused_weights_kde_plain)

    # ---- 2. kernel build -------------------------------------------------
    t0 = time.perf_counter()
    build.load("fused_kde")
    info = build.build_info.get("fused_kde", {})
    ptxas = [ln.split("ptxas info    :")[-1].strip()
             for ln in info.get("log", "").splitlines()
             if "entry function" in ln or "registers" in ln]
    phase(2, "kernel build", f"{time.perf_counter() - t0:.2f} s (nvcc "
          f"{info.get('seconds', 0.0):.2f} s); " + " | ".join(ptxas))

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
    if ll.shape != (16,):
        raise AssertionError(f"log-likelihood shape {tuple(ll.shape)}")
    if torch.isnan(ll).any() or torch.isposinf(ll).any():
        raise AssertionError(f"NaN or +inf log-likelihoods: {ll.tolist()}")
    if launches < 1:
        raise AssertionError("the main path never launched the fused kernel")
    h0_best = h0s[int(torch.argmax(ll))].item()
    if not 60.0 <= h0_best <= 80.0:
        raise AssertionError(f"H0 argmax {h0_best} outside [60, 80]")
    phase(4, "end to end", f"{hl.n_events} events x {hl.dL.shape[1]} samples x "
          f"{hl.z_grids.shape[1]} grid, {hl.selection.dL.shape[0]} detected "
          f"injections of 2000000, setup {setup_s:.1f} s; kernel launches "
          f"{launches}; H0 argmax {h0_best:.2f}; "
          f"log L = {[round(v, 4) for v in ll.tolist()]}")

    # ---- 5. precision: float32 vs float64 through the kernel -------------
    par = mock(64, 1024, 200_000, 300, 300, SEED + 5)
    h0s7 = torch.linspace(58.0, 100.0, 7, device=DEV)
    ll64 = likelihood(par, F64).log_like_batch({"H0": h0s7})
    ll32 = likelihood(par, F32).log_like_batch({"H0": h0s7.to(F32)}).double()
    fin = torch.isfinite(ll64)
    if not fin.any() or not torch.equal(fin, torch.isfinite(ll32)):
        raise AssertionError(f"non-finite log L: f64 {ll64.tolist()}, "
                             f"f32 {ll32.tolist()}")
    rel = ((ll32 - ll64).abs() / ll64.abs())[fin].max().item()
    if rel > 1e-6:
        raise AssertionError(f"float32 vs float64: {rel:.3e} > 1e-6")
    phase(5, "precision", f"float32 vs float64 log L max rel {rel:.3e} "
          f"(bar 1e-6) over {int(fin.sum())} of 7 H0 values")
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
    phase(6, "kernel vs plain", f"[{smi}] at 1000 x 4096 x 500, L = 16: kernel "
          f"{k_call:.3f} ms, plain {p_call:.3f} ms per call "
          f"({p_call / k_call:.1f}x); den max err {den_rel:.3e} of row max, "
          f"stats {stat_rel:.3e}")

    print(json.dumps({"kernels": [{
        "name": "fused_weights_kde", "route": "cuda",
        "source": "chimera_tpu_torch/csrc/fused_kde.cu",
        "replaces": "chimera_tpu/ops/pallas/fused.py:71",
        "launches": launches, "max_abs_err": den_abs,
        "ms": k_call, "plain_ms": p_call}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
