"""Which stage of a float32 likelihood batch depends on the batch size on
the card: the reason a params split (a rank evaluating 8 of 16 λ) could
miss the single process's bits.

    python3 tools/batch_bits.py        # on the card; ~50 s with the builds

On the spectral headline (``chip_smoke.mock(1000, 4096, 2_000_000, 500,
200, SEED)``: K1a), the dark flagship (``chip_smoke.dark_mock(1000, 1024,
15, 500, 500_000, 50_000, SEED + 8)``: K1c + K2) and the binned defaults
on the headline (K4), all float32, each stage of the batch is evaluated for
the 16 H0 values of phase 33 and for rows [0, 8) and [8, 16) of them as
batches of 8: the population's tables, the kernels' outputs, the
numerators, the log numerators, the summed log numerators, the
selection's two sums over the injections, N_exp and log L.  Prints, per
stage, the number of entries whose bits differ between the rows of the
16-batch and the 8-batch and the largest difference; then the three sums
of the 8-batch taken at the rows' place in a 16-row batch
(``pytree.batch_sum``, what ``log_like_batch_sharded`` does).  Without a
card it runs on the CPU at a tiny size (a rehearsal).
"""

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from chimera_tpu_torch import likelihood as lk  # noqa: E402
from chimera_tpu_torch.models.population import pop_rate_det  # noqa: E402
from chimera_tpu_torch.ops.cuda import build  # noqa: E402
from chimera_tpu_torch.pytree import batch_sum, tensor_map  # noqa: E402


def leaves(obj) -> list:
    out = []
    tensor_map(obj, lambda t: out.append(t) or t)
    return out


def stages(hl, batch: dict) -> tuple[dict, object]:
    """Every stage of ``hl``'s batch at ``batch``, in order, and the
    updated population."""
    pop = hl.population.update_batch(batch)
    st = {"population": leaves(pop)}
    if hl.kind == "1d" and not hl.staged:
        pe = (hl.m1det, hl.m2det, hl.dL, hl.inv_pe_prior, pop.cosmo, pop.mass)
        den, stats = lk.fused_weights_kde(*pe, hl.z_grids, kernel=hl.kernel,
                                          bw_method=hl.bw_method)
        st["K1a densities"], st["K1a stats"] = den, list(stats.values())
        num = hl.numerators_from_densities(pop, den, stats)
    elif hl.kind == "marginalized":
        stats = hl._pixel_stats(pop)
        f1, f2, fr = hl.lambda_factors(pop)
        scales = hl.row_scales(stats)
        r = lk.fused_rows_contract(
            hl.row_m1det, hl.row_m2det, hl.row_dL, hl.row_inv_pe_prior,
            pop.cosmo, pop.mass, hl.z_grids, scales, hl.row_s1, hl.row_s2,
            f1, f2, kernel=hl.kernel)
        st["K1c stats"], st["f1 f2 fR"] = list(stats.values()), [f1, f2, fr]
        st["row scales"], st["K2 r"] = scales, r
        num = hl._contracted_numerators(stats, r, fr, hl.rows_per_event)
    else:
        num = hl.batch_numerators(pop)
    st["numerators"] = num
    st["log numerators"] = hl._log_evs(num)
    st["summed log numerators"] = hl.sum_log_evs(num)
    st["dN/p_draw"] = torch.nan_to_num(pop_rate_det(pop, hl.selection.theta_inj)
                                       / hl.selection.p_draw)
    s1, s2 = hl.selection.partial_sums(pop)
    st["selection s1"], st["selection s2"] = s1, s2
    st["N_exp"] = hl.selection.n_exp_from_sums(pop, s1, s2)
    st["log L"] = hl.log_like_batch(batch)
    return st, pop


def differ(a, b) -> tuple[int, float] | list:
    """(entries whose bits differ, the largest absolute difference)."""
    if isinstance(a, list):
        return [differ(x, y) for x, y in zip(a, b)]
    a, b = a.double(), b.double()
    ne = ~((a == b) | (torch.isnan(a) & torch.isnan(b)))
    return int(ne.sum()), float((a - b).abs()[ne].max()) if ne.any() else 0.0


def rows_of(v, rows: slice, n: int):
    if isinstance(v, list):
        return [t[rows] if t.dim() and t.shape[0] == n else t for t in v]
    return v[rows]


def main() -> None:
    t0 = time.perf_counter()
    if torch.cuda.is_available():
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        for lib in (("fused_kde", 0), ("rows_contract", 0), ("kde1d", 0)):
            build.load(*lib)
        data = {"spectral": cs.mock(1000, 4096, 2_000_000, 500, 200, cs.SEED),
                "dark": cs.dark_mock(1000, 1024, 15, 500, 500_000, 50_000,
                                     cs.SEED + 8)[0]}
    else:
        smi = "CPU rehearsal"
        cs.DEV = torch.device("cpu")
        torch.cuda.synchronize = lambda *a, **k: None
        data = {"spectral": cs.mock(12, 256, 20_000, 64, 300, cs.SEED),
                "dark": cs.dark_mock(12, 128, 6, 48, 20_000, 3000, cs.SEED + 8)[0]}
    print(f"{smi}; torch {torch.__version__}; data {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name in ("spectral headline", "dark flagship", "binned defaults"):
        hl = cs.dist_likelihood(data, name, cs.F32)
        b16 = cs.dist_batch(cs.F32)
        s16, _ = stages(hl, b16)
        for rows in (slice(0, 8), slice(8, 16)):
            s8, _ = stages(hl, {"H0": b16["H0"][rows]})
            tag = f"[{name}, rows {rows.start}-{rows.stop - 1}]"
            for k, v in s16.items():
                print(f"{tag} {k}: (entries that differ, largest difference) "
                      f"{differ(rows_of(v, rows, 16), s8[k])}", flush=True)
            place = (16, rows.start)
            dn = s8["dN/p_draw"]
            print(f"{tag} summed at their place in 16 rows: log numerators "
                  f"{differ(s16['summed log numerators'][rows], batch_sum(s8['log numerators'], place))}, "
                  f"s1 {differ(s16['selection s1'][rows], batch_sum(dn, place))}, "
                  f"s2 {differ(s16['selection s2'][rows], batch_sum(dn * dn, place))} "
                  f"[{smi}]", flush=True)
        del hl


if __name__ == "__main__":
    main()
