"""Attribution of the kernels' time on the card (K3, K2b, K2, K4b, K3b, K3d,
K1b, K4, K1e, K1d, K5 and K5b):
variant trees with one change each, timed against each other by
``chip_smoke.py --k3-ab``, and the instruction mix of K3's pair loop
(phase B) in SASS.

    git archive <parent commit> | tar -x -C build/parent
    python3 tools/k3_variants.py trees build/parent
    python3 chip_smoke.py --k3-ab build/parent --variants build/k3/sel ...
    cuobjdump -sass build/kernels/fused_kde_adjoint-*.so > k3.sass   # on the card
    python3 tools/k3_variants.py sass k3.sass
    python3 tools/k3_variants.py sassdiff parent.sass k3.sass

``trees`` writes build/k3/<name>, a copy of what ``--k3-ab`` runs of this
tree (or of the parent's, for the names that start with ``parent_``):
``chip_smoke.py`` and ``chimera_tpu_torch/``, with the substitutions of
VARIANTS; each must match once (of an ``Either``, one alternative's).  The variants change timing only: the
early returns leave the gradients unfinished.  ``sass`` prints, for the
float32 Epanechnikov K3 (``fused_kde_adjoint_kernel<float, float, 0, 0>``)
of each dump, the instructions of its pair loop: the innermost loop with
one shared-memory load, 2 grid points x kSamplesPerThread = 4 samples, 8
(grid point, sample) terms an iteration.  ``sassdiff`` prints, for each
function of two dumps (a parent's and this tree's), its instruction
counts and whether its instructions are the same."""

import collections
import re
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ADJ = "chimera_tpu_torch/csrc/adjoint.cuh"
FKA = "chimera_tpu_torch/csrc/fused_kde_adjoint.cu"
_WEIGHT = "const T m = c1 * support_weight(q);"
_WARPS = "return mode == kAnalysisGrid || mode == kEffectiveGrid ? 8 : kWarps;"
_BOUNDS = "__launch_bounds__(32 * row_warps(MODE), 16 / row_warps(MODE))"
_AFTER_B = "    blk.template sum<4>(kde);\n  }\n"
_PHASE_A = ("  for (int s = blk.rank(); s < n; s += Block::kSize) {\n"
            "    const T z = model.z_from_dgw(a.dl[row + s]);")
# the Epanechnikov weight as the parent's select (full slope at |u| = 1)
# and as a select that keeps half of it; K3 and K3b in blocks of 4 warps;
# no register cap; and, in this tree and the parent's, K3 up to phase B
# (no phases C, D) and phase B alone (phase A's chain skipped too)
_NO_D = (ADJ, _AFTER_B, _AFTER_B.replace("  }\n", "    return;\n  }\n"))
_NO_A = (ADJ, _PHASE_A, _PHASE_A.replace("s < n;", "s < 0;"))
# K2b without its pass 2 (no sample's dw, dz or 1/h adjoint; phase D still
# chains every weighted sample): with K2b on 2 grid points (phases A and
# D, PAIR_TIMING in chip_smoke.py) it splits K2b's time into A + D, pass 1
# and pass 2
_K2B_PASS2 = "if (a.invp[base + s] != T(0)) {  // the fillers carry no weight"
_NO_P2 = (ADJ, _K2B_PASS2, "if (false) {")
# the pruned pair loop (K1a, K2b's pass 1) with runs of 64 grid points, two
# a lane; its tests and bounds without its kept tiles' terms (its
# overhead alone)
KDE = "chimera_tpu_torch/csrc/kde.cuh"
FUSED = "chimera_tpu_torch/ops/cuda/fused.py"
_KEPT = "for (unsigned m = blk.ballot(keep); m != 0u; m &= m - 1u) {"
# K2 with its phase B skipped (every row written as zeros after phase A and
# the barrier that tests its weight) and K2 with phase A's per-sample work
# replaced by a stand-in of a few operations (z proportional to dL, w the
# inverse prior: rows keep their weight and their dL order): the split of
# K2's time into phase A and the per-row overhead, and phase B.  Each names
# the code of its redesign (adjoint.cuh, rows_contract_event) and of the
# parent's kernel (rows_contract.cu).
RC = "chimera_tpu_torch/csrc/rows_contract.cu"
_RC_LIVE = "if (!__syncthreads_or(live)) {"
_RC_A = ("      const T z = model.z_from_dgw(dl[base + s]);\n"
         "      const T inv1pz = T(1) / (T(1) + z);\n"
         "      const T w = model.p_m1m2(m1det[base + s] * inv1pz,\n"
         "                               m2det[base + s] * inv1pz) * inv_prior[base + s];")
_RC_A_NEW = ("      const T z = T(2.3e-4) * dl[base + s];\n"
             "      const T w = inv_prior[base + s];")
_K2_LIVE = "if (!blk.any(live)) {  // no weight anywhere"
_K2_A = ("      const T z = model.z_from_dgw(dl[s]);\n"
         "      const T inv1pz = T(1) / (T(1) + z);\n"
         "      const T w = model.p_m1m2(m1[s] * inv1pz, m2[s] * inv1pz) * invp[s];")
_K2_A_NEW = ("      const T z = T(2.3e-4) * dl[s];\n"
             "      const T w = invp[s];")

# K4b (kde.cuh, kde_row_adjoint) without its sample-major sweep (d_w, d_z)
# or without its grid-major one (d_grid, d_h's pair sums): those outputs
# written as zeros; and K3b (adjoint_row in kEffectiveGrid) without phase
# B's pair loop (every sample's sums 0; the per-sample writes, the block
# sums and phases A, C and D as they were): each sweep's and phase B's
# marginal cost at the binned and cut_grid paths' shapes
# (the parent's full loops, and this tree's pruned ones: walk_tiles over no
# entries, no tile of phase B's pruned loop)
_K4B_S = "    A a0 = A(0), a1 = A(0);\n#pragma unroll 4\n    for (int g = 0; g < G; ++g) {"
_K4B_G = "    A b0 = A(0), b1 = A(0);\n#pragma unroll 4\n    for (int s = 0; s < S; ++s) {"
_K3B_B = "#pragma unroll 2\n      for (int i = 0; i < a.G; ++i) {"
_K4B_WALK = "      walk_tiles<kK4bTile>(\n          blk, {}, prune,"
_K3B_WALK = "    for (int t = 0; t * kGridTile < G; ++t) {"
# K4b's walk in step (the union of the warp's kept tiles), and each lane on
# its own next kept tile
_WALK_UNION = ("    if (prune) {\n      const bool skip = outside(t);\n"
               "      blk.tile(skip);\n      if (skip) continue;\n    }\n")
_WALK_OWN = ("    if (prune) {\n      while (t * TILE < n && outside(t)) {\n"
             "        blk.tile(true);\n        ++t;\n      }\n"
             "      if (t * TILE >= n) break;\n      blk.tile(false);\n    }\n")


# K3d (adjoint_row in kExternalBounds) without phase B's pair loop and K1b
# (fused_row in kEffectiveGrid) without its KDE's pair loop (the densities
# written as zeros): phase B's and the KDE's marginal cost at the dark and
# spectral cut_grid paths' shapes (the parent's full loops, and this
# tree's pruned ones)
_K3D_B = "a.G, inv_h, prune, inv_gm1,"
_K1B_KDE = ("contract<T, KERNEL>(blk, zw, st.n, a.G, inv_h, scale,\n"
            "                        [lo, delta]")
_K1B_PRUNED = "blk, zw, tiles, st.n, a.G, inv_h, grid_at,"
# K3d's Epanechnikov phase B walking K3b's ballot per tile and slot in
# place of each slot's run of tiles
_K3D_WALK = "constexpr int kWalk = PRUNE && MODE == kExternalBounds ? kRunWalk"


# K4 (kde.cuh, kde_row) with its pair loop skipped after the row's load
# (every density written as 0) and K1e (fused_row in kContract) with its
# KDE and the fold into r skipped after phase A and the stats: the pair
# loops' marginal cost at the binned paths' and the contract path's shapes
_K4_LOOP = "contract<T, KERNEL>(blk, zw, S, G, inv_h, kernel_norm<T, KERNEL>() * inv_h,"
_K1E_EPI = "contract_epilogue_tiles<T, KERNEL, {}>(blk, zw, st.n, a.G, inv_h, grid,"
_K4_PRUNED = "blk, zw, tiles, S, G, inv_h, grid_at,"
_K4_FULL = "contract<T, KERNEL>(blk, zw, S, G, inv_h, scale, grid_at, out);"
_K1E_PRUNED = ("            blk, zw, tiles, st.n, a.G, inv_h, [grid](int g) { return grid[g]; },\n"
               "            [&r,")
_K1E_NOB = [(KDE, _K1E_EPI.format(k), _K1E_EPI.format(k).replace("a.G,", "0,"))
            for k in (2, 4)]


# K1d (kExternalBounds) without its KDE's pair loop after phase A and the
# stats (the densities written as 0 times the scale, as an empty row's):
# the pair loop's marginal cost at the dark cut_grid path's shape (the
# parent's full loop, and this tree's pruned one, external_kde, with the
# Gaussian kernel's full loop); and K1d's pruned loop in the 4-warp block
# a row (fused_row) in place of a warp a logical row (logical_kde_kernel)
_K1D_FULL = "contract<T, KERNEL>(blk, zw, st.n, a.G, inv_h, scale, grid_at, out);"
_K1D_NOB = [(KDE, _K1D_FULL, _K1D_FULL.replace(
    "st.n,", "MODE == kExternalBounds ? 0 : st.n,"))]
_K1D_EMPTY = "  if (st.n == 0) {\n    for (int g = blk.rank(); g < G; g += Block::kSize)"
FKD = "chimera_tpu_torch/csrc/fused_kde.cu"
_K1D_WARP = "if (mode == kExternalBounds && kernel == 0 && n_real != nullptr)"


class Either(tuple):
    """Alternative lists of changes: the first whose every old text occurs
    once in the tree is the one applied (the code of the parent, or of this
    tree)."""


# K5 (kde3d.cuh, kde3d.cu).  Attribution, the outputs wrong: its walk over
# no sample (`k5_noB`, every block's sums 0; the prologue, the sky factors,
# the skip radii, band, masks and chain order, and the fold as they were;
# `parent_k5_noB`: the parent's full loop), and with it left out also the
# masks' tests, the sky factors' loop (e and t stale) or the samples'
# extent and its fold (the band every block).  A layout, the same bits:
# tier 32 a block a (lambda, event, pixel), as tiers 8 and 16
# (`k5_tier32_pixel`).
K3D = "chimera_tpu_torch/csrc/kde3d.cuh"
K3DU = "chimera_tpu_torch/csrc/kde3d.cu"
_K5_SWEEP = "  for (int s = s0; s < s1; ++s) {\n    const T u0 = zl0 + ts[s];"
_K5_FULL = "  for (int s = s0; s < s1; ++s) {\n    const ET<T> p = et[slot(s)];"
_K5_PRUNED = "  if (s0 >= s1) return;\n  const int w0"
_K5_NOB = Either(([(K3D, _K5_FULL, _K5_FULL.replace("s < s1", "s < s0")),
                   (K3D, _K5_PRUNED, _K5_PRUNED.replace("s0 >= s1", "true"))],
                  [(K3D, _K5_SWEEP, _K5_SWEEP.replace("s < s1", "s < s0"))]))
_K5_MASKS = "  for (int m = rank; m < Jb * W; m += size) {"
_K5_SF = ("  for (int i = rank; i < S; i += size) {\n"
          "    const double dz = double(z[i]) - rec[kMeanZ];")
_K5_FOLD = "    extent_fold(red, keys, J, threadIdx.x, kThreads);"
_K5_LOOP = "constexpr bool kPixelLoop = TIER == kMaxBlock;"
_K5_GRID = "const size_t blocks = (size_t)L * E * (TIER == kMaxBlock ? 1 : P);"


VARIANTS = {
    "sel": [(ADJ, _WEIGHT, "const T m = q > T(0) ? c1 : T(0);")],
    "sel2": [(ADJ, _WEIGHT, "const T m = q > T(0) ? c1 "
              ": (q == T(0) ? T(0.5) * c1 : T(0));")],
    "w4": [(FKA, _WARPS, "return kWarps;")],
    "nocap": [(FKA, _BOUNDS, "__launch_bounds__(32 * row_warps(MODE))")],
    "w4_nocap": [(FKA, _WARPS, "return kWarps;"),
                 (FKA, _BOUNDS, "__launch_bounds__(32 * row_warps(MODE))")],
    "noD": [_NO_D],
    "noAD": [_NO_D, _NO_A],
    "parent_noD": [_NO_D],
    "parent_noAD": [_NO_D, _NO_A],
    "k2b_nop2": [_NO_P2],
    "parent_k2b_nop2": [_NO_P2],
    "tile64": [(KDE, "constexpr int kTileG = 32;", "constexpr int kTileG = 64;"),
               (FUSED, "_TILE_G = 32", "_TILE_G = 64")],
    "pair_noloop": [(KDE, _KEPT, _KEPT.replace("blk.ballot(keep)",
                                               "blk.ballot(keep) & 0u"))],
    "k2_noB": [Either((
        [(ADJ, _K2_LIVE, _K2_LIVE.replace("live)", "live) || true"))],
        [(RC, _RC_LIVE, "if (!__syncthreads_or(live) || true) {")]))],
    "k2_constA": [Either(([(ADJ, _K2_A, _K2_A_NEW)], [(RC, _RC_A, _RC_A_NEW)]))],
    # K1c on logical rows in blocks of 4 warps, a row each
    "k1c_w4": [(KDE, "constexpr int kStatsWarps = 1;", "constexpr int kStatsWarps = 4;")],
    "k4b_noS": [Either((
        [(KDE, _K4B_WALK.format("G"), _K4B_WALK.format("0"))],
        [(KDE, _K4B_S, _K4B_S.replace("g < G;", "g < 0;"))]))],
    "k4b_noG": [Either((
        [(KDE, _K4B_WALK.format("S"), _K4B_WALK.format("0"))],
        [(KDE, _K4B_G, _K4B_G.replace("s < S;", "s < 0;"))]))],
    "k3b_noB": [Either((
        [(ADJ, _K3B_WALK, _K3B_WALK.replace("< G;", "< 0;"))],
        [(ADJ, _K3B_B, _K3B_B.replace(
            "i < a.G;", "i < (MODE == kEffectiveGrid ? 0 : a.G);"))]))],
    # K4b's sweeps in tiles of 8, and with each lane walking its own kept
    # tiles in place of the warp's union in step
    "k4b_tile8": [(KDE, "constexpr int kK4bTile = 16;", "constexpr int kK4bTile = 8;"),
                  (FUSED, "_K4B_TILE = 16", "_K4B_TILE = 8")],
    "k4b_own": [(KDE, _WALK_UNION, _WALK_OWN)],
    "k3d_noB": [(ADJ, _K3D_B, "MODE == kExternalBounds ? 0 : " + _K3D_B)],
    "k1b_noB": [Either((
        [(KDE, _K1B_KDE, _K1B_KDE.replace("st.n,", "MODE == kEffectiveGrid ? 0 : st.n,"))],
        [(KDE, _K1B_PRUNED, _K1B_PRUNED.replace("st.n,", "0,"))]))],
    "k3d_ballot": [(ADJ, _K3D_WALK, _K3D_WALK.replace("kExternalBounds", "kExternalBounds && !kPrune"))],
    # K4's pruned loop in tiles of 16 bins (their bounds a thread a tile)
    "k4_tile16": [(KDE, "constexpr int kK4Tile = 32;", "constexpr int kK4Tile = 16;"),
                  (FUSED, "_K4_TILE = 32", "_K4_TILE = 16")],
    "k4_noloop": [Either((
        [(KDE, _K4_PRUNED, _K4_PRUNED.replace("S, G,", "0, G,")),
         (KDE, _K4_FULL, _K4_FULL.replace("zw, S, G,", "zw, 0, G,"))],
        [(KDE, _K4_LOOP, _K4_LOOP.replace("zw, S, G,", "zw, 0, G,"))]))],
    "k1d_noB": [Either((
        [(KDE, _K1D_EMPTY, _K1D_EMPTY.replace("st.n == 0", "true"))] + _K1D_NOB,
        _K1D_NOB))],
    "k1d_block": [(FKD, _K1D_WARP, "if (false)")],
    "k1e_noB": [Either((
        [(KDE, _K1E_PRUNED, _K1E_PRUNED.replace("a.G,", "0,"))] + _K1E_NOB,
        _K1E_NOB))],
}
VARIANTS.update({
    "k5_noB": [_K5_NOB],
    "k5_noB_nomask": [_K5_NOB, (K3D, _K5_MASKS, _K5_MASKS.replace("m < Jb * W", "m < 0"))],
    "k5_noB_nosf": [_K5_NOB, (K3D, _K5_SF, _K5_SF.replace("i < S;", "i < 0;"))],
    "k5_noB_noext": [_K5_NOB, (K3DU, _K5_FOLD, "    if (threadIdx.x == 0) "
                                               "{ keys[0] = 0; keys[1] = J - 1; }")],
    "k5_tier32_pixel": [(K3DU, _K5_LOOP, "constexpr bool kPixelLoop = false;"),
                        (K3DU, _K5_GRID, "const size_t blocks = (size_t)L * E * P;")],
})
# K5b (kde3d.cuh, kde3d.cu), each of its design's parts taken back in turn,
# the same bits but the last two (timed by tools/k5b_ab.py in the variant
# tree): every block tested (no kept_range), the scalar term loop (no
# 16-byte loads), 4 and 6 blocks an SM in float32 (128 and 85 registers);
# and, the outputs wrong, a term of three adds (the loads and the walk
# without the terms' arithmetic), no term (the per-sample and per-pixel
# work without the walk), and no shuffle tree (the pixel sums' cost).
_K5B_RANGE = ("  if (!(r < T(INFINITY)) || !(step_h > 0.0) || "
              "!(fabs(t) < T(INFINITY))) {")
_K5B_TERM = ("  const T u = add_rn(zl, t);\n"
             "  const T d = mul_rn(dg, exp_t(mul_rn(mul_rn(T(-0.5), u), u)));\n"
             "  const T du = mul_rn(d, u);\n"
             "  sg = add_rn(sg, d);\n"
             "  su = add_rn(su, du);\n"
             "  sz = fma_t(du, zeta, sz);\n")
_K5B_BLOCKS = "return sizeof(T) > 4 ? 2 : 5;"
VARIANTS.update({
    "k5b_full_walk": [(K3D, _K5B_RANGE, "  if (true) {")],
    "k5b_scalar_terms": [(K3D, "if ((g0 & 3) != 0)", "if (true)")],
    "k5b_blocks4": [(K3DU, _K5B_BLOCKS, _K5B_BLOCKS.replace("5;", "4;"))],
    "k5b_blocks6": [(K3DU, _K5B_BLOCKS, _K5B_BLOCKS.replace("5;", "6;"))],
    "k5b_cheap_term": [(K3D, _K5B_TERM, "  sg = add_rn(sg, dg);\n  su = add_rn(su, zl);\n"
                                        "  sz = add_rn(sz, zeta);\n")],
    "k5b_no_term": [(K3D, _K5B_TERM, "")],
    "k5b_no_shuffle": [(K3D, "for (int o = kWarpSize / 2; o > 0; o >>= 1) v +=",
                        "for (int o = 0; o > 0; o >>= 1) v +=")],
})
for _name in ("k2_noB", "k2_constA", "k4b_noS", "k4b_noG", "k3b_noB",
              "k3d_noB", "k1b_noB", "k4_noloop", "k1e_noB", "k1d_noB", "k5_noB"):
    VARIANTS["parent_" + _name] = VARIANTS[_name]


def substitute(text: str, changes, path: str) -> str:
    """``text`` of ``path`` with each (path, old, new) of ``changes`` that
    names it applied; each old must occur once."""
    for file, old, new in changes:
        if file == path:
            if text.count(old) != 1:
                raise ValueError(f"{path}: {old!r} occurs {text.count(old)} times")
            text = text.replace(old, new)
    return text


def resolve(changes, base: Path) -> list:
    """The (path, old, new) changes of a variant for the tree at ``base``:
    each Either's first alternative whose every old occurs once there."""
    out = []
    for change in changes:
        if not isinstance(change, Either):
            out.append(change)
            continue
        for alt in change:
            if all((base / f).is_file() and (base / f).read_text().count(old) == 1
                   for f, old, _ in alt):
                out.extend(alt)
                break
        else:
            raise ValueError(f"no alternative of {change!r} matches {base}")
    return out


def trees(parent: Path, out: Path = ROOT / "build" / "k3") -> list[Path]:
    """Write every variant tree under ``out``; returns their paths."""
    made = []
    for name, changes in VARIANTS.items():
        base = parent if name.startswith("parent_") else ROOT
        changes = resolve(changes, base)
        dst = out / name
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(base / "chimera_tpu_torch", dst / "chimera_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy2(base / "chip_smoke.py", dst / "chip_smoke.py")
        for file in {c[0] for c in changes}:
            p = dst / file
            p.write_text(substitute(p.read_text(), changes, file))
        made.append(dst)
    return made


def pair_loop(sass: str) -> collections.Counter:
    """Opcode counts of K3's pair loop in ``cuobjdump -sass`` output."""
    kernel, lines = None, []
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = "fused_kde_adjoint_kernelIffLi0ELi0E" in line
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if kernel and m:
            lines.append((int(m.group(1), 16), m.group(2)))
    loops = []
    for addr, ins in lines:
        m = re.search(r"BRA .*?0x([0-9a-f]+)", ins)
        if m and int(m.group(1), 16) < addr:
            loops.append((int(m.group(1), 16), addr))
    best = None
    for lo, hi in loops:
        inner = not any(lo < a <= b < hi for a, b in loops)
        ops = collections.Counter(
            re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0].split(".")[0]
            for a, ins in lines if lo <= a <= hi)
        fp = ops["FFMA"] + ops["FMUL"] + ops["FADD"]
        if inner and ops["LDS"] == 1 and (best is None or fp > best[0]):
            best = (fp, ops)
    if best is None:
        raise ValueError("no pair loop found: is K3's float32 build in the dump?")
    return best[1]


def sass_functions(sass: str) -> dict:
    """The instructions of each function of a ``cuobjdump -sass`` dump, by
    its mangled name less the anonymous namespace (which names the build):
    {name: [instruction, ...]}, addresses and encodings left out."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = re.sub(r"_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_\w*?_cu_[0-9a-f]{8}",
                          "", line.split("Function :")[1].strip())
            out[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if name is not None and m:
            out[name].append(m.group(1))
    return out


def sass_diff(a: str, b: str) -> list[str]:
    """Per function of two dumps: its instruction counts and whether the
    instructions are the same."""
    fa, fb = sass_functions(a), sass_functions(b)
    return [f"{n}: {len(fa.get(n, []))} | {len(fb.get(n, []))} instructions, "
            + ("the same" if fa.get(n) == fb.get(n) else "DIFFER")
            for n in sorted(set(fa) | set(fb))]


def main() -> None:
    if sys.argv[1:2] == ["trees"] and len(sys.argv) == 3:
        for p in trees(Path(sys.argv[2]).resolve()):
            print(p)
    elif sys.argv[1:2] == ["sass"] and len(sys.argv) > 2:
        for f in sys.argv[2:]:
            ops = pair_loop(Path(f).read_text())
            print(f"{f}: {sum(ops.values())} instructions an iteration of 8 "
                  f"terms: {dict(ops.most_common())}; per term FP32 "
                  f"{(ops['FFMA'] + ops['FMUL'] + ops['FADD']) / 8:g}, "
                  f"compare and select {(ops['FSETP'] + ops['FSEL']) / 8:g}")
    elif sys.argv[1:2] == ["sassdiff"] and len(sys.argv) == 4:
        print("\n".join(sass_diff(*(Path(f).read_text() for f in sys.argv[2:]))))
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main()
