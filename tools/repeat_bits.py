"""Which tensors of the float64 dark flagship and of the cut_grid paths'
kernel inputs differ from one build to the next on the card, and whether
PyTorch's deterministic algorithms make them equal.

    python3 tools/repeat_bits.py [TREE ...]    # on the card; default: this tree

For each tree (a checkout whose ``chip_smoke.py`` has ``dark_mock``,
``dark_likelihood``, ``rows_inputs``, ``calls_of`` and
``contract_likelihood``), four processes each build, from
the same seeds: the dark flagship's mock data in float64
(``chip_smoke.dark_mock(1000, 1024, 15, 500, 500_000, 50_000, SEED + 8)``:
the PE catalog, z-grids, pixelated galaxy catalog, injections), the float64
and float32 dark likelihoods on it, and K2b's arguments on the float64 one
at the 16 points of phase 14 (``chip_smoke.rows_inputs``); then, in
float32 at those points, the dark cut_grid likelihood and the arguments of
K1d (the forward, ``chip_smoke.captured``) and K3d (its path's own
cotangents, ``chip_smoke.backward_calls``), the spectral
headline's mock (``chip_smoke.mock(1000, 4096, 2_000_000, 500, 200,
SEED)``), its cut_grid likelihood and the arguments of K1b (the forward,
``chip_smoke.captured``) and K3b; the arguments of K4 and K4b on the binned
dark and spectral paths (the forward and ``chip_smoke.calls_of`` of a
value-and-gradient call) and of K1e on the dark contract path: the inputs
whose hashes ``chip_smoke.py --k3-ab`` holds equal across trees.  Two processes
run as PyTorch does by default, two under
``torch.use_deterministic_algorithms(True, warn_only=True)`` (with
``CUBLAS_WORKSPACE_CONFIG=:4096:8``), which swaps the ops that sum by
atomics for sorted, fixed-order versions and warns of any that has none.
Prints, for each pair, the tensors whose bits differ, in the order they
were built, with the largest difference relative to each tensor's largest
entry, and the warnings.  The tensors go to build/repeat/ (git-ignored).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import dataclasses, hashlib, json, os, sys, warnings
sys.path.insert(0, os.getcwd())
import torch
if sys.argv[2] == "deterministic":
    torch.use_deterministic_algorithms(True, warn_only=True)
warnings.simplefilter("always")
import chip_smoke as cs
from chimera_tpu_torch.ops.cuda import kde

tensors, seen = {}, {}

def keep(name, t):
    # a tensor met before is stored once; one of more than 2^25 entries
    # only as a hash of its bytes
    t = t.detach()
    key = (t.data_ptr(), t.dtype, tuple(t.shape), t.stride())
    if key not in seen:
        c = t.cpu().contiguous()
        seen[key] = c if c.numel() <= 1 << 25 else (
            f"{c.dtype}, {tuple(c.shape)}, sha256 "
            + hashlib.sha256(c.view(torch.uint8).numpy().tobytes()).hexdigest())
    tensors[name] = seen[key]

def walk(name, obj, depth=0):
    if torch.is_tensor(obj):
        keep(name, obj)
    elif depth > 3:
        return
    elif isinstance(obj, torch.nn.Module):
        for k, v in obj.named_buffers():
            keep(f"{name}.{k}", v)
        for k, v in vars(obj).items():
            if not k.startswith("_"):
                walk(f"{name}.{k}", v, depth + 1)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            walk(f"{name}.{f.name}", getattr(obj, f.name), depth + 1)
    elif isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            walk(f"{name}[{i}]", v, depth + 1)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            walk(f"{name}[{k}]", v, depth + 1)

def binned(hl, name):
    # K4's forward inputs and K4b's, the path's own cotangents among them
    walk(f"k4_args_binned_{name}", cs.captured(
        "kde1d_grid", lambda: hl.log_like_batch(cs.batch_of(x))))
    walk(f"k4b_args_binned_{name}", cs.calls_of(
        kde, "kde1d_grid_adjoint", lambda: cs.value_and_grad(hl, x))[-1])

with warnings.catch_warnings(record=True) as caught:
    data, _ = cs.dark_mock(1000, 1024, 15, 500, 500_000, 50_000, cs.SEED + 8)
    cat, z_grids, gal_cat, inj, _ = data
    walk("pe_catalog", cat)
    walk("z_grids", z_grids)
    walk("galaxy_catalog", gal_cat)
    walk("injections", inj)
    hl = cs.dark_likelihood(data, cs.F64)
    walk("likelihood_f64", hl)
    walk("k2b_args_f64", cs.rows_inputs(
        hl, cs.batch_of(cs.chain_points(16, cs.F64)), cs.SEED + 21))
    del hl
    walk("likelihood_f32", cs.dark_likelihood(data, cs.F32))
    x = cs.chain_points(16, cs.F32)
    hl = cs.dark_likelihood(data, cs.F32, **cs.DARK_CUT)
    walk("dark_cut_f32", hl)
    walk("k1d_args_f32", cs.captured(
        "fused_weights_kde", lambda: hl.log_like_batch(cs.batch_of(x))))
    walk("k3d_args_f32", [c for c in cs.backward_calls(hl, x)["K3"]
                          if c[1].get("ext_bounds") is not None])
    binned(cs.dark_likelihood(data, cs.F32, **cs.BINNED), "dark")
    hl = cs.contract_likelihood(data, cs.F32)
    walk("k1e_args_f32", cs.captured(
        "fused_weights_kde", lambda: hl.log_like_batch(cs.batch_of(x))))
    del hl, data, cat, z_grids, gal_cat, inj
    full = cs.mock(1000, 4096, 2_000_000, 500, 200, cs.SEED)
    walk("spectral_mock", full)
    hl = cs.likelihood(full, cs.F32, cut_grid=2.0)
    walk("spectral_cut_f32", hl)
    walk("k1b_args_f32", cs.captured(
        "fused_weights_kde", lambda: hl.log_like_batch(cs.batch_of(x))))
    walk("k3b_args_f32", cs.backward_calls(hl, x)["K3"])
    binned(cs.likelihood(full, cs.F32, **cs.BINNED), "spectral")
    torch.cuda.synchronize()
torch.save(tensors, sys.argv[1])
print(json.dumps(sorted({str(w.message).splitlines()[0] for w in caught})))
"""


def child(tree: str, mode: str, path: Path) -> list[str]:
    env = dict(os.environ)
    if mode == "deterministic":
        env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    out = subprocess.run([sys.executable, "-c", CHILD, str(path), mode],
                         cwd=tree, env=env, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{tree} ({mode}): {out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def differences(a: dict, b: dict) -> list[str]:
    """The tensors of ``a`` whose bits differ in ``b``, in build order."""
    out = []
    for name, x in a.items():
        y = b.get(name)
        if isinstance(x, str):
            if x != y:
                out.append(f"{name} ({x.split(', sha256')[0]}, not kept): "
                           f"the bits differ")
            continue
        if not torch.is_tensor(y) or x.shape != y.shape or x.dtype != y.dtype:
            out.append(f"{name}: missing or reshaped")
            continue
        if not x.is_floating_point():
            if not torch.equal(x, y):
                out.append(f"{name} ({x.dtype}): {int((x != y).sum())} of "
                           f"{x.numel()} entries differ")
            continue
        view = torch.int64 if x.element_size() == 8 else torch.int32
        if x.element_size() not in (4, 8) or torch.equal(
                x.contiguous().view(view), y.contiguous().view(view)):
            continue
        d = (x.double() - y.double()).abs().nan_to_num(0.0)
        scale = x.double().abs().nan_to_num(0.0).max().clamp_min(1e-300)
        out.append(f"{name} ({x.dtype}, {tuple(x.shape)}): "
                   f"{int((d > 0).sum())} of {x.numel()} entries differ, "
                   f"largest {d.max().item():.3e} ({(d.max() / scale).item():.3e} "
                   f"of the largest entry)")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: tools/repeat_bits.py runs on the card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    out_dir = ROOT / "build" / "repeat"
    out_dir.mkdir(parents=True, exist_ok=True)
    for t, tree in enumerate(sys.argv[1:] or [str(ROOT)]):
        print(f"{tree}, torch {torch.__version__}", flush=True)
        for mode in ("default", "deterministic"):
            paths = [out_dir / f"{t}-{mode}-{i}.pt" for i in range(2)]
            warned = [child(tree, mode, p) for p in paths]
            a, b = (torch.load(p, mmap=True) for p in paths)
            diff = differences(a, b)
            print(f"  {mode}: {len(a)} tensors, {len(diff)} differ between the "
                  f"two processes" + "".join(f"\n    {d}" for d in diff), flush=True)
            for w in sorted(set(warned[0]) | set(warned[1])):
                print(f"    warning: {w}", flush=True)
            del a, b


if __name__ == "__main__":
    main()
