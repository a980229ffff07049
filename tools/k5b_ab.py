"""K5b (the adjoint of kind 'full''s 3-D lattice KDE) in one tree of the
repository against another, on one card: the tree to measure is the
working directory, so that this script can time a tree that does not
hold it (a parent unpacked with ``git archive``).

    cd TREE && python3 /path/to/tools/k5b_ab.py run OUT.pt
    python3 tools/k5b_ab.py compare REF.pt OTHER.pt ... [--bits=d_samp,...]

``run`` builds phase 27's 'full' likelihood at the dark width with that
tree's ``chip_smoke.py`` (1000 events x 1024 samples x 15 pixel slots x
500 grid points, float32, L = 16 in H0 and Om0), captures the inputs and
cotangent that the gradient call hands K5b, and prints the median of 17
K5b launches (CUDA events, after a warm-up) and of 17 value-and-gradient
calls per λ; OUT.pt keeps K5b's cotangents and the gradient.  ``compare``
prints, for each OTHER and each of d_samp, d_pix, d_event and the
gradient, equal bits or the gap from REF, and fails unless the tensors
named in ``--bits`` (all four by default) hold REF's bits.  Run the trees in the
order A, B, B, A in one call: a card set below 700 W runs slower under
load, and two calls may get two cards."""

import os
import statistics
import sys

import torch


def run(out: str) -> None:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from chimera_tpu_torch.ops.cuda import kde3d

    f32 = torch.float32
    data = cs.dark_mock(1000, 1024, 15, 500, 500_000, 50_000, cs.SEED + 8)[0]
    hl = cs.dark_likelihood(data, f32, **cs.FULL)
    names = ["H0", "Om0"]
    x = cs.points({"H0": 70.0, "Om0": 0.25}, {"H0": 3.0, "Om0": 0.02}, 16,
                  f32, cs.SEED + 27)
    args, kw = cs.calls_of(kde3d, "lattice_kde3d_adjoint",
                           lambda: cs.named_value_and_grad(hl, names, x))[-1]
    if "records" in kw:  # K5b reads the record of K5's forward
        def k5b():
            return kde3d.launch_k5b(*args[:9], kw["records"], args[9])
    else:  # K5b's C entry runs K5's prologue itself
        def k5b():
            return kde3d.launch_k5b(*args[:10], kw.get("bw_method"))
    ms = cs.cuda_ms(k5b, 17)
    vg = cs.cuda_ms(lambda: cs.named_value_and_grad(hl, names, x), 17)
    cot = [t.cpu() for t in k5b()]
    grad = cs.named_value_and_grad(hl, names, x)[1].cpu()
    torch.save({"cot": cot, "grad": grad}, out)
    print(f"{os.getcwd()}: K5b {statistics.median(ms):.4f} ms a call (min "
          f"{min(ms):.4f}, max {max(ms):.4f}); value and gradient "
          f"{statistics.median(vg) / 16:.4f} ms per λ", flush=True)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int64 if t.element_size() == 8 else torch.int32)


NAMES = ("d_samp", "d_pix", "d_event", "grad")


def _gap(a: torch.Tensor, b: torch.Tensor) -> str:
    """The largest difference of a from b, absolute and relative to each
    row's largest |b| (NaN where both are NaN left out)."""
    a, b = a.double(), b.double()
    both = torch.isnan(a) & torch.isnan(b)
    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        return "NaN in other places"
    a, b = a.masked_fill(both, 0.0), b.masked_fill(both, 0.0)
    scale = b.abs().amax(dim=-1, keepdim=True).clamp_min(1e-300)
    return (f"max abs {(a - b).abs().max().item():.3e}, "
            f"{((a - b).abs() / scale).max().item():.3e} of a row's max")


def compare(ref: str, others: list[str], bits=NAMES) -> bool:
    """Whether each of ``others`` holds REF's bits in the tensors ``bits``;
    prints, for every tensor, equal bits or the gap."""
    want = torch.load(ref)
    ok = True
    for path in others:
        got = torch.load(path)
        for name, a, b in zip(NAMES, [*got["cot"], got["grad"]],
                              [*want["cot"], want["grad"]]):
            same = a.shape == b.shape and torch.equal(_bits(a), _bits(b))
            print(f"{path} vs {ref}: {name} "
                  + ("the same bits" if same else f"differs: {_gap(a, b)}"))
            ok = ok and (same or name not in bits)
    return ok


if __name__ == "__main__":
    if sys.argv[1:2] == ["run"] and len(sys.argv) == 3:
        run(sys.argv[2])
    elif sys.argv[1:2] == ["compare"] and len(sys.argv) > 3:
        paths = [a for a in sys.argv[2:] if not a.startswith("--bits=")]
        bits = [a.split("=", 1)[1].split(",") for a in sys.argv[2:]
                if a.startswith("--bits=")]
        sys.exit(0 if compare(paths[0], paths[1:], *bits) else 1)
    else:
        sys.exit(__doc__)
