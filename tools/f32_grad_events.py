"""Where a float32 d log L / dH0 of a spectral path parts from float64: the
selection term and each event's log numerator, split at one point, and the
float64 slope of the event that differs most at nearby points.

    python3 tools/f32_grad_events.py MOCK.npz MODEL PATH [DEVICE]

MOCK.npz holds the arrays of ``tests/data/f32_grad_spectral.npz`` (m1, m2,
dl, prior, im1, im2, idl, ipd, zg, n_gen); MODEL is a mass model of
``chip_smoke.MASS_MODELS`` or PowerLawPeak; PATH is 'spectral' (analysis
grids) or 'spectral_cut' (cut_grid=2.0); DEVICE is 'cuda' (the kernels, the
default) or 'cpu' (their plain versions).  The point is phase 29's first:
H0 = 62 and the model's own first value.  An event's log numerator is
piecewise smooth in H0 (the Epanechnikov kernel's support edges, the
effective grid's nodes under the resampling): a kink within float32
rounding of the point shows as one event far off, and as a jump of its
float64 slope between H0 - 1e-7 and H0 + 1e-7."""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from chimera_tpu_torch.data.structs import ThetaInjDet, ThetaPEDet  # noqa: E402


def main(path: str, model: str, kind: str, device: str = "cuda") -> None:
    dev = cs.DEV = torch.device(device)
    d = np.load(path)

    def arr(key):
        return torch.as_tensor(d[key], dtype=torch.float64, device=dev)

    cat = ThetaPEDet(m1det=arr("m1"), m2det=arr("m2"), dL=arr("dl"),
                     pe_prior=arr("prior"))
    inj = ThetaInjDet(m1det=arr("im1"), m2det=arr("im2"), dL=arr("idl"),
                      p_draw=arr("ipd"))
    data = (cat, inj, float(d["n_gen"]), arr("zg"))
    kw, key, values = ({}, "mu_g", (30.0,)) if model == "PowerLawPeak" \
        else cs.MASS_MODELS[model]
    cut = {"spectral": {}, "spectral_cut": {"cut_grid": 2.0}}[kind]

    def subset(events):
        rows = torch.tensor(events, device=dev)
        return (cat.update(**{f: getattr(cat, f)[rows] for f in
                              ("m1det", "m2det", "dL", "pe_prior")}),
                inj, data[2], data[3][rows])

    def split(dtype, h0: float, events=None):
        """log num_e and d log num_e / dH0 of ``events`` (every event where
        None), and d log N_exp / dH0, at H0 = h0."""
        hl = cs.likelihood(data if events is None else subset(events), dtype,
                           cfg={"mass": (model, kw)}, **cut)
        x = torch.tensor([h0], dtype=dtype, device=dev, requires_grad=True)
        lam = {"H0": x, key: torch.tensor(values[:1], dtype=dtype, device=dev)}
        log_num = torch.log(hl.batch_numerators(hl.population.update_batch(lam))[0])
        slopes = torch.stack([torch.autograd.grad(v, x, retain_graph=True)[0][0]
                              for v in log_num])
        n_exp = hl.selection.n_exp(hl.population.update_batch(lam))
        sel = torch.autograd.grad(torch.log(n_exp).sum(), x)[0][0]
        return log_num.detach().double().cpu(), slopes.double().cpu(), float(sel)

    h0 = cs.MODEL_H0S[0]
    l64, g64, s64 = split(torch.float64, h0)
    l32, g32, s32 = split(torch.float32, h0)
    print(f"{model} {kind} on {device} at H0 = {h0}, {key} = {values[0]}: "
          f"sum of the events' d log num/dH0 float64 {g64.sum():.6e} float32 "
          f"{g32.sum():.6e}; d log N_exp/dH0 float64 {s64:.6e} float32 {s32:.6e}")
    err = (g32 - g64).abs()
    for e in torch.argsort(err, descending=True)[:5].tolist():
        print(f"  event {e}: log num {l64[e]:.8f} / {l32[e]:.8f}, d log num/dH0 "
              f"float64 {g64[e]:.6e} float32 {g32[e]:.6e} (off {err[e]:.3e})")
    worst = int(torch.argmax(err))
    for step in (-1e-3, -1e-5, -1e-6, -1e-7, 0.0, 1e-7, 1e-6, 1e-5, 1e-3):
        _, g, _ = split(torch.float64, h0 + step, [worst])
        print(f"  event {worst}, float64, H0 = {h0} {step:+.0e}: d log num/dH0 "
              f"{g[0]:.6e}")


if __name__ == "__main__":
    main(*sys.argv[1:])
