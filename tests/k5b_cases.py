"""Inputs of K5b's tests on the CPU (``tests/test_torch_full.py``, through
the host emulation) and on the card (``tests/test_torch_cuda.py``), drawn
with numpy from fixed seeds; no JAX.

Each case is two λ of events of correlated (z, ra, dec) samples around
(0.5, 2.0, 0.3) (sigma 0.05, 0.03, 0.03) with random weights, pixels near
the sky mean and 0.1 and 0.2 rad off it (sky factors from ~1e-3 down to
below the smallest normal), z-grids over [-0.4, 1.4] (>= 80 bandwidths, so
that most of a sample's blocks are flushed), sample 0 without weight and
sample 1's weight below the smallest normal times the sum (e below the
smallest normal), and a random cotangent d_out, 0 at the fake pixels."""

import numpy as np
import torch

# (samples, pixels, grid points, K per event): each tier of the recurrence
# (K = 13: no tier, a block of no 16-byte loads) and the dense sweep;
# "chunks" more pixels than K5b's shared memory holds at once (two chunks
# in float32, four in float64), event 1's cotangent 0 on every pixel;
# "wide" 2 000 samples on 202-point grids (rows padded to 204)
CASES = {"k8": (300, 4, 400, [8, 8]),
         "k16": (300, 4, 400, [16, 16]),
         "k32": (300, 4, 400, [32, 13]),
         "dense": (300, 4, 400, [0, 0]),
         "chunks": (64, 40, 700, [16, 8]),
         "wide": (2000, 2, 202, [16, 0])}


def k5b_case(name: str, dtype, device="cpu"):
    """The case's inputs of ``lattice_kde3d_adjoint`` (z, w, ra, dec,
    ra_pix, dec_pix, pixel_mask, grids, z_block) and its d_out, on
    ``device``.  Besides the module's recipe: in "k16" the second λ's event
    0 has two samples of weight (no whitening: a dead (λ, event)) and event
    1's last pixel is fake; in every case the second pixel of the last
    event has a cotangent row of 0 (a skipped pixel)."""
    s, p, g, ks = CASES[name]
    n_ev = len(ks)
    rng = np.random.default_rng(20 + list(CASES).index(name))
    base = rng.normal(size=(n_ev, 3, s))
    mix = np.array([[1.0, 0.0, 0.0], [0.3, 1.0, 0.0], [-0.2, 0.4, 1.0]])
    data = np.einsum("ij,ejs->eis", mix, base) * np.array([0.05, 0.03, 0.03])[:, None] \
        + np.array([0.5, 2.0, 0.3])[:, None]
    w = rng.uniform(0.1, 1.0, size=(n_ev, s))
    ra_pix = 2.0 + 0.04 * rng.normal(size=(n_ev, p))
    dec_pix = 0.3 + 0.04 * rng.normal(size=(n_ev, p))
    ra_pix[:, 1::3] += 0.1
    dec_pix[:, 2::3] -= 0.2
    grid = np.tile(np.linspace(-0.4, 1.4, g), (n_ev, 1))
    z = np.stack([data[:, 0], data[:, 0] + 0.002 * rng.normal(size=data[:, 0].shape)])
    w2 = np.stack([w, w * rng.uniform(0.5, 1.5, size=w.shape)])
    w2[..., 0] = 0.0
    w2[..., 1] = 1e-3 * float(torch.finfo(dtype).tiny)
    mask = np.ones((n_ev, p), dtype=bool)
    if name == "k16":
        w2[1, 0, 4:] = 0.0
        mask[1, -1] = False
    d_out = rng.normal(size=(2, n_ev, p, g)) * mask[None, :, :, None]
    d_out[:, -1, 1] = 0.0
    if name == "chunks":
        d_out[:, 1] = 0.0

    def t(x):
        return torch.as_tensor(np.asarray(x)).to(dtype).to(device)

    return ((t(z), t(w2), t(data[:, 1]), t(data[:, 2]), t(ra_pix), t(dec_pix),
             torch.as_tensor(mask, device=device), t(grid),
             torch.tensor(ks, device=device)), t(d_out))
