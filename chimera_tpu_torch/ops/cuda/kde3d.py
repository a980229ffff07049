"""The 3-D Gaussian KDE of the 'full' likelihood on the (pixel x z-grid)
lattice, per (λ, event) (K5): the counterpart of the XLA loop
``chimera_tpu/ops/kde.py::gaussian_kde_3d_lattice`` as
``chimera_tpu/likelihood.py::p_gw_3d_full`` maps it over the events.  The
JAX package has no TPU kernel for it; the port adds one because its
chunked PyTorch version streams several (pixels, grid, chunk)
intermediates per step through device memory, where the kernel keeps every
term in registers.

``lattice_kde3d`` runs the hand-written CUDA kernel
(``chimera_tpu_torch/csrc/kde3d.cu``) on CUDA tensors, counting its
launches in ``lattice_kde3d.launches``, and the plain PyTorch version
``lattice_kde3d_plain`` on CPU tensors; on CUDA it launches the kernel or
raises.  On CPU tensors autograd differentiates the plain version; on CUDA
tensors that require grad it raises: K5 has no adjoint kernel (ROADMAP.md
§1 item 16).
"""

from __future__ import annotations

import torch

from chimera_tpu_torch.ops.cuda import fused
from chimera_tpu_torch.ops.cuda.fused import _SMEM_LIMIT
from chimera_tpu_torch.ops.kde import gaussian_kde_3d_lattice

# csrc/kde3d.cuh: the kernel's threads a block, its longest recurrence
# block, the doubles of a (λ, event)'s record
_THREADS, _MAX_BLOCK, _RECORD = 128, 32, 16


def lattice_kde3d_plain(z, w, ra, dec, ra_pix, dec_pix, pixel_mask, grids,
                        z_block, bw_method=None) -> torch.Tensor:
    """Plain PyTorch version of ``lattice_kde3d``:
    ``ops/kde.py::gaussian_kde_3d_lattice`` on each (λ, event)'s samples
    (z, ra, dec), its pixels and z-grid, with the event's block length, and
    0 at the fake pixels."""
    n = z.shape[0]
    dataset = torch.stack([z, ra.expand_as(z), dec.expand_as(z)], dim=-2)
    lead = lambda t: t.expand(n, *t.shape)  # noqa: E731
    p = gaussian_kde_3d_lattice(dataset, lead(ra_pix), lead(dec_pix),
                                lead(grids), weights=w, bw_method=bw_method,
                                z_block=lead(z_block))
    return torch.where(pixel_mask[..., None], p, 0.0)


def lattice_kde3d(z: torch.Tensor, w: torch.Tensor, ra: torch.Tensor,
                  dec: torch.Tensor, ra_pix: torch.Tensor,
                  dec_pix: torch.Tensor, pixel_mask: torch.Tensor,
                  grids: torch.Tensor, z_block: torch.Tensor,
                  bw_method=None) -> torch.Tensor:
    """The weighted 3-D Gaussian KDE of each (λ, event)'s samples on its
    pixels x z-grid lattice: z, w (L, E, S) source-frame redshifts and raw
    weights (normalized here, the uniform fallback where they do not sum
    to a positive number), ra, dec (E, S) the samples' sky positions,
    ra_pix, dec_pix, pixel_mask (E, P) the pixel centres (finite at the
    fake pixels too) and mask, grids (E, G) uniform z-grids, z_block (E,)
    each event's recurrence block length K in [0, 32] (0: the dense sweep)
    -> (L, E, P, G), 0 at the fake pixels and NaN for a (λ, event) whose
    whitening does not exist.  On the card a K outside [0, 32] gives NaN."""
    if not fused.on_card(z):
        return lattice_kde3d_plain(z, w, ra, dec, ra_pix, dec_pix, pixel_mask,
                                   grids, z_block, bw_method)
    fused.refuse_grad("lattice_kde3d (K5)", "K5 has no adjoint kernel "
                      "(ROADMAP.md §1 item 16)", z, w, ra, dec, ra_pix,
                      dec_pix, grids)
    dt, dev = z.dtype, z.device
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"lattice_kde3d takes float32 or float64, not {dt}")
    n, e, s = z.shape
    p, g = ra_pix.shape[1], grids.shape[1]
    for key, t, shape, want in (
            ("w", w, (n, e, s), dt), ("ra", ra, (e, s), dt),
            ("dec", dec, (e, s), dt), ("ra_pix", ra_pix, (e, p), dt),
            ("dec_pix", dec_pix, (e, p), dt),
            ("pixel_mask", pixel_mask, (e, p), torch.bool),
            ("grids", grids, (e, g), dt)):
        if tuple(t.shape) != shape or t.dtype != want or t.device != dev:
            raise ValueError(f"{key} must be {shape} {want} on {dev}")
    if tuple(z_block.shape) != (e,) or z_block.dtype.is_floating_point \
            or z_block.device != dev:
        raise ValueError(f"z_block must be ({e},) integers on {dev}")
    smem = (2 * s + _THREADS * _MAX_BLOCK) * z.element_size()
    if smem > _SMEM_LIMIT:
        raise ValueError(f"S = {s} samples need {smem} bytes of shared memory "
                         f"per block, over the {_SMEM_LIMIT}-byte limit")
    if n * e * p >= 2 ** 31:
        raise ValueError(f"{n} x {e} x {p} (λ, event, pixel) blocks exceed "
                         "the launch's grid")
    bw_mode, bw_value = fused._bw_code(bw_method)
    out = torch.empty((n, e, p, g), dtype=dt, device=dev)
    records = torch.empty((n, e, _RECORD), dtype=torch.float64, device=dev)
    fused.launch("kde3d", "chimera_kde3d", dt, dev,
                 [*(t.contiguous() for t in (z, w, ra, dec, ra_pix, dec_pix,
                                             pixel_mask, grids)),
                  z_block.to(torch.int32).contiguous(), records, out, n, e, s,
                  p, g, bw_mode, bw_value])
    lattice_kde3d.launches += 1
    return out


lattice_kde3d.launches = 0
