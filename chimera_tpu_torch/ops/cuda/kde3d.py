"""The 3-D Gaussian KDE of the 'full' likelihood on the (pixel x z-grid)
lattice, per (λ, event) (K5), and its adjoint (K5b): the counterpart of the
XLA loop ``chimera_tpu/ops/kde.py::gaussian_kde_3d_lattice`` as
``chimera_tpu/likelihood.py::p_gw_3d_full`` maps it over the events, and of
``jax.grad`` through it.  The JAX package has no TPU kernel for either; the
port adds them because the chunked PyTorch version streams several
(pixels, grid, chunk) intermediates per step through device memory, where
the kernels keep every term in registers.

``lattice_kde3d`` runs the hand-written CUDA kernel
(``chimera_tpu_torch/csrc/kde3d.cu``) on CUDA tensors, counting its
launches in ``lattice_kde3d.launches``, and the plain PyTorch version
``lattice_kde3d_plain`` on CPU tensors; on CUDA it launches the kernel or
raises.  On CPU tensors autograd differentiates the plain version.  On
CUDA tensors that require grad the launch sits in a
``torch.autograd.Function`` whose backward launches K5b once
(``lattice_kde3d_adjoint``, counted in ``lattice_kde3d_adjoint.launches``)
on the record that K5's forward wrote: the cotangents of the quantities K5's terms read (each sample's unit weight
and whitened coordinates, each pixel's, the event's L00, mean z and
log_norm), chained to z, w, ra, dec and the pixel centres through a float64
rebuild of K5's record (``ops/kde.py::lattice_record``) by
``torch.autograd.grad``.  The z-grids are data: K5b gives them no
cotangent, and on the card a grid that requires grad is refused
(ValueError).
``lattice_kde3d_adjoint_plain`` is autograd of the plain version, the
tests' and ``chip_smoke.py``'s yardstick.
"""

from __future__ import annotations

import torch

from chimera_tpu_torch.ops.cuda import fused
from chimera_tpu_torch.ops.cuda.fused import _SMEM_LIMIT
from chimera_tpu_torch.ops.kde import gaussian_kde_3d_lattice, lattice_record

# csrc/kde3d.cuh: the kernel's threads a block, its longest recurrence
# block, the doubles of a (λ, event)'s record, the pruned walk's mask words
_THREADS, _MAX_BLOCK, _RECORD, _MASK_WORDS = 128, 32, 16, 2048
# K5b's cotangent columns (csrc/kde3d.cuh, SampleGrad, PixelGrad, EventGrad)
_SAMPLE_GRADS, _PIXEL_GRADS, _EVENT_GRADS = 4, 3, 3
# the inputs K5b's chain differentiates, in the wrappers' order
_WRT = ("z", "w", "ra", "dec", "ra_pix", "dec_pix")
# csrc/kde3d.cuh: K5b's warps a block and the shared memory its chunks of
# pixels may fill
_ADJOINT_WARPS, _ADJOINT_SMEM = _THREADS // 32, 96 * 1024


def adjoint_smem(g: int, pc: int, size: int) -> int:
    """K5b's shared memory a block (``csrc/kde3d.cuh::adjoint_layout``)
    for G grid points, chunks of pc pixels and a working dtype of ``size``
    bytes: the ranks' event sums, the chunk's pixel centres and the warps'
    pixel sums (double), its cotangent rows, the grid twice and the blocks'
    starts (from a 16-byte boundary, each padded to a multiple of 4
    points), and the chunk's pixel lists (int)."""
    doubles = 8 * (2 * _THREADS + pc * _PIXEL_GRADS * (1 + _ADJOINT_WARPS))
    row = -(-g // 4) * 4 * size
    return -(-doubles // 16) * 16 + (pc + 3) * row + 4 * (2 * pc + 1)


def adjoint_chunk(p: int, g: int, size: int) -> int:
    """K5b's pixels a chunk (``csrc/kde3d.cuh::adjoint_chunk``): as many
    of the P as fit in 96 KiB of shared memory, at least one."""
    pc = p
    while pc > 1 and adjoint_smem(g, pc, size) > _ADJOINT_SMEM:
        pc -= 1
    return pc


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


def _checked(z, w, ra, dec, ra_pix, dec_pix, pixel_mask, grids, z_block,
             d_out=None):
    """The shapes, dtypes and devices of a CUDA call; (L, E, S, P, G)."""
    dt, dev = z.dtype, z.device
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"lattice_kde3d takes float32 or float64, not {dt}")
    n, e, s = z.shape
    p, g = ra_pix.shape[1], grids.shape[1]
    expect = [("w", w, (n, e, s), dt), ("ra", ra, (e, s), dt),
              ("dec", dec, (e, s), dt), ("ra_pix", ra_pix, (e, p), dt),
              ("dec_pix", dec_pix, (e, p), dt),
              ("pixel_mask", pixel_mask, (e, p), torch.bool),
              ("grids", grids, (e, g), dt)]
    if d_out is not None:
        expect.append(("d_out", d_out, (n, e, p, g), dt))
    for key, t, shape, want in expect:
        if tuple(t.shape) != shape or t.dtype != want or t.device != dev:
            raise ValueError(f"{key} must be {shape} {want} on {dev}")
    if tuple(z_block.shape) != (e,) or z_block.dtype.is_floating_point \
            or z_block.device != dev:
        raise ValueError(f"z_block must be ({e},) integers on {dev}")
    if n * e * p >= 2 ** 31:
        raise ValueError(f"{n} x {e} x {p} (λ, event, pixel) blocks exceed "
                         "the launch's grid")
    return n, e, s, p, g


def _launch_k5(z, w, ra, dec, ra_pix, dec_pix, pixel_mask, grids, z_block,
               bw_method) -> tuple:
    """K5 on checked CUDA tensors: its output (L, E, P, G) and the record
    (L, E, 16) float64 its prologue wrote, which K5b reads."""
    n, e, s, p, g = _checked(z, w, ra, dec, ra_pix, dec_pix, pixel_mask,
                             grids, z_block)
    # csrc/kde3d.cu::main_smem: the (e, t) slots (a gap after every 256
    # samples, an even count) and radii of the samples padded to 32s
    size, s32 = z.element_size(), 32 * (-(-s // 32))
    slots = (s32 - 1 + ((s32 - 1) >> 8) + 2) & ~1
    smem = max(2 * slots * size + s32 * size + 4 * _MASK_WORDS + 8 * _THREADS,
               _THREADS * _MAX_BLOCK * size)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"S = {s} samples need {smem} bytes of shared memory "
                         f"per block, over the {_SMEM_LIMIT}-byte limit")
    bw_mode, bw_value = fused._bw_code(bw_method)
    out = torch.empty((n, e, p, g), dtype=z.dtype, device=z.device)
    records = torch.empty((n, e, _RECORD), dtype=torch.float64, device=z.device)
    fused.launch("kde3d", "chimera_kde3d", z.dtype, z.device,
                 [*(t.contiguous() for t in (z, w, ra, dec, ra_pix, dec_pix,
                                             pixel_mask, grids)),
                  z_block.to(torch.int32).contiguous(), records, out, n, e, s,
                  p, g, bw_mode, bw_value])
    lattice_kde3d.launches += 1
    return out, records


class _LatticeKDE3D(torch.autograd.Function):
    """K5 on CUDA tensors, with K5b and the chain through the float64 record
    as the backward."""

    @staticmethod
    def forward(ctx, bw_method, z, w, ra, dec, ra_pix, dec_pix, pixel_mask,
                grids, z_block):
        out, records = _launch_k5(z, w, ra, dec, ra_pix, dec_pix, pixel_mask,
                                  grids, z_block, bw_method)
        ctx.save_for_backward(z, w, ra, dec, ra_pix, dec_pix, pixel_mask,
                              grids, z_block, records)
        ctx.bw_method = bw_method
        return out

    @staticmethod
    def backward(ctx, d_out):
        *inputs, records = ctx.saved_tensors
        grads = lattice_kde3d_adjoint(*inputs, d_out.contiguous(),
                                      bw_method=ctx.bw_method,
                                      wrt=ctx.needs_input_grad[1:7],
                                      records=records)
        return (None, *grads, None, None, None)


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
    whitening does not exist.  On the card a K outside [0, 32] gives NaN,
    and where z, w, ra, dec or the pixel centres require grad the backward
    is K5b (``lattice_kde3d_adjoint``)."""
    if not fused.on_card(z):
        return lattice_kde3d_plain(z, w, ra, dec, ra_pix, dec_pix, pixel_mask,
                                   grids, z_block, bw_method)
    if torch.is_grad_enabled() and grids.requires_grad:
        raise ValueError("lattice_kde3d: the z-grids are data, and K5b gives "
                         "them no cotangent on the card")
    inputs = (z, w, ra, dec, ra_pix, dec_pix)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _LatticeKDE3D.apply(bw_method, *inputs, pixel_mask, grids,
                                   z_block)
    return _launch_k5(*inputs, pixel_mask, grids, z_block, bw_method)[0]


lattice_kde3d.launches = 0


def lattice_kde3d_adjoint_plain(z, w, ra, dec, ra_pix, dec_pix, pixel_mask,
                                grids, z_block, d_out, bw_method=None,
                                wrt=(True,) * 6) -> tuple:
    """Plain PyTorch version of ``lattice_kde3d_adjoint``: autograd of
    ``lattice_kde3d_plain``, the vector-Jacobian product with d_out in z,
    w, ra, dec, ra_pix and dec_pix (None where ``wrt`` is False), a few
    events at a time (each event's output reads its inputs only), so that
    no graph of more than ~``fused.plain_budget`` (λ, pixel, grid point,
    sample) terms is held."""
    n, e, s = z.shape
    p, g = ra_pix.shape[1], grids.shape[1]
    step = max(1, fused.plain_budget(z) // (n * p * g * s))
    inputs = (z, w, ra, dec, ra_pix, dec_pix)
    grads = [torch.zeros_like(t) if need else None
             for t, need in zip(inputs, wrt)]
    for e0 in range(0, e, step):
        ev = slice(e0, min(e, e0 + step))
        leaves = [t[..., ev, :].detach().requires_grad_(bool(need))
                  for t, need in zip(inputs, wrt)]
        with torch.enable_grad():
            out = lattice_kde3d_plain(*leaves, pixel_mask[ev], grids[ev],
                                      z_block[ev], bw_method)
            wanted = [t for t in leaves if t.requires_grad]
            got = iter(torch.autograd.grad(out, wanted, d_out[:, ev],
                                           allow_unused=True))
        for acc, t in zip(grads, leaves):
            if t.requires_grad:
                acc[..., ev, :] = _dense(next(got), t)
    return tuple(grads)


def _dense(g, like):
    return torch.zeros_like(like) if g is None else g


def lattice_kde3d_adjoint(z, w, ra, dec, ra_pix, dec_pix, pixel_mask, grids,
                          z_block, d_out, bw_method=None, wrt=(True,) * 6,
                          records=None) -> tuple:
    """The vector-Jacobian product of ``lattice_kde3d`` with d_out (L, E, P,
    G) in z, w (L, E, S), ra, dec (E, S), ra_pix and dec_pix (E, P), each
    None where ``wrt`` (six flags in that order) is False.  CPU tensors
    take the plain version.  On CUDA tensors one launch of K5b reads
    ``records``, the record K5 wrote for the same inputs (the forward's;
    where None, one launch of K5 writes it), and writes the cotangents of
    each sample's unit weight and whitened coordinates, each pixel's, and
    each (λ, event)'s L00, mean z and log_norm; a (λ, event) whose
    whitening does not exist gets NaN, as autograd of the plain version
    gives it.  They are chained to the inputs through
    ``ops/kde.py::lattice_record`` in float64 by ``torch.autograd.grad`` and
    returned in the inputs' dtype."""
    if not fused.on_card(z):
        return lattice_kde3d_adjoint_plain(z, w, ra, dec, ra_pix, dec_pix,
                                           pixel_mask, grids, z_block, d_out,
                                           bw_method, wrt)
    if records is None:
        records = _launch_k5(z, w, ra, dec, ra_pix, dec_pix, pixel_mask, grids,
                             z_block, bw_method)[1]
    cotangents = launch_k5b(z, w, ra, dec, ra_pix, dec_pix, pixel_mask, grids,
                            z_block, records, d_out)
    return chain_k5b(z, w, ra, dec, ra_pix, dec_pix, *cotangents, bw_method,
                     wrt)


def launch_k5b(z, w, ra, dec, ra_pix, dec_pix, pixel_mask, grids, z_block,
               records, d_out) -> tuple:
    """One launch of K5b (counted in ``lattice_kde3d_adjoint.launches``) on
    CUDA tensors and ``records`` (L, E, 16) float64, the record K5 wrote
    for them (``_launch_k5``): the cotangents d_samp (L, E, S, 4)
    of each sample's unit weight and whitened a, b, c, d_pix (L, E, P, 3) of
    each pixel's c0, c1, c2, d_event (L, E, 3) of a shift of the whitened
    grid, of L00 and of log_norm, in float64 (csrc/kde3d.cuh, K5b)."""
    n, e, s, p, g = _checked(z, w, ra, dec, ra_pix, dec_pix, pixel_mask,
                             grids, z_block, d_out)
    dev, f64 = z.device, torch.float64
    if tuple(records.shape) != (n, e, _RECORD) or records.dtype != f64 \
            or records.device != dev:
        raise ValueError(f"records must be {(n, e, _RECORD)} {f64} on {dev}")
    smem = adjoint_smem(g, 1, z.element_size())
    if smem > _SMEM_LIMIT:
        raise ValueError(f"G = {g} grid points need {smem} bytes of shared "
                         f"memory per block, over the {_SMEM_LIMIT}-byte limit")
    d_samp = torch.empty((n, e, s, _SAMPLE_GRADS), dtype=f64, device=dev)
    d_pix = torch.empty((n, e, p, _PIXEL_GRADS), dtype=f64, device=dev)
    d_event = torch.empty((n, e, _EVENT_GRADS), dtype=f64, device=dev)
    fused.launch("kde3d", "chimera_kde3d_adjoint", z.dtype, dev,
                 [*(t.contiguous() for t in (z, w, ra, dec, ra_pix, dec_pix,
                                             pixel_mask, grids)),
                  z_block.to(torch.int32).contiguous(), records.contiguous(),
                  d_out.contiguous(), d_samp, d_pix, d_event, n, e, s, p, g])
    lattice_kde3d_adjoint.launches += 1
    return d_samp, d_pix, d_event


def chain_k5b(z, w, ra, dec, ra_pix, dec_pix, d_samp, d_pix, d_event,
              bw_method=None, wrt=(True,) * 6) -> tuple:
    """K5b's cotangents chained to z, w, ra, dec, ra_pix and dec_pix (None
    where ``wrt`` is False) through ``ops/kde.py::lattice_record`` in
    float64 by ``torch.autograd.grad``, in the inputs' dtype."""
    f64 = torch.float64
    leaves = [t.detach().to(f64).requires_grad_(bool(need))
              for t, need in zip((z, w, ra, dec, ra_pix, dec_pix), wrt)]
    wanted = [t for t in leaves if t.requires_grad]
    if not wanted:
        return (None,) * 6
    with torch.enable_grad():
        rec = lattice_record(*leaves, bw_method)
        # K5b's cotangents of the record's quantities; mean_z's through the
        # grid term l00 (z_g - mean_z) is -l00 times the shift's
        pairs = [(rec["wn"], d_samp[..., 0]), (rec["a"], d_samp[..., 1]),
                 (rec["b"], d_samp[..., 2]), (rec["c"], d_samp[..., 3]),
                 (rec["c0"], d_pix[..., 0]), (rec["c1"], d_pix[..., 1]),
                 (rec["c2"], d_pix[..., 2]), (rec["l00"], d_event[..., 1]),
                 (rec["mean_z"], -rec["l00"].detach() * d_event[..., 0]),
                 (rec["log_norm"], d_event[..., 2])]
        pairs = [(o, c) for o, c in pairs if o.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs],
                                       wanted, [c for _, c in pairs],
                                       allow_unused=True))
    return tuple(_dense(next(got), t).to(z.dtype) if t.requires_grad else None
                 for t in leaves)


lattice_kde3d_adjoint.launches = 0
