"""KDE + dark-siren epilogue contraction over dense chunk rows for a λ
batch (counterpart of ``chimera_tpu/ops/pallas/fused.py::
fused_rows_contract``, K2).

Per (λ, row r of event e), with ``hs[λ, r] = (1/h, scale)`` from the stats
pass (``fused.fused_row_stats``):

    den[g] = sum_s w_s K((grid_eg - z_s) / h)
    r1 = scale * sum_g den[g] s1[r, g] f1[λ, e, g]
    r2 = scale * sum_g den[g] s2[r, g] f2[λ, e, g]

``fused_rows_contract`` runs the hand-written CUDA kernel
(``chimera_tpu_torch/csrc/rows_contract.cu``) on CUDA tensors and the plain
PyTorch version ``fused_rows_contract_plain`` on CPU tensors; on CUDA it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from chimera_tpu_torch.models.cosmology import z_from_dgw
from chimera_tpu_torch.models.mass import p_m1m2
from chimera_tpu_torch.ops.cuda.fused import (_SMEM_LIMIT, check_cuda_call,
                                              refuse_grad,
                                              launch, pack_params, smem_bytes)
from chimera_tpu_torch.ops.kde import KERNELS

# elements of one (L, rows, G, chunk) intermediate in the plain version
_PLAIN_BUDGET = 1 << 25


def _rows_per_event(dl, grids) -> int:
    r_rows, e_ev = dl.shape[0], grids.shape[0]
    if r_rows % e_ev:
        raise ValueError(f"{r_rows} rows are not a whole number of rows for "
                         f"each of the {e_ev} events")
    return r_rows // e_ev


def fused_rows_contract_plain(m1det, m2det, dl, inv_pe_prior, cosmo, mass,
                              grids, hs, s1, s2, f1, f2, kernel: str = "epan"
                              ) -> torch.Tensor:
    """Plain PyTorch version of ``_rows_reference`` (fused.py:613-640),
    chunked over whole events so that no (L, R, G, chunk) tensor is ever
    materialized.  Returns r (L, R, 2)."""
    r_rows, chunk = dl.shape
    c = _rows_per_event(dl, grids)
    g = grids.shape[1]
    n = max(cosmo.L, mass.L)
    kfn = KERNELS[kernel]
    out = torch.empty((n, r_rows, 2), dtype=dl.dtype, device=dl.device)
    step = c * max(1, _PLAIN_BUDGET // (n * g * chunk * c))
    for r0 in range(0, r_rows, step):
        rows = slice(r0, min(r_rows, r0 + step))
        ev = slice(r0 // c, rows.stop // c)
        z = z_from_dgw(cosmo, dl[None, rows]).expand(n, -1, -1)   # (n, rr, chunk)
        inv1pz = 1.0 / (1.0 + z)
        w = p_m1m2(mass, m1det[None, rows] * inv1pz,
                   m2det[None, rows] * inv1pz) * inv_pe_prior[None, rows]
        grid = grids[ev].repeat_interleave(c, dim=0)               # (rr, G)
        u = (grid[None, :, :, None] - z[:, :, None, :]) * hs[:, rows, 0, None, None]
        den = torch.sum(w[:, :, None, :] * kfn(u), dim=-1)         # (n, rr, G)
        f1r = f1[:, ev].repeat_interleave(c, dim=1)
        f2r = f2[:, ev].repeat_interleave(c, dim=1)
        out[:, rows, 0] = torch.sum(den * s1[rows] * f1r, dim=-1) * hs[:, rows, 1]
        out[:, rows, 1] = torch.sum(den * s2[rows] * f2r, dim=-1) * hs[:, rows, 1]
    return out


def fused_rows_contract(m1det, m2det, dl, inv_pe_prior, cosmo, mass, grids,
                        hs, s1, s2, f1, f2, kernel: str = "epan") -> torch.Tensor:
    """KDE + dark-siren contraction over chunk rows.

    Args:
      m1det, m2det, dl, inv_pe_prior: (R, chunk) rows, event-major, R = E * C
        (``data.pixelize.chunk_rows_from_compact``).
      cosmo, mass: λ-batched ``FLRW`` (chebyshev) and ``PowerLawPeak``
        (analytic CDF).
      grids: (E, G) analysis grids.
      hs: (L, R, 2) per (λ, row) [1/bandwidth, scale]; scale = 0 makes a row
        exactly 0.
      s1, s2: (R, G) static factors; f1, f2: (L, E, G) per-λ factors.

    Returns r (L, R, 2): per-row partial sums of the event numerator.
    """
    if dl.device.type == "cpu":
        return fused_rows_contract_plain(m1det, m2det, dl, inv_pe_prior, cosmo,
                                         mass, grids, hs, s1, s2, f1, f2, kernel)
    check_cuda_call("fused_rows_contract", cosmo, mass, dl,
                    {"m1det": m1det, "m2det": m2det, "inv_pe_prior": inv_pe_prior})
    if kernel not in ("epan", "gauss"):
        raise ValueError(f"unknown KDE kernel {kernel!r}")
    dt, dev = dl.dtype, dl.device
    r_rows, chunk = dl.shape
    c = _rows_per_event(dl, grids)
    e_ev, g = grids.shape
    n = max(cosmo.L, mass.L)
    for name, t, shape in (("grids", grids, (e_ev, g)), ("hs", hs, (n, r_rows, 2)),
                           ("s1", s1, (r_rows, g)), ("s2", s2, (r_rows, g)),
                           ("f1", f1, (n, e_ev, g)), ("f2", f2, (n, e_ev, g))):
        if t.shape != shape or t.dtype != dt or t.device != dev:
            raise ValueError(f"{name} must be {shape} {dt} on {dev}")
    series, params = (t.to(dev) for t in pack_params(cosmo, mass, n, dt))
    refuse_grad("fused_rows_contract", series, params, hs, f1, f2)
    # the Chebyshev series are summed in float64 (models.cosmology.z_from_dgw)
    smem = smem_bytes(series, 8, params, 2 * chunk + 3 * g)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"chunk = {chunk} and G = {g} need {smem} bytes of shared memory "
            f"per block, over the {_SMEM_LIMIT}-byte limit")
    inputs = [t.contiguous() for t in (m1det, m2det, dl, inv_pe_prior, grids)]
    rest = [t.contiguous() for t in (hs, s1, s2, f1, f2)]
    out = torch.empty((n, r_rows, 2), dtype=dt, device=dev)
    launch("rows_contract", "chimera_rows_contract", dt, dev,
           [*inputs, series, params, *rest, out, n, e_ev, c, chunk, g,
            cosmo.cheb_deg, mass.window_deg, 0 if kernel == "epan" else 1])
    fused_rows_contract.launches += 1
    return out


fused_rows_contract.launches = 0
