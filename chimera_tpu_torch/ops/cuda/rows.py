"""KDE + dark-siren epilogue contraction over dense chunk rows for a λ
batch (counterpart of ``chimera_tpu/ops/pallas/fused.py::
fused_rows_contract``, K2), and its backward (K2b).

Per (λ, row r of event e), with ``hs[λ, r] = (1/h, scale)`` from the stats
pass (``fused.fused_row_stats``):

    den[g] = sum_s w_s K((grid_eg - z_s) / h)
    r1 = scale * sum_g den[g] s1[r, g] f1[λ, e, g]
    r2 = scale * sum_g den[g] s2[r, g] f2[λ, e, g]

``fused_rows_contract`` runs the hand-written CUDA kernel
(``chimera_tpu_torch/csrc/rows_contract.cu``) on CUDA tensors and the plain
PyTorch version ``fused_rows_contract_plain`` on CPU tensors; on CUDA it
launches the kernel or raises.  Where a model row, ``hs``, ``f1`` or ``f2``
requires grad, the CUDA launch sits in a ``torch.autograd.Function`` whose
backward is ``fused_rows_contract_adjoint`` (K2b,
``csrc/rows_contract_adjoint.cu``; plain version
``fused_rows_contract_adjoint_plain``).  ``fused_rows_contract.launches``
and ``fused_rows_contract_adjoint.launches`` count the launches.
"""

from __future__ import annotations

import torch

from chimera_tpu_torch.models.cosmology import z_from_dgw
from chimera_tpu_torch.models.mass import p_m1m2
from chimera_tpu_torch.ops.cuda.fused import (_ADJOINT_MAX_DEG,
                                              adjoint_scratch,
                                              _ADJOINT_STATIC_SMEM,
                                              _GRID_TILE, _RECORD_EXTRA,
                                              _SMEM_LIMIT, _TILE_S,
                                              check_cuda_call, launch,
                                              mass_kind, on_card,
                                              pack_params, packed_width,
                                              plain_budget, smem_bytes,
                                              stash_rows, unpack_params,
                                              window_degree)
from chimera_tpu_torch.ops.kde import MAX_FORM_KERNELS

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
    kfn = MAX_FORM_KERNELS[kernel]
    out = torch.empty((n, r_rows, 2), dtype=dl.dtype, device=dl.device)
    step = c * max(1, plain_budget(dl) // (n * g * chunk * c))
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


def _check_rows_call(name, m1det, m2det, dl, inv_pe_prior, cosmo, mass,
                     grids, hs, s1, s2, f1, f2, kernel):
    """The checks of a K2 or K2b launch; returns (E, C, chunk, G, L)."""
    check_cuda_call(name, cosmo, mass, dl,
                    {"m1det": m1det, "m2det": m2det, "inv_pe_prior": inv_pe_prior})
    if kernel not in ("epan", "gauss"):
        raise ValueError(f"unknown KDE kernel {kernel!r}")
    dt, dev = dl.dtype, dl.device
    r_rows, chunk = dl.shape
    c = _rows_per_event(dl, grids)
    e_ev, g = grids.shape
    n = max(cosmo.L, mass.L)
    for key, t, shape in (("grids", grids, (e_ev, g)), ("hs", hs, (n, r_rows, 2)),
                          ("s1", s1, (r_rows, g)), ("s2", s2, (r_rows, g)),
                          ("f1", f1, (n, e_ev, g)), ("f2", f2, (n, e_ev, g))):
        if t.shape != shape or t.dtype != dt or t.device != dev:
            raise ValueError(f"{key} must be {shape} {dt} on {dev}")
    return e_ev, c, chunk, g, n


def _launch_k2(series, params, m1det, m2det, dl, inv_pe_prior, grids, hs, s1,
               s2, f1, f2, cosmo, mass, kernel, dims):
    e_ev, c, chunk, g, n = dims
    dt, dev = dl.dtype, dl.device
    # the Chebyshev series are summed in float64 (models.cosmology.z_from_dgw);
    # the pruned Epanechnikov loop keeps its sample tiles' bounds and the
    # row's densities in shared memory too
    smem = smem_bytes(series, 8, params, 2 * chunk + 3 * g + (
        2 * -(-chunk // _TILE_S) + g if kernel == "epan" else 0))
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"chunk = {chunk} and G = {g} need {smem} bytes of shared memory "
            f"per block, over the {_SMEM_LIMIT}-byte limit")
    inputs = [t.contiguous() for t in (m1det, m2det, dl, inv_pe_prior, grids)]
    rest = [t.contiguous() for t in (hs, s1, s2, f1, f2)]
    out = torch.empty((n, e_ev * c, 2), dtype=dt, device=dev)
    launch("rows_contract", "chimera_rows_contract", dt, dev,
           [*inputs, series, params, *rest, out, n, e_ev, c, chunk, g,
            cosmo.cheb_deg, window_degree(mass), 0 if kernel == "epan" else 1],
           mass_kind(mass))
    return out


class _RowsContract(torch.autograd.Function):
    """K2 on CUDA tensors with K2b as the backward in the packed rows, hs,
    f1 and f2."""

    @staticmethod
    def forward(ctx, series, params, hs, f1, f2, cosmo, mass, kernel, dims,
                m1det, m2det, dl, inv_pe_prior, grids, s1, s2):
        ctx.save_for_backward(series, params, hs, f1, f2, m1det, m2det, dl,
                              inv_pe_prior, grids, s1, s2)
        ctx.cfg = (cosmo, mass, kernel)
        return _launch_k2(series, params, m1det, m2det, dl, inv_pe_prior, grids,
                          hs, s1, s2, f1, f2, cosmo, mass, kernel, dims)

    @staticmethod
    def backward(ctx, ct_r):
        series, params, hs, f1, f2, m1, m2, dl, invp, grids, s1, s2 = \
            ctx.saved_tensors
        cosmo, mass, kernel = ctx.cfg
        grads = fused_rows_contract_adjoint(
            m1, m2, dl, invp, grids, series, params, hs, s1, s2, f1, f2,
            ct_r.contiguous(), cosmo, mass, kernel)
        return grads + (None,) * 11


def fused_rows_contract(m1det, m2det, dl, inv_pe_prior, cosmo, mass, grids,
                        hs, s1, s2, f1, f2, kernel: str = "epan") -> torch.Tensor:
    """KDE + dark-siren contraction over chunk rows.

    Args:
      m1det, m2det, dl, inv_pe_prior: (R, chunk) rows, event-major, R = E * C
        (``data.pixelize.chunk_rows_from_compact``).
      cosmo, mass: λ-batched ``FLRW`` or ``MGFLRW`` (chebyshev) and a mass
        model of ``fused.MASS_KINDS`` (analytic CDF).
      grids: (E, G) analysis grids.
      hs: (L, R, 2) per (λ, row) [1/bandwidth, scale]; scale = 0 makes a row
        exactly 0.
      s1, s2: (R, G) static factors; f1, f2: (L, E, G) per-λ factors.

    Returns r (L, R, 2): per-row partial sums of the event numerator.  Where
    a model tensor, ``hs``, ``f1`` or ``f2`` requires grad, the backward on
    CUDA tensors is K2b (``fused_rows_contract_adjoint``).
    """
    if not on_card(dl):
        return fused_rows_contract_plain(m1det, m2det, dl, inv_pe_prior, cosmo,
                                         mass, grids, hs, s1, s2, f1, f2, kernel)
    dims = _check_rows_call("fused_rows_contract", m1det, m2det, dl,
                            inv_pe_prior, cosmo, mass, grids, hs, s1, s2, f1,
                            f2, kernel)
    series, params = (t.to(dl.device) for t in pack_params(cosmo, mass, dims[4],
                                                           dl.dtype))
    data = (m1det, m2det, dl, inv_pe_prior, grids)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (series, params, hs, f1, f2)):
        out = _RowsContract.apply(series, params, hs, f1, f2, cosmo, mass,
                                  kernel, dims, *data, s1, s2)
    else:
        out = _launch_k2(series, params, *data, hs, s1, s2, f1, f2, cosmo,
                         mass, kernel, dims)
    fused_rows_contract.launches += 1
    return out


fused_rows_contract.launches = 0


def fused_rows_contract_adjoint_plain(m1det, m2det, dl, inv_pe_prior, grids,
                                      series, params, hs, s1, s2, f1, f2, ct_r,
                                      cosmo, mass, kernel: str = "epan"):
    """Plain PyTorch version of ``fused_rows_contract_adjoint``: the
    vector-Jacobian product of ``fused_rows_contract_plain`` (the semantics
    of ``jax.vjp`` of ``_rows_reference``, fused.py:605-640) by autograd,
    chunked over whole events so that no (L, R, G, chunk) graph is ever
    held."""
    r_rows, chunk = dl.shape
    c = _rows_per_event(dl, grids)
    g = grids.shape[1]
    n = series.shape[0]
    wrt = [t.detach().requires_grad_() for t in (series, params, hs, f1, f2)]
    series, params, hs, f1, f2 = wrt
    grads = [torch.zeros_like(t) for t in wrt]
    step = c * max(1, plain_budget(dl) // (n * g * chunk * c))
    with torch.enable_grad():
        for r0 in range(0, r_rows, step):
            rows = slice(r0, min(r_rows, r0 + step))
            ev = slice(r0 // c, rows.stop // c)
            cos, mas = unpack_params(cosmo, mass, series, params)
            r = fused_rows_contract_plain(
                m1det[rows], m2det[rows], dl[rows], inv_pe_prior[rows], cos,
                mas, grids[ev], hs[:, rows], s1[rows], s2[rows], f1[:, ev],
                f2[:, ev], kernel)
            out = torch.sum(r * ct_r[:, rows])
            for acc, gr in zip(grads, torch.autograd.grad(out, wrt,
                                                          allow_unused=True)):
                if gr is not None:
                    acc += gr
    return tuple(grads)


def fused_rows_contract_adjoint(m1det, m2det, dl, inv_pe_prior, grids, series,
                                params, hs, s1, s2, f1, f2, ct_r, cosmo, mass,
                                kernel: str = "epan"):
    """Backward of ``fused_rows_contract`` (K2b).

    Args:
      m1det, m2det, dl, inv_pe_prior, grids, hs, s1, s2, f1, f2: the
        forward's inputs.
      series, params: the packed per-λ rows of ``fused.pack_params``.
      ct_r (L, R, 2): the cotangent of r.
      cosmo, mass: the models the rows were packed from.

    Returns d_series (L, cheb_deg + 2 + window_deg) float64 and d_params
    (L, P), P the model's scalars, summed over the events in a fixed order (equal inputs give
    equal bits); d_hs (L, R, 2), the cotangents of 1/h and of the scale;
    d_f1, d_f2 (L, E, G).  The PE data, grids, s1 and s2 get none.  A row
    that r has as an exact zero (scale 0, or no weight) gets zero
    cotangents.  CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise.
    """
    if not on_card(dl):
        return fused_rows_contract_adjoint_plain(
            m1det, m2det, dl, inv_pe_prior, grids, series, params, hs, s1, s2,
            f1, f2, ct_r, cosmo, mass, kernel)
    e_ev, c, chunk, g, n = _check_rows_call(
        "fused_rows_contract_adjoint", m1det, m2det, dl, inv_pe_prior, cosmo,
        mass, grids, hs, s1, s2, f1, f2, kernel)
    dt, dev = dl.dtype, dl.device
    wd = window_degree(mass)
    q = cosmo.cheb_deg + 2 + wd
    if cosmo.cheb_deg > _ADJOINT_MAX_DEG or wd > _ADJOINT_MAX_DEG:
        raise ValueError(
            f"the adjoint kernel takes Chebyshev degrees up to {_ADJOINT_MAX_DEG}")
    n_params = packed_width(mass)
    for key, t, shape, dtype in (
            ("series", series, (n, q), torch.float64),
            ("params", params, (n, n_params), dt),
            ("ct_r", ct_r, (n, e_ev * c, 2), dt)):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev:
            raise ValueError(f"{key} must be {shape} {dtype} on {dev}")
    # the λ's record, (z, w) and (dz, dw) of the row's samples (and
    # PowerLawSpline's knots' points), the grid with its c_g, f1, f2 and
    # their cotangents, the pruned passes' tiles
    smem = smem_bytes(series, 8, params, stash_rows(mass) * chunk + 7 * g
                      + _RECORD_EXTRA[type(mass).__name__]
                      + 2 * (-(-chunk // _TILE_S) - (-g // _GRID_TILE)))
    if smem > _SMEM_LIMIT - _ADJOINT_STATIC_SMEM:
        raise ValueError(
            f"chunk = {chunk} and G = {g} need {smem} bytes of shared memory "
            f"per block, over the {_SMEM_LIMIT - _ADJOINT_STATIC_SMEM}-byte limit")
    inputs = [t.contiguous() for t in (m1det, m2det, dl, inv_pe_prior, grids,
                                       series, params, hs, s1, s2, f1, f2, ct_r)]
    partials = adjoint_scratch(n, e_ev, series, 8, params, mass)
    d_series = torch.empty((n, q), dtype=torch.float64, device=dev)
    d_params = torch.empty((n, n_params), dtype=dt, device=dev)
    d_hs = torch.empty((n, e_ev * c, 2), dtype=dt, device=dev)
    d_f1 = torch.empty((n, e_ev, g), dtype=dt, device=dev)
    d_f2 = torch.empty((n, e_ev, g), dtype=dt, device=dev)
    launch("rows_contract_adjoint", "chimera_rows_contract_adjoint", dt, dev,
           [*inputs, partials, d_series, d_params, d_hs, d_f1, d_f2, n, e_ev, c,
            chunk, g, cosmo.cheb_deg, wd, 0 if kernel == "epan" else 1],
           mass_kind(mass))
    fused_rows_contract_adjoint.launches += 1
    return d_series, d_params, d_hs, d_f1, d_f2


fused_rows_contract_adjoint.launches = 0
