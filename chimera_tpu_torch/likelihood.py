"""The hyper-likelihood of the port (counterpart of
``chimera_tpu/likelihood.py``), for two kinds, both unbinned with the KDEs
evaluated directly on the analysis z-grids (``cut_grid=None``):

* ``kind='1d'``, the spectral siren: per event, the fused weights+KDE
  kernel (K1a), then p_cbc over the jacobian integrated on the z-grids;
* ``kind='marginalized'``, the dark siren with a pixelated galaxy catalog
  (``chimera_tpu/likelihood.py:1019-1089``): per (event, pixel) a 1-D KDE
  of that pixel's samples times the 2-D localization pdf and the catalog
  prior.  Two kernel launches per λ batch: the stats-only pass (K1c) on the
  per-pixel rectangle gives each pixel row its bandwidth and weight sums,
  then the rows-contract kernel (K2) runs the KDE and the whole epilogue
  contraction over dense 128-sample chunk rows.  The layouts and the
  λ-independent contraction factors are built once, in ``create``.

Each kernel runs as its CUDA kernel on CUDA tensors and as its plain
PyTorch version on CPU tensors.  ``log_like_batch`` is differentiable in
the hyper-parameters: pass tensors that require grad.  On CPU tensors the
whole backward is autograd through the plain versions; on CUDA tensors the
backward of the spectral kind's fused pass is the adjoint kernel K3, and
the dark kind has no backward yet (it raises).  ``HyperLikelihood`` is an
``nn.Module``
whose buffers hold the PE data, layouts, z-grids and (in its ``selection``)
the injections; ``.to(device, dtype)`` moves them and the population's
tensors together.
"""

from __future__ import annotations

import torch
from torch import nn

from chimera_tpu_torch.data.pixelize import (chunk_rows_from_compact,
                                             compact_samples_by_pixel)
from chimera_tpu_torch.data.structs import ThetaPEDet
from chimera_tpu_torch.models import cosmology as cosmo_fns
from chimera_tpu_torch.models.population import Population, p_cbc
from chimera_tpu_torch.ops.cuda.fused import fused_row_stats, fused_weights_kde
from chimera_tpu_torch.ops.cuda.rows import fused_rows_contract
from chimera_tpu_torch.ops.integrate import trapz, trapz_weights
from chimera_tpu_torch.pytree import tensor_map
from chimera_tpu_torch.selection import SelectionFunction

_PE_FIELDS = ("m1det", "m2det", "dL", "pe_prior")
# pixelation fields: integer pixel indices, the mask, float sky positions
_PIXEL_FIELDS = {"opt_nsides": torch.int64, "pixels_opt_nsides": torch.int64,
                 "pixels_pe_opt_nside": torch.int64, "pixel_mask": torch.bool,
                 "ra_pix": None, "dec_pix": None, "gw_loc2d_pdf": None}
_PER_SAMPLE_FIELDS = ("m1det", "m2det", "dL", "phi", "theta", "ra", "dec",
                      "pe_prior", "pixels_pe_opt_nside")
_LAYOUT_FIELDS = ("m1det", "m2det", "dL", "inv_pe_prior")


def _validate_shapes(theta_gw: ThetaPEDet, z_grids: torch.Tensor,
                     population: Population, kind: str) -> None:
    """Construction-time shape check, naming the offending axis."""
    if z_grids.dim() != 2:
        raise ValueError(f"z_grids must be (Nev, Nz); got shape {tuple(z_grids.shape)}")
    n_ev = theta_gw.dL.shape[0]
    if z_grids.shape[0] != n_ev:
        raise ValueError(
            f"z_grids has {z_grids.shape[0]} events but theta_gw has {n_ev} "
            f"(dL shape {tuple(theta_gw.dL.shape)})")
    p_cat = getattr(population.gal_cat, "p_cat", None)
    if kind == "1d" or p_cat is None:
        return
    expect = (n_ev, theta_gw.pixel_mask.shape[1], z_grids.shape[1])
    if tuple(p_cat.shape) != expect:
        raise ValueError(
            f"gal_cat.p_cat must be (Nev, P, Nz) = {expect} to match theta_gw "
            f"and z_grids; got {tuple(p_cat.shape)} (build the catalog on "
            "these z-grids: catalog.build.build_pixelated_catalog)")


def _sort_samples_by_distance(theta_gw: ThetaPEDet) -> ThetaPEDet:
    """Sort each event's PE samples by dL, permuting every per-sample field
    (the samples' pixels too) alike: order-free for the likelihood, and it
    makes the sample axis z-ordered under every cosmology."""
    order = torch.argsort(theta_gw.dL, dim=-1, stable=True)
    updates = {}
    for f in _PER_SAMPLE_FIELDS:
        v = getattr(theta_gw, f)
        if v is not None:
            updates[f] = torch.take_along_dim(v, order.to(v.device), dim=-1)
    return theta_gw.update(**updates)


def _jacobian(pop: Population, z: torch.Tensor) -> torch.Tensor:
    """|d(dGW)/dz| (1+z)^2 — detector->source measure; ``z`` has a leading
    λ axis."""
    return cosmo_fns.ddl_dz_at_z(pop.cosmo, z) * (1.0 + z) ** 2


class HyperLikelihood(nn.Module):
    """Spectral-siren ('1d') or dark-siren ('marginalized') hyper-likelihood
    over a λ batch.

    Build it with :meth:`create` (mirrors ``chimera_tpu``'s constructor
    surface) or :meth:`from_state` (from a built JAX object)."""

    def __init__(self, theta_gw: ThetaPEDet, z_grids: torch.Tensor,
                 population: Population, selection: SelectionFunction,
                 kind: str, kernel: str, bw_method, pe_neff: float):
        super().__init__()
        self.kind = kind
        self.population = population
        self.selection = selection
        self.kernel = kernel
        self.bw_method = bw_method
        self.pe_neff = float(pe_neff)
        self.register_buffer("z_grids", z_grids.to(theta_gw.dL.dtype))
        self.n_samples = theta_gw.dL.shape[1]
        if kind == "marginalized":
            self._build_marginalized(theta_gw, z_grids)
            return
        for name in _PE_FIELDS:
            self.register_buffer(name, getattr(theta_gw, name))
        self.register_buffer("inv_pe_prior", 1.0 / theta_gw.pe_prior)

    def _build_marginalized(self, theta_gw: ThetaPEDet, z_grids: torch.Tensor
                            ) -> None:
        """The per-pixel layouts and the λ-independent contraction factors,
        built once as buffers:

        * ``pix_*`` (E*P, S_pp), ``pix_n_real``, ``pix_dl_fill``: the
          per-pixel rectangle of the stats pass;
        * ``row_*`` (R, 128): the chunk rows of the KDE pass, R = E*C;
          ``row_pixel`` (R,) the (event, pixel) row of each chunk row;
        * ``row_s1``, ``row_s2`` (R, G): s1 = p_cat * loc * tw and
          s2 = (1 - P_compl) * loc * tw (loc the masked localization pdf, tw
          the trapezoid weights) gathered per chunk row
          (``chimera_tpu/likelihood.py:987-1002, 1069``), computed in
          float64 from the z-grids as given: float32 trapezoid weights
          (differences of nearby grid points) cost the float32 likelihood
          several 1e-6 of relative accuracy.
        """
        compact = compact_samples_by_pixel(theta_gw)
        rows = chunk_rows_from_compact(compact)
        n_ev, n_pix, _ = compact["dL"].shape
        for name in _LAYOUT_FIELDS:
            self.register_buffer("pix_" + name, compact[name].reshape(n_ev * n_pix, -1))
            self.register_buffer("row_" + name, rows[name].reshape(-1, rows[name].shape[-1]))
        self.register_buffer("pix_n_real", compact["n_real"].reshape(-1))
        self.register_buffer("pix_dl_fill",
                             compact["dl_fill"].repeat_interleave(n_pix))
        row_pixel = (torch.arange(n_ev, device=rows["row_pix"].device)[:, None]
                     * n_pix + rows["row_pix"]).reshape(-1)
        self.register_buffer("row_pixel", row_pixel)
        self.n_pixels = n_pix
        self.rows_per_event = rows["dL"].shape[1]

        gc = self.population.gal_cat
        f64, dt = torch.float64, self.z_grids.dtype
        loc = torch.where(theta_gw.pixel_mask, theta_gw.gw_loc2d_pdf.to(f64), 0.0)
        base = loc[:, :, None] * trapz_weights(z_grids.to(f64))[:, None, :]  # (E, P, G)
        g = z_grids.shape[1]
        s1 = (gc.p_cat.to(f64) * base).reshape(-1, g)[row_pixel]
        s2 = ((1.0 - gc.P_compl.to(f64)) * base).reshape(-1, g)[row_pixel]
        self.register_buffer("row_s1", s1.to(dt))
        self.register_buffer("row_s2", s2.to(dt))

    @classmethod
    def create(cls, theta_gw: ThetaPEDet, z_grids, population: Population,
               selection: SelectionFunction, kind=None, kernel="epan",
               bw_method=None, cut_grid=2.0, binning=True, pe_neff=2.0
               ) -> "HyperLikelihood":
        """PE data, z-grids and injections are moved to the population's
        device and dtype; samples are sorted by distance.  Pixelated data
        takes ``kind='marginalized'`` (or '1d' to ignore the pixels); other
        data is spectral ('1d')."""
        theta_gw = theta_gw.with_derived()
        if kind == "approximate":
            raise NotImplementedError(
                "kind='approximate' is ROADMAP.md §1 item 8")
        if kind == "full":
            raise NotImplementedError("kind='full' is ROADMAP.md §1 item 11")
        if theta_gw.pixelated:
            if kind not in ("1d", "marginalized"):
                raise ValueError("pixelated data requires kind in "
                                 "('1d', 'approximate', 'marginalized', 'full')")
        elif kind not in (None, "1d"):
            raise ValueError(f"kind={kind!r} needs pixelated PE data "
                             "(data.pixelize.pixelize_gw_catalog)")
        else:
            kind = "1d"
        if binning:
            raise NotImplementedError(
                "binning=True is ROADMAP.md §1 item 12 (K4); pass binning=False")
        if cut_grid is not None:
            raise NotImplementedError(
                "effective-grid KDEs (cut_grid) are ROADMAP.md §1 items 8 and 12 "
                "(K1 modes b, d); pass cut_grid=None")
        if selection is None:
            raise ValueError("a SelectionFunction is required")
        ref = population.cosmo.H0
        updates = {f: torch.as_tensor(getattr(theta_gw, f), dtype=ref.dtype,
                                      device=ref.device) for f in _PE_FIELDS}
        if kind == "marginalized":
            updates.update({
                f: torch.as_tensor(getattr(theta_gw, f), device=ref.device)
                for f in _PIXEL_FIELDS if getattr(theta_gw, f) is not None})
        theta_gw = theta_gw.update(**updates)
        z_grids = torch.as_tensor(z_grids, device=ref.device)
        _validate_shapes(theta_gw, z_grids, population, kind)
        hl = cls(_sort_samples_by_distance(theta_gw), z_grids, population,
                 selection, kind, kernel, bw_method, pe_neff)
        hl.selection.to(device=ref.device, dtype=ref.dtype)
        return hl

    @classmethod
    def from_state(cls, state: dict, device=None, dtype=None) -> "HyperLikelihood":
        """Rebuild from ``convert.state_from_reference(jax_hyperlikelihood)``:
        the same PE data (and pixelation), z-grids, injections, population
        (its built tables and catalog included) and configuration.  The
        JAX object's ``grad_engine`` has no counterpart here (the backward
        follows the tensors' device) and is not read."""
        pop = Population.from_state(state, "population.", device, dtype)
        ref = pop.cosmo.H0

        def arr(key, dt=ref.dtype):
            t = torch.as_tensor(state[key], device=ref.device)
            return t.round().to(dt) if t.is_floating_point() and dt == torch.int64 \
                else t.to(dt)

        theta = ThetaPEDet(**{f: arr(f"theta_gw.{f}") for f in _PE_FIELDS})
        pixels = {f: arr(f"theta_gw.{f}", dt or torch.float64)
                  for f, dt in _PIXEL_FIELDS.items() if f"theta_gw.{f}" in state}
        theta = theta.update(**pixels)
        sel = SelectionFunction.from_state(state, "selection.", ref.device,
                                           ref.dtype)
        bw = state.get("bw_method")
        cut = state.get("cut_grid")
        return cls.create(theta, arr("z_grids", torch.float64), pop, sel,
                          kind=str(state["kind"]), kernel=str(state["kernel"]),
                          bw_method=None if bw is None else bw.item(),
                          cut_grid=None if cut is None else float(cut),
                          binning=bool(state["binning"]),
                          pe_neff=float(state["pe_neff"]))

    def _apply(self, fn, *args, **kwargs):
        # .to()/.cuda()/.double() also move the population's tensors
        super()._apply(fn, *args, **kwargs)
        self.population = tensor_map(self.population, fn)
        return self

    # -- evaluation ---------------------------------------------------------

    @property
    def n_events(self) -> int:
        return self.z_grids.shape[0]

    def batch_numerators(self, pop_b: Population) -> torch.Tensor:
        """Per-event numerator integrals for a λ batch — (L, Nev)."""
        if self.kind == "marginalized":
            return self._numerators_marginalized(pop_b)
        return self._numerators_1d(pop_b)

    def _numerators_1d(self, pop_b: Population) -> torch.Tensor:
        """The fused weights+KDE pass, then ``numerators_from_densities``."""
        den, stats = fused_weights_kde(
            self.m1det, self.m2det, self.dL, self.inv_pe_prior,
            pop_b.cosmo, pop_b.mass, self.z_grids,
            kernel=self.kernel, bw_method=self.bw_method)
        return self.numerators_from_densities(pop_b, den, stats)

    def numerators_from_densities(self, pop_b: Population, den: torch.Tensor,
                                  stats: dict) -> torch.Tensor:
        """Spectral numerators (L, Nev) from the fused pass's outputs: the
        densities, gated by N_eff, times p_cbc over the detector jacobian,
        integrated over the z-grids."""
        gate = stats["neff"] >= self.pe_neff
        p_gw = torch.where(gate[..., None], torch.nan_to_num(den), 0.0)
        zg = self.z_grids[None]
        integrand = p_gw * p_cbc(pop_b, zg) / _jacobian(pop_b, zg)
        return trapz(integrand, zg, dim=-1)

    def lambda_factors(self, pop_b: Population):
        """Per-λ contraction factors f1 = psi/(1+z)/jac and f2 = p_bkg * f1
        on the z-grids — (L, E, G) each — and the completeness fraction
        fR — (L,) (``chimera_tpu/likelihood.py:1005-1016``)."""
        zg = self.z_grids[None]
        f1 = pop_b.rate.rate(zg) / (1.0 + zg) / _jacobian(pop_b, zg)
        compl = pop_b.gal_cat.completeness
        return f1, compl.p_bkg(pop_b.cosmo, zg) * f1, compl.fR(pop_b.cosmo)

    def row_scales(self, stats: dict) -> torch.Tensor:
        """(L, R, 2) per chunk row [1/h, 1/(h sum_w)] of its pixel, from the
        stats pass; a pixel row with no weight, or a bandwidth that is not
        finite and positive (NaN from the kernel's raw formulas), gets
        scale 0 (``chimera_tpu/likelihood.py:1058-1070``)."""
        h, sum_w = stats["bandwidth"], stats["sum_w"]
        tiny = torch.finfo(h.dtype).tiny
        ok = (sum_w > tiny ** 0.5) & torch.isfinite(h) & (h > 0.0)
        inv_h = torch.where(ok, 1.0 / torch.where(ok, h, 1.0), 1.0)
        scale = torch.where(ok, inv_h / torch.where(ok, sum_w, 1.0), 0.0)
        return torch.stack([inv_h[:, self.row_pixel], scale[:, self.row_pixel]],
                           dim=-1)

    def _numerators_marginalized(self, pop_b: Population) -> torch.Tensor:
        """Two kernel passes: row statistics on the per-pixel rectangle
        (K1c), then KDE + contraction on the chunk rows (K2); per event

            num = norms * (fR * sum_rows r1 + sum_rows r2),

        gated by the event's N_eff (the pixels partition its samples, so its
        weight sums are the pixel sums)."""
        stats = fused_row_stats(
            self.pix_m1det, self.pix_m2det, self.pix_dL, self.pix_inv_pe_prior,
            pop_b.cosmo, pop_b.mass, n_real=self.pix_n_real,
            dl_fill=self.pix_dl_fill, logical_s=self.n_samples, cut_grid=2.0,
            bw_method=self.bw_method)
        f1, f2, fr = self.lambda_factors(pop_b)
        r = fused_rows_contract(
            self.row_m1det, self.row_m2det, self.row_dL, self.row_inv_pe_prior,
            pop_b.cosmo, pop_b.mass, self.z_grids, self.row_scales(stats),
            self.row_s1, self.row_s2, f1, f2, kernel=self.kernel)
        n, n_ev = r.shape[0], self.n_events
        sum_w = stats["sum_w"].reshape(n, n_ev, self.n_pixels).sum(dim=-1)
        sum_w2 = stats["sum_w2"].reshape(n, n_ev, self.n_pixels).sum(dim=-1)
        gate = sum_w * sum_w / sum_w2 >= self.pe_neff
        r = r.reshape(n, n_ev, self.rows_per_event, 2).sum(dim=2)
        num = sum_w / self.n_samples * (fr[:, None] * r[..., 0] + r[..., 1])
        return torch.where(gate, torch.nan_to_num(num), 0.0)

    def _finish(self, pop_b: Population, log_evs_sum: torch.Tensor,
                n_exp: torch.Tensor) -> torch.Tensor:
        """Combine summed log numerators with N_exp."""
        if not pop_b.scale_free:
            log_evs_sum = log_evs_sum + self.n_events * torch.log(
                pop_b.R0 * pop_b.Tobs)
            return log_evs_sum - n_exp
        return log_evs_sum - self.n_events * torch.log(n_exp)

    def log_like_batch(self, hyper_batch: dict) -> torch.Tensor:
        """Log hyper-likelihood for a batch of λ (dict of equal-length 1-D
        arrays) — (L,).  Tensors that require grad stay in the graph."""
        pop_b = self.population.update_batch(hyper_batch)
        log_evs = torch.nan_to_num(torch.log(self.batch_numerators(pop_b)),
                                   nan=-torch.inf)
        return self._finish(pop_b, torch.sum(log_evs, dim=-1),
                            self.selection.n_exp(pop_b))

    def log_like(self, **hyper) -> torch.Tensor:
        """One hyper-parameter sample (a batch of 1)."""
        return self.log_like_batch({k: [v] for k, v in hyper.items()})[0]

    def compute_all(self, **hyper):
        """Debug decomposition at one λ: per-event log numerators, the log
        numerator, log N_exp and the log hyper-likelihood."""
        pop = self.population.update(**hyper)
        log_evs = torch.nan_to_num(torch.log(self.batch_numerators(pop)),
                                   nan=-torch.inf)[0]
        n_exp = self.selection.n_exp(pop)
        log_num = torch.sum(log_evs)
        log_hyper = self._finish(pop, log_num[None], n_exp)[0]
        if not pop.scale_free:
            log_num = log_num + self.n_events * torch.log(pop.R0 * pop.Tobs)[0]
        return log_evs, log_num, torch.log(n_exp)[0], log_hyper
