"""The hyper-likelihood of the port (counterpart of
``chimera_tpu/likelihood.py``) for the kinds '1d' (spectral siren),
'approximate', 'marginalized' and 'full' (dark siren with a pixelated
galaxy catalog, or an empty one), with or without binning and effective
grids — the reference's defaults (``binning=True, num_bins=200,
cut_grid=2.0``) included.  The engine follows the JAX package on the TPU
(``chimera_tpu/likelihood.py:451-499``):

* ``binning=True``, the stage-by-stage path (``likelihood.py:502-577``):
  source-frame samples and weights in PyTorch, the samples of each event
  (each (event, pixel) for 'marginalized', samples outside the pixel
  masked to the event's min z with weight 0) binned to ``num_bins`` centres,
  the KDE parameters, then one launch of the batched KDE (K4,
  ``ops/cuda/kde.py``) on the effective grids (``Nz // 2`` points over
  [z_min - c σ, z_max + c σ] per event) or on the analysis grids, and with
  ``cut_grid`` a resampling onto the analysis grids (``uniform_interp``).
* ``binning=False``, the fused kernels (``ops/cuda/fused.py``):
  - '1d' and 'approximate': the fused weights+KDE pass per event, on the
    analysis grids (K1a, ``cut_grid=None``) or on its own effective grid
    (K1b), then for 'approximate' the 2-D localization pdf per pixel;
  - 'marginalized': the stats-only pass (K1c) on the per-pixel rectangle,
    then the rows-contract kernel (K2) over dense 128-sample chunk rows
    (``cut_grid=None``); or, on a layout without chunk rows (a JAX object
    whose ``compact`` has no 'rows', ``chunk_rows=False``), one contract
    pass (K1e) on the per-pixel rectangle, the KDE contracted in the
    kernel; or, with ``cut_grid``, K1c on the events for the event-level
    effective-grid bounds, then the per-pixel KDE on them (K1d) and the
    resampling.  The layouts and the λ-independent contraction factors are
    built once, in ``create``.
* 'full' (``chimera_tpu/likelihood.py::p_gw_3d_full``, whatever
  ``binning``): source-frame samples and weights in PyTorch, then one
  launch of the 3-D Gaussian KDE of (z, ra, dec) on each event's (pixel x
  z-grid) lattice (K5, ``ops/cuda/kde3d.py``), by the uniform-z
  block-refresh recurrence with the block length that ``create`` plans per
  event (``z_recurrence_plan``) or by the dense z sweep.

Each kernel runs as its CUDA kernel on CUDA tensors and as its plain
PyTorch version on CPU tensors.  ``log_like_batch`` is differentiable in
the hyper-parameters: pass tensors that require grad.  On CPU tensors the
whole backward is autograd through the plain versions; on CUDA tensors the
backward of each kernel launch is its adjoint kernel — K3 in the mode of
K1a, K1b, K1c or K1d, K2b for K2, K4b for K4 — so every path
differentiates on the card, the binned one included, but the contract
pass and kind 'full', which raise (K1e and K5 have no adjoint kernel;
ROADMAP.md §1 items 15 and 16).
The selects around the kernels' outputs (``row_scales``, the N_eff gates,
``nan_to_num`` before any product) keep the raw NaN of a dead row out of
every backward product.  ``HyperLikelihood`` is an ``nn.Module`` whose
buffers hold the PE data, layouts, z-grids and (in its ``selection``) the
injections; ``.to(device, dtype)`` moves them and the population's tensors
together.
"""

from __future__ import annotations

import torch
from torch import nn

import numpy as np

from chimera_tpu_torch.catalog import EmptyCatalog
from chimera_tpu_torch.config import logger
from chimera_tpu_torch.data.pixelize import (chunk_rows_from_compact,
                                             compact_samples_by_pixel)
from chimera_tpu_torch.data.structs import ThetaPEDet
from chimera_tpu_torch.models import cosmology as cosmo_fns
from chimera_tpu_torch.models.population import (Population, p_cbc,
                                                 theta_det_to_src,
                                                 theta_src_and_weights)
from chimera_tpu_torch.ops.binning import binning1d
from chimera_tpu_torch.ops.cuda.fused import fused_row_stats, fused_weights_kde
from chimera_tpu_torch.ops.cuda.kde import kde1d_grid
from chimera_tpu_torch.ops.cuda.kde3d import lattice_kde3d
from chimera_tpu_torch.ops.cuda.rows import fused_rows_contract
from chimera_tpu_torch.ops.integrate import linspace, trapz, trapz_weights
from chimera_tpu_torch.ops.interp import uniform_interp
from chimera_tpu_torch.ops.kde import bw_factor, kde1d_params
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
KINDS = ("1d", "approximate", "marginalized", "full")
# the block lengths of the 'full' kind's uniform-z recurrence, longest first
Z_BLOCK_TIERS = (32, 16, 8)


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


def z_recurrence_plan(z: np.ndarray, ra: np.ndarray, dec: np.ndarray,
                      z_grids: np.ndarray, bw_method) -> tuple[np.ndarray, str]:
    """Each event's block length K of the 'full' kind's uniform-z
    recurrence (``chimera_tpu/likelihood.py::_z_recurrence_plan``), from
    float64 copies of the samples' z at the fiducial cosmology, their sky
    positions (E, S) and the z-grids (E, G).

    A flushed block loses at most ``tiny * exp((K h)^2 / 2)`` per (pixel,
    sample) pair, h the event's whitened grid step, so K h <= 5.5 at the
    fiducial hyper-parameters (a 2x allowance for the bandwidth's shrinking
    across the prior).  h = sqrt(inv(cov)_00) / factor x the grid step at
    unit weights (n_eff = S, the largest factor's denominator: the largest
    h).  K = min(floor(5.5 / h), 32), rounded down to a tier of
    ``Z_BLOCK_TIERS``, 0 (the dense sweep) below 8; every event dense
    where z is not finite or the covariance is singular.  The JAX
    package's demotion of each tier to a multiple of 8 events and its
    batch-global K serve its ``lax.map`` blocks on the TPU and have no
    counterpart.  Returns (K (E,) int64, a line saying the outcome)."""
    n_ev, n_s = z.shape
    dense = np.zeros(n_ev, dtype=np.int64)
    if not np.all(np.isfinite(z)):
        return dense, "dense: z not finite"
    factor = float(bw_factor(torch.tensor(float(n_s), dtype=torch.float64), 3,
                             bw_method))
    data = np.stack([z, ra, dec], axis=1)                  # (E, 3, S)
    data = data - data.mean(axis=-1, keepdims=True)
    cov = np.einsum("eis,ejs->eij", data, data) / max(n_s - 1, 1)
    try:
        inv00 = np.linalg.inv(cov)[:, 0, 0]
    except np.linalg.LinAlgError:
        return dense, "dense: singular sample covariance"
    if np.any(inv00 <= 0) or not np.all(np.isfinite(inv00)):
        return dense, "dense: covariance not positive definite"
    step = (z_grids[:, -1] - z_grids[:, 0]) / max(z_grids.shape[1] - 1, 1)
    h = np.sqrt(inv00) / factor * step
    if not np.all(np.isfinite(h)) or np.any(h <= 0):
        return dense, "dense: grid step not finite and positive"
    safe = np.minimum((5.5 / h).astype(np.int64), Z_BLOCK_TIERS[0])
    k = dense.copy()
    for tier in Z_BLOCK_TIERS:
        k[(safe >= tier) & (k == 0)] = tier
    return k, ", ".join(f"K={t}: {int(np.sum(k == t))}"
                        for t in (*Z_BLOCK_TIERS, 0)) + " events"


def _jacobian(pop: Population, z: torch.Tensor) -> torch.Tensor:
    """|d(dGW)/dz| (1+z)^2 — detector->source measure; ``z`` has a leading
    λ axis."""
    return cosmo_fns.ddl_dz_at_z(pop.cosmo, z) * (1.0 + z) ** 2


class HyperLikelihood(nn.Module):
    """Spectral-siren ('1d') or dark-siren ('approximate', 'marginalized',
    'full') hyper-likelihood over a λ batch.

    Build it with :meth:`create` (mirrors ``chimera_tpu``'s constructor
    surface) or :meth:`from_state` (from a built JAX object).
    ``chunk_rows`` says whether the unbinned 'marginalized' layout without
    effective grids has the 128-sample chunk rows (K1c + K2, what ``create``
    builds in both packages) or not (the contract pass K1e, as a JAX object
    whose ``compact`` has no 'rows')."""

    def __init__(self, theta_gw: ThetaPEDet, z_grids: torch.Tensor,
                 population: Population, selection: SelectionFunction,
                 kind: str, kernel: str, bw_method, pe_neff: float,
                 cut_grid: float | None, binning: bool, num_bins: int,
                 chunk_rows: bool = True, z_block=None):
        super().__init__()
        self.kind = kind
        self.population = population
        self.selection = selection
        self.kernel = kernel
        self.bw_method = bw_method
        self.pe_neff = float(pe_neff)
        self.cut_grid = None if cut_grid is None else float(cut_grid)
        self.binning = bool(binning)
        self.num_bins = int(num_bins)
        self.chunk_rows = bool(chunk_rows)
        self.register_buffer("z_grids", z_grids.to(theta_gw.dL.dtype))
        self.n_samples = theta_gw.dL.shape[1]
        for name in _PE_FIELDS:
            self.register_buffer(name, getattr(theta_gw, name))
        self.register_buffer("inv_pe_prior", 1.0 / theta_gw.pe_prior)
        if kind == "1d":
            return
        self.n_pixels = theta_gw.pixel_mask.shape[1]
        if kind == "full":
            self._build_full(theta_gw, z_block)
            return
        loc = torch.where(theta_gw.pixel_mask, theta_gw.gw_loc2d_pdf, 0.0)
        self.register_buffer("loc", loc.to(self.z_grids.dtype))  # (E, P)
        if kind != "marginalized":
            return
        if binning:
            # each sample's pixel: the masked-dense layout (E, P, S)
            self.register_buffer("in_pix", theta_gw.pixels_pe_opt_nside[:, None, :]
                                 == theta_gw.pixels_opt_nsides[:, :, None])
        else:
            self._build_marginalized(theta_gw, z_grids)

    def _build_full(self, theta_gw: ThetaPEDet, z_block) -> None:
        """The buffers of kind 'full': the samples' sky positions ``ra``,
        ``dec`` (E, S), in the dL order of the other per-sample fields; the
        pixel mask and the pixel centres ``full_ra_pix``, ``full_dec_pix``
        (E, P), 0 at the fake pixels (finite arithmetic there, as in the
        JAX package); each event's recurrence block length ``z_block`` (E,),
        the JAX object's where given, else ``z_recurrence_plan`` at the
        fiducial cosmology."""
        dt, mask = self.z_grids.dtype, theta_gw.pixel_mask
        self.register_buffer("ra", theta_gw.ra.to(dt))
        self.register_buffer("dec", theta_gw.dec.to(dt))
        self.register_buffer("pixel_mask", mask)
        self.register_buffer("full_ra_pix", torch.where(mask, theta_gw.ra_pix, 0.0).to(dt))
        self.register_buffer("full_dec_pix", torch.where(mask, theta_gw.dec_pix, 0.0).to(dt))
        if z_block is None:
            z = theta_det_to_src(self.population.cosmo, theta_gw).z[0]
            host = lambda t: t.detach().to("cpu", torch.float64).numpy()  # noqa: E731
            z_block, outcome = z_recurrence_plan(
                host(z), host(theta_gw.ra), host(theta_gw.dec),
                host(self.z_grids), self.bw_method)
            logger.info("kind='full', uniform-z recurrence plan: %s", outcome)
        self.register_buffer("z_block", torch.as_tensor(
            z_block, dtype=torch.int32).to(self.z_grids.device))

    def _build_marginalized(self, theta_gw: ThetaPEDet, z_grids: torch.Tensor
                            ) -> None:
        """The per-pixel layouts of the fused dark-siren path, built once as
        buffers:

        * ``pix_*`` (E*P, S_pp), ``pix_n_real``, ``pix_dl_fill``: the
          per-pixel rectangle of the stats pass (and, with ``cut_grid``, of
          the KDE on the event's effective grid);
        * with ``cut_grid=None`` only, the contraction factors s1 = p_cat *
          loc * tw and s2 = (1 - P_compl) * loc * tw (loc the masked
          localization pdf, tw the trapezoid weights;
          ``chimera_tpu/likelihood.py:987-1002``), computed in float64 from
          the z-grids as given (float32 trapezoid weights, differences of
          nearby grid points, cost the float32 likelihood several 1e-6 of
          relative accuracy): per (event, pixel) row, ``pix_s1``,
          ``pix_s2`` (E*P, G), for the contract pass (``chunk_rows=False``);
          or the chunk rows of the KDE pass: ``row_*`` (R, 128), R = E*C;
          ``row_pixel`` (R,) the (event, pixel) row of each chunk row;
          ``row_s1``, ``row_s2`` (R, G), the factors gathered per chunk row
          (``likelihood.py:1069``).
        """
        compact = compact_samples_by_pixel(theta_gw)
        n_ev, n_pix, _ = compact["dL"].shape
        for name in _LAYOUT_FIELDS:
            self.register_buffer("pix_" + name, compact[name].reshape(n_ev * n_pix, -1))
        self.register_buffer("pix_n_real", compact["n_real"].reshape(-1))
        self.register_buffer("pix_dl_fill",
                             compact["dl_fill"].repeat_interleave(n_pix))
        if self.cut_grid is not None:
            return
        loc = torch.where(theta_gw.pixel_mask, theta_gw.gw_loc2d_pdf, 0.0)
        gc = self.population.gal_cat
        f64, dt = torch.float64, self.z_grids.dtype
        base = (loc.to(f64)[:, :, None]
                * trapz_weights(z_grids.to(f64))[:, None, :])      # (E, P, G)
        g = z_grids.shape[1]
        if isinstance(gc, EmptyCatalog):
            # no catalog term: p_gal = p_bkg (lambda_factors)
            s1, s2 = torch.zeros_like(base), base
        else:
            s1 = gc.p_cat.to(f64) * base
            s2 = (1.0 - gc.P_compl.to(f64)) * base
        s1, s2 = (t.reshape(-1, g) for t in (s1, s2))
        if not self.chunk_rows:
            self.register_buffer("pix_s1", s1.to(dt))
            self.register_buffer("pix_s2", s2.to(dt))
            return
        rows = chunk_rows_from_compact(compact)
        for name in _LAYOUT_FIELDS:
            self.register_buffer("row_" + name, rows[name].reshape(-1, rows[name].shape[-1]))
        row_pixel = (torch.arange(n_ev, device=rows["row_pix"].device)[:, None]
                     * n_pix + rows["row_pix"]).reshape(-1)
        self.register_buffer("row_pixel", row_pixel)
        self.rows_per_event = rows["dL"].shape[1]
        self.register_buffer("row_s1", s1[row_pixel].to(dt))
        self.register_buffer("row_s2", s2[row_pixel].to(dt))

    @classmethod
    def create(cls, theta_gw: ThetaPEDet, z_grids, population: Population,
               selection: SelectionFunction, kind=None, kernel="epan",
               bw_method=None, cut_grid=2.0, binning=True, num_bins=200,
               pe_neff=2.0) -> "HyperLikelihood":
        """PE data, z-grids and injections are moved to the population's
        device and dtype; samples are sorted by distance.  Pixelated data
        takes ``kind`` in ('1d', 'approximate', 'marginalized', 'full');
        other data is spectral ('1d').  'full' takes the Gaussian kernel
        whatever ``kernel`` says, ignores ``binning`` and ``num_bins``, and
        needs the samples' ra and dec."""
        return cls._create(theta_gw, z_grids, population, selection, kind,
                           kernel, bw_method, cut_grid, binning, num_bins,
                           pe_neff)

    @classmethod
    def _create(cls, theta_gw: ThetaPEDet, z_grids, population: Population,
                selection: SelectionFunction, kind, kernel, bw_method,
                cut_grid, binning, num_bins, pe_neff, chunk_rows=True,
                z_block=None) -> "HyperLikelihood":
        """``create`` with the layout's ``chunk_rows`` and, for 'full', the
        events' recurrence block lengths ``z_block`` as well (what
        ``from_state`` reads off the JAX object)."""
        theta_gw = theta_gw.with_derived()
        if theta_gw.pixelated:
            if kind not in KINDS:
                raise ValueError("pixelated data requires kind in "
                                 "('1d', 'approximate', 'marginalized', 'full')")
        elif kind not in (None, "1d"):
            raise ValueError(f"kind={kind!r} needs pixelated PE data "
                             "(data.pixelize.pixelize_gw_catalog)")
        else:
            kind = "1d"
        if selection is None:
            raise ValueError("a SelectionFunction is required")
        fields = _PE_FIELDS
        if kind == "full":
            # only Gaussian kernels in 3-D (chimera_tpu/likelihood.py:250-251)
            kernel = "gauss"
            if theta_gw.ra is None or theta_gw.dec is None:
                raise ValueError("kind='full' needs the samples' ra and dec")
            fields = fields + ("ra", "dec")
        ref = population.cosmo.H0
        updates = {f: torch.as_tensor(getattr(theta_gw, f), dtype=ref.dtype,
                                      device=ref.device) for f in fields}
        if kind != "1d":
            updates.update({
                f: torch.as_tensor(getattr(theta_gw, f), device=ref.device)
                for f in _PIXEL_FIELDS if getattr(theta_gw, f) is not None})
        theta_gw = theta_gw.update(**updates)
        z_grids = torch.as_tensor(z_grids, device=ref.device)
        _validate_shapes(theta_gw, z_grids, population, kind)
        hl = cls(_sort_samples_by_distance(theta_gw), z_grids, population,
                 selection, kind, kernel, bw_method, pe_neff, cut_grid,
                 binning, num_bins, chunk_rows, z_block)
        hl.selection.to(device=ref.device, dtype=ref.dtype)
        return hl

    @classmethod
    def from_state(cls, state: dict, device=None, dtype=None) -> "HyperLikelihood":
        """Rebuild from ``convert.state_from_reference(jax_hyperlikelihood)``:
        the same PE data (and pixelation), z-grids, injections, population
        (its built tables and catalog included) and configuration.  The
        JAX object's ``kde_engine`` and ``grad_engine`` have no counterpart
        here (the kernels and the backward follow the tensors' device) and
        are not read; whether its ``compact`` has chunk rows
        (``compact_rows``) selects the rows or the contract pass; kind
        'full' takes the samples' ra and dec and the JAX object's
        recurrence plan as each event's block length (``z_block``)."""
        pop = Population.from_state(state, "population.", device, dtype)
        ref = pop.cosmo.H0

        def arr(key, dt=ref.dtype):
            t = torch.as_tensor(state[key], device=ref.device)
            return t.round().to(dt) if t.is_floating_point() and dt == torch.int64 \
                else t.to(dt)

        theta = ThetaPEDet(**{f: arr(f"theta_gw.{f}") for f in _PE_FIELDS})
        pixels = {f: arr(f"theta_gw.{f}", dt or torch.float64)
                  for f, dt in _PIXEL_FIELDS.items() if f"theta_gw.{f}" in state}
        theta = theta.update(**pixels, **{
            f: arr(f"theta_gw.{f}") for f in ("ra", "dec")
            if f"theta_gw.{f}" in state})
        sel = SelectionFunction.from_state(state, "selection.", ref.device,
                                           ref.dtype)
        bw = state.get("bw_method")
        cut = state.get("cut_grid")
        return cls._create(theta, arr("z_grids", torch.float64), pop, sel,
                           kind=str(state["kind"]), kernel=str(state["kernel"]),
                           bw_method=None if bw is None else bw.item(),
                           cut_grid=None if cut is None else float(cut),
                           binning=bool(state["binning"]),
                           num_bins=int(state["num_bins"]),
                           pe_neff=float(state["pe_neff"]),
                           chunk_rows=bool(state.get("compact_rows", True)),
                           z_block=state.get("z_block"))

    def _apply(self, fn, *args, **kwargs):
        # .to()/.cuda()/.double() also move the population's tensors
        super()._apply(fn, *args, **kwargs)
        self.population = tensor_map(self.population, fn)
        return self

    # -- evaluation ---------------------------------------------------------

    @property
    def n_events(self) -> int:
        return self.z_grids.shape[0]

    @property
    def n_grid(self) -> int:
        """Points of an effective grid: half the analysis grid's."""
        return self.z_grids.shape[1] // 2

    def batch_numerators(self, pop_b: Population) -> torch.Tensor:
        """Per-event numerator integrals for a λ batch — (L, Nev)."""
        if self.kind == "full":
            return self._numerators_full(pop_b)
        if self.binning:
            return self._numerators_binned(pop_b)
        if self.kind == "marginalized":
            if self.cut_grid is not None:
                return self._numerators_marginalized_cut(pop_b)
            if self.chunk_rows:
                return self._numerators_marginalized(pop_b)
            return self._numerators_marginalized_contract(pop_b)
        return self._numerators_eventwise(pop_b)

    def _numerators_eventwise(self, pop_b: Population) -> torch.Tensor:
        """'1d' and 'approximate', unbinned: the fused weights+KDE pass on
        the analysis grids (K1a) or on effective grids (K1b), then
        ``numerators_from_densities``."""
        pe = (self.m1det, self.m2det, self.dL, self.inv_pe_prior,
              pop_b.cosmo, pop_b.mass)
        if self.cut_grid is None:
            den, stats = fused_weights_kde(*pe, self.z_grids, kernel=self.kernel,
                                           bw_method=self.bw_method)
        else:
            den, stats = fused_weights_kde(
                *pe, kernel=self.kernel, bw_method=self.bw_method,
                cut_grid=self.cut_grid, n_grid=self.n_grid)
        return self.numerators_from_densities(pop_b, den, stats)

    def numerators_from_densities(self, pop_b: Population, den: torch.Tensor,
                                  stats: dict) -> torch.Tensor:
        """Numerators (L, Nev) from the fused pass's outputs: the densities
        (resampled from the effective grids onto the analysis grids with
        ``cut_grid``), gated by N_eff, then the kind's z-integral
        (``chimera_tpu/likelihood.py:796-839``)."""
        gate = stats["neff"] >= self.pe_neff
        den = torch.nan_to_num(den)
        if self.cut_grid is not None:
            den = uniform_interp(self.z_grids[None], stats["lo"], stats["ub"], den)
        p_gw = torch.where(gate[..., None], torch.nan_to_num(den), 0.0)
        return self._integrate_events(pop_b, p_gw)

    def _integrate_events(self, pop_b: Population, p_gw: torch.Tensor
                          ) -> torch.Tensor:
        """p_gw (L, E, Nz) -> numerators (L, E): times p_cbc over the
        detector jacobian for '1d'; for 'approximate' times the masked
        localization pdf of each pixel first (``likelihood.py:541-546``)."""
        if self.kind != "1d":
            return self._integrate_pixels(
                pop_b, p_gw[:, :, None, :] * self.loc[None, :, :, None])
        zg = self.z_grids[None]
        integrand = p_gw * p_cbc(pop_b, zg) / _jacobian(pop_b, zg)
        return trapz(integrand, zg, dim=-1)

    def _integrate_pixels(self, pop_b: Population, p3: torch.Tensor
                          ) -> torch.Tensor:
        """p_gw (L, E, P, Nz) -> numerators (L, E): times p_cbc (an empty
        catalog's lifted over the pixel axis) over the jacobian, integrated
        over z and summed over pixels (``likelihood.py:691-706``)."""
        zg = self.z_grids[None]
        p_z = p_cbc(pop_b, zg)
        if p_z.dim() == 3:
            p_z = p_z[:, :, None, :]
        integrand = p3 * p_z / _jacobian(pop_b, zg)[:, :, None, :]
        return torch.sum(trapz(integrand, zg[:, :, None, :], dim=-1), dim=-1)

    # -- the stage-by-stage (binned) path ------------------------------------

    def _effective_grids(self, z: torch.Tensor) -> torch.Tensor:
        """KDE grids per (λ, event): ``n_grid`` points over [min - c σ,
        max + c σ] of the event's source-frame z (lo floored at 1e-8), or
        the analysis grids without ``cut_grid`` (``likelihood.py:433-444``)."""
        if self.cut_grid is None:
            return self.z_grids[None]
        c = self.cut_grid
        lo, hi = torch.amin(z, dim=-1), torch.amax(z, dim=-1)
        sig = torch.std(z, dim=-1, correction=0)
        lb = torch.where(lo - c * sig > 0.0, lo - c * sig, 1e-8)
        return linspace(lb, hi + c * sig, self.n_grid)

    def _kde_to_grid(self, zs: torch.Tensor, ws: torch.Tensor,
                     eff_grids: torch.Tensor) -> torch.Tensor:
        """(..., S) samples and weights -> (..., Nz) densities on the
        analysis grids: binning, the KDE parameters, one K4 launch over all
        rows on ``eff_grids`` (broadcast to (..., G)), and with ``cut_grid``
        the resampling (``likelihood.py:502-527``)."""
        zs, ws = binning1d(zs, ws, self.num_bins)
        wn, h = kde1d_params(zs, ws, self.bw_method)
        lead, s = zs.shape[:-1], zs.shape[-1]
        eff_grids = eff_grids.expand(*lead, eff_grids.shape[-1])
        dens = kde1d_grid(zs.reshape(-1, s), wn.reshape(-1, s),
                          eff_grids.reshape(-1, eff_grids.shape[-1]),
                          h.reshape(-1), kernel=self.kernel).reshape(eff_grids.shape)
        if self.cut_grid is None:
            return dens
        zg = self.z_grids if len(lead) == 2 else self.z_grids[:, None, :]
        return uniform_interp(zg.expand(*lead, -1), eff_grids[..., 0],
                              eff_grids[..., -1], dens)

    def _numerators_binned(self, pop_b: Population) -> torch.Tensor:
        """Every kind with ``binning=True`` (``likelihood.py:530-577``):
        per-event norms and N_eff gates from the unbinned weights, then the
        KDE per event ('1d', 'approximate') or per (event, pixel) of the
        masked-dense layout ('marginalized': samples outside the pixel at
        the event's min z with weight 0, so each pixel row's bins span
        [event min z, pixel max z])."""
        theta = ThetaPEDet(m1det=self.m1det, m2det=self.m2det, dL=self.dL,
                           pe_prior=self.pe_prior)
        th_src, w = theta_src_and_weights(pop_b, theta)             # (L, E, S)
        z = th_src.z
        norms = torch.mean(w, dim=-1)
        sum_w, sum_w2 = torch.sum(w, dim=-1), torch.sum(w * w, dim=-1)
        gate = sum_w * sum_w / sum_w2 >= self.pe_neff    # NaN compares False
        eff = self._effective_grids(z)
        if self.kind != "marginalized":
            dens = self._kde_to_grid(z, w, eff)
            p_gw = torch.where(gate[..., None],
                               torch.nan_to_num(dens * norms[..., None]), 0.0)
            return self._integrate_events(pop_b, p_gw)
        z_fill = torch.amin(z, dim=-1)[..., None, None]
        z_m = torch.where(self.in_pix, z[:, :, None, :], z_fill)     # (L, E, P, S)
        w_m = torch.where(self.in_pix, w[:, :, None, :], 0.0)
        dens = self._kde_to_grid(z_m, w_m, eff[:, :, None, :])
        p = dens * self.loc[None, :, :, None] * norms[..., None, None]
        p = torch.where(gate[..., None, None], torch.nan_to_num(p), 0.0)
        return self._integrate_pixels(pop_b, p)

    # -- the fused dark-siren paths ------------------------------------------

    def lambda_factors(self, pop_b: Population):
        """Per-λ contraction factors f1 = psi/(1+z)/jac and f2 = p_bkg * f1
        on the z-grids — (L, E, G) each — and the completeness fraction
        fR — (L,) (``chimera_tpu/likelihood.py:1005-1016``).  An empty
        catalog has p_gal = p_bkg = dV_c/dz and no catalog term (fR = 0)."""
        zg = self.z_grids[None]
        f1 = pop_b.rate.rate(zg) / (1.0 + zg) / _jacobian(pop_b, zg)
        gc = pop_b.gal_cat
        if isinstance(gc, EmptyCatalog):
            return f1, gc.p_bkg(pop_b.cosmo, zg) * f1, torch.zeros_like(f1[:, 0, 0])
        compl = gc.completeness
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

    def _pixel_stats(self, pop_b: Population) -> dict:
        """The stats pass (K1c) on the per-pixel rectangle's logical rows."""
        return fused_row_stats(
            self.pix_m1det, self.pix_m2det, self.pix_dL, self.pix_inv_pe_prior,
            pop_b.cosmo, pop_b.mass, n_real=self.pix_n_real,
            dl_fill=self.pix_dl_fill, logical_s=self.n_samples,
            cut_grid=2.0 if self.cut_grid is None else self.cut_grid,
            bw_method=self.bw_method)

    def _event_sums(self, stats: dict):
        """Per-event weight sums and N_eff gates from the pixel rows' sums
        (the pixels partition the event's samples): (L, E) each."""
        shape = (stats["sum_w"].shape[0], self.n_events, self.n_pixels)
        sum_w = stats["sum_w"].reshape(shape).sum(dim=-1)
        sum_w2 = stats["sum_w2"].reshape(shape).sum(dim=-1)
        return sum_w, sum_w * sum_w / sum_w2 >= self.pe_neff

    def _numerators_marginalized(self, pop_b: Population) -> torch.Tensor:
        """Two kernel passes: row statistics on the per-pixel rectangle
        (K1c), then KDE + contraction on the chunk rows (K2); per event

            num = norms * (fR * sum_rows r1 + sum_rows r2),

        gated by the event's N_eff."""
        stats = self._pixel_stats(pop_b)
        f1, f2, fr = self.lambda_factors(pop_b)
        r = fused_rows_contract(
            self.row_m1det, self.row_m2det, self.row_dL, self.row_inv_pe_prior,
            pop_b.cosmo, pop_b.mass, self.z_grids, self.row_scales(stats),
            self.row_s1, self.row_s2, f1, f2, kernel=self.kernel)
        return self._contracted_numerators(stats, r, fr, self.rows_per_event)

    def _numerators_marginalized_contract(self, pop_b: Population
                                          ) -> torch.Tensor:
        """One kernel pass (K1e, ``chimera_tpu/likelihood.py:933-984``): the
        row statistics and the unit-mass KDE of each logical pixel row on
        the analysis grids, contracted in the kernel against s1 f1 and
        s2 f2, then the mixture of ``_numerators_marginalized``."""
        f1, f2, fr = self.lambda_factors(pop_b)
        r, stats = fused_weights_kde(
            self.pix_m1det, self.pix_m2det, self.pix_dL, self.pix_inv_pe_prior,
            pop_b.cosmo, pop_b.mass,
            self.z_grids.repeat_interleave(self.n_pixels, dim=0),
            kernel=self.kernel, bw_method=self.bw_method,
            n_real=self.pix_n_real, dl_fill=self.pix_dl_fill,
            logical_s=self.n_samples, den_scale="unit",
            contract=(self.pix_s1, self.pix_s2, f1, f2))
        return self._contracted_numerators(stats, r, fr, self.n_pixels)

    def _contracted_numerators(self, stats: dict, r: torch.Tensor,
                               fr: torch.Tensor, rows_per_event: int
                               ) -> torch.Tensor:
        """num = norms * (fR * sum_rows r1 + sum_rows r2) per event, gated by
        its N_eff, from the pixel rows' stats and r (L, E * rows_per_event,
        2)."""
        sum_w, gate = self._event_sums(stats)
        r = r.reshape(r.shape[0], self.n_events, rows_per_event, 2).sum(dim=2)
        num = sum_w / self.n_samples * (fr[:, None] * r[..., 0] + r[..., 1])
        return torch.where(gate, torch.nan_to_num(num), 0.0)

    def _numerators_marginalized_cut(self, pop_b: Population) -> torch.Tensor:
        """'marginalized' with ``cut_grid``, two kernel passes
        (``chimera_tpu/likelihood.py:842-930``): the stats pass (K1c) on
        the events' full sample rows gives each event's effective-grid
        bounds; the per-pixel KDE (K1d) runs on the logical pixel rows with
        those bounds and unit mass; the densities are resampled onto the
        analysis grids, times the localization pdf, the event's norm and
        gate, then integrated."""
        ev = fused_row_stats(self.m1det, self.m2det, self.dL, self.inv_pe_prior,
                             pop_b.cosmo, pop_b.mass, cut_grid=self.cut_grid,
                             bw_method=self.bw_method)
        ext = torch.stack([ev["lo"].repeat_interleave(self.n_pixels, dim=1),
                           ev["ub"].repeat_interleave(self.n_pixels, dim=1)],
                          dim=-1)                                   # (L, B, 2)
        den, stats = fused_weights_kde(
            self.pix_m1det, self.pix_m2det, self.pix_dL, self.pix_inv_pe_prior,
            pop_b.cosmo, pop_b.mass, kernel=self.kernel,
            bw_method=self.bw_method, ext_bounds=ext, n_grid=self.n_grid,
            n_real=self.pix_n_real, dl_fill=self.pix_dl_fill,
            logical_s=self.n_samples, den_scale="unit")
        sum_w, gate = self._event_sums(stats)
        norms = sum_w / self.n_samples
        n, n_ev, n_pix = den.shape[0], self.n_events, self.n_pixels
        zg = self.z_grids.repeat_interleave(n_pix, dim=0)[None]
        den = uniform_interp(zg, stats["lo"], stats["ub"], torch.nan_to_num(den))
        p = den.reshape(n, n_ev, n_pix, -1) * self.loc[None, :, :, None]
        p = p * norms[..., None, None]
        p = torch.where(gate[..., None, None], torch.nan_to_num(p), 0.0)
        return self._integrate_pixels(pop_b, p)

    def _numerators_full(self, pop_b: Population) -> torch.Tensor:
        """Kind 'full' (``chimera_tpu/likelihood.py:580-675``): per-event
        norms and N_eff gates from the weights, one K5 launch for the 3-D
        KDE of every (λ, event) on its pixels x z-grid, times the norm, the
        ``cut_grid`` z-mask (the z-grid within [min - c σ, max + c σ] of
        the (λ, event)'s unweighted source-frame z, σ with ddof 0; none
        without ``cut_grid``) and the pixel mask, gated, then integrated
        over z and summed over pixels."""
        theta = ThetaPEDet(m1det=self.m1det, m2det=self.m2det, dL=self.dL,
                           pe_prior=self.pe_prior)
        th_src, w = theta_src_and_weights(pop_b, theta)             # (L, E, S)
        z = th_src.z
        norms = torch.mean(w, dim=-1)
        sum_w, sum_w2 = torch.sum(w, dim=-1), torch.sum(w * w, dim=-1)
        gate = sum_w * sum_w / sum_w2 >= self.pe_neff    # NaN compares False
        p = lattice_kde3d(z, w, self.ra, self.dec, self.full_ra_pix,
                          self.full_dec_pix, self.pixel_mask, self.z_grids,
                          self.z_block, bw_method=self.bw_method)   # (L, E, P, G)
        p = p * norms[..., None, None]
        if self.cut_grid is not None:
            c, zg = self.cut_grid, self.z_grids[None]
            sig = torch.std(z, dim=-1, correction=0, keepdim=True)
            z_mask = (zg <= torch.amax(z, dim=-1, keepdim=True) + c * sig) & (
                zg >= torch.amin(z, dim=-1, keepdim=True) - c * sig)
            p = p * z_mask[:, :, None, :]
        p = p * self.pixel_mask[None, :, :, None]
        p = torch.where(gate[..., None, None], torch.nan_to_num(p), 0.0)
        return self._integrate_pixels(pop_b, p)

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
