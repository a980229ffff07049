"""Diagnostic plots of the dark-siren inputs: an event's pixelization on the
sky, and the per-pixel p_gw3d(z), galaxy prior p_gal(z) and catalog prior
p_cat(z) curves (counterpart of ``chimera_tpu/utils/plotting.py``), from
the port's objects (``ThetaPEDet``, ``PixelatedCatalog``,
``HyperLikelihood``), with the port's HEALPix ``boundaries``.  matplotlib
is imported at the first plot: the package never needs it otherwise."""

from __future__ import annotations

import numpy as np
import torch

from chimera_tpu_torch.data.structs import ThetaPEDet
from chimera_tpu_torch.models.population import theta_src_and_weights
from chimera_tpu_torch.ops import healpix as hpx


def _mpl():
    import matplotlib as mpl
    import matplotlib.pyplot as plt

    return mpl, plt


def _colors(cmap):
    mpl, _ = _mpl()
    return mpl.colormaps["tab20"].colors if cmap is None else cmap


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _axes(ax, figsize):
    _, plt = _mpl()
    if ax is None:
        return plt.subplots(figsize=figsize)
    return None, ax


def plot_pixelization(theta_gw, ev: int, cmap=None, ax=None, figsize=(6, 4),
                      label=True, plot_grid=False, boundary_step=10):
    """One event's PE samples on the sky coloured by their pixel, with the
    pixel centres and the HEALPix pixel boundaries.  Returns the new figure
    (None when drawn into ``ax``)."""
    colors = _colors(cmap)
    fig, ax = _axes(ax, figsize)
    mask = _np(theta_gw.pixel_mask[ev])
    pix = _np(theta_gw.pixels_opt_nsides[ev])[mask].astype(np.int64)
    ra_pix = _np(theta_gw.ra_pix[ev])[mask]
    dec_pix = _np(theta_gw.dec_pix[ev])[mask]
    nside = int(theta_gw.opt_nsides[ev])
    ra, dec = _np(theta_gw.ra[ev]), _np(theta_gw.dec[ev])
    pe_pix = _np(theta_gw.pixels_pe_opt_nside[ev])
    b_theta, b_phi = (_np(b) for b in hpx.boundaries(
        nside, torch.as_tensor(pix), step=boundary_step))
    for i, jpix in enumerate(pix):
        c = colors[i % len(colors)]
        sel = pe_pix == jpix
        ax.scatter(ra[sel], dec[sel], color=c, alpha=0.25, s=50, marker="x")
        ax.scatter(ra_pix[i], dec_pix[i], s=100, marker="o", color=c,
                   edgecolor="black", linewidth=1.0)
        bt = np.append(b_theta[i], b_theta[i][0])
        bp = np.append(b_phi[i], b_phi[i][0])
        ax.plot(bp, np.pi / 2 - bt, lw=0.85, zorder=0, color=c)
    if plot_grid:
        ax.grid(True, alpha=0.5)
    if label:
        ax.set_xlabel("RA [rad]", fontsize=14)
        ax.set_ylabel("Dec [rad]", fontsize=14)
    return fig


def _per_pixel_curves(ax, z_grid, curves, mask, cmap, label, ylabel):
    colors = _colors(cmap)
    for i in np.flatnonzero(mask):
        ax.plot(z_grid, curves[i], color=colors[i % len(colors)], lw=1.0)
    if label:
        ax.set_xlabel("z", fontsize=14)
        ax.set_ylabel(ylabel, fontsize=14)


def _pixel_mask(hl) -> torch.Tensor:
    if hl.kind == "full":
        return hl.pixel_mask
    mask = getattr(hl.population.gal_cat, "pixel_mask", None)
    return hl.loc != 0 if mask is None else mask


def _pixel_samples(hl, pop_b, z, w):
    """Each pixel's source-frame samples and weights as (L, E, P, S): the
    pixel's samples, then the event's min z at weight 0 (the JAX package's
    masked-dense layout), from the staged path's sample-to-pixel mask or
    from the fused path's per-pixel rectangle (whose fillers are at the
    event's min dL, so its min z)."""
    if hasattr(hl, "in_pix"):
        z_fill = torch.amin(z, dim=-1)[..., None, None]
        return (torch.where(hl.in_pix, z[:, :, None, :], z_fill),
                torch.where(hl.in_pix, w[:, :, None, :], 0.0))
    n_ev, n_pix, s = hl.n_events, hl.n_pixels, hl.n_samples
    rect = ThetaPEDet(m1det=hl.pix_m1det, m2det=hl.pix_m2det, dL=hl.pix_dL,
                      pe_prior=1.0 / hl.pix_inv_pe_prior)
    th, w_r = theta_src_and_weights(pop_b, rect)                # (L, E*P, S_pp)
    z_r, w_r = th.z[..., :s], w_r[..., :s]
    if z_r.shape[-1] < s:                                       # fillers to S
        pad = s - z_r.shape[-1]
        z_r = torch.cat([z_r, z_r[..., -1:].expand(*z_r.shape[:-1], pad)], -1)
        w_r = torch.cat([w_r, torch.zeros_like(w_r[..., :pad])], -1)
    real = torch.arange(s, device=z.device) < hl.pix_n_real[:, None]
    z_fill = torch.amin(z, dim=-1).repeat_interleave(n_pix, dim=-1)[..., None]
    z_m = torch.where(real, z_r, z_fill)
    w_m = torch.where(real, w_r, 0.0)
    return (z_m.reshape(-1, n_ev, n_pix, s), w_m.reshape(-1, n_ev, n_pix, s))


@torch.no_grad()
def p_gw_3d(hl, pop_b) -> torch.Tensor:
    """Per-pixel p_gw of a pixelated likelihood, (L, E, P, Nz) on the
    analysis grids (``chimera_tpu/likelihood.py::p_gw_3d_*``): 'approximate'
    the event's KDE times each pixel's localization pdf, 'marginalized' a
    KDE of each pixel's samples times its pdf, 'full' the 3-D KDE; times
    the KDE norm, gated by the event's N_eff."""
    if hl.kind == "full":
        return hl.p_gw_full(pop_b)
    if hl.kind not in ("approximate", "marginalized"):
        raise ValueError(f"kind {hl.kind!r} has no pixels")
    theta = ThetaPEDet(m1det=hl.m1det, m2det=hl.m2det, dL=hl.dL,
                       pe_prior=hl.pe_prior)
    th_src, w = theta_src_and_weights(pop_b, theta)             # (L, E, S)
    z = th_src.z
    norms = torch.mean(w, dim=-1)
    gate = torch.sum(w, -1) ** 2 / torch.sum(w * w, -1) >= hl.pe_neff
    eff = hl._effective_grids(z)
    if hl.kind == "approximate":
        dens = hl._kde_to_grid(z, w, eff)[:, :, None, :]
    else:
        dens = hl._kde_to_grid(*_pixel_samples(hl, pop_b, z, w),
                               eff[:, :, None, :])
    p = dens * norms[..., None, None] * hl.loc[None, :, :, None]
    return torch.where(gate[..., None, None], torch.nan_to_num(p), 0.0)


def plot_p_gw3d_pixelated(hl, ev: int, cmap=None, ax=None, label=True,
                          figsize=(6, 4), **hyper_params):
    """One event's per-pixel p_gw3d(z) curves at the given
    hyper-parameters."""
    fig, ax = _axes(ax, figsize)
    pop = hl.population.update(**hyper_params)
    _per_pixel_curves(ax, _np(hl.z_grids[ev]), _np(p_gw_3d(hl, pop)[0, ev]),
                      _np(_pixel_mask(hl)[ev]), cmap, label,
                      r"$p_{\rm gw}(z,\hat\Omega)$")
    return fig


def plot_p_gal_pixelated(hl, ev: int, cmap=None, ax=None, label=True,
                         figsize=(6, 4), **hyper_params):
    """One event's per-pixel galaxy prior p_gal(z) at the given
    hyper-parameters (the likelihood's population otherwise)."""
    fig, ax = _axes(ax, figsize)
    pop = hl.population.update(**hyper_params) if hyper_params else hl.population
    with torch.no_grad():
        p_gal = pop.gal_cat.p_gal(pop.cosmo, hl.z_grids[None])[0, ev]
    _per_pixel_curves(ax, _np(hl.z_grids[ev]), _np(p_gal),
                      _np(pop.gal_cat.pixel_mask[ev]), cmap, label,
                      r"$p_{\rm gal}(z,\hat\Omega)$")
    return fig


def plot_p_cat_pixelated(gal_cat, z_grids, ev: int, cmap=None, ax=None,
                         label=True, figsize=(6, 4)):
    """One event's per-pixel precomputed catalog term p_cat(z)."""
    fig, ax = _axes(ax, figsize)
    _per_pixel_curves(ax, _np(z_grids[ev]), _np(gal_cat.p_cat[ev]),
                      _np(gal_cat.pixel_mask[ev]), cmap, label,
                      r"$p_{\rm cat}(z,\hat\Omega)$")
    return fig
