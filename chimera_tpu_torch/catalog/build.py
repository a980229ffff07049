"""Pixelated-catalog precompute: galaxies -> per-(event, pixel) redshift
priors p_cat(z) (counterpart of ``chimera_tpu/catalog/build.py``), and its
HDF5 round trip.

p_cat is built at the fiducial cosmology: per galaxy a Gaussian
N(z; z_gal, z_err (1 + z_gal)) times dV_C/dz (or the completeness' p_bkg)
on the event's z-grid, normalized by its trapezoid integral, then
weight-averaged over the galaxies of each (event, pixel) voxel.  The galaxy
-> voxel assignment is host numpy (a CSR gather) on pixels indexed from the
float64 angles; with ``engine='device'`` the Gaussian sums run on the
z-grids' device as chunked accumulating ``index_put_`` into the
(Nev * P, Nz) accumulator, with ``engine='host'`` as the numpy loop over
events and pixels that is the device engine's oracle.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from chimera_tpu_torch.catalog.pixelated import PixelatedCatalog
from chimera_tpu_torch.config import default_dtype, logger, resolve_device
from chimera_tpu_torch.data.structs import ThetaPEDet
from chimera_tpu_torch.models import cosmology as cosmo_fns
from chimera_tpu_torch.ops import healpix as hpx
from chimera_tpu_torch.ops.integrate import trapz

# elements of one (galaxies, Nz) Gaussian block
_CHUNK_ELEMS = 1 << 24
_CAT_FIELDS = ("p_cat", "P_compl", "pixel_mask", "n_gal")


def _sum_gaussians(z_grid: np.ndarray, mu: np.ndarray, sigma: np.ndarray,
                   weights: np.ndarray, bkg_grid: np.ndarray) -> np.ndarray:
    """Weighted mean of the galaxies' grid-normalized Gaussian x background
    rows on one z-grid (the host engine's voxel)."""
    if mu.size == 0:
        return np.zeros_like(z_grid)
    g = (np.power(2 * np.pi * sigma[None, :] ** 2, -0.5)
         * np.exp(-0.5 * ((z_grid[:, None] - mu[None, :]) / sigma[None, :]) ** 2))
    g = g * bkg_grid[:, None]
    norm = np.trapezoid(g, z_grid, axis=0)
    norm = np.where(norm > 0, norm, 1.0)
    return (g / norm) @ weights / weights.sum()


def _voxel_galaxy_csr(gal_pix: dict, opt_nsides: np.ndarray,
                      pix_sets: np.ndarray, pixel_mask: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray]:
    """For every real (event, pixel) slot, the galaxies whose pixel at the
    event's nside is that pixel, as flat ``(gal_idx, seg)`` with
    ``seg = e * P + j``: one argsort and two searchsorted per nside."""
    nev, max_npix = pix_sets.shape
    gal_parts, seg_parts = [], []
    for ns in np.unique(opt_nsides):
        ev_sel = np.nonzero(opt_nsides == ns)[0]
        gp = gal_pix[int(ns)]
        order = np.argsort(gp, kind="stable")
        sorted_pix = gp[order]
        pix = pix_sets[ev_sel]
        starts = np.searchsorted(sorted_pix, pix, side="left")
        ends = np.searchsorted(sorted_pix, pix, side="right")
        lens = np.where(pixel_mask[ev_sel], ends - starts, 0).ravel()
        total = int(lens.sum())
        if total == 0:
            continue
        offs = np.cumsum(lens) - lens
        pos = (np.arange(total) - np.repeat(offs, lens)
               + np.repeat(starts.ravel(), lens))
        ep = ev_sel[:, None] * max_npix + np.arange(max_npix)[None, :]
        gal_parts.append(order[pos])
        seg_parts.append(np.repeat(ep.ravel(), lens))
    if not gal_parts:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(gal_parts), np.concatenate(seg_parts)


def _p_cat_segments(mu, sig, w, seg, z_grids, bkg_grids, max_npix: int):
    """Segmented p_cat accumulation on the device: per chunk of voxel
    galaxies, the grid-normalized Gaussian x background rows are added into
    their (event, pixel) rows; galaxies outside the event's z-grid count
    for nothing.  Returns p_cat (Nev, P, Nz) and n_gal (Nev,)."""
    nev, nz = z_grids.shape
    acc_p = torch.zeros((nev * max_npix, nz), dtype=z_grids.dtype,
                        device=z_grids.device)
    acc_w = torch.zeros(nev * max_npix, dtype=z_grids.dtype, device=z_grids.device)
    acc_n = torch.zeros(nev, dtype=torch.int64, device=z_grids.device)
    chunk = max(1, _CHUNK_ELEMS // nz)
    for i in range(0, mu.shape[0], chunk):
        mu_c, sig_c, w_c, seg_c = (a[i:i + chunk] for a in (mu, sig, w, seg))
        e = torch.div(seg_c, max_npix, rounding_mode="floor")
        zg = z_grids[e]
        in_z = (mu_c > zg[:, 0]) & (mu_c < zg[:, -1])
        w_eff = torch.where(in_z, w_c, 0.0)
        g = (torch.exp(-0.5 * torch.square((zg - mu_c[:, None]) / sig_c[:, None]))
             / torch.sqrt(2.0 * math.pi * torch.square(sig_c[:, None])))
        g = g * bkg_grids[e]
        norm = trapz(g, zg, dim=1)
        g = g / torch.where(norm > 0, norm, 1.0)[:, None]
        # on CUDA an accumulating index_put_ sorts the voxel indices and sums
        # each voxel's galaxies in order, so the same catalog gives the same
        # bits (index_add_ sums by atomics, in an order that changes from run
        # to run); the integer counts are exact in any order
        acc_p.index_put_((seg_c,), w_eff[:, None] * g, accumulate=True)
        acc_w.index_put_((seg_c,), w_eff, accumulate=True)
        acc_n.index_add_(0, e, in_z.to(torch.int64))
    p_cat = acc_p / torch.where(acc_w > 0, acc_w, 1.0)[:, None]
    p_cat = torch.where(torch.isfinite(p_cat), p_cat, 0.0)
    return p_cat.reshape(nev, max_npix, nz), acc_n


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _host_p_cat(gal_pix: dict, z, sig, w, z_grids, bkg_grids, pix_sets,
                pixel_mask, opt_nsides):
    """The host engine: per event, the galaxies of its pixels inside its
    z-grid, and per pixel their ``_sum_gaussians``."""
    nev, nz = z_grids.shape
    p_cat = np.zeros((nev, pix_sets.shape[1], nz))
    n_gal = np.zeros(nev, dtype=np.int64)
    for e in range(nev):
        ns = int(opt_nsides[e])
        zg = z_grids[e]
        good = pix_sets[e][pixel_mask[e]].astype(np.int64)
        in_vox = np.isin(gal_pix[ns], good) & (z > zg[0]) & (z < zg[-1])
        idx = np.nonzero(in_vox)[0]
        gp = gal_pix[ns][idx]
        for j, p in enumerate(good):
            sel = gp == p
            if sel.any():
                p_cat[e, j] = _sum_gaussians(zg, z[idx][sel], sig[idx][sel],
                                             w[idx][sel], bkg_grids[e])
        n_gal[e] = int(in_vox.sum())
        p_cat[e][~np.isfinite(p_cat[e])] = 0.0
    return p_cat, n_gal


def build_pixelated_catalog(galaxies: dict, theta_gw: ThetaPEDet, z_grids,
                            cosmo, completeness, z_err: float = 0.01,
                            weights=None, sumgauss: str = "dVdz",
                            nest: bool = False, mask=None,
                            z_reshuffle_seed: int | None = None,
                            out_file: str | None = None,
                            engine: str = "device") -> PixelatedCatalog:
    """Precompute the pixelated catalog prior of a pixelized PE catalog.

    Args:
      galaxies: {'ra', 'dec', 'z'} tensors or arrays, radians.
      theta_gw: pixelized PE catalog (``data.pixelize.pixelize_gw_catalog``,
        in the scheme ``nest`` names).
      z_grids: (Nev, Nz) analysis grids.
      cosmo: fiducial cosmology (L = 1) of the dV_C/dz factor.
      completeness: the completeness model (P_compl of the catalog; p_bkg
        of the Gaussians with ``sumgauss='pbkg'``).
      z_err: galaxy z sigma as a fraction of (1 + z).
      weights: per-galaxy weights (default 1), e.g. luminosities.
      sumgauss: 'dVdz' or 'pbkg', the prior that multiplies the Gaussians.
      nest: the galaxies' pixels in the NESTED scheme.
      mask: boolean subselection of the galaxies.
      z_reshuffle_seed: draw each galaxy's z anew from N(z, z_err (1 + z))
        by ``np.random.default_rng(seed).normal`` (the JAX build's draws),
        and take z_err (1 + z_new) as its sigma.
      out_file: HDF5 path to save the result to (``load_pixelated_catalog``).
      engine: 'device', or 'host' (the numpy oracle).

    The galaxies' z, sigma and weights are prepared in float64 numpy; their
    pixels are indexed from the float64 angles whatever the dtype of
    ``z_grids``, so a float32 build puts every galaxy in the float64
    build's voxel.  Everything else is computed on the device and dtype of
    ``z_grids``.
    """
    if engine not in ("device", "host"):
        raise ValueError("engine must be 'device' or 'host'")
    if sumgauss not in ("dVdz", "pbkg"):
        raise ValueError("sumgauss must be 'dVdz' or 'pbkg'")
    z_grids = torch.as_tensor(z_grids)
    device, dtype = z_grids.device, z_grids.dtype
    ra = _np(galaxies["ra"]).astype(np.float64)
    dec = _np(galaxies["dec"]).astype(np.float64)
    z = _np(galaxies["z"]).astype(np.float64)
    w = np.ones_like(z) if weights is None else _np(weights).astype(np.float64)
    if mask is not None:
        keep = _np(mask).astype(bool)
        ra, dec, z, w = (a[keep] for a in (ra, dec, z, w))
    sig = z_err * (1.0 + z)
    if z_reshuffle_seed is not None:
        z = np.random.default_rng(z_reshuffle_seed).normal(z, sig)
        sig = z_err * (1.0 + z)

    pix_sets = _np(theta_gw.pixels_opt_nsides)
    pixel_mask = _np(theta_gw.pixel_mask)
    opt_nsides = _np(theta_gw.opt_nsides)
    max_npix = pix_sets.shape[1]
    ra_t = torch.as_tensor(ra, device=device)
    dec_t = torch.as_tensor(dec, device=device)
    gal_pix = {}
    for ns in np.unique(opt_nsides):
        logger.info("indexing %d galaxies at nside=%d", z.size, ns)
        gal_pix[int(ns)] = _np(hpx.find_pix_ra_dec(ra_t, dec_t, int(ns),
                                                   nest=nest))
    del ra_t, dec_t

    # the prior of the Gaussians on every grid, one batched call
    if sumgauss == "dVdz":
        bkg_grids = cosmo_fns.differential_comoving_volume(cosmo, z_grids[None])[0]
    else:
        bkg_grids = completeness.p_bkg(cosmo, z_grids[None])[0]
    bkg_grids = bkg_grids.to(dtype)

    if engine == "device":
        gal_idx, seg = _voxel_galaxy_csr(gal_pix, opt_nsides, pix_sets,
                                         pixel_mask)
        logger.info("p_cat: %d voxel galaxies", gal_idx.size)

        def dev(a):
            return torch.as_tensor(a[gal_idx], device=device).to(dtype)

        p_cat, n_gal = _p_cat_segments(dev(z), dev(sig), dev(w),
                                       torch.as_tensor(seg, device=device),
                                       z_grids, bkg_grids, max_npix)
    else:
        p_cat, n_gal = _host_p_cat(gal_pix, z, sig, w, _np(z_grids).astype(np.float64),
                                   _np(bkg_grids).astype(np.float64), pix_sets,
                                   pixel_mask, opt_nsides)
        p_cat = torch.as_tensor(p_cat, device=device).to(dtype)
        n_gal = torch.as_tensor(n_gal, device=device)
    cat = PixelatedCatalog(
        p_cat=p_cat, P_compl=completeness.P_compl(z_grids)[:, None, :],
        pixel_mask=torch.as_tensor(pixel_mask, device=device), n_gal=n_gal,
        completeness=completeness)
    if out_file is not None:
        save_pixelated_catalog(out_file, cat)
    return cat


def save_pixelated_catalog(fname: str, cat: PixelatedCatalog) -> None:
    """Write the catalog's p_cat, P_compl, pixel_mask and n_gal in the JAX
    package's HDF5 layout; the completeness model is given again at load."""
    import h5py

    with h5py.File(fname, "w") as f:
        for k in _CAT_FIELDS:
            f.create_dataset(k, data=_np(getattr(cat, k)))


def load_pixelated_catalog(fname: str, completeness, device=None, dtype=None
                           ) -> PixelatedCatalog:
    """Read a saved catalog (either package's file), skipping the
    precompute, onto ``device`` (default: the card) in ``dtype`` (default:
    the device's)."""
    import h5py

    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    with h5py.File(fname, "r") as f:
        arrs = {k: torch.as_tensor(f[k][...], device=device) for k in _CAT_FIELDS}
    return PixelatedCatalog(
        p_cat=arrs["p_cat"].to(dtype), P_compl=arrs["P_compl"].to(dtype),
        pixel_mask=arrs["pixel_mask"].to(torch.bool),
        n_gal=arrs["n_gal"].to(torch.int64), completeness=completeness)
