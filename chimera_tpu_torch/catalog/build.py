"""Pixelated-catalog precompute: galaxies -> per-(event, pixel) redshift
priors p_cat(z) (counterpart of ``chimera_tpu/catalog/build.py`` with
``engine='device'``).

p_cat is built at the fiducial cosmology: per galaxy a Gaussian
N(z; z_gal, z_err (1 + z_gal)) times dV_C/dz (or p_bkg) on the event's
z-grid, normalized by its trapezoid integral, then weight-averaged over the
galaxies of each (event, pixel) voxel.  The galaxy -> voxel assignment is
host numpy (a CSR gather); the Gaussian sums run on the galaxies' device as
chunked accumulating ``index_put_`` into the (Nev * P, Nz) accumulator.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from chimera_tpu_torch.catalog.pixelated import PixelatedCatalog
from chimera_tpu_torch.config import logger
from chimera_tpu_torch.data.structs import ThetaPEDet
from chimera_tpu_torch.models import cosmology as cosmo_fns
from chimera_tpu_torch.ops import healpix as hpx
from chimera_tpu_torch.ops.integrate import trapz

# elements of one (galaxies, Nz) Gaussian block
_CHUNK_ELEMS = 1 << 24


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


def build_pixelated_catalog(galaxies: dict, theta_gw: ThetaPEDet, z_grids,
                            cosmo, completeness, z_err: float = 0.01
                            ) -> PixelatedCatalog:
    """Precompute the pixelated catalog prior of a pixelized PE catalog,
    with unit galaxy weights and dV_C/dz as the prior of the Gaussians (the
    JAX package's defaults).

    Args:
      galaxies: {'ra', 'dec', 'z'} tensors, radians.
      theta_gw: pixelized PE catalog (``data.pixelize.pixelize_gw_catalog``).
      z_grids: (Nev, Nz) analysis grids.
      cosmo: fiducial cosmology (L = 1) of the dV_C/dz factor.
      completeness: the completeness model (P_compl of the catalog).
      z_err: galaxy z sigma as a fraction of (1 + z).

    Everything is computed on the device and dtype of ``z_grids``.
    """
    z_grids = torch.as_tensor(z_grids)
    device, dtype = z_grids.device, z_grids.dtype

    def dev(a):
        return torch.as_tensor(a, device=device).to(dtype)

    ra, dec, z = dev(galaxies["ra"]), dev(galaxies["dec"]), dev(galaxies["z"])
    w = torch.ones_like(z)
    sig = z_err * (1.0 + z)

    pix_sets = theta_gw.pixels_opt_nsides.cpu().numpy()
    pixel_mask = theta_gw.pixel_mask.cpu().numpy()
    opt_nsides = theta_gw.opt_nsides.cpu().numpy()
    max_npix = pix_sets.shape[1]
    gal_pix = {}
    for ns in np.unique(opt_nsides):
        logger.info("indexing %d galaxies at nside=%d", z.numel(), ns)
        gal_pix[int(ns)] = hpx.find_pix_ra_dec(ra, dec, int(ns)).cpu().numpy()

    bkg_grids = cosmo_fns.differential_comoving_volume(cosmo, z_grids[None])[0]

    gal_idx, seg = _voxel_galaxy_csr(gal_pix, opt_nsides, pix_sets, pixel_mask)
    logger.info("p_cat: %d voxel galaxies", gal_idx.size)
    gi = torch.as_tensor(gal_idx, device=device)
    p_cat, n_gal = _p_cat_segments(z[gi], sig[gi], w[gi],
                                   torch.as_tensor(seg, device=device),
                                   z_grids, bkg_grids, max_npix)
    return PixelatedCatalog(
        p_cat=p_cat, P_compl=completeness.P_compl(z_grids)[:, None, :],
        pixel_mask=torch.as_tensor(pixel_mask, device=device), n_gal=n_gal,
        completeness=completeness)
