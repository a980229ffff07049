"""GW-catalog pixelization and the per-pixel sample layouts of the
dark-siren likelihood (counterpart of ``chimera_tpu/data/pixelize.py``).

The per-sample HEALPix indexing, the angular separations and the 2-D
localization KDEs run as batched tensor ops on the device the PE samples
live on, in float64; the ragged bookkeeping (confidence sets, the grouping of
samples by pixel, the chunk rows) is host numpy.  Layouts keep the JAX
package's defaults (pixel axis padded to a multiple of 8, ``S_pp`` to 128,
chunk rows of 128, rows per event to a multiple of 8), so they compare
array for array.
"""

from __future__ import annotations

import numpy as np
import torch

from chimera_tpu_torch.config import logger
from chimera_tpu_torch.data.structs import PAD_VALUE, ThetaPEDet
from chimera_tpu_torch.ops import healpix as hpx
from chimera_tpu_torch.ops.kde import gaussian_kde_nd

F64 = torch.float64


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def confidence_pixels(pix_samples: np.ndarray, sky_conf: float) -> np.ndarray:
    """Pixels covering ``sky_conf`` of an event's sky probability: the
    per-pixel probability is the share of PE samples; keep every pixel at or
    above the smallest probability whose descending cumulative sum reaches
    ``sky_conf``."""
    unique, counts = np.unique(pix_samples, return_counts=True)
    p = counts / pix_samples.shape[0]
    order = np.argsort(p)[::-1]
    cum = np.cumsum(p[order])
    thr = p[order][np.searchsorted(cum, sky_conf)]
    return unique[p >= thr]


def pixelize_gw_catalog(theta_gw: ThetaPEDet, nside_list: list[int],
                        mean_npixels_event: int, sky_conf: float = 0.9
                        ) -> ThetaPEDet:
    """Attach the RING pixelation to a PE catalog.

    Per event: the nside whose confidence region has closest to
    ``mean_npixels_event`` pixels, its pixel set (padded to a multiple of 8
    with ``pixel_mask``), the pixel centres, the 2-D localization pdf at each
    centre, and each PE sample's pixel (samples outside the region snap to
    the angularly nearest confidence pixel)."""
    device = theta_gw.ra.device
    ra_t, dec_t = theta_gw.ra.to(F64), theta_gw.dec.to(F64)
    ra, dec = _np(ra_t), _np(dec_t)
    n_events = ra.shape[0]

    pix_all = {ns: _np(hpx.find_pix_ra_dec(ra_t, dec_t, ns)) for ns in nside_list}
    counts = np.array([[confidence_pixels(pix_all[ns][e], sky_conf).size
                        for ns in nside_list] for e in range(n_events)])
    best = np.argmin(np.abs(counts - mean_npixels_event), axis=1)
    opt_nsides = np.asarray(nside_list)[best]
    logger.info("optimal nsides: %s",
                dict(zip(*np.unique(opt_nsides, return_counts=True))))

    event_pixels = [confidence_pixels(pix_all[opt_nsides[e]][e], sky_conf)
                    for e in range(n_events)]
    max_npix = -(-max(len(p) for p in event_pixels) // 8) * 8
    pix_padded = np.full((n_events, max_npix), int(PAD_VALUE), dtype=np.int64)
    mask = np.zeros((n_events, max_npix), dtype=bool)
    for e, pix_e in enumerate(event_pixels):
        pix_padded[e, :len(pix_e)] = pix_e
        mask[e, :len(pix_e)] = True

    # pixel centres, one call per distinct nside (padded slots at pixel 0)
    pix_clamped = np.where(mask, pix_padded, 0)
    ra_pix = np.zeros((n_events, max_npix))
    dec_pix = np.zeros((n_events, max_npix))
    for ns in np.unique(opt_nsides):
        sel = opt_nsides == ns
        r_c, d_c = hpx.find_ra_dec(torch.as_tensor(pix_clamped[sel], device=device),
                                   int(ns))
        ra_pix[sel], dec_pix[sel] = _np(r_c), _np(d_c)
    ra_c = np.where(mask, ra_pix, 0.0)
    dec_c = np.where(mask, dec_pix, 0.0)
    ra_pix[~mask] = PAD_VALUE
    dec_pix[~mask] = PAD_VALUE

    # samples in the region keep their pixel, the others snap to the nearest
    samp_pix = np.stack([pix_all[int(opt_nsides[e])][e] for e in range(n_events)])
    inside = (samp_pix[:, None, :] == pix_padded[:, :, None]).any(axis=1)
    ra_c_t = torch.as_tensor(ra_c, device=device)
    dec_c_t = torch.as_tensor(dec_c, device=device)
    sep = _np(hpx.angular_separation(ra_t[:, :, None], dec_t[:, :, None],
                                     ra_c_t[:, None, :], dec_c_t[:, None, :]))
    sep = np.where(mask[:, None, :], sep, np.inf)                 # (E, S, P)
    nearest = np.take_along_axis(pix_padded, np.argmin(sep, axis=2), axis=1)
    pe_pix = np.where(inside, samp_pix, nearest)

    loc = _np(gaussian_kde_nd(torch.stack([ra_t, dec_t], dim=1),
                              torch.stack([ra_c_t, dec_c_t], dim=1)))
    loc_pdf = np.where(mask, loc, PAD_VALUE)

    def dev(a):
        return torch.as_tensor(a, device=device)

    return theta_gw.update(
        opt_nsides=dev(opt_nsides.astype(np.int64)), pixels_opt_nsides=dev(pix_padded),
        ra_pix=dev(ra_pix), dec_pix=dev(dec_pix), gw_loc2d_pdf=dev(loc_pdf),
        pixels_pe_opt_nside=dev(pe_pix), pixel_mask=dev(mask))


def compact_samples_by_pixel(theta_gw: ThetaPEDet, pad_multiple: int = 128) -> dict:
    """Regroup each event's PE samples by their pixel (the pixels partition
    the sample axis).

    Returns tensors on the samples' device:
      m1det, m2det, dL, inv_pe_prior: (Nev, P, S_pp) — each pixel's samples
        first, then fillers at dL = the event's min dL (whose z is the min-z
        filler of the masked per-pixel row under every cosmology) with zero
        weight; S_pp is the largest pixel occupancy rounded up to
        ``pad_multiple``;
      n_real: (Nev, P) samples per pixel;
      dl_fill: (Nev,) the filler distance.
    """
    pe_pix = _np(theta_gw.pixels_pe_opt_nside)
    pixels = _np(theta_gw.pixels_opt_nsides)
    m1, m2, dl = _np(theta_gw.m1det), _np(theta_gw.m2det), _np(theta_gw.dL)
    inv_prior = 1.0 / _np(theta_gw.pe_prior)
    n_ev, n_pix = pixels.shape
    n_s = pe_pix.shape[1]

    # stable sort of each sample by its pixel's slot j, scattered by
    # (j, rank within the pixel)
    eq = pixels[:, :, None] == pe_pix[:, None, :]                 # (E, P, S)
    if not eq.any(axis=1).all():
        raise ValueError("every PE sample must map to a confidence pixel "
                         "(run pixelize_gw_catalog first)")
    j_of = np.argmax(eq, axis=1)
    counts = eq.sum(axis=2, dtype=np.int64)
    order = np.argsort(j_of, axis=1, kind="stable")
    j_sorted = np.take_along_axis(j_of, order, axis=1)
    starts = np.concatenate([np.zeros((n_ev, 1), np.int64),
                             np.cumsum(counts, axis=1)[:, :-1]], axis=1)
    rank = np.arange(n_s)[None, :] - np.take_along_axis(starts, j_sorted, axis=1)

    s_pp = int(-(-max(1, counts.max()) // pad_multiple) * pad_multiple)
    dl_fill = dl.min(axis=1)
    out = {
        # filler masses: the event's first sample (any finite value will do)
        "m1det": np.repeat(m1[:, None, :1], n_pix, 1).repeat(s_pp, 2),
        "m2det": np.repeat(m2[:, None, :1], n_pix, 1).repeat(s_pp, 2),
        "dL": np.repeat(dl_fill[:, None, None], n_pix, 1).repeat(s_pp, 2),
        "inv_pe_prior": np.zeros((n_ev, n_pix, s_pp), inv_prior.dtype),
    }
    e_idx = np.arange(n_ev)[:, None]
    for name, src in (("m1det", m1), ("m2det", m2), ("dL", dl),
                      ("inv_pe_prior", inv_prior)):
        out[name][e_idx, j_sorted, rank] = np.take_along_axis(src, order, axis=1)
    device = theta_gw.dL.device
    res = {k: torch.as_tensor(v, device=device) for k, v in out.items()}
    res["n_real"] = torch.as_tensor(counts, device=device)
    res["dl_fill"] = torch.as_tensor(dl_fill, device=device)
    return res


def chunk_rows_from_compact(compact: dict, chunk: int = 128) -> dict:
    """Repack the (E, P, S_pp) layout into dense rows of ``chunk`` samples:
    (E, C, chunk), each row one pixel's samples (a pixel with n samples
    spans ceil(n / chunk) rows), C the largest row count of an event rounded
    up to a multiple of 8.  Padding rows carry zero weight at ``dl_fill``.

    Returns m1det, m2det, dL, inv_pe_prior (E, C, chunk) and row_pix (E, C),
    the pixel slot of each row (0 for padding rows)."""
    m1 = _np(compact["m1det"])
    n_ev, n_pix, s_pp = m1.shape
    if s_pp % chunk:
        raise ValueError(f"S_pp = {s_pp} is not a multiple of chunk = {chunk}")
    counts = _np(compact["n_real"])
    chunks_pp = -(-counts // chunk)                              # 0 if empty
    c_max = int(-(-max(1, chunks_pp.sum(axis=1).max()) // 8) * 8)

    # run-length expansion: (e, p) owns chunks_pp[e, p] consecutive rows
    # from the exclusive per-event cumsum on
    pool_per_pix = s_pp // chunk
    sel = np.zeros((n_ev, c_max), dtype=np.int64)
    row_pix = np.zeros((n_ev, c_max), dtype=np.int64)
    dead = np.ones((n_ev, c_max), dtype=bool)
    flat_k = chunks_pp.ravel()
    start = (np.cumsum(chunks_pp, axis=1) - chunks_pp).ravel()
    idx_in_run = np.arange(flat_k.sum()) - np.repeat(np.cumsum(flat_k) - flat_k,
                                                     flat_k)
    ev = np.repeat(np.repeat(np.arange(n_ev), n_pix), flat_k)
    pix = np.repeat(np.tile(np.arange(n_pix), n_ev), flat_k)
    pos = np.repeat(start, flat_k) + idx_in_run
    sel[ev, pos] = pix * pool_per_pix + idx_in_run
    row_pix[ev, pos] = pix
    dead[ev, pos] = False

    device = compact["dL"].device
    out = {"row_pix": torch.as_tensor(row_pix, device=device)}
    e_idx = np.arange(n_ev)[:, None]
    dlf = _np(compact["dl_fill"])[:, None, None]
    for name in ("m1det", "m2det", "dL", "inv_pe_prior"):
        pool = _np(compact[name]).reshape(n_ev, n_pix * pool_per_pix, chunk)
        rows = pool[e_idx, sel]
        if name == "inv_pe_prior":
            rows = np.where(dead[:, :, None], 0.0, rows)
        elif name == "dL":
            rows = np.where(dead[:, :, None], dlf, rows)
        out[name] = torch.as_tensor(rows, device=device)
    return out
