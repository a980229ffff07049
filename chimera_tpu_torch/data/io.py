"""HDF5 I/O in the reference's file schema (counterpart of
``chimera_tpu/data/io.py``): PE samples (a ``posteriors`` group of
m1det, m2det, dL, ...), injections (the reference's key names), galaxy
catalogs, pixelated GW catalogs (pixel arrays padded with -100), and the
generic attribute / dataset round trip.  On load the -100 sentinels become
explicit masks (``ThetaPEDet.pixel_mask``); on save the masks become -100
again, so either package reads the other's files.

``h5py`` is imported inside the functions: the module imports where it is
not installed, and only reading or writing a file needs it.  Loaders put
their tensors on ``device`` (default: the card, see
``config.resolve_device``); numbers keep the file's dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from chimera_tpu_torch.config import logger, resolve_device
from chimera_tpu_torch.data.structs import PAD_VALUE, ThetaInjDet, ThetaPEDet

THETA_PE_DATASETS = ["m1det", "m2det", "dL", "pe_prior"]
# the (Nev, P) pixel arrays whose masked slots the files hold as -100
_PADDED = ("pixels_opt_nsides", "ra_pix", "dec_pix", "gw_loc2d_pdf")
# integer fields (the JAX package may write them as floats)
_INDEX_FIELDS = ("opt_nsides", "pixels_opt_nsides", "pixels_pe_opt_nside")
THETA_PE_PIXELATED_DATASETS = THETA_PE_DATASETS + [
    "ra", "dec", "theta", "phi", "opt_nsides", "pixels_opt_nsides",
    "ra_pix", "dec_pix", "gw_loc2d_pdf", "pixels_pe_opt_nside"]


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def load_data_h5(fname, group=None, device=None, require_keys=None) -> dict:
    """Every dataset of a file or group as a dict of tensors on ``device``
    (``device='numpy'``: numpy arrays, as the JAX package's
    ``backend='numpy'``)."""
    import h5py

    as_numpy = device == "numpy"
    dev = None if as_numpy else resolve_device(device)
    out = {}
    with h5py.File(fname, "r") as f:
        target = f if group is None else f[group]
        if require_keys:
            missing = [k for k in require_keys if k not in target]
            if missing:
                raise ValueError(f"missing keys in {fname}: {missing}")
        for k in target.keys():
            a = target[k][:]
            out[k] = a if as_numpy else torch.as_tensor(a, device=dev)
    return out


def save_attrs_datasets(obj, fname, attrs=(), datasets=(), groups=()) -> None:
    """Write ``obj``'s named attributes, datasets and groups of datasets."""
    import h5py

    with h5py.File(fname, "w") as f:
        for a in attrs:
            f.attrs[a] = getattr(obj, a)
        for d in datasets:
            f.create_dataset(d, data=_np(getattr(obj, d)))
        for g in groups:
            grp = f.create_group(g)
            for k, v in getattr(obj, g).items():
                grp.create_dataset(str(k), data=_np(v))


def load_attrs_datasets(fname, attrs=(), datasets=(), groups=(), device=None
                        ) -> dict:
    """Read named attributes, datasets (tensors on ``device``) and groups
    of datasets into a field dict."""
    import h5py

    dev = resolve_device(device)
    out = {}
    with h5py.File(fname, "r") as f:
        for a in attrs:
            out[a] = f.attrs[a]
        for d in datasets:
            out[d] = torch.as_tensor(f[d][:], device=dev)
        for g in groups:
            out[g] = {k: torch.as_tensor(f[g][k][:], device=dev)
                      for k in f[g].keys()}
    return out


# ---------------------------------------------------------------------------
# catalog loaders
# ---------------------------------------------------------------------------

def load_galaxy_catalog(file_path, parameters=("ra_gal", "dec_gal", "z_cgal"),
                        units="rad", device=None) -> dict:
    """Galaxy catalog -> {'ra', 'dec', 'z'}; with ``units='rad'`` the
    file's angles (in degrees) are converted to radians."""
    if units not in ("rad", "deg"):
        raise ValueError("units must be 'rad' or 'deg'")
    data = load_data_h5(file_path, device="numpy", require_keys=list(parameters))
    out = {"ra": data[parameters[0]], "dec": data[parameters[1]],
           "z": data[parameters[2]]}
    if units == "rad":
        out["ra"] = np.deg2rad(out["ra"])
        out["dec"] = np.deg2rad(out["dec"])
    if device == "numpy":
        return out
    dev = resolve_device(device)
    return {k: torch.as_tensor(v, device=dev) for k, v in out.items()}


def _selection_indices(n, max_n, name, rng: np.random.Generator | None = None):
    """Event / sample / injection subselection: all (None), the given
    indices, or ``n`` sorted indices drawn without replacement by ``rng``
    (default ``np.random.default_rng(0)``, the JAX package's)."""
    if n is None:
        return slice(None)
    if isinstance(n, (list, np.ndarray)):
        return np.asarray(n)
    if isinstance(n, int):
        if n > max_n:
            logger.warning("requested more %s than available; using all", name)
            return slice(None)
        rng = rng or np.random.default_rng(0)
        return np.sort(rng.choice(max_n, n, replace=False))
    raise ValueError(f"invalid selection for {name}")


def load_gw_pe_samples(file_ev_pe,
                       parameters=("dL", "m1det", "m2det", "phi", "theta"),
                       group="posteriors", nevents=None, nsamples=None,
                       rng=None, device=None) -> ThetaPEDet:
    """PE samples from the reference file schema; ra = phi and
    dec = pi/2 - theta where the file has the angles."""
    data = load_data_h5(file_ev_pe, group=group, device="numpy",
                        require_keys=list(parameters))
    ev_idx = _selection_indices(nevents, data["dL"].shape[0], "events", rng)
    s_idx = _selection_indices(nsamples, data["dL"].shape[1], "samples", rng)
    dev = resolve_device(device)
    result = {k: torch.as_tensor(data[k][ev_idx][:, s_idx], device=dev)
              for k in parameters}
    if {"theta", "phi"} <= set(parameters):
        result["ra"] = result["phi"]
        result["dec"] = 0.5 * math.pi - result["theta"]
    return ThetaPEDet(**result).with_derived()


def load_injection_data(file_inj, snr_cut=None, ninj=None, group=None,
                        key_mapping=None, rng=None, device=None
                        ) -> tuple[ThetaInjDet, int]:
    """Detected injections with an SNR cut, in the detector frame (from the
    source frame and z where the file has no detector masses).  Returns
    (theta_inj, number loaded); the number generated comes from the file's
    metadata or the caller."""
    keys = {"m1s": "m1src", "m2s": "m2src", "m1d": "m1det", "m2d": "m2det",
            "dL": "dL", "z": "z", "snr": "SNR_net",
            "log_pdraw": "log_p_draw_nospin"}
    keys.update(key_mapping or {})
    data = load_data_h5(file_inj, group=group, device="numpy")

    keep = data[keys["snr"]] > snr_cut if snr_cut else slice(None)
    if keys["m1d"] in data:
        m1d, m2d = data[keys["m1d"]], data[keys["m2d"]]
    else:
        m1d = data[keys["m1s"]] * (1 + data[keys["z"]])
        m2d = data[keys["m2s"]] * (1 + data[keys["z"]])
    m1d, m2d, dl = m1d[keep], m2d[keep], data[keys["dL"]][keep]
    if not ((m1d > 0).all() and (m2d > 0).all()):
        raise ValueError("masses must be positive")
    if not (dl > 0).all():
        raise ValueError("distances must be positive")
    if not (m2d <= m1d).all():
        raise ValueError("primary mass must be >= secondary")
    p_draw = np.exp(data[keys["log_pdraw"]][keep])

    idx = _selection_indices(ninj, len(m1d), "injections", rng)
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(a[idx], device=dev)

    theta = ThetaInjDet(m1det=t(m1d), m2det=t(m2d), dL=t(dl), p_draw=t(p_draw))
    return theta, int(theta.dL.shape[0])


def save_pixelated_gw_catalog(theta: ThetaPEDet, fname: str) -> None:
    """Write a pixelated PE catalog in the reference layout, masked pixel
    slots as -100."""
    fields = {}
    mask = None if theta.pixel_mask is None else _np(theta.pixel_mask)
    for name in THETA_PE_PIXELATED_DATASETS:
        a = _np(getattr(theta, name))
        if mask is not None and name in _PADDED:
            a = np.where(mask, a, np.asarray(PAD_VALUE, a.dtype))
        fields[name] = a
    import h5py

    with h5py.File(fname, "w") as f:
        for name, a in fields.items():
            f.create_dataset(name, data=a)


def load_pixelated_gw_catalog(fname: str, device=None) -> ThetaPEDet:
    """Read a pixelated PE catalog (reference layout); the -100 sentinels
    become the pixel mask, the pixel indices and nsides int64."""
    fields = load_attrs_datasets(fname, datasets=THETA_PE_PIXELATED_DATASETS,
                                 device=device)
    for name in _INDEX_FIELDS:
        fields[name] = fields[name].to(torch.int64)
    return ThetaPEDet(**fields).with_derived()
