"""ctypes loader of the host C++ library (HEALPix and KDE), the port's own
copy of ``chimera_tpu/native``: independent oracles of the tensor HEALPix
and KDEs, on the CPU and on the card (whose results are copied back).

At first use ``g++`` builds ``healpix.cpp`` and ``kde.cpp`` into
``build/native/`` at the repository root (never into the source tree),
named by a hash of the sources and flags.  ``-ffp-contract=off`` keeps
every product and sum rounded on its own, as the tensor code's are.  The
build is serial (no OpenMP: the sources' pragmas are ignored), so it needs
nothing beyond the C++ compiler, and the oracles take one core.  A failed
build raises when a function is called; ``available()`` reports whether
the library builds and loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parents[1] / "build" / "native"
SOURCES = ("healpix.cpp", "kde.cpp")
CXX_FLAGS = ("-O3", "-fPIC", "-ffp-contract=off", "-shared", "-Wall",
             "-Wno-unknown-pragmas")

_lib = None
_error: Exception | None = None

_D = ctypes.POINTER(ctypes.c_double)
_I = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    "chimera_ang2pix": [ctypes.c_int64, _D, _D, _I, ctypes.c_int64, ctypes.c_int],
    "chimera_pix2ang": [ctypes.c_int64, _I, _D, _D, ctypes.c_int64, ctypes.c_int],
    "chimera_boundaries": [ctypes.c_int64, _I, ctypes.c_int64, _D, _D,
                           ctypes.c_int64],
    "chimera_gkde_whitened": [_D, _D, _D, ctypes.c_double, ctypes.c_int64,
                              ctypes.c_int64, ctypes.c_int64, ctypes.c_int, _D],
    "chimera_kde1d": [_D, _D, ctypes.c_double, _D, ctypes.c_int64,
                      ctypes.c_int64, ctypes.c_int, _D],
}


def _shared_object() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode() + (_DIR / name).read_bytes())
    return BUILD_DIR / f"libchimera_native-{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
         *(str(_DIR / s) for s in SOURCES)],
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)


def _load() -> ctypes.CDLL:
    """The library, built at first use; raises what the build or load
    raised (and raises it again on every later call)."""
    global _lib, _error
    if _lib is not None:
        return _lib
    if _error is not None:
        raise RuntimeError("the native library did not build") from _error
    try:
        so = _shared_object()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            getattr(lib, name).argtypes = argtypes
    except Exception as e:  # kept and raised on every call
        _error = e
        raise
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load()
    except Exception:
        return False
    return True


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64).ravel()


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64).ravel()


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(_D)


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(_I)


def ang2pix(nside: int, theta, phi, nest: bool = False) -> np.ndarray:
    lib = _load()
    theta, phi = _f64(theta), _f64(phi)
    out = np.empty(theta.size, dtype=np.int64)
    lib.chimera_ang2pix(nside, _dptr(theta), _dptr(phi), _iptr(out),
                        theta.size, int(nest))
    return out


def pix2ang(nside: int, pix, nest: bool = False) -> tuple[np.ndarray, np.ndarray]:
    lib = _load()
    pix = _i64(pix)
    theta = np.empty(pix.size, dtype=np.float64)
    phi = np.empty(pix.size, dtype=np.float64)
    lib.chimera_pix2ang(nside, _iptr(pix), _dptr(theta), _dptr(phi), pix.size,
                        int(nest))
    return theta, phi


def boundaries(nside: int, pix, step: int = 1, nest: bool = False
               ) -> tuple[np.ndarray, np.ndarray]:
    """(theta, phi) of shape (n, 4 step); RING pixels go to NESTED through
    their centres."""
    pix = _i64(pix)
    if not nest:
        pix = ang2pix(nside, *pix2ang(nside, pix), nest=True)
    lib = _load()
    theta = np.empty(pix.size * 4 * step, dtype=np.float64)
    phi = np.empty_like(theta)
    lib.chimera_boundaries(nside, _iptr(pix), step, _dptr(theta), _dptr(phi),
                           pix.size)
    return theta.reshape(-1, 4 * step), phi.reshape(-1, 4 * step)


def gkde_whitened(points_w, data_w, weights, log_norm: float,
                  in_log: bool = False) -> np.ndarray:
    lib = _load()
    points_w = np.ascontiguousarray(points_w, dtype=np.float64)
    data_w = np.ascontiguousarray(data_w, dtype=np.float64)
    weights = _f64(weights)
    n_p, d = points_w.shape
    out = np.empty(n_p, dtype=np.float64)
    lib.chimera_gkde_whitened(_dptr(points_w), _dptr(data_w), _dptr(weights),
                              float(log_norm), n_p, data_w.shape[0], d,
                              int(in_log), _dptr(out))
    return out


def kde1d(data, weights, bandwidth: float, grid, kernel: str = "epan"
          ) -> np.ndarray:
    lib = _load()
    data, weights, grid = _f64(data), _f64(weights), _f64(grid)
    out = np.empty(grid.size, dtype=np.float64)
    lib.chimera_kde1d(_dptr(data), _dptr(weights), float(bandwidth),
                      _dptr(grid), data.size, grid.size,
                      0 if kernel == "epan" else 1, _dptr(out))
    return out
