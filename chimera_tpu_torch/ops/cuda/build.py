"""Build and load the hand-written CUDA kernels.

Each ``chimera_tpu_torch/csrc/<name>.cu`` exposes a plain C interface.  At
first use it is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``build/kernels/`` at the repository root, named by a hash of
the source, the shared headers ``csrc/*.cuh`` and the flags (a changed
source or header builds anew), and loaded with
``ctypes``.  The kernels that evaluate the population build once a mass
model: ``load(name, kind)`` defines CHIMERA_MASS_KIND=kind for kind > 0
(``csrc/population.cuh``) and names the library ``<name>_m<kind>``;
PowerLawPeak's (kind 0) is the build without the macro.  Nothing includes PyTorch's headers, so a build takes seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
# per kernel: nvcc's output (ptxas register / shared-memory / spill report)
# and the build time in seconds, for the first build in this process
build_info: dict[str, dict] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _flags(kind: int) -> tuple[str, ...]:
    return NVCC_FLAGS + ((f"-DCHIMERA_MASS_KIND={kind}",) if kind else ())


def lib_name(name: str, kind: int = 0) -> str:
    """The library's name: the source's, with the mass model's kind > 0."""
    return f"{name}_m{kind}" if kind else name


def _shared_object(name: str, kind: int = 0) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(_flags(kind)).encode())
    return BUILD_DIR / f"{lib_name(name, kind)}-{h.hexdigest()[:16]}.so"


def load(name: str, kind: int = 0) -> ctypes.CDLL:
    """Compile (if needed) and load ``csrc/<name>.cu`` for the mass model
    ``kind``.  Builds of different kernels may run in parallel threads:
    ``nvcc`` runs outside the GIL."""
    key = lib_name(name, kind)
    lib = _libs.get(key)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    so = _shared_object(name, kind)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc(), *_flags(kind), "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
        build_info[key] = {"seconds": time.perf_counter() - t0,
                           "log": proc.stdout + proc.stderr}
    lib = ctypes.CDLL(str(so))
    _libs[key] = lib
    return lib
