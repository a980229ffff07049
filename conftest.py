"""Builds the JAX package's native library once, before any test process
starts.

``chimera_tpu/native`` builds ``libchimera_native.so`` with ``make`` at its
first use.  Under pytest-xdist every worker imports ``tests/test_native.py``
at once, so on a checkout without the library several workers would run
``make`` together on one output file, and a worker that loads the file
half-written gives up on it and skips the file's tests.  Here the
controlling process (not an xdist worker) runs the package's own ``make``
once when the library is missing; a failed build is left to the package,
which then reports the library unavailable as before.
"""

import subprocess
from pathlib import Path

_NATIVE = Path(__file__).resolve().parent / "chimera_tpu" / "native"


def pytest_configure(config):
    if hasattr(config, "workerinput") or (_NATIVE / "libchimera_native.so").exists():
        return
    try:
        subprocess.run(["make", "-C", str(_NATIVE)], capture_output=True,
                       timeout=300, check=False)
    except (OSError, subprocess.TimeoutExpired):
        pass
