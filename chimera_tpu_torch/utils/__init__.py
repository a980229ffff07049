"""Utilities: magnitudes, profiling and plotting (matplotlib imported at the
first plot).  The JAX package's ``utils/devices.py::ensure_virtual_devices``
provisions virtual CPU devices for its meshes; the port's counterpart is
``chimera_tpu_torch/parallel/spawn.py::run_ranks``, which starts local
ranks of one process group, so this package has no devices module."""

from chimera_tpu_torch.utils.mags import (absolute_magnitude,
                                          apparent_magnitude, lum2mag,
                                          mag2lum,
                                          schechter_luminosity_fraction)
from chimera_tpu_torch.utils.profiling import (StageTimer, compile_time,
                                               device_trace)

__all__ = [
    "mag2lum",
    "lum2mag",
    "absolute_magnitude",
    "apparent_magnitude",
    "schechter_luminosity_fraction",
    "StageTimer",
    "compile_time",
    "device_trace",
]
