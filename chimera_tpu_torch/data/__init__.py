"""Event structs, HDF5 loaders (``data.io``, h5py imported at first use),
mock data, the pixelization and localization areas and volumes."""

from chimera_tpu_torch.data.localization import (localization_areas,
                                                 localization_volumes)
from chimera_tpu_torch.data.structs import (PAD_VALUE, ThetaInjDet, ThetaPEDet,
                                            ThetaSrc)

__all__ = [
    "PAD_VALUE",
    "ThetaInjDet",
    "ThetaPEDet",
    "ThetaSrc",
    "localization_areas",
    "localization_volumes",
]
