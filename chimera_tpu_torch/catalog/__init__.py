"""Galaxy-catalog redshift priors: the catalog-free one and the pixelated
dark-siren catalog with its completeness models."""

from chimera_tpu_torch.catalog.completeness import (DVdzCompleteness,
                                                    HomogeneousCompleteness)
from chimera_tpu_torch.catalog.empty import EmptyCatalog
from chimera_tpu_torch.catalog.pixelated import PixelatedCatalog

__all__ = ["DVdzCompleteness", "HomogeneousCompleteness", "EmptyCatalog",
           "PixelatedCatalog"]
