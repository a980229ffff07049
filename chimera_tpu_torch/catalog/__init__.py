"""Galaxy-catalog redshift priors: the catalog-free one and the pixelated
dark-siren catalog with its completeness model."""

from chimera_tpu_torch.catalog.completeness import DVdzCompleteness
from chimera_tpu_torch.catalog.empty import EmptyCatalog
from chimera_tpu_torch.catalog.pixelated import PixelatedCatalog

__all__ = ["DVdzCompleteness", "EmptyCatalog", "PixelatedCatalog"]
