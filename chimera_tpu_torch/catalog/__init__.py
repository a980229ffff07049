"""Galaxy-catalog redshift priors (the spectral-siren one so far)."""

from chimera_tpu_torch.catalog.empty import EmptyCatalog

__all__ = ["EmptyCatalog"]
