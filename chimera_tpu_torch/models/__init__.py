"""Population models: cosmology, mass, rate and the population wrapper."""

from chimera_tpu_torch.models.cosmology import FLRW
from chimera_tpu_torch.models.mass import BaseMassModel, PowerLawPeak, p_m1m2
from chimera_tpu_torch.models.population import (
    Population,
    compute_z_grids,
    p_cbc,
    pop_rate_det,
    theta_det_to_src,
    theta_src_and_weights,
)
from chimera_tpu_torch.models.rate import MadauDickinsonRate

__all__ = [
    "FLRW",
    "BaseMassModel",
    "PowerLawPeak",
    "p_m1m2",
    "MadauDickinsonRate",
    "Population",
    "compute_z_grids",
    "p_cbc",
    "pop_rate_det",
    "theta_det_to_src",
    "theta_src_and_weights",
]
