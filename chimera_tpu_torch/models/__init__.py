"""Population models: cosmology, mass, rate and the population wrapper."""

from chimera_tpu_torch.models.cosmology import FLRW, MGFLRW, angular_distance
from chimera_tpu_torch.models.mass import (
    BaseMassModel,
    BrokenPowerLaw,
    PowerLawPeak,
    PowerLawSpline,
    PowerLawTwoPeaks,
    TruncatedPowerLaw,
    p_m1m2,
    pdf_joint_and_marginals,
)
from chimera_tpu_torch.models.population import (
    Population,
    compute_z_grids,
    n_cbc_1yr,
    p_cbc,
    pop_rate_det,
    theta_det_to_src,
    theta_src_and_weights,
)
from chimera_tpu_torch.models.rate import (
    BaseRateModel,
    MadauDickinsonRate,
    PowerLawRate,
    TruncatedMadauDickinsonRate,
    TruncatedPowerLawRate,
    merger_rate,
)

__all__ = [
    "FLRW",
    "MGFLRW",
    "angular_distance",
    "BaseMassModel",
    "BrokenPowerLaw",
    "PowerLawPeak",
    "PowerLawSpline",
    "PowerLawTwoPeaks",
    "TruncatedPowerLaw",
    "p_m1m2",
    "pdf_joint_and_marginals",
    "BaseRateModel",
    "MadauDickinsonRate",
    "PowerLawRate",
    "TruncatedMadauDickinsonRate",
    "TruncatedPowerLawRate",
    "merger_rate",
    "Population",
    "compute_z_grids",
    "n_cbc_1yr",
    "p_cbc",
    "pop_rate_det",
    "theta_det_to_src",
    "theta_src_and_weights",
]
