"""chimera_tpu_torch — the PyTorch + CUDA port of chimera_tpu for NVIDIA
Hopper GPUs.

It follows ``chimera_tpu``'s module layout and imports no JAX.  Ported so
far: the hyper-likelihood batch of the kinds '1d', 'approximate' and
'marginalized', binned or not, on effective or analysis grids (the
reference's defaults included), its population models, galaxy-catalog
prior, selection function and mock data, the gradient of the spectral
kind and the HMC / ChEES samplers; the hot loops are hand-written CUDA
kernels (``csrc/``).  CPU tensors run each kernel's plain PyTorch version,
CUDA tensors the kernel.
"""

from chimera_tpu_torch import config  # noqa: F401  (TF32 off, logger)
# models before catalog: models.population imports catalog.empty, which
# imports models.cosmology
from chimera_tpu_torch import models  # noqa: F401, I001
from chimera_tpu_torch.catalog import EmptyCatalog
from chimera_tpu_torch.data.structs import ThetaInjDet, ThetaPEDet, ThetaSrc
from chimera_tpu_torch.likelihood import HyperLikelihood
from chimera_tpu_torch.selection import SelectionFunction

__all__ = [
    "EmptyCatalog",
    "HyperLikelihood",
    "SelectionFunction",
    "ThetaInjDet",
    "ThetaPEDet",
    "ThetaSrc",
]
