"""chimera_tpu_torch — the PyTorch + CUDA port of chimera_tpu for NVIDIA
Hopper GPUs.

It follows ``chimera_tpu``'s module layout and imports no JAX.  It does
what the JAX package does: the hyper-likelihood batch of every kind ('1d',
'approximate', 'marginalized', 'full'), binned or not, on effective or
analysis grids, with every population model and engine, the galaxy-catalog
prior (both completeness models) and the injection selection function;
gradients of every kind, binned or not, with every mass model on the
card as on the CPU (the contract pass's and a sharded batch's excepted),
with the HMC / ChEES samplers and the gradient-free ensemble sampler; distribution over ranks
(``parallel``); and the precompute and run surface: HDF5 I/O of the
reference's files (``data.io``), the pixelization (RING or NESTED) and the
catalog build, chain checkpoints (``inference.checkpoint``), TOML run
configuration (``runconfig``), localization volumes and the utilities.  The
hot loops are hand-written CUDA kernels (``csrc/``): CPU tensors run each
kernel's plain PyTorch version, CUDA tensors the kernel.  Constructors
build on the card unless given ``device="cpu"``.
"""

from chimera_tpu_torch import config  # noqa: F401  (TF32 off, logger)
# models before catalog: models.population imports catalog.empty, which
# imports models.cosmology
from chimera_tpu_torch import models  # noqa: F401, I001
from chimera_tpu_torch import catalog, data, ops  # noqa: F401
from chimera_tpu_torch.catalog import EmptyCatalog
from chimera_tpu_torch.config import logger
from chimera_tpu_torch.data.structs import ThetaInjDet, ThetaPEDet, ThetaSrc
from chimera_tpu_torch.likelihood import (HyperLikelihood, compute_all,
                                          log_hyperlikelihood,
                                          log_hyperlikelihood_batch)
from chimera_tpu_torch.selection import SelectionFunction

__all__ = [
    "catalog",
    "data",
    "models",
    "ops",
    "logger",
    "EmptyCatalog",
    "HyperLikelihood",
    "compute_all",
    "log_hyperlikelihood",
    "log_hyperlikelihood_batch",
    "SelectionFunction",
    "ThetaInjDet",
    "ThetaPEDet",
    "ThetaSrc",
]
