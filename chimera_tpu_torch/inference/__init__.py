"""Samplers of the hyper-posterior (counterpart of
``chimera_tpu/inference``): HMC and ChEES-HMC on the batched log
hyper-likelihood and its gradient, and chain diagnostics."""

from chimera_tpu_torch.inference.chees import (run_chees,
                                               sample_hyperposterior_chees)
from chimera_tpu_torch.inference.diagnostics import effective_sample_size, rhat
from chimera_tpu_torch.inference.hmc import (AdaptState, HMCState, Transform,
                                             continue_hmc,
                                             make_transformed_log_prob,
                                             make_transformed_log_prob_batch,
                                             run_hmc, sample_hyperposterior)

__all__ = [
    "AdaptState", "HMCState", "Transform", "continue_hmc",
    "effective_sample_size", "make_transformed_log_prob",
    "make_transformed_log_prob_batch", "rhat", "run_chees", "run_hmc",
    "sample_hyperposterior", "sample_hyperposterior_chees",
]
