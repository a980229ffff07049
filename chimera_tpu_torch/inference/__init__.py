"""Samplers of the hyper-posterior (counterpart of
``chimera_tpu/inference``): HMC and ChEES-HMC on the batched log
hyper-likelihood and its gradient, the affine-invariant ensemble sampler
(no gradient), chain diagnostics, and HDF5 checkpoints of chains and HMC
runs (h5py imported at first use)."""

from chimera_tpu_torch.inference.checkpoint import (latest_chain_file,
                                                    load_chain, load_hmc,
                                                    load_state,
                                                    next_chain_file,
                                                    save_chain, save_hmc)
from chimera_tpu_torch.inference.chees import (run_chees,
                                               sample_hyperposterior_chees)
from chimera_tpu_torch.inference.diagnostics import effective_sample_size, rhat
from chimera_tpu_torch.inference.ensemble import (EnsembleState, init_state,
                                                  initialize_walkers,
                                                  make_vector_log_prob, run,
                                                  step)
from chimera_tpu_torch.inference.hmc import (AdaptState, HMCState, Transform,
                                             continue_hmc,
                                             make_transformed_log_prob,
                                             make_transformed_log_prob_batch,
                                             run_hmc, sample_hyperposterior)

__all__ = [
    "AdaptState", "EnsembleState", "HMCState", "Transform", "continue_hmc",
    "effective_sample_size", "init_state", "initialize_walkers",
    "make_transformed_log_prob", "make_transformed_log_prob_batch",
    "make_vector_log_prob", "rhat", "run", "run_chees", "run_hmc",
    "sample_hyperposterior", "sample_hyperposterior_chees", "step",
    "latest_chain_file", "load_chain", "load_hmc", "load_state",
    "next_chain_file", "save_chain", "save_hmc",
]
