"""Runtime configuration of the PyTorch port: dtype policy, matmul precision,
logging.

Counterpart of ``chimera_tpu/config.py``.  The precision policy:

* float64 on the CPU — the golden tests hold the port to the JAX package's
  float64 results;
* float32 on CUDA — the hot path, held to 1e-6 relative of float64 on the
  log hyper-likelihood.

TF32 is disabled for float32 matmuls and convolutions: the Chebyshev fits are
small matmuls whose coefficients feed every per-sample evaluation, and a
reduced-precision product there corrupts results on the card while every CPU
test still passes (the JAX package pins ``Precision.HIGHEST`` for the same
reason, ``chimera_tpu/ops/chebyshev.py:62-66``).
"""

from __future__ import annotations

import logging
import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

logger = logging.getLogger("chimera_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(
        logging.Formatter("%(asctime)s %(name)s [%(levelname)s] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(os.environ.get("CHIMERA_TPU_LOGLEVEL", "INFO"))


def resolve_device(device) -> torch.device:
    """The device a constructor builds on: the one asked for, else the CUDA
    card.  With no card and no device asked for it raises rather than fall
    back to the CPU; pass ``device="cpu"`` to build there."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port builds on the card by default; pass "
            "device='cpu' to build on the CPU")
    return torch.device("cuda")


def default_dtype(device) -> torch.dtype:
    """float64 on the CPU (golden tests), float32 on an accelerator."""
    return torch.float64 if torch.device(device).type == "cpu" else torch.float32
