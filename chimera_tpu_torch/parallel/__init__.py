"""Distribution over ranks on ``torch.distributed``: the (params x data)
grid of ranks, padding, sharding and the batched evaluation (counterpart
of ``chimera_tpu/parallel``)."""

from chimera_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    PARAMS_AXIS,
    Mesh,
    ShardedHyperLikelihood,
    init_distributed,
    log_like_batch_sharded,
    make_mesh,
    pad_events,
    pad_injections,
    shard_hyperlikelihood,
)

__all__ = [
    "DATA_AXIS",
    "init_distributed",
    "Mesh",
    "PARAMS_AXIS",
    "log_like_batch_sharded",
    "make_mesh",
    "pad_events",
    "pad_injections",
    "shard_hyperlikelihood",
    "ShardedHyperLikelihood",
]
