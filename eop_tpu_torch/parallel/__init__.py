"""Data parallelism over processes (counterpart of ``eop_tpu/parallel``):
``dist`` (the process group), ``global_bn`` (BatchNorm over the global
batch) and ``mesh`` (batch sharding, the gradient average, FSDP, sharded
inference)."""

from .global_bn import GlobalBatchNorm2d, convert_global_bn, global_batch_norm
from .mesh import (
    average_gradients,
    place_state,
    shard_batch,
    shard_inference,
    shard_train_step,
    state_bytes,
    state_to_host,
    sync_batch_stats,
)

__all__ = [
    "GlobalBatchNorm2d", "average_gradients", "convert_global_bn",
    "global_batch_norm", "place_state", "shard_batch", "shard_inference",
    "shard_train_step", "state_bytes", "state_to_host", "sync_batch_stats",
]
