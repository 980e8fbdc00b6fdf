"""Parallelism over processes (counterpart of ``eop_tpu/parallel``):
``dist`` (the process group and the ``(data, space, model)`` layout of
the ranks), ``global_bn`` (BatchNorm over the global batch), ``spatial``
(an image's rows over a space group: halo exchanges and the fence),
``tensor`` (convs' output channels over a model group) and ``mesh`` (batch
sharding, the gradient reductions, FSDP, sharded inference)."""

from .dist import Mesh, make_mesh
from .global_bn import GlobalBatchNorm2d, convert_global_bn, global_batch_norm
from .mesh import (
    average_gradients,
    place_state,
    reduce_gradients,
    shard_batch,
    shard_inference,
    shard_inference_tp,
    shard_train_step,
    state_bytes,
    state_to_host,
    sync_batch_stats,
)
from .spatial import convert_spatial, gather_rows, halo_exchange, row_split
from .tensor import convert_tensor, whole_tensors

__all__ = [
    "GlobalBatchNorm2d", "Mesh", "average_gradients", "convert_global_bn",
    "convert_spatial", "convert_tensor", "gather_rows", "global_batch_norm",
    "halo_exchange", "make_mesh", "place_state", "reduce_gradients",
    "row_split", "shard_batch", "shard_inference", "shard_inference_tp",
    "shard_train_step", "state_bytes", "state_to_host", "sync_batch_stats",
    "whole_tensors",
]
