"""Model summary (counterpart of ``eop_tpu/utils/model_utils.py``'s
``get_model_info``): the parameter count and the multiply-accumulates of
one forward at batch 1."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn


def count_params(model: nn.Module) -> int:
    """Trainable parameters (BatchNorm statistics are buffers, as they are
    ``batch_stats`` in the JAX package, not ``params``)."""
    return sum(p.numel() for p in model.parameters())


def get_model_info(model: nn.Module, tsize: Tuple[int, int]) -> str:
    """``"Params: {:.2f}M, Gflops: {:.2f}"`` (the reference's summary).
    The FLOPs are ``torch.utils.flop_counter``'s count of one eval-mode
    forward of a zero ``[1, 3, *tsize]`` image on the model's device,
    halved to multiply-accumulates as thop counts and ``eop_tpu`` reports
    (XLA's cost analysis, halved)."""
    from torch.utils.flop_counter import FlopCounterMode

    p = next(model.parameters())
    x = torch.zeros((1, 3, *tsize), device=p.device).contiguous(
        memory_format=torch.channels_last)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            model(x)
    finally:
        model.train(was_training)
    macs = counter.get_total_flops() / 2.0
    return "Params: {:.2f}M, Gflops: {:.2f}".format(
        count_params(model) / 1e6, macs / 1e9)
