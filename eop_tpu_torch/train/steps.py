"""The training step: forward, SimOTA, loss, backward, optimizer and EMA
(counterpart of ``eop_tpu/train/steps.py``).

JAX jits one pure function over an immutable ``TrainState``; the port's
state holds the live ``nn.Module`` and optimizer and the step updates them
in place.  Nothing in the step fetches a value to the host: the metrics come
back as tensors on the model's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from ..losses import (
    DWAState,
    Loss24PConfig,
    YoloxLossConfig,
    loss_24p,
    yolox_losses,
)
from ..models.yolox import training_outputs
from ..utils.device import set_fp32_precision
from .ema import ema_update
from .optimizer import SGD


@dataclass
class TrainState:
    model: nn.Module
    optimizer: SGD
    step: int = 0
    # The EMA averages every floating state_dict entry, BatchNorm running
    # statistics included, so eval with EMA pairs EMA parameters with EMA
    # statistics.  Keys are the model's state_dict keys.
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    ema_batch_stats: Optional[Dict[str, torch.Tensor]] = None
    dwa: Optional[DWAState] = None


def batch_stats(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The floating buffers (BatchNorm running mean and variance; not
    ``num_batches_tracked``) by state_dict key."""
    return {k: v for k, v in model.named_buffers() if v.is_floating_point()}


def eval_weights(state: TrainState, use_ema: bool) -> Dict[str, torch.Tensor]:
    """The state_dict an evaluation runs: the model's, with the EMA
    parameters and BatchNorm statistics laid over it where ``use_ema`` and
    the state has them."""
    weights = state.model.state_dict()
    if use_ema and state.ema_params is not None:
        weights = {**weights, **state.ema_params,
                   **(state.ema_batch_stats or {})}
    return weights


def create_train_state(model: nn.Module, optimizer: SGD,
                       use_ema: bool = True,
                       with_dwa: bool = False) -> TrainState:
    device = next(model.parameters()).device
    copy = lambda d: {k: v.detach().clone() for k, v in d.items()}  # noqa: E731
    return TrainState(
        model=model,
        optimizer=optimizer,
        step=0,
        ema_params=copy(dict(model.named_parameters())) if use_ema else None,
        ema_batch_stats=copy(batch_stats(model)) if use_ema else None,
        dwa=DWAState.init(device) if with_dwa else None,
    )


def _make_step(micro: Callable, ema_decay: Optional[float],
               accum_steps: int, mark: Callable) -> Callable:
    """``step(state, images, labels)`` around one family's ``micro(state,
    images, labels, scale) -> metrics``: zero the gradients, run the
    micro-batches, set the scheduled rate, step the optimizer, then the
    EMA."""

    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        model, optimizer = state.model, state.optimizer
        set_fp32_precision(images.device)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        b = images.shape[0]
        if b % accum_steps:
            raise ValueError(
                f"batch {b} does not split into accum={accum_steps}")
        if accum_steps > 1:
            micros = [micro(state, im, lb, 1.0 / accum_steps)
                      for im, lb in zip(images.chunk(accum_steps),
                                        labels.chunk(accum_steps))]
            metrics = {k: torch.stack([m[k] for m in micros]).float().mean(0)
                       for k in micros[0]}
            metrics["cand_dropped"] = metrics["cand_dropped"] * accum_steps
        else:
            metrics = micro(state, images, labels, 1.0)
        optimizer.set_lr(state.step)
        optimizer.step()
        state.step += 1
        if state.ema_params is not None and ema_decay is not None:
            ema_update(state.ema_params, dict(model.named_parameters()),
                       state.step, ema_decay)
            if state.ema_batch_stats is not None:
                ema_update(state.ema_batch_stats, batch_stats(model),
                           state.step, ema_decay)
        mark("optimizer")
        mark("step", metrics)
        return state, metrics

    return step


def _marker(hook: Optional[Callable]) -> Callable:
    return hook if hook is not None else (lambda name, metrics=None: None)


def make_train_step_bbox(config: YoloxLossConfig,
                         ema_decay: Optional[float] = 0.9998,
                         accum_steps: int = 1,
                         hook: Optional[Callable] = None,
                         group=None) -> Callable:
    """Train step for the bbox family: ``step(state, images, labels) ->
    (state, metrics)`` with images ``[B, H, W, 3]`` float in 0..255 and
    labels ``[B, M, 5]`` (cls, cx, cy, w, h), both on the model's device.
    ``config.use_l1`` changes what the step computes, so a trainer holds one
    step for each value.  ``accum_steps``, ``hook`` and ``group`` as in
    :func:`make_train_step_24p` (BatchNorm statistics advance per
    micro-batch)."""
    mark = _marker(hook)

    def micro(state: TrainState, images, labels, scale: float):
        mark("start")
        head_outs, _ = state.model(images.permute(0, 3, 1, 2))
        mark("forward")
        decoded, origin_reg, grids, strides = training_outputs(
            head_outs, reg_dim=4)
        total, aux = yolox_losses(decoded, origin_reg, labels, grids,
                                  strides, config, group)
        mark("loss")
        (total * scale if scale != 1.0 else total).backward()
        mark("backward")
        return {
            "total_loss": total.detach(),
            "iou_loss": aux.loss_iou.detach(),
            "conf_loss": aux.loss_obj.detach(),
            "cls_loss": aux.loss_cls.detach(),
            "l1_loss": aux.loss_l1.detach(),
            "num_fg": aux.num_fg_per_gt,
            "cand_dropped": aux.cand_dropped,
        }

    return _make_step(micro, ema_decay, accum_steps, mark)


def make_train_step_24p(config: Loss24PConfig,
                        ema_decay: Optional[float] = None,
                        accum_steps: int = 1,
                        hook: Optional[Callable] = None,
                        group=None) -> Callable:
    """Train step for the 24-point detector: ``step(state, images, labels)
    -> (state, metrics)`` with images ``[B, H, W, 3]`` float in 0..255 and
    labels ``[B, M, 51]``, both on the model's device.

    ``accum_steps > 1`` runs that many micro-batches before one optimizer
    step: BatchNorm statistics and the DWA state advance per micro-batch,
    gradients are averaged, optimizer and EMA apply once; metrics come back
    micro-averaged except ``cand_dropped``, which is summed (it is a count).

    ``hook`` is the step's one instrumentation seam (timing with CUDA
    events, counters, tests).  Where given, ``hook(name)`` is called as each
    phase of a micro-batch has been enqueued (``"start"``, ``"forward"``,
    ``"loss"``, ``"backward"``), ``hook("optimizer")`` once per step, and
    last ``hook("step", metrics)`` with the metrics the step returns: device
    tensors, so a hook that only stores them costs no synchronisation.

    ``group`` (a process group; ``None``: this process alone): the images
    are this rank's rows of a global batch (``parallel.shard_batch``), and
    the loss, ``num_fg``, the DWA state and the metrics are the global
    batch's (``cand_dropped`` summed over the ranks), as in ``eop_tpu``'s
    sharded step; with the model's BatchNorm global too
    (``parallel.convert_global_bn``) and the step wrapped by
    ``parallel.shard_train_step``, each micro-batch is the global one's
    share, as in ``_accum_scan``.
    """
    mark = _marker(hook)

    def micro(state: TrainState, images, labels, scale: float):
        mark("start")
        head_outs, _ = state.model(images.permute(0, 3, 1, 2))
        mark("forward")
        decoded, origin_reg, grids, strides = training_outputs(
            head_outs, reg_dim=26)
        total, aux, new_dwa = loss_24p(decoded, origin_reg, labels, grids,
                                       strides, state.dwa, config, group)
        mark("loss")
        (total * scale if scale != 1.0 else total).backward()
        mark("backward")
        state.dwa = new_dwa
        return {
            "total_loss": total.detach(),
            "conf_loss": aux.loss_obj.detach(),
            "cls_loss": aux.loss_cls.detach(),
            "l1_loss": aux.loss_l1.detach(),
            "num_fg": aux.num_fg_per_gt,
            "cand_dropped": aux.cand_dropped,
            # per-step observability: the 24 per-radius IoU losses and the
            # 26 DWA weights
            "iou_losses_24": aux.loss_iou.detach(),
            "dwa_reg_w": aux.reg_w,
            "dwa_obj_w": aux.obj_w,
            "dwa_cls_w": aux.cls_w,
        }

    return _make_step(micro, ema_decay, accum_steps, mark)
