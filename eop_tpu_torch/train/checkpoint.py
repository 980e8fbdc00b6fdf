"""Checkpoint save and load in the port's own format (counterpart of
``eop_tpu/train/checkpoint.py``): one ``torch.save`` file holding the model,
the optimizer, the EMA, the DWA state, the step and a ``metadata`` dict.
State trained by the JAX package crosses as numpy arrays through
``utils.weights.train_state_from_jax``, not through a checkpoint reader.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import torch

from ..losses import DWAState
from ..parallel.mesh import state_to_host
from ..parallel.tensor import whole_tensors
from .steps import TrainState


def state_to_payload(state: TrainState) -> Dict[str, Any]:
    """The ``TrainState`` as plain containers of whole tensors and numbers.
    Under FSDP the shards are gathered (``parallel.state_to_host``), and
    under tensor parallelism the channel slices
    (``parallel.tensor.whole_tensors``): collectives that every rank joins
    before rank 0 writes; the keys are the model's attribute names either
    way, so the file loads strictly into a model on one device."""
    model = state.model
    payload = state_to_host({
        "model": model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "ema_params": state.ema_params,
        "ema_batch_stats": state.ema_batch_stats,
        "dwa": state.dwa._asdict() if state.dwa is not None else None,
        "step": int(state.step),
    })
    if getattr(model, "tensor_parallel", None) is None:
        return payload
    for field in ("model", "ema_params", "ema_batch_stats"):
        payload[field] = whole_tensors(payload[field], model)
    # the momentum, numbered in parameter-group order
    names = {id(p): n for n, p in model.named_parameters()}
    order = [names[id(p)] for g in state.optimizer.param_groups
             for p in g["params"]]
    momentum = {order[i]: s["momentum_buffer"]
                for i, s in payload["optimizer"]["state"].items()
                if s.get("momentum_buffer") is not None}
    whole = whole_tensors(momentum, model)
    for i, s in payload["optimizer"]["state"].items():
        if order[i] in whole:
            s["momentum_buffer"] = whole[order[i]]
    return payload


def _ckpt_path(save_dir: str, name: str) -> str:
    return os.path.abspath(os.path.join(save_dir, f"{name}_ckpt.pth"))


def save_checkpoint(state, is_best: bool, save_dir: str,
                    model_name: str, metadata: Optional[Dict] = None) -> str:
    """Save ``<save_dir>/<model_name>_ckpt.pth`` (and a ``best_ckpt.pth``
    copy) of a ``TrainState``, or of its :func:`state_to_payload` taken on
    every rank beforehand (several processes: rank 0 writes).  The file is
    written beside the live checkpoint and renamed over it, so a kill
    during a save never leaves the run without a restorable checkpoint."""
    os.makedirs(save_dir, exist_ok=True)
    path = _ckpt_path(save_dir, model_name)
    payload = {"state": state_to_payload(state)
               if isinstance(state, TrainState) else state}
    if metadata:
        payload["metadata"] = dict(metadata)
    tmp = path + ".saving"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if is_best:
        best = _ckpt_path(save_dir, "best")
        shutil.copyfile(path, best + ".saving")
        os.replace(best + ".saving", best)
    return path


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    """Load a checkpoint file -> ``{"state": ..., "metadata": ...}``."""
    return torch.load(path, map_location=map_location, weights_only=True)


def _merge_tensors(dst: Dict[str, torch.Tensor], src, prefix: str, report):
    for key, leaf in dst.items():
        cand = (src or {}).get(key)
        name = f"{prefix}/{key}"
        if cand is None:
            report["skipped"].append((name, None, tuple(leaf.shape)))
        elif tuple(cand.shape) != tuple(leaf.shape):
            report["skipped"].append((name, tuple(cand.shape),
                                      tuple(leaf.shape)))
        else:
            with torch.no_grad():
                leaf.copy_(cand)
            report["loaded"].append(name)


def load_ckpt_partial(state: TrainState, ckpt_state: Dict[str, Any]):
    """Shape-checked partial overlay of a checkpoint's ``state`` onto
    ``state``, in place: a key that is missing or whose shape differs keeps
    the value it has.  Returns (state, report) with ``report["loaded"]`` and
    ``report["skipped"]`` (name, checkpoint shape, own shape)."""
    report = {"loaded": [], "skipped": []}
    _merge_tensors(state.model.state_dict(), ckpt_state.get("model"),
                   "model", report)
    # momentum buffers: the optimizer's state_dict numbers the parameters in
    # group order, as this optimizer does
    opt = ckpt_state.get("optimizer") or {}
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    for i, p in enumerate(params):
        buf = (opt.get("state") or {}).get(i, {}).get("momentum_buffer")
        name = f"optimizer/{i}"
        if buf is None:
            report["skipped"].append((name, None, tuple(p.shape)))
        elif tuple(buf.shape) != tuple(p.shape):
            report["skipped"].append((name, tuple(buf.shape), tuple(p.shape)))
        else:
            state.optimizer.state[p]["momentum_buffer"] = buf.to(
                p.device, p.dtype).clone()
            report["loaded"].append(name)
    for field in ("ema_params", "ema_batch_stats"):
        if getattr(state, field) is not None:
            _merge_tensors(getattr(state, field), ckpt_state.get(field),
                           field, report)
    if state.dwa is not None and ckpt_state.get("dwa"):
        dwa = state.dwa._asdict()
        _merge_tensors(dwa, ckpt_state["dwa"], "dwa", report)
        state.dwa = DWAState(**dwa)
    if "step" in ckpt_state:
        state.step = int(ckpt_state["step"])
    return state, report
