"""Experiment config base (counterpart of ``eop_tpu/exp/base_exp.py``): the
config object is also the factory, with CLI overrides through
``merge(["key", "value", ...])`` and type coercion; the inference, serving
and int8 PTQ entry points both families share."""

from __future__ import annotations

import ast
import copy

import numpy as np
import torch
import torch.nn as nn

from ..data.transforms import letterbox_batch_device
from ..eval.postprocess import Detections
from ..utils.device import resolve_device, set_fp32_precision


class ServingModule(nn.Module):
    """uint8 ``[B, *src_hw, 3]`` on the model's device -> ``(rows,
    valid)``: the device letterbox to ``test_size`` in fp32, the forward,
    the family's decode and NMS (``postprocess(head_outs) ->
    Detections``).  What :meth:`BaseExp.get_serving_fn` calls and
    ``utils/serving_export.py`` exports, so both run one code."""

    def __init__(self, model: nn.Module, postprocess, src_hw, test_size):
        super().__init__()
        self.model = model
        self.postprocess = postprocess
        self.src_hw = tuple(int(v) for v in src_hw)
        self.test_size = tuple(int(v) for v in test_size)

    def forward(self, raw: torch.Tensor):
        imgs, _ = letterbox_batch_device(raw.float(), self.src_hw,
                                         self.test_size)
        head_outs, _ = self.model(imgs.permute(0, 3, 1, 2))
        det = self.postprocess(head_outs)
        return det.rows, det.valid


class BaseExp:
    def __init__(self):
        self.seed = None
        self.output_dir = "./eop_outputs"
        self.print_interval = 100
        self.eval_interval = 10

    def _nms_iters(self):
        """``nms_mode`` -> a ``_suppress`` fixpoint argument: ``"exact"``
        -> the stationarity-checked loop; an int -> that fixed budget;
        ``"budget"`` -> 64."""
        mode = getattr(self, "nms_mode", "exact")
        if isinstance(mode, int) and not isinstance(mode, bool):
            return mode
        return "exact" if mode == "exact" else 64

    def _inference_model(self, model, quant_scales, quant_min_channels):
        """``model``, or its int8 copy where ``quant_scales`` is given."""
        if not quant_scales:
            return model
        from ..ops.quant import quantize_model

        return quantize_model(model, quant_scales, quant_min_channels)

    def get_infer_fn(self, model, device=None, quant_scales=None,
                     quant_min_channels=64):
        """One call, a letterboxed NHWC batch ``[B, *test_size, 3]`` (float
        or uint8, on the host or the card) -> ``Detections`` on ``device``:
        forward, then the family's decode and NMS (``_postprocess``).

        It enters ``torch.inference_mode`` itself, because the batcher calls
        it from its own thread and grad mode is thread-local.  The batch
        goes in as fp32 and the model casts it to its compute dtype, as
        ``eop_tpu`` does.  On the card it turns TF32 off: the fp32 path is
        full fp32.  ``quant_scales`` (from :meth:`quantize_for_inference`)
        runs the eligible convs in int8 (``ops/quant.py``) on a copy of
        ``model``.
        """
        device = resolve_device(device)
        set_fp32_precision(device)
        model = self._inference_model(model, quant_scales,
                                      quant_min_channels)
        postprocess = self._postprocess

        def infer(imgs):
            with torch.inference_mode():
                x = torch.as_tensor(imgs).to(device, non_blocking=True)
                # NHWC storage viewed as NCHW: channels_last for the model
                head_outs, _ = model(x.float().permute(0, 3, 1, 2))
                return postprocess(head_outs)

        return infer

    def get_sharded_infer_fn(self, model, device=None, group=None,
                             quant_scales=None, quant_min_channels=64,
                             mesh=None):
        """:meth:`get_infer_fn` run data-parallel over ``group`` (the
        default process group where ``None``): every rank calls it with
        the same batch, computes its ``B / world`` rows and gets every
        row's detections back (``parallel.shard_inference``).  The
        counterpart of ``eop_tpu``'s ``get_sharded_infer_fn`` over a
        mesh's data axis.  With ``mesh`` (``parallel.dist.make_mesh``) the
        batch splits over its data group, and where it has a space group
        each rank passes its height rows: ``model`` is put under that
        group in place (``parallel.spatial.convert_spatial``), as
        ``eop_tpu``'s over a ``(data, space)`` mesh."""
        from ..parallel.mesh import shard_inference

        space = None
        if mesh is not None:
            group, space = mesh.data, mesh.space
            if space is not None:
                from ..parallel.spatial import convert_spatial

                convert_spatial(model, space)
        elif group is None:
            import torch.distributed as dist

            group = dist.group.WORLD if dist.is_initialized() else None
        return shard_inference(
            self.get_infer_fn(model, device, quant_scales,
                              quant_min_channels), group, space)

    def get_tp_infer_fn(self, model, mesh, device=None):
        """:meth:`get_infer_fn` tensor-parallel over ``mesh``'s model group
        (``parallel.shard_inference_tp``): ``model`` keeps this rank's
        slices of the qualifying convs' channels, in place, and the batch
        splits over the data group as :meth:`get_sharded_infer_fn`
        splits it.  Every rank calls it with the same batch."""
        from ..parallel.mesh import shard_inference_tp

        return shard_inference_tp(self.get_infer_fn(model, device), model,
                                  mesh)

    def get_serving_module(self, model, src_hw, device=None,
                           quant_scales=None, quant_min_channels=64):
        """The :class:`ServingModule` of ``model`` (its int8 copy where
        ``quant_scales`` is given) for uint8 ``[B, *src_hw, 3]``; TF32 off
        on the card."""
        set_fp32_precision(resolve_device(device))
        return ServingModule(
            self._inference_model(model, quant_scales, quant_min_channels),
            self._postprocess, src_hw, self.test_size)

    def get_serving_fn(self, model, src_hw, device=None, quant_scales=None,
                       quant_min_channels=64):
        """One call, uint8 ``[B, *src_hw, 3]`` -> ``Detections`` on
        ``device``: letterbox to ``test_size`` on the device in fp32, then
        forward, decode and NMS (:meth:`get_serving_module`), int8 where
        ``quant_scales`` is given."""
        device = resolve_device(device)
        module = self.get_serving_module(model, src_hw, device, quant_scales,
                                         quant_min_channels)

        def serve(raw_uint8):
            with torch.inference_mode():
                x = torch.as_tensor(np.asarray(raw_uint8)).to(device)
                return Detections(*module(x))

        return serve

    def quantize_for_inference(self, model, calib_batches, min_channels=64):
        """int8 PTQ deployment state (``eop_tpu``'s
        ``quantize_for_inference``): a copy of ``model`` with every
        BaseConv's BatchNorm folded into its conv
        (``utils/model_utils.py::fuse_conv_bn``), then the activation
        scales calibrated on ``calib_batches`` (preprocessed NHWC batches,
        uint8 or float) with the observation gate at ``max(1, min_channels
        // 4)``, as ``eop_tpu`` observes, TF32 off on the card.  Returns
        ``(deploy_model, act_scales)``: pass both to :meth:`get_infer_fn` /
        :meth:`get_serving_fn`."""
        from ..ops import quant
        from ..utils.model_utils import fuse_conv_bn

        deploy = fuse_conv_bn(copy.deepcopy(model).eval())
        device = next(deploy.parameters()).device
        # observe the fp32 path the served program runs (TF32 off)
        set_fp32_precision(device)
        observe_min = max(1, min_channels // 4)

        def observe(batch):
            with torch.inference_mode(), quant.observing(
                    deploy, observe_min) as stats:
                x = torch.as_tensor(batch).to(device)
                deploy(x.float().permute(0, 3, 1, 2))
            return stats

        return deploy, quant.calibrate_act_scales(observe, calib_batches)

    def get_quant_infer_fn(self, model, calib_batches, min_channels=64):
        """int8 PTQ inference (forward, decode and NMS with the eligible
        convs in int8) on the device ``model``'s weights are on: returns
        ``(infer_fn, act_scales)`` (``eop_tpu``'s ``get_quant_infer_fn``)."""
        deploy, scales = self.quantize_for_inference(model, calib_batches,
                                                     min_channels)
        device = next(deploy.parameters()).device
        return self.get_infer_fn(deploy, device, quant_scales=scales,
                                 quant_min_channels=min_channels), scales

    def merge(self, cfg_list):
        """Override attributes from alternating key/value strings.  An
        unknown key raises (the JAX exp skips it silently)."""
        if len(cfg_list) % 2:
            raise ValueError(f"overrides come in key value pairs: {cfg_list}")
        for k, v in zip(cfg_list[0::2], cfg_list[1::2]):
            if not hasattr(self, k):
                raise KeyError(f"unknown exp attribute {k!r}")
            src_value = getattr(self, k)
            src_type = type(src_value)
            if src_value is None and isinstance(v, str):
                # None-default fields (seed, data_dir, ...): a literal where
                # the text is one, else the text itself
                try:
                    v = ast.literal_eval(v)
                except (ValueError, SyntaxError):
                    pass
            elif src_type != type(v):
                if src_type in (tuple, list, dict, bool):
                    # parse the literal, then cast (tuple("(1,2)") would
                    # split characters)
                    v = src_type(ast.literal_eval(v))
                else:
                    try:
                        v = src_type(v)
                    except (TypeError, ValueError):
                        v = ast.literal_eval(v)
            setattr(self, k, v)
