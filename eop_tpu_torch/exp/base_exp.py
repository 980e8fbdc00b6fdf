"""Experiment config base (counterpart of ``eop_tpu/exp/base_exp.py``): the
config object is also the factory, with CLI overrides through
``merge(["key", "value", ...])`` and type coercion."""

from __future__ import annotations

import ast

import numpy as np
import torch

from ..data.transforms import letterbox_batch_device
from ..utils.device import resolve_device


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

    def get_serving_fn(self, model, src_hw, device=None):
        """One call, uint8 ``[B, *src_hw, 3]`` -> ``Detections`` on
        ``device``: letterbox to ``test_size`` on the device in fp32, then
        the family's ``get_infer_fn``: forward, decode and NMS."""
        device = resolve_device(device)
        infer = self.get_infer_fn(model, device)
        src_hw = tuple(int(v) for v in src_hw)
        test_size = tuple(self.test_size)

        def serve(raw_uint8):
            with torch.inference_mode():
                x = torch.as_tensor(np.asarray(raw_uint8)).to(device)
                imgs, _ = letterbox_batch_device(x.float(), src_hw, test_size)
                return infer(imgs)

        return serve

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
