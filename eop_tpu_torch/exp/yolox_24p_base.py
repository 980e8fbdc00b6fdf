"""24-point experiment: model factory and the fused serving function
(counterpart of ``eop_tpu/exp/yolox_24p_base.py``; serving half)."""

from __future__ import annotations

import numpy as np
import torch

from ..data.transforms import letterbox_batch_device
from ..eval.postprocess import postprocess_24p_heads
from ..models.yolox import YOLOX, init_weights
from ..utils.device import resolve_device, set_fp32_precision
from .base_exp import BaseExp


class Exp24P(BaseExp):
    def __init__(self):
        # ---------------- model config ---------------- #
        self.num_classes = 80
        self.depth = 1.00
        self.width = 1.00
        # -----------------  testing config ------------------ #
        self.test_size = (640, 640)
        self.test_conf = 0.01
        self.nmsthre = 0.3
        self.reference_parity = False  # replicate the theta*cos NMS quirk
        # "exact" = stationarity-checked NMS fixpoint (greedy-exact)
        self.nms_mode = "exact"

    def get_model(self, device=None, seed: int = 0):
        """26-channel-reg YOLOX in eval mode on ``device`` (the card unless
        ``"cpu"`` is asked for), channels_last, with seeded random weights;
        load a state_dict over them for trained weights."""
        device = resolve_device(device)
        model = YOLOX(depth=self.depth, width=self.width,
                      num_classes=self.num_classes, reg_dim=26)
        init_weights(model, seed)
        return model.to(device, memory_format=torch.channels_last).eval()

    def get_serving_fn(self, model, src_hw, device=None):
        """One call, uint8 ``[B, *src_hw, 3]`` -> ``Detections`` on
        ``device``: letterbox to ``test_size``, forward, decode, NMS.

        It enters ``torch.inference_mode`` itself, because the batcher calls
        it from its own thread and grad mode is thread-local.  On the card
        it turns TF32 off: the fp32 path is full fp32.
        """
        device = resolve_device(device)
        set_fp32_precision(device)
        src_hw = tuple(int(v) for v in src_hw)
        test_size = tuple(self.test_size)
        nms_iters = self._nms_iters()

        def serve(raw_uint8):
            with torch.inference_mode():
                x = torch.as_tensor(np.asarray(raw_uint8)).to(device)
                imgs, _ = letterbox_batch_device(x.float(), src_hw, test_size)
                # NHWC storage viewed as NCHW: channels_last for the model
                head_outs, _ = model(imgs.permute(0, 3, 1, 2))
                return postprocess_24p_heads(
                    head_outs,
                    num_classes=self.num_classes,
                    conf_thre=self.test_conf,
                    nms_thre=self.nmsthre,
                    reference_parity=self.reference_parity,
                    nms_fixpoint_iters=nms_iters,
                )

        return serve
