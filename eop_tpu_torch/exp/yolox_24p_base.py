"""24-point experiment: configuration and factories for the model, the
fused serving function, the optimizer, the LR schedule and the multiscale
preprocess (counterpart of ``eop_tpu/exp/yolox_24p_base.py``).  The
file-backed data loader and the evaluator are not ported yet."""

from __future__ import annotations

import random
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..data.transforms import letterbox_batch_device
from ..eval.postprocess import postprocess_24p_heads
from ..models.yolox import YOLOX, init_weights
from ..utils.device import resolve_device, set_fp32_precision
from .base_exp import BaseExp


class Exp24P(BaseExp):
    def __init__(self):
        super().__init__()
        # ---------------- model config ---------------- #
        self.num_classes = 80
        self.depth = 1.00
        self.width = 1.00
        # ---------------- dataloader config ---------------- #
        self.input_size = (640, 640)
        self.multiscale_range = 5
        self.random_size: Optional[tuple] = None
        # --------------  training config --------------------- #
        self.warmup_epochs = 5
        self.max_epoch = 2000
        self.warmup_lr = 0
        self.basic_lr_per_img = 0.01 / 64.0
        self.scheduler = "yoloxwarmcos"
        self.no_aug_epochs = 100
        self.min_lr_ratio = 0.05
        self.ema = False
        self.ema_decay = 0.9998
        self.L1_epoch = 100        # enable L1 loss for the last N epochs
        self.ckpt_interval = 1     # epochs between ``last_epoch`` saves
        self.weight_decay = 0.0    # the 24p trainer uses plain SGD
        self.momentum = 0.9
        self.print_interval = 10
        self.eval_interval = 10
        self.exp_name = "yolox_24p_base"
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

    # ------------------------------------------------------------------
    # training

    def get_data_loader(self, batch_size, is_distributed=False, rank=0,
                        world_size=1):
        """An iterable of ``(images [B, H, W, 3], labels [B, 50, 51], info,
        ids)`` batches with a length (iterations per epoch) that never runs
        out.  Exp subclasses override this, as exp files do."""
        raise NotImplementedError(
            "the file-backed 24p dataset (data/coco24p.py, samplers, loader) "
            "is not ported yet: ROADMAP.md queue 2, 'Eval and CLIs'; "
            "override get_data_loader in an Exp24P subclass")

    def preprocess(self, inputs: torch.Tensor, targets: torch.Tensor, tsize):
        """Multiscale resize of an NHWC batch to ``tsize``, scaling the
        interleaved 24p coordinates of the label rows with it.  Bilinear,
        antialiased when shrinking, as ``jax.image.resize`` is."""
        scale_y = tsize[0] / self.input_size[0]
        scale_x = tsize[1] / self.input_size[1]
        if scale_x != 1 or scale_y != 1:
            inputs = F.interpolate(
                inputs.permute(0, 3, 1, 2), size=tuple(tsize),
                mode="bilinear", align_corners=False,
                antialias=True).permute(0, 2, 3, 1)
            out = torch.zeros_like(targets)
            out[..., 0:1] = targets[..., 0:1]
            out[..., 1::2] = targets[..., 1::2] * scale_x
            out[..., 2::2] = targets[..., 2::2] * scale_y
            targets = out
        return inputs, targets

    def get_optimizer(self, model, batch_size: int,
                      iters_per_epoch: Optional[int] = None,
                      lr: Optional[float] = None):
        """Plain nesterov SGD over ``model`` at a fixed lr, the reference's
        24p choice.  With ``iters_per_epoch`` the optimizer follows the
        ``self.scheduler`` schedule per iteration."""
        from ..train.optimizer import build_sgd

        if lr is None:
            lr = self.basic_lr_per_img * batch_size
        rate = lr
        if iters_per_epoch is not None:
            sched = self.get_lr_scheduler(lr, iters_per_epoch)
            total = max(iters_per_epoch * self.max_epoch, 1)
            rate = lambda it: sched.update_lr(min(max(it, 0), total))  # noqa: E731
        return build_sgd(model, rate, momentum=self.momentum,
                         weight_decay=self.weight_decay, nesterov=True)

    def get_lr_scheduler(self, lr: float, iters_per_epoch: int):
        from ..train.lr_schedule import LRScheduler

        return LRScheduler(
            self.scheduler, lr, iters_per_epoch, self.max_epoch,
            warmup_epochs=self.warmup_epochs,
            warmup_lr_start=self.warmup_lr,
            no_aug_epochs=self.no_aug_epochs,
            min_lr_ratio=self.min_lr_ratio,
        )

    def random_resize(self, step: int = 0):
        """A training size drawn deterministically from (seed, step)."""
        if self.random_size is None:
            min_size = int(self.input_size[0] / 32) - self.multiscale_range
            max_size = int(self.input_size[0] / 32) + self.multiscale_range
            self.random_size = (min_size, max_size)
        rng = random.Random(((self.seed or 0) * 1_000_003) ^ step)
        size = rng.randint(*self.random_size)
        return (int(32 * size), int(32 * size))
