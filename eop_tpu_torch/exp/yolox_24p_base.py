"""24-point experiment: configuration and factories for the model, the
fused serving and inference functions, the file-backed data loaders, the
COCO-24p evaluator, the optimizer, the LR schedule and the multiscale
preprocess (counterpart of ``eop_tpu/exp/yolox_24p_base.py``)."""

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

# compute_dtype -> the model's compute dtype (the kernels take these two)
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Exp24P(BaseExp):
    def __init__(self):
        super().__init__()
        # ---------------- model config ---------------- #
        self.num_classes = 80
        self.depth = 1.00
        self.width = 1.00
        self.act = "silu"          # silu | relu | lrelu
        # ---------------- dataloader config ---------------- #
        self.data_num_workers = 8
        self.input_size = (640, 640)
        self.multiscale_range = 5
        self.random_size: Optional[tuple] = None
        self.data_dir = None       # images directory
        self.label_dir = None      # 24p txt labels directory
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
        # "bfloat16": fp32 parameters, BN statistics, optimizer and EMA,
        # bf16 convs and activations (flax's dtype semantics)
        self.compute_dtype = "float32"
        # gradient checkpointing of the backbone + neck in training steps
        self.remat = False
        # eop_tpu's TPU MXU packed layout; it changes no result, so the port
        # reads neither (ROADMAP.md queue 1 item 13)
        self.packed_early = "auto"
        self.packed_infer_max_batch = 64

    def get_model(self, device=None, seed: int = 0):
        """26-channel-reg YOLOX in eval mode on ``device`` (the card unless
        ``"cpu"`` is asked for), channels_last, with seeded random fp32
        weights, computing in ``compute_dtype`` and checkpointing its
        backbone + neck in training where ``remat``; load a state_dict over
        them for trained weights."""
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {self.compute_dtype!r}: the port "
                             f"computes in {sorted(COMPUTE_DTYPES)}")
        device = resolve_device(device)
        model = YOLOX(depth=self.depth, width=self.width,
                      num_classes=self.num_classes, reg_dim=26, act=self.act,
                      dtype=COMPUTE_DTYPES[self.compute_dtype],
                      remat=bool(self.remat))
        init_weights(model, seed)
        return model.to(device, memory_format=torch.channels_last).eval()

    def get_infer_fn(self, model, device=None):
        """One call, a letterboxed NHWC batch ``[B, *test_size, 3]`` (float
        or uint8, on the host or the card) -> ``Detections`` on ``device``:
        forward, decode, NMS.

        It enters ``torch.inference_mode`` itself, because the batcher calls
        it from its own thread and grad mode is thread-local.  The batch
        goes in as fp32 and the model casts it to its compute dtype, as
        ``eop_tpu`` does.  On the card it turns TF32 off: the fp32 path is
        full fp32.
        """
        device = resolve_device(device)
        set_fp32_precision(device)
        nms_iters = self._nms_iters()

        def infer(imgs):
            with torch.inference_mode():
                x = torch.as_tensor(imgs).to(device, non_blocking=True)
                # NHWC storage viewed as NCHW: channels_last for the model
                head_outs, _ = model(x.float().permute(0, 3, 1, 2))
                return postprocess_24p_heads(
                    head_outs,
                    num_classes=self.num_classes,
                    conf_thre=self.test_conf,
                    nms_thre=self.nmsthre,
                    reference_parity=self.reference_parity,
                    nms_fixpoint_iters=nms_iters,
                )

        return infer

    def get_serving_fn(self, model, src_hw, device=None):
        """One call, uint8 ``[B, *src_hw, 3]`` -> ``Detections`` on
        ``device``: letterbox to ``test_size`` on the device in fp32, then
        :meth:`get_infer_fn`'s forward, decode and NMS."""
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

    def get_data_input(self, img_path: str):
        """Letterbox one image file for inference: (float32 ``[1,
        *test_size, 3]``, ratio, the raw BGR image)."""
        from ..data.augment import preproc
        from ..data.image_io import imread

        img = imread(img_path)
        padded, r = preproc(img, self.test_size)
        return padded[None], r, img

    # ------------------------------------------------------------------
    # evaluation

    def get_eval_loader(self, batch_size):
        """Every image of ``data_dir`` in order, letterboxed to
        ``test_size``, in batches of ``batch_size`` (the last may be
        short)."""
        from ..data.coco24p import COCO24PDataset, TrainTransform24P
        from ..data.dataloading import data_loader

        dataset = COCO24PDataset(
            data_dir=self.data_dir,
            label_dir=self.label_dir,
            img_size=self.test_size,
            preproc=TrainTransform24P(max_labels=50),
        )
        return data_loader(dataset, batch_size=batch_size,
                           num_workers=self.data_num_workers)

    def get_evaluator(self, batch_size):
        """COCO-style AP over the polygons' enclosing boxes
        (``eval/evaluator_24p.py``); the thresholds are the infer function's
        (``test_conf``, ``nmsthre``)."""
        from ..eval.evaluator_24p import Evaluator24P

        return Evaluator24P(
            dataloader=self.get_eval_loader(batch_size),
            img_size=self.test_size,
            num_classes=self.num_classes,
        )

    def eval(self, model, evaluator):
        """``evaluator.evaluate`` over ``model`` (in eval mode) on the
        device its weights are on: (AP50:95, AP50, summary)."""
        device = next(model.parameters()).device
        return evaluator.evaluate(self.get_infer_fn(model, device))

    # ------------------------------------------------------------------
    # training

    def get_data_loader(self, batch_size, is_distributed=False, rank=0,
                        world_size=1):
        """Batches ``[images [B, H, W, 3], labels [B, 50, 51], [hs, ws],
        ids [B, 1]]`` over ``data_dir`` / ``label_dir`` at ``input_size``,
        drawn for ever from the rank-strided shuffled stream seeded by
        ``seed``; its length is the iterations of one epoch."""
        from ..data.coco24p import COCO24PDataset, TrainTransform24P
        from ..data.dataloading import data_loader, worker_init_reset_seed
        from ..data.samplers import InfiniteSampler, YoloBatchSampler

        dataset = COCO24PDataset(
            data_dir=self.data_dir,
            label_dir=self.label_dir,
            img_size=self.input_size,
            preproc=TrainTransform24P(max_labels=50),
        )
        self.dataset = dataset
        if is_distributed:
            batch_size = batch_size // world_size
        sampler = InfiniteSampler(len(dataset), seed=self.seed or 0,
                                  rank=rank, world_size=world_size)
        batch_sampler = YoloBatchSampler(sampler, batch_size, drop_last=False,
                                         mosaic=False)
        return data_loader(dataset, batch_sampler=batch_sampler,
                           num_workers=self.data_num_workers,
                           worker_init_fn=worker_init_reset_seed)

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
