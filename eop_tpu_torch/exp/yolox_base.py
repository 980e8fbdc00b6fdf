"""The bbox family's experiment: YOLOX-S/M/L/X, -Nano, -Tiny and YOLOv3
defaults and the factories for the model, the mosaic train loader,
multiscale resizing, the optimizer with its weight-decay groups, the
``yoloxwarmcos`` schedule, the COCO and VOC evaluation loaders and
evaluators, and the fused inference, decode-only and serving functions
(counterpart of ``eop_tpu/exp/yolox_base.py``).

``model_kind`` stands for the one method override of ``exps/default/``:
``yolov3.py``'s ``get_model``, which builds ``YOLOv3``; the port's ``ast``
reader maps that override to ``model_kind = "yolov3"``.

``backbone_type`` (``darknet``, ``vgg``, ``resnet``, ``densenet``) swaps
the YOLOX backbone, as the feature-map study does.

``data_kind = "voc"`` stands for the loader and evaluator overrides of
``exps/example/yolox_voc/yolox_voc_s.py`` (``exp/build.py`` recognises
them): the training set is ``voc_train_sets`` of ``<data_dir>/VOCdevkit``
in mosaic, the test set ``voc_test_sets``, scored by ``VOCEvaluator``.
Otherwise the data are COCO-format under ``data_dir``.  Not ported yet (it
raises where asked for): the sharded multi-chip inference function and
the distributed evaluation loader."""

from __future__ import annotations

import os
import random
from typing import Optional

import torch
import torch.nn.functional as F

from ..eval.postprocess import postprocess_bbox_heads
from ..models.yolox import (YOLOX, YOLOv3, dropouts, inference_outputs,
                            init_weights)
from ..utils.device import resolve_device, set_fp32_precision
from .base_exp import BaseExp
from .yolox_24p_base import COMPUTE_DTYPES


class Exp(BaseExp):
    def __init__(self):
        super().__init__()
        # ---------------- model config ---------------- #
        self.num_classes = 80
        self.depth = 1.00
        self.width = 1.00
        self.act = "silu"
        self.backbone_type = "darknet"
        self.depthwise = False
        # "yolox" or "yolov3" (YOLOFPN over Darknet-53, lrelu head)
        self.model_kind = "yolox"
        # ---------------- dataloader config ---------------- #
        self.data_num_workers = 4
        self.input_size = (640, 640)  # (height, width)
        self.multiscale_range = 5     # +-range x 32 px
        self.random_size: Optional[tuple] = None
        # the reference's exps/default/yolox_tiny.py sets this typo of
        # input_size, which nothing reads: Tiny trains at input_size
        self.input_scale: Optional[tuple] = None
        self.data_dir = None
        # "coco" (annotations/*.json under data_dir) or "voc" (the
        # VOCdevkit under data_dir: yolox_voc_s.py's overrides)
        self.data_kind = "coco"
        self.voc_train_sets = [("2007", "trainval"), ("2012", "trainval")]
        self.voc_test_sets = [("2007", "test")]
        self.train_ann = "instances_train2017.json"
        self.val_ann = "instances_val2017.json"
        self.test_ann = "instances_test2017.json"
        # --------------- transform config ----------------- #
        self.mosaic_prob = 1.0
        self.mixup_prob = 1.0
        self.hsv_prob = 1.0
        self.flip_prob = 0.5
        self.degrees = 10.0
        self.translate = 0.1
        self.shear = 2.0
        self.mosaic_scale = (0.1, 2)
        self.mixup_scale = (0.5, 1.5)
        self.enable_mixup = True
        # --------------  training config --------------------- #
        self.warmup_epochs = 5
        self.max_epoch = 300
        self.warmup_lr = 0
        self.basic_lr_per_img = 0.01 / 64.0
        self.scheduler = "yoloxwarmcos"
        self.no_aug_epochs = 15
        self.min_lr_ratio = 0.05
        self.ema = True
        self.ema_decay = 0.9998
        self.weight_decay = 5e-4
        self.momentum = 0.9
        self.print_interval = 10
        self.eval_interval = 10
        self.ckpt_interval = 1     # epochs between ``latest`` saves
        self.exp_name = "yolox_base"
        # -----------------  testing config ------------------ #
        self.test_size = (640, 640)
        self.test_conf = 0.01
        self.nmsthre = 0.65
        # "exact" = stationarity-checked NMS fixpoint (greedy-exact)
        self.nms_mode = "exact"
        # "bfloat16": fp32 parameters, BN statistics, optimizer and EMA,
        # bf16 convs and activations (flax's dtype semantics)
        self.compute_dtype = "float32"
        # gradient checkpointing of the backbone + neck in training steps
        self.remat = False
        # eop_tpu's TPU MXU packed layout; it changes no result, so the port
        # reads neither (ROADMAP.md queue 1 item 9)
        self.packed_early = "auto"
        self.packed_infer_max_batch = 64

    # ------------------------------------------------------------------
    # model and inference

    def get_model(self, device=None, seed: int = 0,
                  backbone_type: Optional[str] = None):
        """The model of ``model_kind`` with a 4-channel box head, in eval
        mode on ``device`` (the card unless ``"cpu"``), channels_last, with
        seeded random fp32 weights, computing in ``compute_dtype``.  YOLOX
        takes ``depthwise``, ``backbone_type or self.backbone_type`` (an
        unknown one raises ``ValueError``) and checkpoints its backbone +
        neck in training where ``remat``; DenseNet's dropout generator is
        seeded with ``seed``.  YOLOv3 takes ``num_classes``, ``width`` and
        the dtype, as ``eop_tpu``'s ``yolov3`` exp builds it."""
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {self.compute_dtype!r}: the port "
                             f"computes in {sorted(COMPUTE_DTYPES)}")
        dtype = COMPUTE_DTYPES[self.compute_dtype]
        device = resolve_device(device)
        if self.model_kind == "yolov3":
            if self.remat:
                raise ValueError("remat: YOLOv3 has no checkpointed trunk "
                                 "(eop_tpu's neither)")
            model = YOLOv3(num_classes=self.num_classes, width=self.width,
                           dtype=dtype)
        elif self.model_kind != "yolox":
            raise ValueError(f"model_kind {self.model_kind!r}: expected "
                             "'yolox' or 'yolov3'")
        else:
            model = YOLOX(depth=self.depth, width=self.width,
                          num_classes=self.num_classes, reg_dim=4,
                          act=self.act, dtype=dtype, remat=bool(self.remat),
                          depthwise=bool(self.depthwise),
                          backbone_type=backbone_type or self.backbone_type)
            for d in dropouts(model):
                d.reseed(seed)
        init_weights(model, seed)
        return model.to(device, memory_format=torch.channels_last).eval()

    def _postprocess(self, head_outs):
        """Raw head maps -> ``Detections`` rows ``[B, 300, 7]``: decode and
        per-class NMS (``get_infer_fn`` / ``get_serving_fn`` run it after
        the forward)."""
        return postprocess_bbox_heads(
            head_outs, num_classes=self.num_classes,
            conf_thre=self.test_conf, nms_thre=self.nmsthre,
            nms_fixpoint_iters=self._nms_iters())

    # ------------------------------------------------------------------
    # training data

    def get_data_loader(self, batch_size, is_distributed=False, no_aug=False,
                        cache_img=False, rank=0, world_size=1, seed=None):
        """The mosaic train loader over ``data_dir``'s ``train_ann`` (VOC:
        ``voc_train_sets`` of the devkit): batches ``[images [B, H, W, 3],
        labels [B, 120, 5], info, ids]`` drawn for ever from the
        rank-strided shuffled stream seeded by ``seed``; its length is the
        iterations of one epoch."""
        if self.data_kind == "voc":
            from ..data.voc import VOCDetection

            dataset = VOCDetection(
                data_dir=self._devkit_dir(), image_sets=self.voc_train_sets,
                img_size=self.input_size,
                preproc=self.build_train_transform(max_labels=50),
                cache=cache_img)
        else:
            from ..data.coco_dataset import COCODataset

            dataset = COCODataset(
                data_dir=self.data_dir, json_file=self.train_ann,
                img_size=self.input_size,
                preproc=self.build_train_transform(max_labels=50),
                cache=cache_img)
        return self.wrap_train_dataset(
            dataset, batch_size, is_distributed=is_distributed,
            no_aug=no_aug, rank=rank, world_size=world_size, seed=seed)

    def build_train_transform(self, max_labels: int):
        from ..data.augment import TrainTransform

        return TrainTransform(max_labels=max_labels, flip_prob=self.flip_prob,
                              hsv_prob=self.hsv_prob)

    def wrap_train_dataset(self, dataset, batch_size, is_distributed=False,
                           no_aug=False, rank=0, world_size=1, seed=None):
        """Mosaic / MixUp around ``dataset``, the infinite rank-strided
        sampler, the ``(mosaic, index)`` batch sampler and the workers."""
        from ..data.dataloading import data_loader, worker_init_reset_seed
        from ..data.mosaic import MosaicDetection
        from ..data.samplers import InfiniteSampler, YoloBatchSampler

        dataset = MosaicDetection(
            dataset, mosaic=not no_aug, img_size=self.input_size,
            preproc=self.build_train_transform(max_labels=120),
            degrees=self.degrees, translate=self.translate,
            mosaic_scale=self.mosaic_scale, mixup_scale=self.mixup_scale,
            shear=self.shear, enable_mixup=self.enable_mixup,
            mosaic_prob=self.mosaic_prob, mixup_prob=self.mixup_prob,
            seed=seed)
        self.dataset = dataset
        if is_distributed:
            batch_size = batch_size // world_size
        sampler = InfiniteSampler(len(dataset), seed=self.seed or 0,
                                  rank=rank, world_size=world_size)
        batch_sampler = YoloBatchSampler(sampler, batch_size, drop_last=False,
                                         mosaic=not no_aug,
                                         input_dimension=self.input_size)
        return data_loader(dataset, batch_sampler=batch_sampler,
                           num_workers=self.data_num_workers,
                           worker_init_fn=worker_init_reset_seed)

    def random_resize(self, step: int = 0):
        """A multiscale training size ``(h, w)`` drawn from (seed, step) and
        keeping ``input_size``'s aspect."""
        if self.random_size is None:
            min_size = int(self.input_size[0] / 32) - self.multiscale_range
            max_size = int(self.input_size[0] / 32) + self.multiscale_range
            self.random_size = (min_size, max_size)
        rng = random.Random(((self.seed or 0) * 1_000_003) ^ step)
        size = rng.randint(*self.random_size)
        size_factor = self.input_size[1] / self.input_size[0]
        return (int(32 * size), 32 * int(size * size_factor))

    def preprocess(self, inputs: torch.Tensor, targets: torch.Tensor, tsize):
        """Multiscale resize of an NHWC batch to ``tsize`` on its device,
        scaling the ``(cls, cx, cy, w, h)`` label rows with it.  Bilinear,
        antialiased when shrinking, as ``jax.image.resize`` is."""
        scale_y = tsize[0] / self.input_size[0]
        scale_x = tsize[1] / self.input_size[1]
        if scale_x != 1 or scale_y != 1:
            inputs = F.interpolate(
                inputs.permute(0, 3, 1, 2), size=tuple(tsize),
                mode="bilinear", align_corners=False,
                antialias=True).permute(0, 2, 3, 1)
            scale = targets.new_tensor([1.0, scale_x, scale_y, scale_x,
                                        scale_y])
            targets = targets * scale
        return inputs, targets

    # ------------------------------------------------------------------
    # optimizer and schedule

    def get_optimizer(self, model, batch_size: int, iters_per_epoch: int = 1,
                      lr: Optional[float] = None):
        """Nesterov SGD with weight decay on the conv kernels only (BN
        scales and biases get none), following ``self.scheduler`` per
        iteration, clamped to the run's last iteration."""
        from ..train.optimizer import build_sgd

        if lr is None:
            lr = self.basic_lr_per_img * batch_size
        sched = self.get_lr_scheduler(lr, iters_per_epoch)
        total = max(iters_per_epoch * self.max_epoch, 1)
        return build_sgd(
            model, lambda it: sched.update_lr(min(max(it, 0), total)),
            momentum=self.momentum, weight_decay=self.weight_decay,
            nesterov=True)

    def get_lr_scheduler(self, lr: float, iters_per_epoch: int):
        from ..train.lr_schedule import LRScheduler

        return LRScheduler(
            self.scheduler, lr, iters_per_epoch, self.max_epoch,
            warmup_epochs=self.warmup_epochs,
            warmup_lr_start=self.warmup_lr,
            no_aug_epochs=self.no_aug_epochs,
            min_lr_ratio=self.min_lr_ratio)

    # ------------------------------------------------------------------
    # evaluation

    def _devkit_dir(self):
        return os.path.join(self.data_dir or "datasets", "VOCdevkit")

    def get_eval_loader(self, batch_size, is_distributed=False,
                        testdev=False, legacy=False):
        """The evaluation images in order, letterboxed to ``test_size``
        (``legacy``: RGB in 0..1, ImageNet-normalised), in batches of
        ``batch_size`` (the last may be short): ``data_dir``'s ``val_ann``
        (``val2017/``), with ``testdev`` its ``test_ann`` (``test2017/``);
        VOC: ``voc_test_sets`` of the devkit."""
        from ..data.augment import ValTransform
        from ..data.dataloading import data_loader

        if is_distributed:
            raise NotImplementedError(
                "is_distributed=True: the port evaluates on one device "
                "(ROADMAP.md queue 1 item 7)")
        if self.data_kind == "voc":
            from ..data.voc import VOCDetection

            dataset = VOCDetection(
                data_dir=self._devkit_dir(), image_sets=self.voc_test_sets,
                img_size=self.test_size, preproc=ValTransform(legacy=legacy))
        else:
            from ..data.coco_dataset import COCODataset

            dataset = COCODataset(
                data_dir=self.data_dir,
                json_file=self.test_ann if testdev else self.val_ann,
                name="test2017" if testdev else "val2017",
                img_size=self.test_size, preproc=ValTransform(legacy=legacy))
        return data_loader(dataset, batch_size=batch_size,
                           num_workers=self.data_num_workers)

    def get_evaluator(self, batch_size, is_distributed=False, testdev=False,
                      legacy=False, per_class_AP: bool = False,
                      per_class_AR: bool = False):
        """COCO box AP over :meth:`get_eval_loader`'s images (with the
        per-class tables where asked), or VOC mAP where ``data_kind`` is
        ``"voc"`` (it prints every class's AP); the thresholds are the
        infer function's (``test_conf``, ``nmsthre``)."""
        loader = self.get_eval_loader(batch_size, is_distributed, testdev,
                                      legacy)
        if self.data_kind == "voc":
            from ..eval.voc_evaluator import VOCEvaluator

            return VOCEvaluator(
                dataloader=loader, img_size=self.test_size,
                confthre=self.test_conf, nmsthre=self.nmsthre,
                num_classes=self.num_classes)
        from ..eval.coco_evaluator import COCOEvaluator

        return COCOEvaluator(
            dataloader=loader, img_size=self.test_size,
            num_classes=self.num_classes, per_class_AP=per_class_AP,
            per_class_AR=per_class_AR, testdev=testdev)

    def get_decode_fn(self, model, device=None):
        """Forward and decode without NMS (``inference_outputs``), taking
        the input :meth:`get_infer_fn` takes: what the evaluators time to
        split the inference time into forward and NMS."""
        device = resolve_device(device)
        set_fp32_precision(device)

        def decode_only(imgs):
            with torch.inference_mode():
                x = torch.as_tensor(imgs).to(device, non_blocking=True)
                head_outs, _ = model(x.float().permute(0, 3, 1, 2))
                return inference_outputs(head_outs, reg_dim=4)

        return decode_only

    def eval(self, model, evaluator, time_split: bool = False,
             quant_scales=None, quant_min_channels: int = 64):
        """``evaluator.evaluate`` over ``model`` (in eval mode) on the
        device its weights are on: (AP50:95, AP50, summary).
        ``time_split`` also hands it :meth:`get_decode_fn`, whose extra
        forwards estimate the NMS time (the evaluation command line's
        diagnostic; training leaves it off).  ``quant_scales`` (with the
        deploy model of ``quantize_for_inference``) evaluates the int8
        path; the split is off there, as in ``eop_tpu``: the decode-only
        probe runs in fp and would put the difference on NMS."""
        device = next(model.parameters()).device
        return evaluator.evaluate(
            self.get_infer_fn(model, device, quant_scales,
                              quant_min_channels),
            decode_fn=(self.get_decode_fn(model, device)
                       if time_split and not quant_scales else None))
