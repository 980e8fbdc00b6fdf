"""24-point detector trainer (counterpart of
``eop_tpu/train/trainer_24p.py``): plain SGD, an epoch loop over
``exp.get_data_loader``, the L1 loss for the last ``L1_epoch`` epochs, a log
line every ``print_interval`` iterations, a ``last_epoch`` checkpoint per
epoch, ``--resume`` / ``--ckpt`` / ``start_epoch``, optional EMA and LR
scheduling.  One device; mesh parallelism, the evaluator hook and the
GT-vs-prediction overlay are not ported yet.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..losses import Loss24PConfig
from ..utils.device import resolve_device
from ..utils.logger import logger, setup_logger
from ..utils.metric import CandidateDropMonitor
from .checkpoint import load_checkpoint, load_ckpt_partial, save_checkpoint
from .steps import create_train_state, make_train_step_24p


class Trainer24P:
    """``Trainer24P(exp, args).train()`` returns the final ``TrainState``.

    ``args`` attributes: ``batch_size``; optional ``lr``, ``accum``,
    ``resume``, ``ckpt``, ``start_epoch``, ``device`` (the card unless
    ``"cpu"``).  ``hook``, where set before ``train()``, is handed to
    ``make_train_step_24p`` as its ``hook``.
    """

    def __init__(self, exp, args):
        self.exp = exp
        self.args = args
        self.device = resolve_device(getattr(args, "device", None))
        self.max_epoch = exp.max_epoch
        self.input_size = exp.input_size
        self.start_epoch = 0
        self.hook = None
        self.drop_monitor = CandidateDropMonitor(logger)
        self.file_name = os.path.join(exp.output_dir, exp.exp_name)
        os.makedirs(self.file_name, exist_ok=True)
        setup_logger(self.file_name, filename="train_log.txt")

        self.train_loader = exp.get_data_loader(args.batch_size)
        self.iters_per_epoch = len(self.train_loader)

        self.tblogger = None
        try:
            from tensorboardX import SummaryWriter

            self.tblogger = SummaryWriter(
                os.path.join(self.file_name, "tensorboard"))
        except ImportError:
            pass

    def train(self):
        exp, args = self.exp, self.args
        model = exp.get_model(self.device, seed=exp.seed or 0).train()
        lr = getattr(args, "lr", None) or exp.basic_lr_per_img * args.batch_size
        optimizer = exp.get_optimizer(model, args.batch_size, lr=lr)
        state = create_train_state(model, optimizer, use_ema=exp.ema,
                                   with_dwa=True)
        state = self._maybe_resume(state)
        steps = {}

        def get_step(use_l1: bool):
            if use_l1 not in steps:
                cfg = Loss24PConfig(
                    num_classes=exp.num_classes,
                    use_l1=use_l1,
                    reference_parity=exp.reference_parity,
                )
                steps[use_l1] = make_train_step_24p(
                    cfg,
                    ema_decay=exp.ema_decay if exp.ema else None,
                    accum_steps=getattr(args, "accum", 1),
                    hook=self.hook,
                )
            return steps[use_l1]

        logger.info("24p training start...")
        global_step = 0
        # one persistent iterator: the loader never runs out
        it = iter(self.train_loader)
        for epoch in range(self.start_epoch, self.max_epoch):
            self.epoch = epoch
            use_l1 = epoch >= self.max_epoch - exp.L1_epoch
            step_fn = get_step(use_l1)
            epoch_start = time.time()
            for i in range(self.iters_per_epoch):
                imgs, labels, _, _ = next(it)
                imgs = torch.as_tensor(imgs).to(
                    self.device, torch.float32, non_blocking=True)
                labels = torch.as_tensor(labels).to(
                    self.device, torch.float32, non_blocking=True)
                state, metrics = step_fn(state, imgs, labels)
                if (i + 1) % exp.print_interval == 0:
                    # the only host fetch of the loop: one transfer for the
                    # whole metric tree
                    host = {k: v.cpu() for k, v in metrics.items()}
                    dropped = int(host["cand_dropped"])
                    logger.info(
                        f"epoch {epoch + 1}/{self.max_epoch} "
                        f"iter {i + 1}/{self.iters_per_epoch} "
                        f"loss {float(host['total_loss']):.4f} "
                        f"conf {float(host['conf_loss']):.4f} "
                        f"cls {float(host['cls_loss']):.4f} "
                        f"fg/gt {float(host['num_fg']):.2f}"
                        + (f" cand_dropped {dropped}" if dropped else ""))
                    # sampled at print cadence: each probe is a host fetch
                    self.drop_monitor.update(dropped)
                    self._tb_data(host, global_step)
                global_step += 1
            logger.info(
                f"epoch {epoch + 1} done in {time.time() - epoch_start:.1f}s")
            if ((epoch + 1) % exp.ckpt_interval == 0
                    or epoch + 1 == self.max_epoch):
                save_checkpoint(state, False, self.file_name, "last_epoch",
                                metadata={"start_epoch": epoch + 1})
        if hasattr(self.train_loader, "shutdown"):
            self.train_loader.shutdown()
        return state

    def _maybe_resume(self, state):
        args = self.args
        if getattr(args, "resume", False) or getattr(args, "ckpt", None):
            ckpt_file = getattr(args, "ckpt", None) or os.path.join(
                self.file_name, "last_epoch_ckpt.pth")
            logger.info(f"loading checkpoint {ckpt_file}")
            payload = load_checkpoint(ckpt_file, map_location=self.device)
            state, _ = load_ckpt_partial(state, payload["state"])
            if getattr(args, "resume", False):
                explicit = getattr(args, "start_epoch", None)
                self.start_epoch = (
                    explicit if explicit is not None
                    else payload.get("metadata", {}).get("start_epoch", 0))
        return state

    def _tb_data(self, metrics, step: int):
        """Observability at print cadence: total/conf/cls, the 24 per-radius
        IoU losses and the DWA weights (``metrics`` on the host)."""
        if self.tblogger is None:
            return
        tb = self.tblogger
        tb.add_scalar("train/total_loss", float(metrics["total_loss"]), step)
        tb.add_scalar("train/conf_loss", float(metrics["conf_loss"]), step)
        tb.add_scalar("train/cls_loss", float(metrics["cls_loss"]), step)
        iou24 = np.asarray(metrics["iou_losses_24"])
        reg_w = np.asarray(metrics["dwa_reg_w"])
        for r in range(24):
            tb.add_scalar(f"iou_loss/radius_{r:02d}", float(iou24[r]), step)
            tb.add_scalar(f"dwa_weight/reg_{r:02d}", float(reg_w[r]), step)
        tb.add_scalar("dwa_weight/obj", float(metrics["dwa_obj_w"]), step)
        tb.add_scalar("dwa_weight/cls", float(metrics["dwa_cls_w"]), step)
        tb.add_scalar("train/cand_dropped", float(metrics["cand_dropped"]),
                      step)
