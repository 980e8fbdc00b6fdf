"""24-point detector trainer (counterpart of
``eop_tpu/train/trainer_24p.py``): plain SGD, an epoch loop over
``exp.get_data_loader``, the L1 loss for the last ``L1_epoch`` epochs, a log
line every ``print_interval`` iterations, a ``last_epoch`` checkpoint per
epoch, ``--resume`` / ``--ckpt`` / ``start_epoch``, optional EMA and LR
scheduling, and with ``args.eval`` the COCO-24p evaluation every
``eval_interval`` epochs (EMA weights where ``exp.ema``) that keeps
``best_ckpt.pth``.

Data parallel over processes as the bbox ``Trainer`` is
(``train/trainer.py``, ``Parallel``): ``args.batch_size`` is the global
batch (the learning rate follows it), each rank loads its share, a step is
the one-process step on the global batch, ``args.fsdp`` shards the state,
rank 0 alone writes the log file, tensorboard and the checkpoints (the
state gathered on every rank first); ``args.spatial`` / ``args.tensor``
shard each image's rows / the qualifying convs' channels over a data
row's ranks, which load the same images (the loader keyed by the data
rank).  Every rank evaluates with the
gathered weights, and ``Evaluator24P`` scores the whole set on each, as
``eop_tpu``'s does.

Where ``tensorboardX`` is installed, every step writes one row of scalars,
as ``eop_tpu``'s trainer does; the steps keep their metrics on the device
and the print step fetches them all in one transfer, so the loop still
synchronises with the device once per ``print_interval`` steps (and once
at the end of an epoch that leaves steps unwritten).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..losses import Loss24PConfig
from ..parallel.mesh import state_to_host
from ..parallel.tensor import whole_tensors
from ..utils.logger import logger, setup_logger
from ..utils.metric import CandidateDropMonitor, fetch_metrics
from .checkpoint import (
    load_checkpoint,
    load_ckpt_partial,
    save_checkpoint,
    state_to_payload,
)
from .steps import create_train_state, eval_weights, make_train_step_24p
from .trainer import Parallel, reject_unported


class Trainer24P:
    """``Trainer24P(exp, args).train()`` returns the final ``TrainState``.

    ``args`` attributes: ``batch_size`` (the global batch); optional
    ``lr``, ``accum``, ``resume``, ``ckpt``, ``start_epoch``, ``eval``,
    ``device`` (the card unless ``"cpu"``), ``fsdp``, ``spatial``,
    ``tensor``.  ``hook``, where set
    before ``train()``, is handed to ``make_train_step_24p`` as its
    ``hook``.
    """

    def __init__(self, exp, args):
        reject_unported(args)
        self.exp = exp
        self.args = args
        self.par = par = Parallel.of(args)
        self.device = par.device
        self.is_main = par.is_main
        self.max_epoch = exp.max_epoch
        self.input_size = exp.input_size
        self.start_epoch = 0
        self.hook = None
        self._eval_model = None
        self.drop_monitor = CandidateDropMonitor(logger)
        self.file_name = os.path.join(exp.output_dir, exp.exp_name)
        if self.is_main:
            os.makedirs(self.file_name, exist_ok=True)
        setup_logger(self.file_name, filename="train_log.txt", rank=par.rank)

        # args.batch_size is the global batch: each rank loads its share
        par.check_batch(args.batch_size)
        self.train_loader = exp.get_data_loader(
            args.batch_size, is_distributed=par.data_world > 1,
            rank=par.data_rank, world_size=par.data_world)
        self.iters_per_epoch = len(self.train_loader)

        self.host_fetches = 0  # metric transfers to the host
        self.tblogger = None
        if self.is_main:
            try:
                from tensorboardX import SummaryWriter

                self.tblogger = SummaryWriter(
                    os.path.join(self.file_name, "tensorboard"))
            except ImportError:
                pass

    def train(self):
        exp, args, par = self.exp, self.args, self.par
        model = par.model(exp.get_model(self.device, seed=exp.seed or 0)
                          .train())
        lr = getattr(args, "lr", None) or exp.basic_lr_per_img * args.batch_size
        optimizer = exp.get_optimizer(model, args.batch_size, lr=lr)
        state = create_train_state(model, optimizer, use_ema=exp.ema,
                                   with_dwa=True)
        state = par.place(self._maybe_resume(state))
        steps = {}

        def get_step(use_l1: bool):
            if use_l1 not in steps:
                cfg = Loss24PConfig(
                    num_classes=exp.num_classes,
                    use_l1=use_l1,
                    reference_parity=exp.reference_parity,
                )
                steps[use_l1] = par.step(make_train_step_24p(
                    cfg,
                    ema_decay=exp.ema_decay if exp.ema else None,
                    accum_steps=getattr(args, "accum", 1),
                    hook=self.hook,
                    group=par.group,
                ))
            return steps[use_l1]

        evaluator = None
        if getattr(args, "eval", False):
            evaluator = exp.get_evaluator(args.batch_size)
        best_ap = 0.0

        logger.info("24p training start...")
        global_step = 0
        # one persistent iterator: the loader never runs out, and a new one
        # would start its worker processes again
        it = iter(self.train_loader)
        tb_pending = []  # (step, device metrics) not yet written
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
                state, metrics = step_fn(state, par.rows(imgs), labels)
                if self.tblogger is not None:
                    tb_pending.append((global_step, metrics))
                if (i + 1) % exp.print_interval == 0:
                    # one host fetch: a single transfer for this
                    # step's metrics and those the tensorboard rows wait on
                    rows = self._fetch(tb_pending or [(global_step, metrics)])
                    tb_pending = []
                    host = rows[-1][1]
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
                    self._tb_rows(rows)
                global_step += 1
            if tb_pending:
                self._tb_rows(self._fetch(tb_pending))
                tb_pending = []
            logger.info(
                f"epoch {epoch + 1} done in {time.time() - epoch_start:.1f}s")
            want_eval = (evaluator is not None
                         and (epoch + 1) % exp.eval_interval == 0)
            payload = None
            if ((epoch + 1) % exp.ckpt_interval == 0
                    or epoch + 1 == self.max_epoch or want_eval):
                # every rank joins the gather of a sharded state
                payload = state_to_payload(state)
                if self.is_main:
                    save_checkpoint(payload, False, self.file_name,
                                    "last_epoch",
                                    metadata={"start_epoch": epoch + 1})
            if want_eval:
                ap5095, ap50, summary = evaluator.evaluate(
                    exp.get_infer_fn(self.eval_model(state), self.device))
                logger.info(f"epoch {epoch + 1} eval:\n{summary}")
                logger.info(f"AP50:95={ap5095:.4f} AP50={ap50:.4f}")
                if self.tblogger is not None:
                    self.tblogger.add_scalar("val/AP50", ap50, epoch + 1)
                    self.tblogger.add_scalar("val/AP50_95", ap5095, epoch + 1)
                if ap5095 > best_ap:
                    best_ap = ap5095
                    if self.is_main:
                        save_checkpoint(payload, True, self.file_name,
                                        "last_epoch",
                                        metadata={"start_epoch": epoch + 1})
        del it  # stops the loader's workers
        if hasattr(self.train_loader, "shutdown"):
            self.train_loader.shutdown()
        return state

    def eval_model(self, state):
        """A separate eval-mode model carrying the EMA parameters and batch
        statistics where ``exp.ema``, else the live ones: the training
        model's mode, autograd state and weights stay as they are.  Built at
        the first evaluation and loaded anew at each: the in-place loads
        move the tensor versions that key its packed and folded weights.
        Under FSDP, and the channel slices under tensor parallelism, the
        weights are gathered on every rank first."""
        weights = whole_tensors(state_to_host(eval_weights(state,
                                                           self.exp.ema)),
                                state.model)
        if self._eval_model is None:
            self._eval_model = self.exp.get_model(self.device)
        self._eval_model.load_state_dict(weights, strict=True)
        return self._eval_model

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

    def _fetch(self, rows):
        """``[(step, device metrics)]`` -> numpy metrics, in one transfer."""
        self.host_fetches += 1
        return fetch_metrics(rows)

    def _tb_rows(self, rows):
        if self.tblogger is not None:
            for step, metrics in rows:
                self._tb_data(metrics, step)

    def _tb_data(self, metrics, step: int):
        """One step's row: total/conf/cls, the 24 per-radius IoU losses and
        the DWA weights (``metrics`` on the host)."""
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

    def render_train_sample(self, image, pred_rows, gt_rows, out_path):
        """Ground truth against predictions on one image, written to
        ``out_path`` (``.png``, ``.jpg`` / ``.jpeg`` or ``.bmp``): a green
        circle of each label's mean radius (label rows ``[cls, cx, cy, 24 x
        (x, y)]``, all-zero rows skipped) and a red one of each detection's
        (rows ``[x, y, r1..r24, ...]``), thickness 1, drawn in numpy."""
        from ..ops.polygon import radii_from_points
        from ..utils.synth import write_image
        from ..utils.visualize import circle

        img = np.ascontiguousarray(image).astype(np.uint8)
        for row in np.asarray(gt_rows):
            if row.sum() == 0:
                continue
            cx, cy = row[1], row[2]
            radii = radii_from_points(torch.as_tensor(
                row[None, 1:], dtype=torch.float32)).numpy()[0]
            circle(img, (int(cx), int(cy)), int(radii.mean()), (0, 255, 0), 1)
        for row in np.asarray(pred_rows):
            cx, cy = row[0], row[1]
            circle(img, (int(cx), int(cy)), int(np.mean(row[2:26])),
                   (0, 0, 255), 1)
        write_image(out_path, img)
        return out_path
