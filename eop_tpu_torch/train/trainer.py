"""The bbox family's trainer (counterpart of ``eop_tpu/train/trainer.py``):
the learning rate scheduled per iteration, EMA, meters with an ETA in the
log line, a multiscale size drawn every 10 iterations, the no-aug switch,
resume and fine-tuning, evaluation with the EMA weights every
``eval_interval`` epochs keeping ``best_ckpt.pth``.

The no-aug switch (at the start of epoch ``max_epoch - no_aug_epochs - 1``,
0-based, as the reference places it, or at the first epoch of a run
resumed past it): mosaic closes, the L1 loss comes on (a second step
function: ``use_l1`` changes what the step computes), evaluation runs every
epoch, ``last_mosaic_epoch_ckpt.pth`` keeps the state before it, and the
loader's iterator is made again so that the workers see the sampler's
flag from the next batch on (batches already prefetched were drawn with
mosaic).

Before each step, DenseNet's dropout generator is seeded from the exp's
seed and the global step (``models/densenet.py::step_seed``), so a resumed
run draws the masks an uninterrupted one draws, as ``eop_tpu``'s
``PRNGKey(step)`` does.

The steps keep their metrics on the device; the print step fetches them in
one transfer (``host_fetches`` counts them), and with ``tensorboardX`` each
step writes one row.  ``--accum N`` splits each batch into N micro-batches
before one optimizer step (``make_train_step_bbox(accum_steps=N)``;
DenseNet's micro-batches draw their masks from the step's generator in
order).

Data parallel over processes (one per GPU, ``cuda:LOCAL_RANK``), as
``eop_tpu``'s trainer runs over a mesh: where a process group exists
(``tools.train --multi-host`` or torchrun) ``args.batch_size`` is the
global batch, each rank loads its ``1 / world`` share, the BatchNorm, the
loss and the metrics are the global batch's and the gradients are
averaged (``parallel``), so a step is the one-process step on the global
batch; ``args.fsdp`` shards the parameters, the momentum and the EMA
(``place_state``).  Rank 0 alone writes the log file, tensorboard and the
checkpoints; the checkpoint's state is gathered on every rank first.  The
multiscale size comes from (seed, step), the same on every rank.  Each
rank evaluates its strided share of the validation set and the detections
are gathered before every rank scores them.  ``args.spatial`` /
``args.tensor`` lay the ranks out as ``eop_tpu``'s mesh
(``parallel.dist.make_mesh``: data, space, model): a data row's space and
model ranks load the same images (the loader keyed by the data rank, its
augmentations by one shared seed), a space rank trains on its height
rows, a model rank on its slices of the qualifying convs' channels
(``Parallel``).  ``args.profile_port`` has rank 0 answer live profiling
requests on that port (``utils/profiler.py::ProfileServer``, which the
loop hands every step boundary); the XLA bucket prewarm is not ported.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..losses import YoloxLossConfig
from ..models.densenet import step_seed
from ..models.yolox import dropouts
from ..utils.device import resolve_device
from ..utils.logger import logger, setup_logger
from ..utils.metric import (
    CandidateDropMonitor,
    MeterBuffer,
    device_mem_usage,
    fetch_metrics,
)
from ..utils.model_utils import get_model_info
from ..utils.profiler import profile_server
from ..parallel.dist import (
    Mesh,
    get_rank,
    get_world_size,
    make_mesh,
    rank_device,
    shared_random_seed,
)
from ..parallel.global_bn import convert_global_bn
from ..parallel.mesh import place_state, shard_train_step, state_to_host
from ..parallel.spatial import convert_spatial, shard_rows
from ..parallel.tensor import whole_tensors
from ..utils.weights import train_state_from_jax
from .checkpoint import (
    load_checkpoint,
    load_ckpt_partial,
    save_checkpoint,
    state_to_payload,
)
from .steps import create_train_state, eval_weights, make_train_step_bbox

class Parallel(NamedTuple):
    """This process's place in the run: its device (``cuda:LOCAL_RANK``
    on a card), rank and world size, the data group (``None`` without
    one: this process's images are the batch), whether to shard the state
    (``fsdp``) and the layout of the ranks (``mesh``: the data, space and
    model groups of ``--spatial`` / ``--tensor``)."""

    device: torch.device
    rank: int
    world: int
    group: Optional[object]
    fsdp: bool
    mesh: Mesh = Mesh()

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @classmethod
    def of(cls, args) -> "Parallel":
        """From ``args.device``, ``args.fsdp``, ``args.spatial`` and
        ``args.tensor`` and the default process group, where one has been
        started (``init_distributed``).  ``spatial`` / ``tensor`` that do
        not split the ranks raise ``ValueError`` (``make_mesh``)."""
        mesh = make_mesh(int(getattr(args, "spatial", 1) or 1),
                         int(getattr(args, "tensor", 1) or 1))
        return cls(rank_device(resolve_device(getattr(args, "device", None))),
                   get_rank(), get_world_size(), mesh.data,
                   bool(getattr(args, "fsdp", False)), mesh)

    @property
    def data_rank(self) -> int:
        return self.mesh.data_rank

    @property
    def data_world(self) -> int:
        return self.mesh.data_size

    def check_batch(self, batch_size: int) -> None:
        if batch_size % self.data_world:
            raise ValueError(f"the global batch {batch_size} does not split "
                             f"over {self.data_world} data ranks")

    def loader_seed(self) -> Optional[int]:
        """The augmentations' seed where a data row has several ranks (one
        draw shared by every rank, plus the data rank: the ranks of a data
        row draw the same batches); None (random) otherwise."""
        if self.mesh.spatial * self.mesh.tensor == 1:
            return None
        return (shared_random_seed() + self.data_rank) % 2**31

    def model(self, model):
        """``model`` under the mesh: its rows over the space group
        (``convert_spatial``) and its BatchNorm over the global batch (the
        sharded region's over data x space)."""
        mesh = self.mesh
        if mesh.space is not None:
            convert_spatial(model, mesh.space)
        if mesh.data is not None or mesh.space is not None:
            convert_global_bn(model, mesh.data,
                              mesh.data_space if mesh.space else None)
        return model

    def rows(self, images):
        """This rank's height rows of an NHWC batch under a space group."""
        return shard_rows(images, self.mesh.space_rank, self.mesh.spatial)

    def step(self, step_fn):
        return shard_train_step(step_fn, self.group, self.fsdp, self.mesh)

    def place(self, state):
        return place_state(state, self.fsdp, self.group, self.mesh.model)


class Trainer:
    """``Trainer(exp, args).train()`` returns the final ``TrainState``.

    ``args`` attributes: ``batch_size``; optional ``accum`` (micro-batches a
    step, 1), ``resume``, ``ckpt``, ``start_epoch``, ``cache``,
    ``experiment_name``, ``device`` (the card
    unless ``"cpu"``), ``jax_state`` (a JAX ``TrainState`` as numpy trees,
    the form ``utils.weights.train_state_from_jax`` takes, to start from).
    ``hook``, where set before ``train()``, is handed to the step functions
    (``make_train_step_bbox``); ``profile_port`` (rank 0 listens there for
    live profiling requests, ``utils/profiler.py::profile_server``).
    Rank 0 logs ``Model summary: `` (``get_model_info``) once, at start.
    """

    def __init__(self, exp, args):
        self.exp = exp
        self.args = args
        self.par = Parallel.of(args)
        self.device = self.par.device
        self.is_main = self.par.is_main
        self.max_epoch = exp.max_epoch
        self.input_size = exp.input_size
        self.start_epoch = 0
        self.best_ap = 0.0
        self.hook = None
        self.profiler = None
        self.host_fetches = 0
        self.meter = MeterBuffer(window_size=exp.print_interval)
        self.drop_monitor = CandidateDropMonitor(logger)
        self.file_name = os.path.join(
            exp.output_dir, getattr(args, "experiment_name", None)
            or exp.exp_name)
        if self.is_main:
            os.makedirs(self.file_name, exist_ok=True)
        setup_logger(self.file_name, filename="train_log.txt",
                     rank=self.par.rank)
        self._eval_model = None
        self._steps = {}
        self.tblogger = None
        if self.is_main:
            try:
                from tensorboardX import SummaryWriter

                self.tblogger = SummaryWriter(
                    os.path.join(self.file_name, "tensorboard"))
            except ImportError:
                pass

    # ------------------------------------------------------------------

    def train(self):
        self.profiler = profile_server(self.args, self.is_main,
                                       self.file_name)
        try:
            self.before_train()
            try:
                for self.epoch in range(self.start_epoch, self.max_epoch):
                    self.before_epoch()
                    self.train_one_epoch()
                    self.after_epoch()
            finally:
                self.after_train()
        finally:
            if self.profiler is not None:
                self.profiler.close()
        return self.state

    def before_train(self):
        exp, args = self.exp, self.args
        logger.info(f"args: {args}")
        # the epoch a resume starts at decides no_aug, and with it the
        # loader's mosaic flag: read it before the loader is built
        payload = None
        if getattr(args, "resume", False):
            payload = load_checkpoint(
                getattr(args, "ckpt", None)
                or os.path.join(self.file_name, "latest_ckpt.pth"),
                map_location=self.device)
            explicit = getattr(args, "start_epoch", None)
            self.start_epoch = (explicit if explicit is not None else
                                payload.get("metadata", {}).get(
                                    "start_epoch", 0))
        self.no_aug = self.start_epoch >= self.max_epoch - exp.no_aug_epochs
        par = self.par
        par.check_batch(args.batch_size)
        # args.batch_size is the global batch: each rank loads its share
        self.train_loader = exp.get_data_loader(
            args.batch_size, is_distributed=par.data_world > 1,
            no_aug=self.no_aug, cache_img=getattr(args, "cache", False),
            rank=par.data_rank, world_size=par.data_world,
            seed=par.loader_seed())
        self.iters_per_epoch = len(self.train_loader)
        model = exp.get_model(self.device, seed=exp.seed or 0).train()
        if self.is_main:
            # counted on the meta device before the layout converts the
            # model: every layout prints the one-process figure, and no
            # kernel launches
            logger.info("Model summary: "
                        + get_model_info(model, exp.test_size))
        model = par.model(model)
        self._dropouts = dropouts(model)
        for d in self._dropouts:
            d.shard = (par.data_rank, par.data_world)
        optimizer = exp.get_optimizer(model, args.batch_size,
                                      self.iters_per_epoch)
        jax_state = getattr(args, "jax_state", None)
        if jax_state is not None:
            self.state = train_state_from_jax(jax_state, model, optimizer)
        else:
            self.state = create_train_state(model, optimizer,
                                            use_ema=exp.ema)
        if payload is not None or getattr(args, "ckpt", None):
            if payload is None:
                logger.info("loading checkpoint for fine tuning")
                payload = load_checkpoint(args.ckpt,
                                          map_location=self.device)
            self.state, report = load_ckpt_partial(self.state,
                                                   payload["state"])
            if report["skipped"]:
                logger.warning(
                    f"{len(report['skipped'])} missing or mismatched keys "
                    f"kept their fresh values (first: "
                    f"{report['skipped'][:3]})")
            logger.info(f"loaded {len(report['loaded'])} tensors; starting "
                        f"at epoch {self.start_epoch}")
        self.state = par.place(self.state)
        # each rank scores its strided share; the evaluator gathers
        self.evaluator = (exp.get_evaluator(args.batch_size,
                                            is_distributed=par.world > 1)
                          if exp.data_dir else None)
        self.use_l1 = False
        self._no_aug_applied = False
        self._iter = None
        self._restart_iter = True
        self.tsize = tuple(self.input_size)
        logger.info("Training start...")

    def _step_fn(self):
        if self.use_l1 not in self._steps:
            cfg = YoloxLossConfig(num_classes=self.exp.num_classes,
                                  use_l1=self.use_l1)
            self._steps[self.use_l1] = self.par.step(make_train_step_bbox(
                cfg, ema_decay=self.exp.ema_decay if self.exp.ema else None,
                accum_steps=getattr(self.args, "accum", 1), hook=self.hook,
                group=self.par.group))
        return self._steps[self.use_l1]

    def before_epoch(self):
        logger.info(f"---> start train epoch{self.epoch + 1}")
        exp = self.exp
        if not self._no_aug_applied and (
                self.epoch + 1 == self.max_epoch - exp.no_aug_epochs
                or self.no_aug):
            self._no_aug_applied = True
            logger.info("--->No mosaic aug now!")
            self.train_loader.batch_sampler.mosaic = False
            self._restart_iter = True
            logger.info("--->Add additional L1 loss now!")
            self.use_l1 = True
            exp.eval_interval = 1
            if not self.no_aug:
                self.save_ckpt("last_mosaic_epoch")
        # one iterator for the run: the sampler never ends, and a new one
        # starts the workers again; made anew only for the switch
        if self._restart_iter:
            self._iter = None  # stops the old workers first
            self._iter = iter(self.train_loader)
            self._restart_iter = False

    def train_one_epoch(self):
        step_fn = self._step_fn()
        pending = []  # (global step, device metrics) not yet fetched
        for it in range(self.iters_per_epoch):
            self._it = it
            t0 = time.perf_counter()
            imgs, labels, _, _ = next(self._iter)
            imgs = torch.as_tensor(imgs).to(self.device, torch.float32,
                                            non_blocking=True)
            labels = torch.as_tensor(labels).to(self.device, torch.float32,
                                                non_blocking=True)
            if self.tsize != tuple(self.input_size):
                imgs, labels = self.exp.preprocess(imgs, labels, self.tsize)
            imgs = self.par.rows(imgs)
            data_time = time.perf_counter() - t0
            for d in self._dropouts:  # DenseNet's masks: (seed, step)
                d.reseed(step_seed(self.exp.seed or 0,
                                   self.progress_in_iter))
            self.state, metrics = step_fn(self.state, imgs, labels)
            if self.profiler is not None:
                self.profiler.step()
            pending.append((self.progress_in_iter, metrics))
            self.meter.update(iter_time=time.perf_counter() - t0,
                              data_time=data_time)
            if (it + 1) % self.exp.print_interval == 0:
                self._log_rows(pending)
                pending = []
            # multiscale: a new size every 10 iterations, from (seed, step)
            if (self.progress_in_iter + 1) % 10 == 0:
                self.tsize = tuple(
                    self.exp.random_resize(self.progress_in_iter + 1))
        if pending:
            self._log_rows(pending, print_line=False)

    def _log_rows(self, rows, print_line: bool = True):
        """Fetch the steps' metrics in one transfer, write their tensorboard
        rows, and log the last one with the meters and an ETA."""
        self.host_fetches += 1
        host = [(step, {k: float(v) for k, v in m.items()})
                for step, m in fetch_metrics(rows)]
        for step, h in host:
            self.drop_monitor.update(h["cand_dropped"])
            if self.tblogger is not None:
                for k, v in h.items():
                    self.tblogger.add_scalar(f"train/{k}", v, step)
        if not print_line:
            return
        last = host[-1][1]
        left = self.iters_per_epoch * self.max_epoch - (
            self.progress_in_iter + 1)
        eta = datetime.timedelta(
            seconds=int(self.meter["iter_time"].global_avg * left))
        times = ", ".join(f"{k}: {v.avg:.3f}s" for k, v in
                          self.meter.get_filtered_meter("time").items())
        losses = ", ".join(f"{k}: {v:.2f}" for k, v in last.items()
                           if "loss" in k)
        logger.info(
            f"epoch: {self.epoch + 1}/{self.max_epoch}, iter: "
            f"{self._it + 1}/{self.iters_per_epoch}, mem: "
            f"{device_mem_usage():.0f}MB, {times}, {losses}, num_fg: "
            f"{last['num_fg']:.2f}, size: {self.tsize[0]}, ETA: {eta}")
        self.meter.clear_meters()

    def after_epoch(self):
        if ((self.epoch + 1) % self.exp.ckpt_interval == 0
                or self.epoch + 1 == self.max_epoch):
            self.save_ckpt("latest")
        if (self.epoch + 1) % self.exp.eval_interval == 0:
            self.evaluate_and_save_model()

    def after_train(self):
        logger.info(f"Training of experiment is done and the best AP is "
                    f"{self.best_ap * 100:.2f}")
        self._iter = None  # stops the loader's workers

    @property
    def progress_in_iter(self):
        return self.epoch * self.iters_per_epoch + getattr(self, "_it", 0)

    # ------------------------------------------------------------------

    def eval_model(self):
        """A separate eval-mode model carrying the EMA parameters and batch
        statistics where ``exp.ema``, else the live ones (built at the first
        evaluation and loaded anew at each; gathered on every rank under
        FSDP, and the channel slices under tensor parallelism)."""
        weights = whole_tensors(
            state_to_host(eval_weights(self.state, self.exp.ema)),
            self.state.model)
        if self._eval_model is None:
            self._eval_model = self.exp.get_model(self.device)
        self._eval_model.load_state_dict(weights, strict=True)
        return self._eval_model

    def evaluate_and_save_model(self):
        if self.evaluator is None:
            self.save_ckpt("last_epoch")
            return
        ap50_95, ap50, summary = self.exp.eval(
            self.eval_model(), self.evaluator,
            is_distributed=self.par.world > 1)
        logger.info(f"\n{summary}")
        logger.info(f"AP50:95={ap50_95:.4f} AP50={ap50:.4f}")
        if self.tblogger is not None:
            self.tblogger.add_scalar("val/COCOAP50", ap50, self.epoch + 1)
            self.tblogger.add_scalar("val/COCOAP50_95", ap50_95,
                                     self.epoch + 1)
        self.save_ckpt("last_epoch", ap50_95 > self.best_ap)
        self.best_ap = max(self.best_ap, ap50_95)

    def save_ckpt(self, ckpt_name: str, update_best_ckpt: bool = False):
        # every rank joins the gather of a sharded state; rank 0 writes
        payload = state_to_payload(self.state)
        if not self.is_main:
            return
        logger.info(f"Save weights to {self.file_name}")
        save_checkpoint(payload, update_best_ckpt, self.file_name,
                        ckpt_name, metadata={"start_epoch": self.epoch + 1})
