"""Gradient accumulation of the bbox family in the port against
``eop_tpu``: one ``make_train_step_bbox(accum_steps=2)`` step of a small
YOLOX (depth 0.33, width 0.25, 3 classes, 64 px, B=4: two micro-batches of
2) from bridged weights with perturbed BatchNorm, and the ``Trainer``'s
``--accum``.

YOLOX over CSPDarknet draws no random numbers in a step, so the two
packages' steps are held to each other directly (a DenseNet step draws
dropout masks from generators the packages do not share).  The rate is
small (5e-5 at this first step), as in tests/test_torch_bbox_step.py,
whose bounds these are (fp32; measured here with one thread in
brackets): the total loss 1e-5 relative (5.3e-7), the other metrics 1e-4
(cls_loss 5.9e-5: the two frameworks' fp32 forwards, 3.7e-6 to 5.9e-5
over seeds and thread counts, plain step or accumulated), the foreground
count equal; updates 2e-2 of each tensor's largest update plus two ulps;
parameters and EMA 1e-4 of each tensor's largest value (2.9e-5), or the
update's bound where that is larger; BatchNorm statistics, which advance
once a micro-batch, 1e-4 of their scale (6.5e-5).  Two micro-batches of
2 move the statistics otherwise than one batch of 4 does (by more than
1e-4: the last test)."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eop_tpu.losses import YoloxLossConfig as JLossConfig
from eop_tpu.models import YOLOX as JYOLOX
from eop_tpu.train import lr_schedule as j_sched
from eop_tpu.train.optimizer import build_sgd as j_build_sgd
from eop_tpu.train.steps import TrainState as JTrainState
from eop_tpu.train.steps import make_train_step_bbox as j_make_step
from eop_tpu.utils.torch_import import convert_state_dict
from eop_tpu_torch.exp import Exp
from eop_tpu_torch.losses import YoloxLossConfig
from eop_tpu_torch.train.steps import make_train_step_bbox
from eop_tpu_torch.train.trainer import Trainer
from eop_tpu_torch.utils.synth import write_coco_dataset
from eop_tpu_torch.utils.weights import state_dict_from_jax, train_state_from_jax
from test_torch_bbox_step import carried

SIZE, BATCH, CLASSES, ACCUM = 64, 4, 3, 2
DEPTH, WIDTH = 0.33, 0.25
EMA_DECAY, MOMENTUM, WEIGHT_DECAY = 0.9998, 0.9, 5e-4
ITERS_PER_EPOCH, EPOCHS, BASE_LR = 2, 4, 2e-4
SCHED = dict(warmup_epochs=1, warmup_lr_start=5e-5, no_aug_epochs=1,
             min_lr_ratio=0.05)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores, and
    PyTorch's default of a thread per core in each worker oversubscribes
    them (tests/test_torch_bbox_step.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch(seed: int = 3):
    """images [B, S, S, 3] in 0..255, labels [B, 50, 5] with 3 boxes
    each."""
    rng = np.random.RandomState(seed)
    imgs = rng.uniform(0, 255, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    labels = np.zeros((BATCH, 50, 5), np.float32)
    for b in range(BATCH):
        for g in range(3):
            w, h = rng.uniform(12, 30, 2)
            labels[b, g] = (rng.randint(CLASSES), rng.uniform(w, SIZE - w),
                            rng.uniform(h, SIZE - h), w, h)
    return imgs, labels


def port_exp():
    exp = Exp()
    exp.depth, exp.width, exp.num_classes = DEPTH, WIDTH, CLASSES
    exp.max_epoch, exp.weight_decay = EPOCHS, WEIGHT_DECAY
    exp.warmup_epochs = SCHED["warmup_epochs"]
    exp.warmup_lr = SCHED["warmup_lr_start"]
    exp.no_aug_epochs = SCHED["no_aug_epochs"]
    return exp


@pytest.fixture(scope="module")
def jax_side():
    """The starting state (the port's seeded weights, BatchNorm perturbed,
    momentum 0), and the state and metrics after eop_tpu's accumulated
    step on the fixed batch."""
    model = JYOLOX(backbone_type="darknet", depth=DEPTH, width=WIDTH,
                   num_classes=CLASSES, reg_dim=4, packed_early=False)
    sched = j_sched.LRScheduler("yoloxwarmcos", BASE_LR, ITERS_PER_EPOCH,
                                EPOCHS, **SCHED)
    tx = j_build_sgd(j_sched.tabulate_schedule(sched, ITERS_PER_EPOCH
                                               * EPOCHS),
                     momentum=MOMENTUM, weight_decay=WEIGHT_DECAY,
                     nesterov=True)
    variables = convert_state_dict(
        {k: v.numpy() for k, v in port_exp().get_model("cpu").state_dict()
         .items()})
    rng = np.random.RandomState(1)

    def perturb(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v, path + (k,))
            elif "bn" in path and k in ("scale", "var"):
                tree[k] = rng.uniform(0.7, 1.3, v.shape).astype(v.dtype)
            elif "bn" in path and k in ("bias", "mean"):
                tree[k] = (rng.randn(*v.shape) * 0.05).astype(v.dtype)

    perturb(variables)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    start = JTrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=tx.init(params),
        ema_params=jax.tree_util.tree_map(jnp.copy, params),
        ema_batch_stats=jax.tree_util.tree_map(jnp.copy, stats))
    step = jax.jit(j_make_step(model, tx, JLossConfig(num_classes=CLASSES),
                               ema_decay=EMA_DECAY, accum_steps=ACCUM))
    imgs, labels = batch()
    after, metrics = step(start, jnp.asarray(imgs), jnp.asarray(labels),
                          jax.random.PRNGKey(0))
    return start, after, metrics


def port_state(jstate):
    exp = port_exp()
    model = exp.get_model("cpu").train()
    opt = exp.get_optimizer(model, BATCH, ITERS_PER_EPOCH, lr=BASE_LR)
    return train_state_from_jax(carried(jstate), model, opt)


def test_accumulated_step_matches_eop_tpu(jax_side):
    start, after, jm = jax_side
    imgs, labels = batch()
    state = port_state(start)
    marks = []
    step = make_train_step_bbox(YoloxLossConfig(num_classes=CLASSES),
                                ema_decay=EMA_DECAY, accum_steps=ACCUM,
                                hook=lambda name, m=None: marks.append(name))
    state, tm = step(state, torch.from_numpy(imgs), torch.from_numpy(labels))
    assert marks.count("start") == ACCUM and marks.count("optimizer") == 1
    assert set(tm) == set(jm) and state.step == 1
    for k in jm:
        np.testing.assert_allclose(
            tm[k].item(), float(jm[k]), atol=1e-7,
            rtol=1e-5 if k == "total_loss" else 1e-4, err_msg=k)
    assert tm["num_fg"].item() == float(jm["num_fg"])

    want, start_np = carried(after), carried(start)
    live = state_dict_from_jax({"params": want["params"],
                                "batch_stats": want["batch_stats"]})
    live0 = state_dict_from_jax({"params": start_np["params"],
                                 "batch_stats": start_np["batch_stats"]})
    ema = state_dict_from_jax({"params": want["ema_params"],
                               "batch_stats": want["ema_batch_stats"]})
    sd = state.model.state_dict()
    tema = {**state.ema_params, **state.ema_batch_stats}
    moved = 0
    for k, v in live.items():
        if not v.is_floating_point():
            # flax keeps no count; BatchNorm here counts the micro-batches
            assert sd[k].item() == ACCUM, k
            continue
        scale = v.abs().max().item()
        if "running_" in k:
            bound = 1e-4 * max(scale, 1e-3)
        else:
            update = (v - live0[k]).abs().max().item()
            moved += update > 0
            update_bound = 2e-2 * update + 2.4e-7 * scale
            np.testing.assert_allclose(
                (sd[k] - live0[k]).detach().numpy(), (v - live0[k]).numpy(),
                atol=update_bound, rtol=0, err_msg=f"update {k}")
            bound = max(1e-4 * scale, update_bound)
        for got, ref, name in ((sd[k], v, k), (tema[k], ema[k], f"ema {k}")):
            np.testing.assert_allclose(got.detach().numpy(), ref.numpy(),
                                       atol=bound, rtol=0, err_msg=name)
    assert moved >= 0.9 * len(state.ema_params)


def test_accumulation_is_not_one_big_batch(jax_side):
    """BatchNorm sees two micro-batches of 2, not one of 4: the running
    statistics differ from a plain step's."""
    start, after, _ = jax_side
    imgs, labels = batch()
    plain = port_state(start)
    plain, _ = make_train_step_bbox(YoloxLossConfig(num_classes=CLASSES),
                                    ema_decay=EMA_DECAY)(
        plain, torch.from_numpy(imgs), torch.from_numpy(labels))
    want = state_dict_from_jax({"batch_stats": carried(after)[
        "batch_stats"]})
    key = next(k for k in want if k.endswith("running_mean"))
    diff = (plain.model.state_dict()[key] - want[key]).abs().max().item()
    assert diff > 1e-4


def test_trainer_accum_builds_the_accumulated_step(tmp_path):
    """Trainer(args.accum=2): each step runs two micro-batches (the hook
    sees two starts a step); a batch that does not split raises."""
    exp = port_exp()
    exp.data_dir = write_coco_dataset(str(tmp_path / "coco"), 4, 2,
                                      (SIZE, SIZE), num_classes=CLASSES)
    exp.input_size = exp.test_size = (SIZE, SIZE)
    exp.data_num_workers, exp.output_dir = 0, str(tmp_path / "out")
    trainer = Trainer(exp, types.SimpleNamespace(batch_size=BATCH,
                                                 device="cpu", accum=ACCUM))
    marks = []
    trainer.hook = lambda name, m=None: marks.append(name)
    trainer.before_train()
    step = trainer._step_fn()
    imgs, labels = batch()
    trainer.state, _ = step(trainer.state, torch.from_numpy(imgs),
                            torch.from_numpy(labels))
    assert marks.count("start") == ACCUM and trainer.state.step == 1
    with pytest.raises(ValueError, match="does not split into accum=2"):
        step(trainer.state, torch.from_numpy(imgs[:3]),
             torch.from_numpy(labels[:3]))
