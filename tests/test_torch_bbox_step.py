"""The bbox family's model, training step and exps in the port against the
JAX package's: YOLOX with a 4-channel box head (depth 0.33, width 0.25, 3
classes, 64 px, B=2), its weights and whole train state carried across by
the port's bridge.

The JAX model is built with ``packed_early=False`` (the port has no packed
layout: the same parameters, another summation order).  The step runs from
the state after one JAX step (momentum, EMA and the schedule's count all
under way) at a small rate on a batch fixed by ``DATA_SEED``: the loss is
discrete (SimOTA), so at test sizes the fp32 noise of two frameworks'
forwards may flip a match on other data (the same foreground count is held
exactly).  Bounds: loss and metrics
1e-4 relative; updates 2e-2 of the update (plus two ulps of the weight);
parameters and EMA 1e-4 of each tensor's largest value, or the update's
bound where that is larger (biases still near their zero start are all
update); BatchNorm statistics 1e-4 of their scale."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import unfreeze

from eop_tpu.exp import get_exp as j_get_exp
from eop_tpu.losses import YoloxLossConfig as JLossConfig
from eop_tpu.models import YOLOX as JYOLOX
from eop_tpu.train import lr_schedule as j_sched
from eop_tpu.train.optimizer import build_sgd as j_build_sgd
from eop_tpu.train.steps import TrainState as JTrainState
from eop_tpu.train.steps import make_train_step_bbox as j_make_step
from eop_tpu.utils.torch_import import convert_state_dict
from eop_tpu_torch.exp import Exp, get_exp
from eop_tpu_torch.losses import YoloxLossConfig
from eop_tpu_torch.train.steps import make_train_step_bbox
from eop_tpu_torch.utils.weights import state_dict_from_jax, train_state_from_jax

SIZE, BATCH, CLASSES = 64, 2, 3
DEPTH, WIDTH = 0.33, 0.25
EMA_DECAY, MOMENTUM, WEIGHT_DECAY = 0.9998, 0.9, 5e-4
ITERS_PER_EPOCH, EPOCHS = 2, 4
SCHED = dict(warmup_epochs=1, warmup_lr_start=5e-5, no_aug_epochs=1,
             min_lr_ratio=0.05)
BASE_LR = 2e-4
DATA_SEED = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores, and
    PyTorch's default of a thread per core in each worker oversubscribes
    them (the CLI test took 465 s in a 6-worker run, 8 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, unfreeze(tree))


def batch(seed=DATA_SEED):
    """images [B, S, S, 3] in 0..255, labels [B, 50, 5] with 4 boxes each."""
    rng = np.random.RandomState(seed)
    imgs = rng.uniform(0, 255, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    labels = np.zeros((BATCH, 50, 5), np.float32)
    for b in range(BATCH):
        for g in range(4):
            w, h = rng.uniform(10, 30, 2)
            labels[b, g] = (rng.randint(CLASSES), rng.uniform(w, SIZE - w),
                            rng.uniform(h, SIZE - h), w, h)
    return imgs, labels


def momentum_trace(opt_state):
    is_trace = lambda s: type(s).__name__ == "TraceState"  # noqa: E731
    found = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=is_trace)
             if is_trace(s)]
    assert len(found) == 1
    return found[0].trace


@pytest.fixture(scope="module")
def jax_side():
    """The JAX model, the state after one step from a perturbed
    initialisation (the start), the state one more step on the fixed batch
    later and that step's metrics."""
    model = JYOLOX(backbone_type="darknet", depth=DEPTH, width=WIDTH,
                   num_classes=CLASSES, reg_dim=4, packed_early=False)
    sched = j_sched.LRScheduler("yoloxwarmcos", BASE_LR, ITERS_PER_EPOCH,
                                EPOCHS, **SCHED)
    tx = j_build_sgd(j_sched.tabulate_schedule(sched, ITERS_PER_EPOCH
                                               * EPOCHS),
                     momentum=MOMENTUM, weight_decay=WEIGHT_DECAY,
                     nesterov=True)
    rng = np.random.RandomState(1)
    # the port's seeded weights through the JAX package's importer (its
    # jitted init would compile for 10 s)
    variables = convert_state_dict(
        {k: v.numpy() for k, v in port_exp().get_model("cpu").state_dict()
         .items()})

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
    init = JTrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=tx.init(params),
        ema_params=jax.tree_util.tree_map(jnp.copy, params),
        ema_batch_stats=jax.tree_util.tree_map(jnp.copy, stats))
    step = jax.jit(j_make_step(model, tx, JLossConfig(num_classes=CLASSES),
                               ema_decay=EMA_DECAY))
    imgs, labels = batch(DATA_SEED + 1)
    start, _ = step(init, jnp.asarray(imgs), jnp.asarray(labels),
                    jax.random.PRNGKey(0))
    imgs, labels = batch()
    after, metrics = step(start, jnp.asarray(imgs), jnp.asarray(labels),
                          jax.random.PRNGKey(1))
    return model, start, after, metrics


def carried(jstate):
    """The JAX state as numpy, in the form train_state_from_jax takes."""
    return {
        "params": to_np(jstate.params),
        "batch_stats": to_np(jstate.batch_stats),
        "momentum": to_np(momentum_trace(jstate.opt_state)),
        "ema_params": to_np(jstate.ema_params),
        "ema_batch_stats": to_np(jstate.ema_batch_stats),
        "step": int(jstate.step),
    }


def port_exp():
    exp = Exp()
    exp.depth, exp.width, exp.num_classes = DEPTH, WIDTH, CLASSES
    exp.max_epoch, exp.weight_decay = EPOCHS, WEIGHT_DECAY
    exp.warmup_epochs = SCHED["warmup_epochs"]
    exp.warmup_lr = SCHED["warmup_lr_start"]
    exp.no_aug_epochs = SCHED["no_aug_epochs"]
    return exp


def port_state(jstate):
    exp = port_exp()
    model = exp.get_model("cpu").train()
    opt = exp.get_optimizer(model, BATCH, ITERS_PER_EPOCH, lr=BASE_LR)
    return train_state_from_jax(carried(jstate), model, opt)


def test_head_maps_match_jax(jax_side):
    """Eval-mode head maps of the bridged weights (perturbed BatchNorm)
    within 1e-4; the box head has 4 + 1 + 3 channels."""
    model, start, _, _ = jax_side
    imgs, _ = batch(5)
    want, _ = jax.jit(lambda v, x: model.apply(v, x, False))(
        {"params": start.params, "batch_stats": start.batch_stats},
        jnp.asarray(imgs))
    tmodel = port_state(start).model.eval()
    with torch.no_grad():
        got, _ = tmodel(torch.from_numpy(imgs).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        assert g.shape[1] == 8
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), atol=1e-4, rtol=1e-4)


def test_bridge_carries_the_bbox_state(jax_side):
    """train_state_from_jax over a reg_dim=4 model: weights, statistics and
    EMA bit-equal, momentum transposed, no DWA state."""
    _, _, after, _ = jax_side
    want = carried(after)
    state = port_state(after)
    assert state.step == 2 and state.dwa is None
    sd = state.model.state_dict()
    for k, v in state_dict_from_jax({"params": want["params"],
                                     "batch_stats": want["batch_stats"]}
                                    ).items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)
    p = dict(state.model.named_parameters())["head.reg_preds.0.weight"]
    assert p.shape[0] == 4
    assert state.optimizer.state[p]["momentum_buffer"].shape == p.shape


def test_one_step_matches_jax(jax_side):
    """One make_train_step_bbox step from the carried state on the fixed
    batch: loss and metrics 1e-4 (the foreground count equal), the whole
    state as the module docstring states."""
    _, start, after, jm = jax_side
    imgs, labels = batch()
    state = port_state(start)
    step = make_train_step_bbox(YoloxLossConfig(num_classes=CLASSES),
                                ema_decay=EMA_DECAY)
    state, tm = step(state, torch.from_numpy(imgs), torch.from_numpy(labels))
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert state.step == 2 and tm["num_fg"].item() == float(jm["num_fg"])

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
    # the coarse scales' classification branch has no foreground on this
    # batch: no gradient there, in either package (held by the update bound)
    assert moved >= 0.9 * len(state.ema_params)


@pytest.mark.parametrize("name,depth,width", [
    ("yolox-s", 0.33, 0.50), ("yolox-m", 0.67, 0.75), ("yolox-l", 1.0, 1.0),
    ("yolox-x", 1.33, 1.25)])
def test_exp_by_name_matches_eop_tpu(name, depth, width):
    """Every attribute both exps have is equal (the port reads the same
    exps/default file with its ast reader, without importing it)."""
    exp, ref = get_exp(exp_name=name), j_get_exp(exp_name=name)
    assert type(exp) is Exp and (exp.depth, exp.width) == (depth, width)
    shared = set(vars(exp)) & set(vars(ref))
    assert len(shared) > 40
    for k in shared:
        assert getattr(exp, k) == getattr(ref, k), k


@pytest.mark.parametrize("name,needs", [
    ("yolox-nano", "vgg"), ("yolox-tiny", "resnet"), ("yolox-s", "densenet")])
def test_unported_exps_raise_naming_what_they_need(name, needs):
    """Every exps/default model builds since Nano, Tiny and YOLOv3 were
    ported; what is left unported, another backbone_type, raises naming it
    and the ROADMAP queue."""
    exp = get_exp(exp_name=name)
    exp.backbone_type = needs
    with pytest.raises(NotImplementedError, match=f"{needs}.*ROADMAP"):
        exp.get_model("cpu")


def test_trainer_starts_from_a_jax_state(jax_side, tmp_path):
    """Trainer(args.jax_state=...) builds its state through
    train_state_from_jax: the JAX weights, EMA and step count, and the
    schedule continues from that count."""
    import types

    from eop_tpu_torch.train.trainer import Trainer
    from eop_tpu_torch.utils.synth import write_coco_dataset

    _, _, after, _ = jax_side
    exp = port_exp()
    exp.data_dir = write_coco_dataset(str(tmp_path / "coco"), 4, 2,
                                      (SIZE, SIZE), num_classes=CLASSES)
    exp.input_size = exp.test_size = (SIZE, SIZE)
    exp.data_num_workers, exp.output_dir = 0, str(tmp_path / "out")
    trainer = Trainer(exp, types.SimpleNamespace(
        batch_size=BATCH, device="cpu", jax_state=carried(after)))
    trainer.before_train()
    want = state_dict_from_jax({"params": carried(after)["ema_params"]})
    assert trainer.state.step == 2
    for k, v in trainer.state.ema_params.items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    trainer.state.optimizer.set_lr(trainer.state.step)
    assert trainer.state.optimizer.param_groups[0]["lr"] == pytest.approx(
        exp.get_lr_scheduler(exp.basic_lr_per_img * BATCH,
                             trainer.iters_per_epoch).update_lr(2))
