"""One bbox training step of YOLOX-Nano's structure (depth 0.33, width
0.25, ``depthwise=True``) and of YOLOv3 (YOLOFPN over Darknet-21: the
step's JAX compile at depth 53 costs twice as much, and Darknet-53 is held
alone in ``tests/test_torch_zoo_models.py``) in the port
against the JAX package's (3 classes, 64 px, B=2), from one state carried
across by the port's bridge, and the exps ``-n yolox-nano|yolox-tiny|yolov3``
against ``eop_tpu``'s.

The step starts from random weights with BatchNorm away from the identity
(the shapes of ``init`` through ``jax.eval_shape``; no init compile), at a
small rate, on a batch fixed by ``DATA_SEED`` (see
``tests/test_torch_bbox_step.py`` for why the data is fixed).  Bounds: the
loss and its parts 1e-4 relative, the foreground count (the SimOTA
assignment's size) equal, the head's prediction layers' updates (what the
assignment decides) within 2e-2 of the update plus two ulps of the weight,
the whole update within 5e-2 in relative L2 norm, and the BatchNorm
statistics within 1e-4 of their scale.  Per tensor, a deep backbone's
update is fp32 noise: measured on this YOLOv3 step, the port in fp32 and in
fp64 differ by the whole update on some BatchNorm scales, and by 5.6e-3 of
the whole update's norm (the port in fp32 against JAX: 8.5e-3)."""

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
from eop_tpu_torch.exp import Exp, get_exp
from eop_tpu_torch.exp.build import read_exp_file
from eop_tpu_torch.losses import YoloxLossConfig
from eop_tpu_torch.train.steps import make_train_step_bbox
from eop_tpu_torch.utils.weights import (
    state_dict_from_jax,
    train_state_from_jax,
)
from test_torch_zoo_models import jax_yolov3, torch_yolov3

SIZE, BATCH, CLASSES = 64, 2, 3
MOMENTUM, WEIGHT_DECAY, EMA_DECAY = 0.9, 5e-4, 0.9998
ITERS_PER_EPOCH, EPOCHS = 2, 4
SCHED = dict(warmup_epochs=1, warmup_lr_start=5e-5, no_aug_epochs=1,
             min_lr_ratio=0.05)
BASE_LR = 2e-4
DATA_SEED = 2
MODELS = {
    # JAX model, the port's exp settings, the port's model where the exp
    # does not build it (YOLOv3 over Darknet-21)
    "nano": (lambda: JYOLOX(depth=0.33, width=0.25, num_classes=CLASSES,
                            depthwise=True, packed_early=False),
             dict(depth=0.33, width=0.25, depthwise=True), None),
    "yolov3": (lambda: jax_yolov3(21, CLASSES), dict(model_kind="yolov3"),
               lambda: torch_yolov3(21, CLASSES)),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
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


def random_variables(module, seed=0):
    """numpy variables of ``module``'s init shapes: LeCun-normal kernels,
    obj / cls prediction biases at the prior, BatchNorm away from the
    identity."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), False))
    rng = np.random.RandomState(seed)

    def fill(tree, path=()):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = fill(v, path + (k,))
                continue
            if k == "kernel":
                a = rng.randn(*v.shape) / np.sqrt(np.prod(v.shape[:-1]))
            elif k in ("scale", "var"):
                a = rng.uniform(0.7, 1.3, v.shape)
            elif k == "bias" and path[-1][:8] in ("cls_pred", "obj_pred"):
                a = np.full(v.shape, -np.log(99.0))
            else:
                a = rng.randn(*v.shape) * 0.05
            out[k] = a.astype(np.float32)
        return out

    return fill(dict(shapes))


def port_exp(kind):
    exp = Exp()
    for k, v in MODELS[kind][1].items():
        setattr(exp, k, v)
    exp.num_classes = CLASSES
    exp.max_epoch, exp.weight_decay = EPOCHS, WEIGHT_DECAY
    exp.warmup_epochs = SCHED["warmup_epochs"]
    exp.warmup_lr = SCHED["warmup_lr_start"]
    exp.no_aug_epochs = SCHED["no_aug_epochs"]
    return exp


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_one_step_matches_jax(kind):
    model = MODELS[kind][0]()
    variables = random_variables(model)
    sched = j_sched.LRScheduler("yoloxwarmcos", BASE_LR, ITERS_PER_EPOCH,
                                EPOCHS, **SCHED)
    tx = j_build_sgd(j_sched.tabulate_schedule(sched, ITERS_PER_EPOCH
                                               * EPOCHS),
                     momentum=MOMENTUM, weight_decay=WEIGHT_DECAY,
                     nesterov=True)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    start = JTrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=tx.init(params),
        ema_params=jax.tree_util.tree_map(jnp.copy, params),
        ema_batch_stats=jax.tree_util.tree_map(jnp.copy, stats))
    imgs, labels = batch()
    step = jax.jit(j_make_step(model, tx, JLossConfig(num_classes=CLASSES),
                               ema_decay=EMA_DECAY))
    after, jm = step(start, jnp.asarray(imgs), jnp.asarray(labels),
                     jax.random.PRNGKey(1))

    exp = port_exp(kind)
    tmodel = (exp.get_model("cpu") if MODELS[kind][2] is None
              else MODELS[kind][2]()).train()
    opt = exp.get_optimizer(tmodel, BATCH, ITERS_PER_EPOCH, lr=BASE_LR)
    zeros = jax.tree_util.tree_map(np.zeros_like, variables["params"])
    state = train_state_from_jax(
        {**variables, "momentum": zeros, "ema_params": variables["params"],
         "ema_batch_stats": variables["batch_stats"], "step": 0},
        tmodel, opt)
    tstep = make_train_step_bbox(YoloxLossConfig(num_classes=CLASSES),
                                 ema_decay=EMA_DECAY)
    state, tm = tstep(state, torch.from_numpy(imgs), torch.from_numpy(labels))

    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert tm["num_fg"].item() == float(jm["num_fg"]) > 0

    live = state_dict_from_jax({"params": to_np(after.params),
                                "batch_stats": to_np(after.batch_stats)})
    live0 = state_dict_from_jax(variables)
    sd = state.model.state_dict()
    num = den = 0.0
    for k, v in live.items():
        if not v.is_floating_point():
            continue
        if "running_" in k:
            np.testing.assert_allclose(
                sd[k].numpy(), v.numpy(), rtol=0,
                atol=1e-4 * max(v.abs().max().item(), 1e-3), err_msg=k)
            continue
        got, want = (sd[k] - live0[k]).double(), (v - live0[k]).double()
        num += ((got - want) ** 2).sum().item()
        den += (want ** 2).sum().item()
        if "_preds." in k:
            update = want.abs().max().item()
            np.testing.assert_allclose(
                got.numpy(), want.numpy(), rtol=0, err_msg=k,
                atol=2e-2 * update + 2.4e-7 * v.abs().max().item())
    assert den > 0 and (num / den) ** 0.5 <= 5e-2


@pytest.mark.parametrize("name", ["yolox-nano", "yolox-tiny", "yolov3"])
def test_zoo_exps_by_name_match_eop_tpu(name):
    """Every attribute both exps have is equal; Nano is depthwise at 416
    px, Tiny trains at 640 px (the reference's ``input_scale`` typo) and
    evaluates at 416, YOLOv3 builds the YOLOv3 model."""
    exp, ref = get_exp(exp_name=name), j_get_exp(exp_name=name)
    shared = set(vars(exp)) & set(vars(ref))
    assert len(shared) > 40
    for k in shared:
        assert getattr(exp, k) == getattr(ref, k), k
    want = {"yolox-nano": ((416, 416), (416, 416), True, "yolox"),
            "yolox-tiny": ((640, 640), (416, 416), False, "yolox"),
            "yolov3": ((640, 640), (640, 640), False, "yolov3")}[name]
    assert (tuple(exp.input_size), tuple(exp.test_size), exp.depthwise,
            exp.model_kind) == want
    model = exp.get_model("cpu")
    assert type(model).__name__ == {"yolov3": "YOLOv3"}.get(name, "YOLOX")


def test_exp_file_with_another_method_raises_naming_file_and_line(tmp_path):
    """The reader takes __init__ and yolov3.py's get_model; any other
    method, or a get_model that builds something else, raises with the
    file, the line and the method."""
    base = ("from eop_tpu.exp import Exp as _Scale\n\n\n"
            "class Exp(_Scale):\n"
            "    def __init__(self):\n"
            "        super().__init__()\n"
            "        self.depth = 0.33\n\n")
    other = tmp_path / "other.py"
    other.write_text(base + "    def get_data_loader(self, batch_size):\n"
                            "        return None\n")
    with pytest.raises(ValueError,
                       match=rf"{other}:9: method 'get_data_loader'"):
        get_exp(exp_file=str(other))
    model = tmp_path / "model.py"
    model.write_text(base + "    def get_model(self):\n"
                            "        from eop_tpu.models import YOLOX\n"
                            "        return YOLOX(num_classes=1, width=1.0, "
                            "dtype=None)\n")
    with pytest.raises(ValueError, match=rf"{model}:9: method 'get_model'"):
        get_exp(exp_file=str(model))
    v3 = tmp_path / "v3.py"
    v3.write_text(base + "    def get_model(self):\n"
                         "        from eop_tpu.models import YOLOv3\n"
                         "        return YOLOv3(num_classes=self.num_classes, "
                         "width=self.width, dtype=None)\n")
    family, settings = read_exp_file(str(v3))
    assert family is Exp and settings == {"depth": 0.33,
                                          "model_kind": "yolov3"}
