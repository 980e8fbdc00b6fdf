"""The training step as a whole: the JAX package's ``make_train_step_24p``
and the port's, started from one state carried across by
``train_state_from_jax``, on the same numpy batches.

The JAX model is built with ``packed_early=False``: the Exp's ``"auto"`` would
pick the packed early-backbone layout for training, which the port does not
have (same parameters, another summation order).

How the comparison is built, and why.  Two fp32 forwards of this model in
train mode (BatchNorm over 32 to 512 values per channel) differ by 1e-4 on
head maps of scale 10, whichever framework runs them: the port in float64
lies as far from either.  The reference's loss is not smooth (SimOTA is
discrete; the circle GIoU clips acos arguments at +-0.99 and switches
branches at containment), so that noise now and then lands on the other side
of a switch (noise of that size injected into the head maps does so in a few
percent of batches) and the gradient jumps by several percent while the
loss agrees to 1e-5.  At the default rate such a difference grows tenfold
per step.  So:

* everything smooth is held tightly on shared inputs: the model's backward
  under one cotangent, and the optimizer and EMA arithmetic under one
  gradient tree (the loss's own gradient is held the same way in
  test_torch_loss_24p.py);
* the free-running steps run at a rate where the trajectories cannot part
  (updates 1e-4 of the weights) on batches fixed by ``DATA_SEED``, on which
  no switch flips, and hold everything to ten times the gap measured there
  (worst tensor, with and without accumulation): parameter and EMA updates
  2e-2 of each tensor's update (measured 2.0e-3) plus two ulps of the
  weight, momentum 2e-2 of its largest value (measured 2.2e-3), BN
  statistics 1e-4 of their scale (measured 9.6e-6), DWA 5e-4 (measured
  2.7e-5).  A wrong factor, sign or nesterov term or a missing average in
  the step's wiring moves these by tens of percent (weight decay is 1e-4 of
  the gradient here: the shared-gradient test holds it)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import unfreeze

from eop_tpu.losses import Loss24PConfig as JLossConfig
from eop_tpu.models import YOLOX as JYOLOX
from eop_tpu.models import init_model
from eop_tpu.models.yolox import training_outputs as j_training_outputs
from eop_tpu.train import lr_schedule as j_sched
from eop_tpu.train.optimizer import build_sgd as j_build_sgd
from eop_tpu.train.steps import TrainState as JTrainState
from eop_tpu.train.steps import make_train_step_24p as j_make_step
from eop_tpu_torch.losses import Loss24PConfig, simota_assign_24p
from eop_tpu_torch.models.yolox import YOLOX, training_outputs
from eop_tpu_torch.train import lr_schedule as t_sched
from eop_tpu_torch.train.ema import ema_decay_at
from eop_tpu_torch.train.optimizer import build_sgd
from eop_tpu_torch.train.steps import create_train_state, make_train_step_24p
from eop_tpu_torch.utils.weights import (
    state_dict_from_jax,
    train_state_from_jax,
)

from importlib import import_module


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores, and
    PyTorch's default of a thread per core in each worker oversubscribes
    them (tests/test_torch_bbox_step.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


j_l24 = import_module("eop_tpu.losses.loss_24p")

SIZE, BATCH, CLASSES = 128, 2, 3
DEPTH, WIDTH = 0.33, 0.25
EMA_DECAY, MOMENTUM, WEIGHT_DECAY = 0.9998, 0.9, 5e-4
ITERS_PER_EPOCH, EPOCHS = 2, 4
SCHED = dict(warmup_epochs=1, warmup_lr_start=5e-6, no_aug_epochs=1,
             min_lr_ratio=0.05)
BASE_LR = 2e-5
N_STEPS = 3
DATA_SEED = 4


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, unfreeze(tree))


def batches(n, seed=DATA_SEED):
    """n batches: images [B, S, S, 3] in 0..255 and labels [B, 50, 51] with
    three star polygons each."""
    rng = np.random.RandomState(seed)
    theta = np.arange(24) * (2 * np.pi / 24)
    out = []
    for _ in range(n):
        imgs = rng.uniform(0, 255, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
        labels = np.zeros((BATCH, 50, 51), np.float32)
        for b in range(BATCH):
            for g in range(3):
                cx, cy = rng.uniform(30, SIZE - 30, 2)
                r = rng.uniform(8, 30, 24)
                labels[b, g, 0] = rng.randint(CLASSES)
                labels[b, g, 1:3] = cx, cy
                labels[b, g, 3::2] = cx + r * np.cos(theta)
                labels[b, g, 4::2] = cy + r * np.sin(theta)
        out.append((imgs, labels))
    return out


def momentum_trace(opt_state):
    """The optax momentum trace (a tree shaped like params) inside a chained
    optimizer state."""
    is_trace = lambda s: type(s).__name__ == "TraceState"  # noqa: E731
    found = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=is_trace)
             if is_trace(s)]
    assert len(found) == 1
    return found[0].trace


def jax_side():
    model = JYOLOX(backbone_type="darknet", depth=DEPTH, width=WIDTH,
                   num_classes=CLASSES, reg_dim=26, packed_early=False)
    sched = j_sched.LRScheduler("yoloxwarmcos", BASE_LR, ITERS_PER_EPOCH,
                                EPOCHS, **SCHED)
    tx = j_build_sgd(
        j_sched.tabulate_schedule(sched, ITERS_PER_EPOCH * EPOCHS),
        momentum=MOMENTUM, weight_decay=WEIGHT_DECAY, nesterov=True)
    return model, tx


def start_state(model, tx):
    """A JAX TrainState after one step from a perturbed initialisation, so
    that momentum, EMA, DWA and the step count are all non-trivial."""
    rng = np.random.RandomState(1)
    variables = to_np(init_model(model, jax.random.PRNGKey(0),
                                 jnp.zeros((1, SIZE, SIZE, 3))))

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
    return JTrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=tx.init(params),
        ema_params=jax.tree_util.tree_map(jnp.copy, params),
        ema_batch_stats=jax.tree_util.tree_map(jnp.copy, stats),
        dwa=j_l24.DWAState.init())


def carried(jstate):
    """The JAX state as numpy, in the form train_state_from_jax takes."""
    return {
        "params": to_np(jstate.params),
        "batch_stats": to_np(jstate.batch_stats),
        "momentum": to_np(momentum_trace(jstate.opt_state)),
        "ema_params": to_np(jstate.ema_params),
        "ema_batch_stats": to_np(jstate.ema_batch_stats),
        "dwa": {k: np.asarray(v) for k, v in jstate.dwa._asdict().items()},
        "step": int(jstate.step),
    }


def port_side(state_np):
    model = YOLOX(depth=DEPTH, width=WIDTH, num_classes=CLASSES, reg_dim=26)
    model = model.to(memory_format=torch.channels_last)
    sched = t_sched.LRScheduler("yoloxwarmcos", BASE_LR, ITERS_PER_EPOCH,
                                EPOCHS, **SCHED)
    opt = build_sgd(model, sched.update_lr, momentum=MOMENTUM,
                    weight_decay=WEIGHT_DECAY, nesterov=True)
    return train_state_from_jax(state_np, model, opt)


def assert_state_close(tstate, jstate, jstart, what):
    """The port's state against the JAX state ``jstate`` taken through the
    bridge, both ``N_STEPS`` after ``jstart`` (tolerances: module docstring).
    """
    want, start = carried(jstate), carried(jstart)

    def close(got, ref, bound, name):
        np.testing.assert_allclose(got.detach().numpy(), ref.numpy(),
                                   atol=bound, rtol=0,
                                   err_msg=f"{what}: {name}")

    def bridged(c, ema=False):
        pre = "ema_" if ema else ""
        return state_dict_from_jax({"params": c[pre + "params"],
                                    "batch_stats": c[pre + "batch_stats"]})

    live, live0 = bridged(want), bridged(start)
    ema = bridged(want, ema=True)
    sd = tstate.model.state_dict()
    tema = {**tstate.ema_params, **tstate.ema_batch_stats}
    moved = 0
    for k, v in live.items():
        if not v.is_floating_point():
            continue
        update = (v - live0[k]).abs().max().item()
        moved += update > 0
        if "running_" in k:   # BN statistics, forward only: 1e-4 of scale
            bound = 1e-4 * max(v.abs().max().item(), 1e-3)
        else:                 # + two ulps of the weight itself
            bound = 2e-2 * update + 2.4e-7 * v.abs().max().item()
        close(sd[k], v, bound, k)
        close(tema[k], ema[k], bound, f"ema {k}")
    assert moved == len(tema)   # every tensor took an update
    mom = state_dict_from_jax({"params": want["momentum"]})
    for name, p in tstate.model.named_parameters():
        close(tstate.optimizer.state[p]["momentum_buffer"], mom[name],
              2e-2 * mom[name].abs().max().item(), f"momentum {name}")
    for k, v in tstate.dwa._asdict().items():
        ref = torch.tensor(np.asarray(want["dwa"][k]))
        close(v, ref, 5e-4 * ref.abs().max().item(), f"dwa {k}")
    assert tstate.step == want["step"]


@pytest.fixture(scope="module")
def common():
    jmodel, tx = jax_side()
    data = batches(1 + N_STEPS)
    cfg = JLossConfig(num_classes=CLASSES)
    jstep = jax.jit(j_make_step(jmodel, tx, cfg, ema_decay=EMA_DECAY))
    jstate, _ = jstep(start_state(jmodel, tx), jnp.asarray(data[0][0]),
                      jnp.asarray(data[0][1]), jax.random.PRNGKey(0))
    return jmodel, tx, cfg, jstep, jstate, data[1:]


def test_bridge_carries_the_whole_state(common):
    _, _, _, _, jstate, _ = common
    tstate = port_side(carried(jstate))
    assert tstate.step == 1
    want = carried(jstate)
    sd = tstate.model.state_dict()
    for k, v in state_dict_from_jax(
            {"params": want["params"],
             "batch_stats": want["batch_stats"]}).items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)
    ema = state_dict_from_jax({"params": want["ema_params"],
                               "batch_stats": want["ema_batch_stats"]})
    for k, v in {**tstate.ema_params, **tstate.ema_batch_stats}.items():
        np.testing.assert_array_equal(v.numpy(), ema[k].numpy(), err_msg=k)
    for k, v in tstate.dwa._asdict().items():
        np.testing.assert_array_equal(v.numpy(), want["dwa"][k])
    # momentum of a conv kernel took the HWIO -> OIHW transpose
    p = dict(tstate.model.named_parameters())[
        "backbone.backbone.dark2.0.conv.weight"]
    buf = tstate.optimizer.state[p]["momentum_buffer"]
    assert buf.shape == p.shape and buf.abs().max() > 0


def test_first_step_assignment_is_bit_equal(common):
    """Train-mode forward of both packages from the carried state, then
    SimOTA on each side's own predictions: fg_mask and matched_gt equal."""
    jmodel, _, cfg, _, jstate, data = common
    imgs, labels = data[0]
    (heads, _), _ = jmodel.apply(
        {"params": jstate.params, "batch_stats": jstate.batch_stats},
        jnp.asarray(imgs), True, mutable=["batch_stats"])
    dec, _, grids, strides = j_training_outputs(heads, reg_dim=26)
    lab = jnp.asarray(labels)
    want = jax.vmap(lambda lxy, gc, gv, pp, ol, cl: j_l24.simota_assign_24p(
        lxy, gc, gv, pp, ol, cl, grids, strides, cfg))(
            lab[..., 1:], lab[..., 0], jnp.sum(lab, axis=2) > 0,
            dec[..., :26], dec[..., 26], dec[..., 27:])

    tstate = port_side(carried(jstate))
    tstate.model.train()
    with torch.no_grad():
        theads, _ = tstate.model(torch.from_numpy(imgs).permute(0, 3, 1, 2))
        tdec, _, tgrids, tstrides = training_outputs(theads, reg_dim=26)
        tl = torch.from_numpy(labels)
        got = simota_assign_24p(
            tl[..., 1:], tl[..., 0], tl.sum(dim=2) > 0, tdec[..., :26],
            tdec[..., 26], tdec[..., 27:], tgrids, tstrides,
            Loss24PConfig(num_classes=CLASSES))
    # train-mode BN over 32 to 512 values per channel amplifies fp32 rounding:
    # the port in float64 lies as far from either fp32 run (1e-4 on raw maps
    # of scale 10) as they lie from each other; exp() carries that to 6e-3
    # relative on the decoded radii
    np.testing.assert_allclose(tdec.numpy(), np.asarray(dec), atol=1e-2,
                               rtol=1e-2)
    np.testing.assert_array_equal(got.fg_mask.numpy(),
                                  np.asarray(want.fg_mask))
    np.testing.assert_array_equal(got.matched_gt.numpy(),
                                  np.asarray(want.matched_gt))
    assert int(got.fg_mask.sum()) > 6


def test_model_backward_matches_jax_under_one_cotangent(common):
    """Train-mode forward of both packages from the carried state, then the
    same random cotangent on the head maps pulled back to the parameters:
    every gradient within 2e-3 of the tensor's largest value (measured 2e-4;
    smooth, so forward noise only scales through).  This is the model's whole
    backward on the CPU: the plain dgrad and wgrad of phase_conv, train-mode
    BN, the SPP pool, upsampling and concatenation."""
    jmodel, _, _, _, jstate, data = common
    imgs, _ = data[0]

    def fwd(p):
        (heads, _), _ = jmodel.apply(
            {"params": p, "batch_stats": jstate.batch_stats},
            jnp.asarray(imgs), True, mutable=["batch_stats"])
        return heads

    jheads, vjp = jax.vjp(fwd, jstate.params)
    rng = np.random.RandomState(5)
    cot = [rng.randn(*h.shape).astype(np.float32) for h in jheads]
    (jgrads,) = vjp([jnp.asarray(c) for c in cot])
    want = state_dict_from_jax({"params": to_np(jgrads)})

    tstate = port_side(carried(jstate))
    tstate.model.train()
    theads, _ = tstate.model(torch.from_numpy(imgs).permute(0, 3, 1, 2))
    torch.autograd.backward(
        theads, [torch.from_numpy(c).permute(0, 3, 1, 2) for c in cot])
    for name, p in tstate.model.named_parameters():
        ref = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=2e-3 * np.abs(ref).max(),
                                   err_msg=name)


def test_optimizer_and_ema_match_jax_on_shared_gradients(common):
    """Two updates of both optimizers and EMAs with the same random gradient
    trees, from the carried state (momentum, schedule count 1, weight decay
    on conv kernels): parameters, momentum and EMA 1e-6 of each tensor's
    scale.  The arithmetic only: no model, no loss."""
    import optax

    from eop_tpu.train.ema import ema_update as j_ema_update
    from eop_tpu_torch.train.ema import ema_update

    _, tx, _, _, jstate, _ = common
    tstate = port_side(carried(jstate))
    named = dict(tstate.model.named_parameters())
    rng = np.random.RandomState(6)
    params, opt_state = jstate.params, jstate.opt_state
    ema, step = jstate.ema_params, int(jstate.step)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32)),
            params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        ema = j_ema_update(ema, params, step + 1, EMA_DECAY)

        for name, g in state_dict_from_jax({"params": to_np(grads)}).items():
            named[name].grad = g
        tstate.optimizer.set_lr(step)
        tstate.optimizer.step()
        ema_update(tstate.ema_params, named, step + 1, EMA_DECAY)
        step += 1

    trace = momentum_trace(opt_state)
    for got, tree, what in (
            (named, params, "param"),
            ({n: tstate.optimizer.state[p]["momentum_buffer"]
              for n, p in named.items()}, trace, "momentum"),
            (tstate.ema_params, ema, "ema")):
        want = state_dict_from_jax({"params": to_np(tree)})
        for name, ref in want.items():
            np.testing.assert_allclose(
                got[name].detach().numpy(), ref.numpy(), rtol=0,
                atol=1e-6 * max(ref.abs().max().item(), 1.0),
                err_msg=f"{what} {name}")
    # the schedule moved the rate between the two updates
    assert tstate.optimizer.param_groups[0]["lr"] == pytest.approx(
        t_sched.LRScheduler("yoloxwarmcos", BASE_LR, ITERS_PER_EPOCH, EPOCHS,
                            **SCHED).update_lr(step - 1))


def test_three_steps_with_ema_match_jax(common):
    """Per-step total loss 1e-4 relative and every metric 1e-3 (all decided
    by the forward); after the steps parameters, BN statistics, EMA, momentum
    and DWA as the module docstring states."""
    _, _, _, jstep, jstate, data = common
    jstart = jstate
    tstate = port_side(carried(jstate))
    step = make_train_step_24p(Loss24PConfig(num_classes=CLASSES),
                               ema_decay=EMA_DECAY)
    for i, (imgs, labels) in enumerate(data):
        jstate, jm = jstep(jstate, jnp.asarray(imgs), jnp.asarray(labels),
                           jax.random.PRNGKey(i))
        tstate, tm = step(tstate, torch.from_numpy(imgs),
                          torch.from_numpy(labels))
        assert set(tm) == set(jm)
        np.testing.assert_allclose(tm["total_loss"].item(),
                                   float(jm["total_loss"]), rtol=1e-4)
        assert tm["num_fg"].item() == float(jm["num_fg"])
        for k in jm:
            np.testing.assert_allclose(
                tm[k].float().numpy(), np.asarray(jm[k], np.float32),
                rtol=1e-3, atol=1e-5, err_msg=f"step {i}: {k}")
    assert tstate.step == 1 + N_STEPS
    assert_state_close(tstate, jstate, jstart, "after 3 steps")
    # the EMA is a state of its own, apart from the live parameters
    assert any((tstate.ema_params[n] - p).abs().max() > 0
               for n, p in tstate.model.named_parameters())


def test_three_steps_with_accumulation_match_jax(common):
    """accum_steps=2: BN statistics and DWA advance per micro-batch (of one
    image), gradients are averaged, optimizer and EMA apply once."""
    jmodel, tx, cfg, _, jstate, data = common
    jstart = jstate
    jstep = jax.jit(j_make_step(jmodel, tx, cfg, ema_decay=EMA_DECAY,
                                accum_steps=2))
    tstate = port_side(carried(jstate))
    step = make_train_step_24p(Loss24PConfig(num_classes=CLASSES),
                               ema_decay=EMA_DECAY, accum_steps=2)
    for i, (imgs, labels) in enumerate(data):
        jstate, jm = jstep(jstate, jnp.asarray(imgs), jnp.asarray(labels),
                           jax.random.PRNGKey(i))
        tstate, tm = step(tstate, torch.from_numpy(imgs),
                          torch.from_numpy(labels))
        np.testing.assert_allclose(tm["total_loss"].item(),
                                   float(jm["total_loss"]), rtol=1e-4)
        for k in jm:
            np.testing.assert_allclose(
                tm[k].float().numpy(), np.asarray(jm[k], np.float32),
                rtol=1e-3, atol=1e-5, err_msg=f"step {i}: {k}")
    assert_state_close(tstate, jstate, jstart, "after 3 accumulated steps")
    with pytest.raises(ValueError):
        make_train_step_24p(Loss24PConfig(num_classes=CLASSES),
                            accum_steps=3)(tstate, torch.zeros(2, 8, 8, 3),
                                           torch.zeros(2, 50, 51))


def test_lr_schedule_values_equal():
    """Every scheduler of the zoo returns the JAX package's value at every
    iteration, and the port's optimizer applies it per update."""
    cases = [
        ("cos", {}),
        ("warmcos", dict(warmup_epochs=2, warmup_lr_start=1e-5)),
        ("yoloxwarmcos", SCHED),
        ("yoloxsemiwarmcos", dict(warmup_epochs=1, semi_epoch=2,
                                  iters_per_epoch_semi=5, no_aug_epochs=1)),
        ("multistep", dict(milestones=[1, 3], gamma=0.1)),
    ]
    for name, kw in cases:
        a = j_sched.LRScheduler(name, 0.02, 7, 5, **kw)
        b = t_sched.LRScheduler(name, 0.02, 7, 5, **kw)
        for it in range(7 * 5 + 1):
            assert a.update_lr(it) == b.update_lr(it), (name, it)
    with pytest.raises(ValueError):
        t_sched.LRScheduler("nope", 0.1, 1, 1)
    lin = torch.nn.Conv2d(1, 1, 1)
    sched = t_sched.LRScheduler("yoloxwarmcos", BASE_LR, ITERS_PER_EPOCH,
                                EPOCHS, **SCHED)
    opt = build_sgd(lin, sched.update_lr)
    for it in (0, 1, 5):
        opt.set_lr(it)
        assert all(g["lr"] == sched.update_lr(it) for g in opt.param_groups)


def test_sgd_groups_decay_and_ema_ramp():
    """Weight decay reaches conv kernels only; a fixed rate stays fixed; the
    EMA ramp is d * (1 - exp(-updates / 2000)) with 1-based updates."""
    model = YOLOX(depth=DEPTH, width=WIDTH, num_classes=CLASSES, reg_dim=26)
    opt = build_sgd(model, 0.1, weight_decay=5e-4)
    decayed, plain = opt.param_groups
    assert decayed["weight_decay"] == 5e-4 and plain["weight_decay"] == 0.0
    assert all(p.dim() == 4 for p in decayed["params"])
    assert all(p.dim() == 1 for p in plain["params"])
    assert len(decayed["params"]) + len(plain["params"]) == len(
        list(model.parameters()))
    assert decayed["nesterov"] and decayed["momentum"] == 0.9
    opt.set_lr(10)
    assert decayed["lr"] == 0.1
    np.testing.assert_allclose(ema_decay_at(1), 0.9998 * (1 - np.exp(-1 / 2000)))
    state = create_train_state(model, opt, use_ema=True, with_dwa=True)
    assert state.step == 0 and state.dwa.last_iou.shape == (24,)
    assert set(state.ema_batch_stats) == {
        k for k, v in model.state_dict().items()
        if k.endswith(("running_mean", "running_var"))}
    assert not any(k.endswith("num_batches_tracked")
                   for k in state.ema_batch_stats)
    assert create_train_state(model, opt, use_ema=False).ema_params is None
    # global-norm clipping scales every gradient before the update
    clipped = build_sgd(torch.nn.Conv2d(1, 1, 1), 1.0, momentum=0.0,
                        nesterov=False, clip_grad_norm=0.5)
    (p, q) = [p for g in clipped.param_groups for p in g["params"]]
    p.grad, q.grad = torch.full_like(p, 3.0), torch.full_like(q, 4.0)
    before = p.detach().clone()
    clipped.step()
    np.testing.assert_allclose((before - p.detach()).item(), 0.3, rtol=1e-4)
