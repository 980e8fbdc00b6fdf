"""The port's trainer on the CPU: ``Trainer24P`` over a synthetic-loader exp
(epochs, the L1 switch, logging cadence, checkpoints, resume), the checkpoint
format, and the exp's training factories against the JAX package's."""

import logging
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eop_tpu.exp.yolox_24p_base import Exp24P as JaxExp24P
from eop_tpu.utils.synth import synthetic_24p_batch as j_synth
from eop_tpu_torch.exp import Exp24P
from eop_tpu_torch.losses import Loss24PConfig
from eop_tpu_torch.train import trainer_24p
from eop_tpu_torch.train.checkpoint import (
    load_checkpoint,
    load_ckpt_partial,
    save_checkpoint,
)
from eop_tpu_torch.train.steps import create_train_state, make_train_step_24p
from eop_tpu_torch.train.trainer_24p import Trainer24P
from eop_tpu_torch.utils.metric import CandidateDropMonitor
from eop_tpu_torch.utils.synth import synthetic_24p_batch, write_24p_dataset


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores, and
    PyTorch's default of a thread per core in each worker oversubscribes
    them (tests/test_torch_bbox_step.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SIZE, BATCH, ITERS = 64, 2, 3


class CyclingLoader:
    """Three seeded synthetic batches, repeated for ever."""

    def __init__(self, batch_size):
        g = torch.Generator().manual_seed(7)
        self.batches = [synthetic_24p_batch(g, batch_size, size=SIZE, ngt=2,
                                            r_lo=5.0, r_hi=12.0)
                        for _ in range(ITERS)]
        self.closed = False

    def __len__(self):
        return ITERS

    def __iter__(self):
        while True:
            for imgs, labels in self.batches:
                # numpy, as a file-backed loader would hand them over
                yield imgs.numpy(), labels.numpy(), None, None

    def shutdown(self):
        self.closed = True


class SynthExp(Exp24P):
    def get_data_loader(self, batch_size, is_distributed=False, rank=0,
                        world_size=1):
        self.loader = CyclingLoader(batch_size)
        return self.loader


def make_exp(tmp_path, max_epoch=2, **overrides):
    exp = SynthExp()
    exp.depth, exp.width, exp.num_classes = 0.33, 0.25, 3
    exp.input_size = exp.test_size = (SIZE, SIZE)
    exp.max_epoch, exp.L1_epoch = max_epoch, 1
    exp.print_interval = 2
    exp.ema = True
    exp.seed = 3
    exp.output_dir = str(tmp_path)
    exp.exp_name = "synth"
    for k, v in overrides.items():
        setattr(exp, k, v)
    return exp


def args(**kw):
    return types.SimpleNamespace(batch_size=BATCH, device="cpu", **kw)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two epochs; the hook records which loss configuration each step used
    and its metrics."""
    tmp = tmp_path_factory.mktemp("run")
    exp = make_exp(tmp)
    trainer = Trainer24P(exp, args())
    events = []
    trainer.hook = lambda name, payload=None: events.append((name, payload))
    made = []
    orig = trainer_24p.make_train_step_24p

    def spy(cfg, **kw):
        made.append(cfg)
        return orig(cfg, **kw)

    trainer_24p.make_train_step_24p = spy
    try:
        state = trainer.train()
    finally:
        trainer_24p.make_train_step_24p = orig
    return exp, trainer, state, events, made, tmp


def test_trainer_runs_two_epochs(trained):
    exp, trainer, state, events, _, _ = trained
    assert state.step == 2 * ITERS and trainer.iters_per_epoch == ITERS
    steps = [p for n, p in events if n == "step"]
    assert len(steps) == 2 * ITERS
    losses = [float(m["total_loss"]) for m in steps]
    assert np.isfinite(losses).all()
    assert set(steps[0]) == {
        "total_loss", "conf_loss", "cls_loss", "l1_loss", "num_fg",
        "cand_dropped", "iou_losses_24", "dwa_reg_w", "dwa_obj_w",
        "dwa_cls_w"}
    assert steps[0]["iou_losses_24"].shape == (24,)
    # phase marks of every step, in order
    names = [n for n, _ in events if n != "step"]
    assert names == ["start", "forward", "loss", "backward",
                     "optimizer"] * (2 * ITERS)
    assert exp.loader.closed
    assert state.model.training and state.ema_params is not None


def test_l1_switches_on_for_the_last_epochs(trained):
    _, _, _, events, made, _ = trained
    assert [c.use_l1 for c in made] == [False, True]
    assert all(c.num_classes == 3 for c in made)
    l1 = [float(p["l1_loss"]) for n, p in events if n == "step"]
    assert l1[:ITERS] == [0.0] * ITERS and all(v > 0 for v in l1[ITERS:])


def test_logging_happens_at_print_interval_only(trained):
    _, _, _, _, _, tmp = trained
    log = (tmp / "synth" / "train_log.txt").read_text()
    lines = [ln for ln in log.splitlines() if " iter " in ln]
    # print_interval 2 over 3 iterations: one line per epoch
    assert len(lines) == 2 and all("iter 2/3" in ln for ln in lines)
    assert "epoch 1/2" in lines[0] and "fg/gt" in lines[0]
    assert log.count("done in") == 2


def test_last_epoch_checkpoint_round_trip(trained):
    exp, _, state, _, _, tmp = trained
    path = tmp / "synth" / "last_epoch_ckpt.pth"
    assert path.exists() and not (tmp / "synth" / "best_ckpt.pth").exists()
    payload = load_checkpoint(str(path))
    assert payload["metadata"] == {"start_epoch": 2}
    saved = payload["state"]
    assert saved["step"] == state.step
    for k, v in state.model.state_dict().items():
        assert torch.equal(saved["model"][k], v), k
    for k, v in state.ema_params.items():
        assert torch.equal(saved["ema_params"][k], v), k
    assert set(saved["ema_batch_stats"]) == set(state.ema_batch_stats)
    assert torch.equal(saved["dwa"]["last_iou"], state.dwa.last_iou)
    bufs = [s["momentum_buffer"] for s in saved["optimizer"]["state"].values()]
    assert len(bufs) == len(list(state.model.parameters()))


def test_resume_continues_to_an_identical_next_step(tmp_path):
    """Three epochs straight against two epochs, a new process's worth of
    objects, ``--resume`` and the third epoch: the same state, bit for bit
    (the loader restarts its cycle at an epoch boundary, as it would)."""
    straight = Trainer24P(make_exp(tmp_path / "a", max_epoch=3), args()).train()
    Trainer24P(make_exp(tmp_path / "b", max_epoch=2, L1_epoch=0),
               args()).train()
    resumed_trainer = Trainer24P(make_exp(tmp_path / "b", max_epoch=3),
                                 args(resume=True))
    resumed = resumed_trainer.train()
    assert resumed_trainer.start_epoch == 2
    assert resumed.step == straight.step == 3 * ITERS
    for (k, a), b in zip(straight.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    for k in straight.ema_params:
        assert torch.equal(straight.ema_params[k], resumed.ema_params[k]), k
    for k in straight.ema_batch_stats:
        assert torch.equal(straight.ema_batch_stats[k],
                           resumed.ema_batch_stats[k]), k
    for pa, pb in zip(straight.model.parameters(), resumed.model.parameters()):
        assert torch.equal(straight.optimizer.state[pa]["momentum_buffer"],
                           resumed.optimizer.state[pb]["momentum_buffer"])
    assert torch.equal(straight.dwa.last_iou, resumed.dwa.last_iou)


def test_ckpt_and_explicit_start_epoch(tmp_path):
    """``--ckpt`` loads weights without moving the epoch; ``--resume`` with
    ``start_epoch`` overrides the stored one."""
    Trainer24P(make_exp(tmp_path, max_epoch=1), args()).train()
    ckpt = str(tmp_path / "synth" / "last_epoch_ckpt.pth")
    fine = Trainer24P(make_exp(tmp_path / "other", max_epoch=1),
                      args(ckpt=ckpt))
    state = fine.train()
    assert fine.start_epoch == 0 and state.step == 2 * ITERS
    again = Trainer24P(make_exp(tmp_path, max_epoch=3),
                       args(resume=True, start_epoch=2))
    state = again.train()
    assert again.start_epoch == 2 and state.step == 2 * ITERS


def _small_state(width=0.25, seed=0):
    exp = Exp24P()
    exp.depth, exp.width, exp.num_classes = 0.33, width, 3
    model = exp.get_model("cpu", seed=seed)
    return create_train_state(model, exp.get_optimizer(model, 2),
                              use_ema=True, with_dwa=True)


def test_checkpoint_save_is_atomic_and_marks_best(tmp_path):
    state = _small_state()
    path = save_checkpoint(state, True, str(tmp_path), "last_epoch",
                           metadata={"start_epoch": 5})
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "best_ckpt.pth", "last_epoch_ckpt.pth"]      # no temporary left
    assert load_checkpoint(path)["metadata"]["start_epoch"] == 5
    best = load_checkpoint(str(tmp_path / "best_ckpt.pth"))
    assert best["state"]["step"] == 0 and best["state"]["dwa"] is not None


def test_load_ckpt_partial_is_shape_tolerant(tmp_path):
    """A checkpoint of another width: tensors whose shapes agree load, the
    others keep their values and are reported."""
    src = _small_state(width=0.25, seed=1)
    one_step = make_train_step_24p(Loss24PConfig(num_classes=3), 0.9998)
    g = torch.Generator().manual_seed(0)
    imgs, labels = synthetic_24p_batch(g, 2, size=64, ngt=2, r_lo=5.0,
                                       r_hi=12.0)
    one_step(src, imgs, labels)            # momentum and step now exist
    payload = load_checkpoint(save_checkpoint(src, False, str(tmp_path), "w"))

    same = _small_state(width=0.25, seed=2)
    same, report = load_ckpt_partial(same, payload["state"])
    assert report["skipped"] == [] and same.step == 1
    for (k, a), b in zip(src.model.state_dict().items(),
                         same.model.state_dict().values()):
        assert torch.equal(a, b), k
    p0 = next(iter(same.model.parameters()))
    assert same.optimizer.state[p0]["momentum_buffer"].abs().max() > 0

    wider = _small_state(width=0.375, seed=2)
    before = {k: v.clone() for k, v in wider.model.state_dict().items()}
    wider, report = load_ckpt_partial(wider, payload["state"])
    skipped = {name for name, _, _ in report["skipped"]}
    loaded = set(report["loaded"])
    assert skipped and loaded and not skipped & loaded
    for k, v in wider.model.state_dict().items():
        name = f"model/{k}"
        want = payload["state"]["model"][k] if name in loaded else before[k]
        assert torch.equal(v, want), k
    # the 3-class prediction biases have the same shape at every width
    assert "model/head.cls_preds.0.bias" in loaded
    assert "model/backbone.backbone.dark2.0.conv.weight" in skipped


def test_get_data_loader_names_its_queue(tmp_path):
    """The file loader the exp builds (it raised NotImplementedError before
    the file dataset was ported): one epoch's length from the rank's share,
    and a first batch in eop_tpu's structure.  Without a card, the trainer
    refuses to start unless asked for the CPU."""
    img_dir, lab_dir = write_24p_dataset(str(tmp_path), 5, (48, 80), seed=9)
    exp = Exp24P()
    exp.input_size, exp.data_num_workers = (SIZE, SIZE), 0
    exp.data_dir, exp.label_dir = img_dir, lab_dir
    loader = exp.get_data_loader(BATCH)
    assert len(loader) == 3                          # ceil(5 / 2)
    # a rank's share is 5 // 2 = 2 indices, its batch 4 // 2 = 2 images
    assert len(exp.get_data_loader(4, is_distributed=True, rank=1,
                                   world_size=2)) == 1
    imgs, labels, (hs, ws), ids = next(iter(loader))
    assert imgs.shape == (BATCH, SIZE, SIZE, 3) and imgs.dtype == torch.float32
    assert labels.shape == (BATCH, 50, 51)
    assert hs.tolist() == [48, 48] and ws.tolist() == [80, 80]
    assert ids.shape == (BATCH, 1) and 0 <= ids.min() and ids.max() <= 4
    assert (labels.sum(dim=2) > 0).any(dim=1).all()  # every image has a row
    with pytest.raises(RuntimeError):   # no card here, and none asked away
        if torch.cuda.is_available():
            raise RuntimeError("a card is present")
        Trainer24P(make_exp("unused"), types.SimpleNamespace(batch_size=2))


def test_eval_model_is_built_once_and_loaded_anew(trained):
    """The hook's eval-mode model is built at the first evaluation and
    loaded at each: loaded with other weights after a forward has filled its
    HWIO and folded-BatchNorm caches, it gives exactly what a fresh model
    loaded with them gives."""
    exp, trainer, state, _, _, _ = trained
    x = torch.from_numpy(np.random.RandomState(0).uniform(
        0, 255, (BATCH, SIZE, SIZE, 3)).astype(np.float32)).permute(0, 3, 1, 2)
    model = trainer.eval_model(state)                # the EMA weights
    with torch.inference_mode():
        ema_out = [h.clone() for h in model(x)[0]]
    exp.ema = False
    try:
        assert trainer.eval_model(state) is model    # now the live weights
    finally:
        exp.ema = True
    assert not model.training
    fresh = exp.get_model("cpu", seed=5)
    fresh.load_state_dict(state.model.state_dict())
    with torch.inference_mode():
        got, want = model(x)[0], fresh(x)[0]
    for g, w, e in zip(got, want, ema_out):
        assert torch.equal(g, w)
        assert not torch.equal(g, e)


def test_eval_after_a_training_step_uses_the_new_weights():
    """One process, eval then train then eval: the eval forward's folded
    BatchNorm and cached HWIO weights follow the step's in-place updates of
    the weights and running statistics (caches keyed by tensor versions), so
    the model gives what a fresh model loaded from its state gives."""
    exp = Exp24P()
    exp.depth, exp.width, exp.num_classes = 0.33, 0.25, 3
    model = exp.get_model("cpu", seed=0)
    g = torch.Generator().manual_seed(1)
    imgs, labels = synthetic_24p_batch(g, BATCH, size=SIZE, ngt=2, r_lo=5.0,
                                       r_hi=12.0)
    x = imgs.permute(0, 3, 1, 2)
    with torch.inference_mode():
        before = [h.clone() for h in model(x)[0]]
    state = create_train_state(model, exp.get_optimizer(model, BATCH),
                               use_ema=False, with_dwa=True)
    make_train_step_24p(Loss24PConfig(num_classes=3))(state, imgs, labels)
    model.eval()
    fresh = exp.get_model("cpu", seed=5)
    fresh.load_state_dict(model.state_dict())
    with torch.inference_mode():
        after, want = model(x)[0], fresh(x)[0]
    for a, w, b in zip(after, want, before):
        assert torch.equal(a, w)
        assert not torch.equal(a, b)


def test_training_fields_match_the_jax_exp():
    j, t = JaxExp24P(), Exp24P()
    for name in ("warmup_epochs", "max_epoch", "warmup_lr", "basic_lr_per_img",
                 "scheduler", "no_aug_epochs", "min_lr_ratio", "ema",
                 "ema_decay", "L1_epoch", "ckpt_interval", "weight_decay",
                 "momentum", "print_interval", "eval_interval", "input_size",
                 "multiscale_range", "seed", "output_dir", "test_size",
                 "test_conf", "nmsthre", "reference_parity"):
        assert getattr(t, name) == getattr(j, name), name
    for step in (0, 1, 17, 4000):
        assert t.random_resize(step) == j.random_resize(step)
    t.seed = j.seed = 5
    assert t.random_resize(3) == j.random_resize(3)
    a = j.get_lr_scheduler(0.01, 10)
    b = t.get_lr_scheduler(0.01, 10)
    assert [a.update_lr(i) for i in range(0, 20000, 997)] == [
        b.update_lr(i) for i in range(0, 20000, 997)]


def test_get_optimizer_follows_the_schedule():
    exp = Exp24P()
    exp.max_epoch, exp.warmup_epochs, exp.no_aug_epochs = 4, 1, 1
    model = torch.nn.Conv2d(1, 1, 1)
    fixed = exp.get_optimizer(model, 64)
    assert fixed.lr_schedule is None
    assert fixed.param_groups[0]["lr"] == pytest.approx(0.01)
    assert fixed.param_groups[0]["nesterov"]
    sched = exp.get_lr_scheduler(0.02, 5)
    opt = exp.get_optimizer(model, 64, iters_per_epoch=5, lr=0.02)
    for it in (0, 3, 5, 19, 20, 10 ** 6):   # clipped past the last iteration
        opt.set_lr(it)
        assert opt.param_groups[0]["lr"] == sched.update_lr(min(it, 20))


@pytest.mark.parametrize("tsize", [(96, 96), (32, 48), (64, 64)])
def test_preprocess_matches_jax(tsize):
    """Bilinear resize (antialiased when shrinking, as jax.image.resize is)
    1e-3 of the 0..255 range; the label rescale exact."""
    rng = np.random.RandomState(0)
    imgs = rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    labels = np.zeros((2, 50, 51), np.float32)
    labels[:, :3] = rng.uniform(1, 60, (2, 3, 51))
    j, t = JaxExp24P(), Exp24P()
    j.input_size = t.input_size = (64, 64)
    want_i, want_l = j.preprocess(jnp.asarray(imgs), jnp.asarray(labels), tsize)
    got_i, got_l = t.preprocess(torch.from_numpy(imgs),
                                torch.from_numpy(labels), tsize)
    assert tuple(got_i.shape) == (2, *tsize, 3)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), atol=0.255)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=1e-6)


def test_synthetic_batch_layout_matches_jax():
    """Another random stream, the same layout and ranges."""
    import jax

    g = torch.Generator().manual_seed(0)
    imgs, labels = synthetic_24p_batch(g, 3, size=320, ngt=5)
    j_imgs, j_labels = j_synth(jax.random.PRNGKey(0), 3, size=320, ngt=5)
    assert imgs.shape == j_imgs.shape and labels.shape == j_labels.shape
    assert imgs.dtype == labels.dtype == torch.float32
    valid = labels.sum(dim=2) > 0
    np.testing.assert_array_equal(valid.numpy(),
                                  np.asarray(j_labels.sum(axis=2) > 0))
    assert 0 <= imgs.min() and imgs.max() <= 255
    rows = labels[valid]
    assert (rows[:, 0] == 0).all()                        # class 0
    dx = rows[:, 3::2] - rows[:, 1:2]
    dy = rows[:, 4::2] - rows[:, 2:3]
    r = torch.sqrt(dx * dx + dy * dy)
    assert 10.0 <= r.min() and r.max() <= 80.0
    assert 100.0 <= rows[:, 1:3].min() and rows[:, 1:3].max() <= 220.0
    # ray 0 points along +x, ray 6 along +y
    np.testing.assert_allclose(dy[:, 0].numpy(), 0.0, atol=1e-4)
    assert (dx[:, 0] > 0).all() and (dy[:, 6] > 0).all()
    again, _ = synthetic_24p_batch(torch.Generator().manual_seed(0), 3,
                                   size=320, ngt=5)
    assert torch.equal(imgs, again)


def test_candidate_drop_monitor_warns_once_per_window(caplog):
    log = logging.getLogger("test_drop_monitor")
    mon = CandidateDropMonitor(log, window=3)
    with caplog.at_level(logging.WARNING, logger="test_drop_monitor"):
        for dropped in (0, 0, 0):
            mon.update(dropped)
        assert not caplog.records
        for dropped in (torch.tensor(4), 0, 1, 7):
            mon.update(dropped)
    assert len(caplog.records) == 1
    assert "shed 5 candidate anchors over the last 3" in caplog.text


class RecordingWriter:
    """A tensorboard writer that keeps its scalars: {tag: [(step, v)]}."""

    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, step):
        self.scalars.setdefault(tag, []).append((step, value))


@pytest.mark.parametrize("with_writer", [True, False])
def test_tensorboard_writes_one_row_per_step_with_one_fetch_per_print(
        tmp_path, with_writer):
    """``k x print_interval`` steps: a row of scalars per step, equal to the
    step's metrics (eop_tpu writes every step), fetched to the host once per
    print; without a writer the prints alone fetch."""
    exp = make_exp(tmp_path, max_epoch=2, print_interval=ITERS)
    trainer = Trainer24P(exp, args())
    trainer.tblogger = RecordingWriter() if with_writer else None
    steps = []
    trainer.hook = lambda name, m=None: name == "step" and steps.append(
        {k: v.clone() for k, v in m.items()})
    trainer.train()
    assert len(steps) == 2 * ITERS
    assert trainer.host_fetches == 2  # one per print, nothing at epoch ends
    if not with_writer:
        return
    tb = trainer.tblogger.scalars
    assert len(tb) == 3 + 24 + 24 + 2 + 1
    for tag, rows in tb.items():
        assert [s for s, _ in rows] == list(range(2 * ITERS)), tag
    for s, m in enumerate(steps):
        assert tb["train/total_loss"][s][1] == float(m["total_loss"])
        assert tb["train/cand_dropped"][s][1] == float(m["cand_dropped"])
        assert tb["dwa_weight/obj"][s][1] == float(m["dwa_obj_w"])
        for r in (0, 23):
            assert tb[f"iou_loss/radius_{r:02d}"][s][1] == float(
                m["iou_losses_24"][r])
            assert tb[f"dwa_weight/reg_{r:02d}"][s][1] == float(
                m["dwa_reg_w"][r])


def test_tensorboard_rows_of_a_partial_print_window_flush_at_epoch_end(
        tmp_path):
    exp = make_exp(tmp_path, max_epoch=1, print_interval=2)
    trainer = Trainer24P(exp, args())
    trainer.tblogger = RecordingWriter()
    trainer.train()
    # iteration 2 prints (steps 0-1); step 2 is written at the epoch's end
    assert [s for s, _ in trainer.tblogger.scalars["train/total_loss"]] == [
        0, 1, 2]
    assert trainer.host_fetches == 2
