"""Data parallelism over processes (``eop_tpu_torch/parallel``) on the CPU:
two ranks over gloo, spawned by ``tests/_torch_dist_child.py`` (which
imports no JAX), against one process.

* ``GlobalBatchNorm2d`` on two ranks is ``BatchNorm2d`` on the
  concatenated batch: output, input and parameter gradients, and the
  biased running statistics;
* the two-rank 24p step is ``eop_tpu``'s ``shard_train_step`` over
  ``make_mesh(2)`` on the same global batch, with and without ``accum=2``
  (``shard_batch`` in ``_accum_scan``'s layout), from the state
  ``train_state_from_jax`` carries; the construction, the low rate, the
  fixed data seed and the bounds are ``tests/test_torch_train_step.py``'s
  (its module docstring says why);
* the two-rank 24p and bbox steps are the one-process port step on the
  global batch, tightly: with the models in float64 (the bbox loss too;
  the 24p loss computes in fp32), so that fp32 forward noise, which train
  BatchNorm amplifies and the 24p loss's switches can turn into
  gradients several percent apart (test_torch_train_step.py), does not
  hide a fault; in fp32 the two-rank step lies as far from the
  one-process step as from eop_tpu's;
* an ``fsdp`` step is the replicated one (float64), each rank holds about
  half the state's bytes, and the gathered checkpoint loads strictly;
* the ranks' states are bit-equal after the steps;
* the object collectives, ``sync_batch_stats`` and ``shard_inference``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from eop_tpu.losses import Loss24PConfig as JLossConfig
from eop_tpu.parallel import make_mesh
from eop_tpu.parallel import shard_batch as j_shard_batch
from eop_tpu.parallel import shard_train_step as j_shard_train_step
from eop_tpu.train.steps import make_train_step_24p as j_make_step
from eop_tpu_torch.models.yolox import YOLOX, init_weights
from eop_tpu_torch.ops.blocks import BatchNorm2d
from eop_tpu_torch.parallel import (
    GlobalBatchNorm2d,
    convert_global_bn,
    global_batch_norm,
    shard_batch,
)
from eop_tpu_torch.train.checkpoint import (
    load_checkpoint,
    load_ckpt_partial,
    state_to_payload,
)
from eop_tpu_torch.train.optimizer import build_sgd
from eop_tpu_torch.train.steps import create_train_state

from _torch_dist_child import batches_of, build_state, make_step, run_ranks
from test_torch_train_step import (
    BASE_LR,
    CLASSES,
    DATA_SEED,
    DEPTH,
    EMA_DECAY,
    EPOCHS,
    ITERS_PER_EPOCH,
    MOMENTUM,
    N_STEPS,
    SCHED,
    SIZE,
    WEIGHT_DECAY,
    WIDTH,
    assert_state_close,
    carried,
    jax_side,
    port_side,
    start_state,
)

GLOBAL_BATCH = 4   # two ranks; with accum=2, one image a rank a micro-batch
# two ranks against one process, both in float64: metrics relative to their
# scale, states relative to each tensor's update (ten times the gap
# measured: 2.6e-7 and 1.6e-7 for 24p, whose loss computes in fp32; 1.6e-12
# for the bbox step; 6e-13 for fsdp against the replicated step)
TIGHT = {"a1_64": 3e-6, "bbox_64": 2e-11, "fsdp_64": 1e-11}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batches_24p(n, batch=GLOBAL_BATCH, seed=DATA_SEED):
    """``n`` global batches built as tests/test_torch_train_step.py's."""
    rng = np.random.RandomState(seed)
    theta = np.arange(24) * (2 * np.pi / 24)
    out = []
    for _ in range(n):
        imgs = rng.uniform(0, 255, (batch, SIZE, SIZE, 3)).astype(np.float32)
        labels = np.zeros((batch, 50, 51), np.float32)
        for b in range(batch):
            for g in range(3):
                cx, cy = rng.uniform(30, SIZE - 30, 2)
                r = rng.uniform(8, 30, 24)
                labels[b, g, 0] = rng.randint(CLASSES)
                labels[b, g, 1:3] = cx, cy
                labels[b, g, 3::2] = cx + r * np.cos(theta)
                labels[b, g, 4::2] = cy + r * np.sin(theta)
        out.append((imgs, labels))
    return out


def batches_bbox(n, batch=GLOBAL_BATCH, size=64, seed=2):
    """Images in 0..255 and four boxes an image (test_torch_bbox_step.py's
    construction)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        imgs = rng.uniform(0, 255, (batch, size, size, 3)).astype(np.float32)
        labels = np.zeros((batch, 50, 5), np.float32)
        for b in range(batch):
            for g in range(4):
                w, h = rng.uniform(10, 30, 2)
                labels[b, g] = (rng.randint(CLASSES), rng.uniform(w, size - w),
                                rng.uniform(h, size - h), w, h)
        out.append((imgs, labels))
    return out


def spec(family, start, batches, accum=1, fsdp=False, **kw):
    reg_dim = 26 if family == "24p" else 4
    return dict(
        family=family, accum=accum, fsdp=fsdp, start=start,
        model=dict(depth=DEPTH, width=WIDTH, num_classes=CLASSES,
                   reg_dim=reg_dim),
        sched=("yoloxwarmcos", BASE_LR, ITERS_PER_EPOCH, EPOCHS),
        sched_kw=SCHED, momentum=MOMENTUM, weight_decay=WEIGHT_DECAY,
        ema_decay=EMA_DECAY,
        batches=[(torch.from_numpy(i), torch.from_numpy(lb))
                 for i, lb in batches], **kw)


def bbox_start():
    """A seeded bbox model's state after one one-process step (momentum,
    EMA and the schedule under way)."""
    model = init_weights(YOLOX(depth=DEPTH, width=WIDTH, num_classes=CLASSES,
                               reg_dim=4), seed=5)
    model = model.to(memory_format=torch.channels_last)
    opt = build_sgd(model, 1e-3, momentum=MOMENTUM,
                    weight_decay=WEIGHT_DECAY)
    state = create_train_state(model, opt, use_ema=True)
    s = spec("bbox", None, [])
    imgs, labels = batches_bbox(1, seed=9)[0]
    state, _ = make_step(s, None)(state, torch.from_numpy(imgs),
                                  torch.from_numpy(labels))
    return state_to_payload(state)


def one_process(s):
    """The run ``s`` in this process on the whole global batches."""
    state = build_state(s)
    step = make_step(s, None)
    metrics = []
    for imgs, labels in batches_of(s):
        state, m = step(state, imgs, labels)
        metrics.append({k: v.detach().clone() for k, v in m.items()})
    return metrics, state_to_payload(state)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX sharded steps, the two-rank runs and the one-process runs."""
    tmp = tmp_path_factory.mktemp("parallel")
    jmodel, tx = jax_side()
    mesh = make_mesh(2)
    cfg = JLossConfig(num_classes=CLASSES)
    jsteps = {a: j_shard_train_step(j_make_step(jmodel, tx, cfg,
                                                ema_decay=EMA_DECAY,
                                                accum_steps=a), mesh)
              for a in (1, 2)}
    data = batches_24p(1 + N_STEPS)

    def jrun(jstate, accum, batches):
        # the sharded step donates its state: run on a copy
        jstate = jax.tree_util.tree_map(jnp.array, jstate)
        ms = []
        for i, (imgs, labels) in enumerate(batches):
            with mesh:
                sb = j_shard_batch(mesh, {"i": imgs, "l": labels})
                jstate, m = jsteps[accum](jstate, sb["i"], sb["l"],
                                          jax.random.PRNGKey(i))
            ms.append(jax.device_get(m))
        return jstate, ms

    jstart, _ = jrun(start_state(jmodel, tx), 1, data[:1])
    start = state_to_payload(port_side(carried(jstart)))
    specs = {
        "a1": spec("24p", start, data[1:]),
        "a2": spec("24p", start, data[1:], accum=2),
        "a1_64": spec("24p", start, data[1:], float64=True),
        "fsdp_64": spec("24p", start, data[1:], fsdp=True, float64=True,
                        ckpt_dir=str(tmp / "fsdp_ckpt")),
        "bbox_64": spec("bbox", bbox_start(), batches_bbox(N_STEPS),
                        accum=2, float64=True),
    }
    ranks = run_ranks("steps", {"runs": specs}, str(tmp))
    jax_runs = {a: jrun(jstart, a, data[1:]) for a in (1, 2)}
    return dict(jstart=jstart, jax=jax_runs, specs=specs, ranks=ranks,
                one={k: one_process(specs[k]) for k in ("a1_64", "bbox_64")},
                tmp=tmp)


def port_state_of(payload, jstart):
    """A TrainState (the bridge's model and optimizer) holding ``payload``."""
    state = port_side(carried(jstart))
    state, report = load_ckpt_partial(state, payload)
    assert not report["skipped"]
    return state


def assert_rel_close(got, want, rel, what):
    """``got`` within ``rel`` of ``want``'s largest magnitude."""
    got, want = got.double(), want.double()
    scale = max(want.abs().max().item(), 1e-6)
    err = (got - want).abs().max().item()
    assert err <= rel * scale, f"{what}: {err:.3g} > {rel} x {scale:.3g}"


def assert_payloads_close(got, want, start, what, rel):
    """Parameters, EMA and momentum within ``rel`` of each tensor's update
    from ``start`` (the momentum: of its largest value) plus four ulps of
    the tensor; BatchNorm statistics within ``rel`` of their scale; the
    step count equal."""
    def close(g, w, ref, name):
        eps = torch.finfo(w.dtype).eps
        bound = rel * ref + 4 * eps * w.abs().max().item()
        err = (g - w).abs().max().item()
        assert err <= bound, f"{what}: {name}: {err:.3g} > {bound:.3g}"

    for part in ("model", "ema_params", "ema_batch_stats"):
        for k, w in want[part].items():
            if not w.is_floating_point():
                assert torch.equal(got[part][k], w), f"{what}: {part} {k}"
            elif "running_" in k:
                close(got[part][k], w, w.abs().max().item(), f"{part} {k}")
            else:
                update = (w - start[part][k].to(w.dtype)).abs().max().item()
                close(got[part][k], w, update, f"{part} {k}")
    for i, s in want["optimizer"]["state"].items():
        w = s["momentum_buffer"]
        close(got["optimizer"]["state"][i]["momentum_buffer"], w,
              w.abs().max().item(), f"momentum {i}")
    assert got["step"] == want["step"]


def test_global_bn_matches_batchnorm_on_the_concatenated_batch(tmp_path):
    g = torch.Generator().manual_seed(3)
    c = 6
    x = (torch.randn(4, c, 5, 7, generator=g) * 3 + 1).contiguous(
        memory_format=torch.channels_last)
    dy = torch.randn(4, c, 5, 7, generator=g)
    bn = BatchNorm2d(c, eps=1e-3, momentum=0.03)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.uniform_(-0.5, 0.5, generator=g)
        bn.running_var.uniform_(0.5, 2.0, generator=g)
    start = {k: v.clone() for k, v in bn.state_dict().items()}
    ranks = run_ranks("bn", {"c": c, "x": x, "dy": dy, "bn": start},
                      str(tmp_path))
    # bf16: the reference rounds its sums to bf16 (the port's are fp32)
    for name, dtype, tol, ptol in (("fp32", torch.float32, 2e-5, 1e-4),
                                   ("bf16", torch.bfloat16, 2e-2, 1e-2)):
        ref = BatchNorm2d(c, eps=1e-3, momentum=0.03)
        ref.load_state_dict(start)
        xr = x.detach().to(dtype).clone().requires_grad_()
        y = ref.train()(xr)
        y.backward(dy.to(dtype))
        got = [r[name] for r in ranks]
        torch.testing.assert_close(torch.cat([r["y"] for r in got]),
                                   y.detach().float(), atol=tol, rtol=tol)
        torch.testing.assert_close(torch.cat([r["dx"] for r in got]),
                                   xr.grad.float(), atol=tol, rtol=tol)
        # parameter gradients: each rank's share, summing to the whole's
        torch.testing.assert_close(got[0]["dweight"] + got[1]["dweight"],
                                   ref.weight.grad, atol=ptol, rtol=ptol)
        torch.testing.assert_close(got[0]["dbias"] + got[1]["dbias"],
                                   ref.bias.grad, atol=ptol, rtol=ptol)
        for r in got:   # the biased statistics, equal on both ranks
            for k in ("running_mean", "running_var"):
                torch.testing.assert_close(r["state"][k], ref.state_dict()[k],
                                           atol=1e-6, rtol=1e-5)
            assert r["state"]["num_batches_tracked"] == 1
        assert all(torch.equal(got[0]["state"][k], got[1]["state"][k])
                   for k in start)
    # the recompute of a checkpointed forward normalises and updates nothing
    assert not any(r["frozen"]["moved"] for r in ranks)
    torch.testing.assert_close(torch.cat([r["frozen"]["y"] for r in ranks]),
                               torch.cat([r["fp32"]["y"] for r in ranks]),
                               atol=0.05, rtol=0.05)


def test_global_bn_at_one_rank_is_batchnorm():
    """Without a group of two ranks it is ``BatchNorm2d``; the plain
    function with no group gives its result within fp32 noise."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(3, 5, 6, 6, generator=g) * 2 + 0.5
    a, b = BatchNorm2d(5, momentum=0.03), BatchNorm2d(5, momentum=0.03)
    convert_global_bn(b, None)
    assert isinstance(b, GlobalBatchNorm2d)
    assert list(b.state_dict()) == list(a.state_dict())
    assert torch.equal(a.train()(x), b.train()(x))
    assert all(torch.equal(u, v) for u, v in zip(a.state_dict().values(),
                                                   b.state_dict().values()))
    rm, rv = torch.zeros(5), torch.ones(5)
    w, bias = torch.rand(5, generator=g) + 0.5, torch.rand(5, generator=g)
    xr = x.clone().requires_grad_()
    y = global_batch_norm(xr, w, bias, rm, rv, 0.03, 1e-3)
    ref = BatchNorm2d(5, eps=1e-3, momentum=0.03)
    with torch.no_grad():
        ref.weight.copy_(w)
        ref.bias.copy_(bias)
    xq = x.clone().requires_grad_()
    yr = ref.train()(xq)
    torch.testing.assert_close(y, yr, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rm, ref.running_mean, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(rv, ref.running_var, atol=1e-6, rtol=1e-6)
    dy = torch.randn(x.shape, generator=g)
    y.backward(dy)
    yr.backward(dy)
    torch.testing.assert_close(xr.grad, xq.grad, atol=1e-5, rtol=1e-5)


def test_shard_batch_is_the_accum_scan_layout():
    """A rank's rows are the rows ``eop_tpu``'s mesh puts on its device:
    the global batch sharded on the data axis, and with ``accum`` the
    ``[accum, B / accum]`` micro-batch stack sharded per micro-batch."""
    mesh = make_mesh(2)
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    for accum in (1, 2, 4):
        stacked = jax.device_put(jnp.asarray(x).reshape(accum, -1, 3),
                                 NamedSharding(mesh, P(None, "data")))
        for rank in range(2):
            shard = next(s for s in stacked.addressable_shards
                         if s.device == mesh.devices.reshape(-1)[rank])
            np.testing.assert_array_equal(
                shard_batch(x, rank, 2, accum),
                np.asarray(shard.data).reshape(-1, 3))
    with pytest.raises(ValueError):
        shard_batch(x, 0, 3)


@pytest.mark.parametrize("accum", [1, 2])
def test_two_ranks_match_eop_tpu_sharded_step(runs, accum):
    """Per-step loss 1e-4 relative, num_fg equal, every metric 1e-3; the
    state after the steps within test_torch_train_step.py's bounds."""
    jstate, jms = runs["jax"][accum]
    name = f"a{accum}"
    for rank in runs["ranks"]:
        for i, (tm, jm) in enumerate(zip(rank[name]["metrics"], jms)):
            assert set(tm) == set(jm)
            np.testing.assert_allclose(tm["total_loss"].item(),
                                       float(jm["total_loss"]), rtol=1e-4)
            assert tm["num_fg"].item() == float(jm["num_fg"])
            for k in jm:
                np.testing.assert_allclose(
                    tm[k].float().numpy(), np.asarray(jm[k], np.float32),
                    rtol=1e-3, atol=1e-5, err_msg=f"step {i}: {k}")
    tstate = port_state_of(runs["ranks"][0][name]["state"], runs["jstart"])
    assert_state_close(tstate, jstate, runs["jstart"],
                       f"two ranks, accum={accum}")


@pytest.mark.parametrize("name", ["a1_64", "bbox_64"])
def test_two_ranks_match_one_process_on_the_global_batch(runs, name):
    metrics, payload = runs["one"][name]
    for i, (tm, om) in enumerate(zip(runs["ranks"][0][name]["metrics"],
                                     metrics)):
        assert tm["num_fg"].item() == om["num_fg"].item(), i
        for k, v in om.items():
            assert_rel_close(tm[k], v, TIGHT[name], f"{name} step {i}: {k}")
    assert_payloads_close(runs["ranks"][0][name]["state"], payload,
                          runs["specs"][name]["start"], name, TIGHT[name])


def test_ranks_are_bit_equal_after_the_steps(runs):
    r0, r1 = runs["ranks"]
    for name in runs["specs"]:
        a, b = r0[name]["state"], r1[name]["state"]
        for part in ("model", "ema_params", "ema_batch_stats"):
            for k, v in a[part].items():
                assert torch.equal(v, b[part][k]), (name, part, k)
        for i, s in a["optimizer"]["state"].items():
            assert torch.equal(s["momentum_buffer"],
                               b["optimizer"]["state"][i]["momentum_buffer"])
        for m0, m1 in zip(r0[name]["metrics"], r1[name]["metrics"]):
            assert all(torch.equal(m0[k], m1[k]) for k in m0), name


def test_fsdp_step_matches_the_replicated_step(runs):
    """The same steps under ``fsdp``; each rank holds about half of the
    state's bytes (placed, and after the steps with momentum); rank 0's
    checkpoint holds the whole state and loads strictly into one
    device's model."""
    fsdp, repl = runs["ranks"][0]["fsdp_64"], runs["ranks"][0]["a1_64"]
    for i, (a, b) in enumerate(zip(fsdp["metrics"], repl["metrics"])):
        for k in a:
            assert_rel_close(a[k], b[k], TIGHT["fsdp_64"],
                             f"fsdp step {i}: {k}")
    assert_payloads_close(fsdp["state"], repl["state"],
                          runs["specs"]["fsdp_64"]["start"], "fsdp",
                          TIGHT["fsdp_64"])
    for key in ("bytes_placed", "bytes_after"):
        local, total = fsdp[key]
        assert 0.45 <= local / total <= 0.56, (key, local, total)
        local, total = repl[key]
        assert local == total
    ckpt = load_checkpoint(str(runs["tmp"] / "fsdp_ckpt"
                               / "fsdp_64_ckpt.pth"))
    model = YOLOX(depth=DEPTH, width=WIDTH, num_classes=CLASSES,
                  reg_dim=26).double()
    model.load_state_dict(ckpt["state"]["model"], strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, fsdp["state"]["model"][k]), k
    assert not any(k.startswith("module.") for k in ckpt["state"]["model"])


def test_object_collectives_batch_stats_and_sharded_inference(tmp_path):
    x = torch.arange(4 * 3 * 2 * 2, dtype=torch.float32).reshape(4, 3, 2, 2)
    r0, r1 = run_ranks("objects", {"x": x}, str(tmp_path))
    for rank, r in enumerate((r0, r1)):
        assert (r["rank"], r["world"], r["main"]) == (rank, 2, rank == 0)
        assert [g["rank"] for g in r["gathered"]] == [0, 1]
        assert [len(g["blob"]) for g in r["gathered"]] == [7, 507]
        assert r["seeds"][0] == r["seeds"][1] == r["seed"]
        # the mean of the ranks' buffers: 0 and 1, 1 and 3
        assert torch.equal(r["bn"]["running_mean"], torch.full((3,), 0.5))
        assert torch.equal(r["bn"]["running_var"], torch.full((3,), 2.0))
        sums, doubled = r["infer"]
        assert torch.equal(sums, x.sum(dim=1)) and torch.equal(doubled, x * 2)
    assert r0["to_last"] == [] and r1["to_last"] == [{"rank": 0},
                                                     {"rank": 1}]
