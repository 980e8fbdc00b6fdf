"""One rank of the port's multi-process CPU tests (over gloo).

    python tests/_torch_dist_child.py JOB RANK WORLD PORT IN OUT

Imports torch and eop_tpu_torch only, never JAX or eop_tpu.  Starts the
process group through ``parallel.dist.init_distributed`` (a short timeout,
so that a hang fails), runs the job named ``JOB`` on the payload that
``torch.save`` wrote to ``IN``, and saves its results to ``OUT`` (one file
a rank).  The tests start the ranks with :func:`run_ranks` and hold the
results against a one-process run."""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys

import torch
import torch.distributed as dist

from eop_tpu_torch.parallel import dist as pdist
from eop_tpu_torch.parallel.global_bn import convert_global_bn
from eop_tpu_torch.parallel.mesh import (
    place_state,
    shard_batch,
    shard_inference,
    shard_train_step,
    state_bytes,
    sync_batch_stats,
)

TIMEOUT_S = 90
HERE = os.path.dirname(os.path.abspath(__file__))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(job: str, inp, tmp_dir, world: int = 2,
              timeout: float = 150.0):
    """Run ``job`` on ``inp`` in ``world`` child processes and return each
    rank's results, in rank order.  A child that fails, or a run that
    outlasts ``timeout`` seconds (every child then killed), fails with the
    children's output."""
    inp_path = os.path.join(tmp_dir, f"{job}_in.pt")
    torch.save(inp, inp_path)
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(HERE), env.get("PYTHONPATH", "")])
    outs = [os.path.join(tmp_dir, f"{job}_rank{r}.pt") for r in range(world)]
    logs = [open(os.path.join(tmp_dir, f"{job}_rank{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_dist_child.py"), job,
         str(r), str(world), str(port), inp_path, outs[r]],
        stdout=logs[r], stderr=subprocess.STDOUT, env=env)
        for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = []
    for r, f in enumerate(logs):
        f.seek(0)
        text.append(f"--- rank {r} (rc {procs[r].returncode}) ---\n"
                    + f.read()[-4000:])
        f.close()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"{job} failed:\n" + "\n".join(text))
    return [torch.load(o, weights_only=False) for o in outs]


def job_bn(inp, rank, world):
    """GlobalBatchNorm2d on this rank's rows, forward and backward, fp32
    and bf16; then the frozen (recompute) forward."""
    from eop_tpu_torch.ops.blocks import BatchNorm2d, batch_stats_frozen

    out = {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        bn = BatchNorm2d(inp["c"], eps=1e-3, momentum=0.03)
        bn.load_state_dict(inp["bn"])
        convert_global_bn(bn, dist.group.WORLD)
        x = shard_batch(inp["x"], rank, world).to(dtype).requires_grad_()
        dy = shard_batch(inp["dy"], rank, world).to(dtype)
        y = bn.train()(x)
        y.backward(dy)
        out[name] = {"y": y.detach().float(), "dx": x.grad.float(),
                     "dweight": bn.weight.grad, "dbias": bn.bias.grad,
                     "state": bn.state_dict()}
    with batch_stats_frozen():
        before = {k: v.clone() for k, v in bn.state_dict().items()}
        y = bn(shard_batch(inp["x"], rank, world))
    out["frozen"] = {"y": y.detach(), "moved": any(
        not torch.equal(before[k], v) for k, v in bn.state_dict().items())}
    return out


def job_objects(inp, rank, world):
    """The object collectives, sync_batch_stats and shard_inference."""
    from eop_tpu_torch.ops.blocks import BatchNorm2d

    pdist.synchronize()
    gathered = pdist.all_gather({"rank": rank,
                                 "blob": b"x" * (7 + 500 * rank)})
    to_last = pdist.gather({"rank": rank}, dst=world - 1)
    seed = pdist.shared_random_seed()
    bn = BatchNorm2d(3)
    with torch.no_grad():
        bn.running_mean.fill_(float(rank))
        bn.running_var.fill_(1.0 + 2.0 * rank)
    sync_batch_stats(bn, dist.group.WORLD)
    fn = shard_inference(lambda x: (x.sum(dim=1), x * 2), dist.group.WORLD)
    return {"gathered": gathered, "to_last": to_last, "seed": seed,
            "seeds": pdist.all_gather(seed), "bn": bn.state_dict(),
            "infer": fn(inp["x"]), "rank": pdist.get_rank(),
            "world": pdist.get_world_size(), "main": pdist.is_main_process()}


def build_state(spec):
    """A TrainState of the spec's model and optimizer with the payload's
    state laid over it (``train.checkpoint.load_ckpt_partial``)."""
    from eop_tpu_torch.models.yolox import YOLOX
    from eop_tpu_torch.train import lr_schedule
    from eop_tpu_torch.train.checkpoint import load_ckpt_partial
    from eop_tpu_torch.train.optimizer import build_sgd
    from eop_tpu_torch.train.steps import create_train_state

    model = YOLOX(**spec["model"]).to(memory_format=torch.channels_last)
    if spec.get("float64"):
        model = to_float64(model)
    sched = lr_schedule.LRScheduler(*spec["sched"], **spec["sched_kw"])
    opt = build_sgd(model, sched.update_lr, momentum=spec["momentum"],
                    weight_decay=spec["weight_decay"], nesterov=True)
    state = create_train_state(model, opt, use_ema=True,
                               with_dwa=spec["family"] == "24p")
    state, report = load_ckpt_partial(state, spec["start"])
    assert not report["skipped"], report["skipped"][:3]
    return state


def to_float64(model):
    """The model in float64: parameters, buffers and every module's compute
    ``dtype`` (the bbox loss keeps float64 in float64; the 24p loss
    computes in fp32)."""
    model = model.double()
    for m in model.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float64
    return model


def batches_of(spec):
    """The spec's global batches, in float64 where the model is."""
    dtype = torch.float64 if spec.get("float64") else torch.float32
    return [(i.to(dtype), lb.to(dtype)) for i, lb in spec["batches"]]


def make_step(spec, group):
    from eop_tpu_torch.losses import Loss24PConfig, YoloxLossConfig
    from eop_tpu_torch.train.steps import (
        make_train_step_24p,
        make_train_step_bbox,
    )

    c = spec["model"]["num_classes"]
    if spec["family"] == "24p":
        step = make_train_step_24p(Loss24PConfig(num_classes=c),
                                   ema_decay=spec["ema_decay"],
                                   accum_steps=spec["accum"], group=group)
    else:
        step = make_train_step_bbox(YoloxLossConfig(num_classes=c,
                                                    use_l1=True),
                                    ema_decay=spec["ema_decay"],
                                    accum_steps=spec["accum"], group=group)
    return shard_train_step(step, group, spec["fsdp"])


def job_steps(inp, rank, world):
    """For each run of the payload: its state, ``convert_global_bn``,
    ``place_state`` and the data-parallel step on this rank's rows of each
    global batch; the metrics, the state gathered whole, and the bytes."""
    from eop_tpu_torch.train.checkpoint import save_checkpoint, state_to_payload

    group = dist.group.WORLD
    out = {}
    for name, spec in inp["runs"].items():
        state = build_state(spec)
        convert_global_bn(state.model, group)
        state = place_state(state, spec["fsdp"], group)
        placed = state_bytes(state)
        step = make_step(spec, group)
        metrics = []
        for imgs, labels in batches_of(spec):
            local = shard_batch((imgs, labels), rank, world, spec["accum"])
            state, m = step(state, *local)
            metrics.append({k: v.detach().clone() for k, v in m.items()})
        payload = state_to_payload(state)
        if rank == 0 and spec.get("ckpt_dir"):
            save_checkpoint(payload, False, spec["ckpt_dir"], name)
        out[name] = {"metrics": metrics, "state": payload,
                     "bytes_placed": placed, "bytes_after": state_bytes(state)}
    return out


def jittered(dets):
    """Detections with each box moved by 0 to 4 px and a score of 0.1 to 1,
    both keyed on the box itself: an AP between 0 and 1 that does not
    depend on which rank or batch a row came from."""
    from eop_tpu_torch.eval.postprocess import Detections

    rows = dets.rows.clone()
    key = torch.floor(rows[..., 0] * 7 + rows[..., 1] * 13)
    rows[..., 0:4] += (key % 5)[..., None]
    rows[..., 4] = (key % 10 + 1) / 10
    return Detections(rows, dets.valid)


def job_eval(inp, rank, world):
    """Distributed evaluation of the payload's exp: the seeded model's AP
    (and the COCO detection count), a label oracle's AP and a jittered
    one's, the rows each rank loaded, and one batch through the sharded
    infer function."""
    from eop_tpu_torch.exp import get_exp
    from eop_tpu_torch.utils.synth import LabelOracle

    exp = get_exp(inp.get("exp_file"), inp.get("exp_name"))
    exp.merge(inp["opts"])
    model = exp.get_model("cpu")
    model.load_state_dict(inp["weights"])
    ev = exp.get_evaluator(inp["batch"], is_distributed=True)
    ap = exp.eval(model, ev, is_distributed=True)[:2]
    oracles = {}
    for name, wrap in (("oracle", lambda d: d), ("jittered", jittered)):
        oracle_ev = exp.get_evaluator(inp["batch"], is_distributed=True)
        ds = oracle_ev.dataloader.dataset
        oracle = LabelOracle(ds, "cpu", indices=range(rank, len(ds), world))
        oracles[name] = oracle_ev.evaluate(
            lambda imgs, o=oracle, w=wrap: w(o(imgs)), distributed=True)[:2]
    return {"ap": ap, "detections": ev.timings.get("detections"), **oracles,
            "rows": list(ev.dataloader.sampler),
            "sharded": exp.get_sharded_infer_fn(model, "cpu")(inp["imgs"])}


JOBS = {"bn": job_bn, "objects": job_objects, "steps": job_steps,
        "eval": job_eval}


def main() -> None:
    job, rank, world, port, inp_path, out_path = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    pdist.init_distributed("cpu", coordinator=f"127.0.0.1:{port}",
                           num_processes=world, process_id=rank,
                           timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        inp = torch.load(inp_path, weights_only=False)
        torch.save(JOBS[job](inp, rank, world), out_path)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
