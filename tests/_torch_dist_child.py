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
from eop_tpu_torch.parallel.dist import make_mesh
from eop_tpu_torch.parallel.global_bn import convert_global_bn
from eop_tpu_torch.parallel.mesh import (
    place_state,
    shard_batch,
    shard_inference,
    shard_inference_tp,
    shard_train_step,
    state_bytes,
    sync_batch_stats,
)
from eop_tpu_torch.parallel.spatial import convert_spatial

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


def make_step(spec, mesh):
    """The spec's step, run over ``mesh`` (``None``: one process)."""
    from eop_tpu_torch.losses import Loss24PConfig, YoloxLossConfig
    from eop_tpu_torch.train.steps import (
        make_train_step_24p,
        make_train_step_bbox,
    )

    c = spec["model"]["num_classes"]
    group = mesh.data if mesh is not None else None
    if spec["family"] == "24p":
        step = make_train_step_24p(Loss24PConfig(num_classes=c),
                                   ema_decay=spec["ema_decay"],
                                   accum_steps=spec["accum"], group=group)
    else:
        step = make_train_step_bbox(YoloxLossConfig(num_classes=c,
                                                    use_l1=True),
                                    ema_decay=spec["ema_decay"],
                                    accum_steps=spec["accum"], group=group)
    return shard_train_step(step, group, spec["fsdp"], mesh)


def job_steps(inp, rank, world):
    """For each run of the payload: the ranks laid out as its ``spatial``
    and ``tensor`` ask (``make_mesh``; data parallel without them), its
    state under the mesh (``convert_spatial``, ``convert_global_bn``,
    ``place_state``) and the step on this rank's rows of each global
    batch; the metrics, the state gathered whole, the bytes and the
    rank's place.  Then the payload's ``infer`` specs (:func:`run_infer`)
    and its ``loader`` spec (:func:`draw_batches`)."""
    from eop_tpu_torch.train.checkpoint import (
        save_checkpoint,
        state_to_payload,
    )

    out = {}
    for name, spec in inp["runs"].items():
        mesh = make_mesh(spec.get("spatial", 1), spec.get("tensor", 1))
        state = build_state(spec)
        if mesh.space is not None:
            convert_spatial(state.model, mesh.space)
        convert_global_bn(state.model, mesh.data,
                          mesh.data_space if mesh.space else None)
        state = place_state(state, spec["fsdp"], mesh.data, mesh.model)
        placed = state_bytes(state)
        step = make_step(spec, mesh)
        metrics = []
        for imgs, labels in batches_of(spec):
            local = shard_batch((imgs, labels), mesh.data_rank,
                                mesh.data_size, spec["accum"],
                                mesh.space_rank, mesh.spatial)
            state, m = step(state, *local)
            metrics.append({k: v.detach().clone() for k, v in m.items()})
        payload = state_to_payload(state)
        if rank == 0 and spec.get("ckpt_dir"):
            save_checkpoint(payload, False, spec["ckpt_dir"], name)
        out[name] = {"metrics": metrics, "state": payload,
                     "bytes_placed": placed, "bytes_after": state_bytes(state),
                     "coords": (mesh.data_rank, mesh.space_rank,
                                mesh.model_rank)}
    for name, spec in inp.get("infer", {}).items():
        out[name] = run_infer(spec)
    if "loader" in inp:
        out["loader"] = draw_batches(inp["loader"])
    return out


def run_infer(spec):
    """One batch through sharded inference on ``spec``'s mesh: ``exp``
    (an exp's ``get_sharded_infer_fn(mesh=)``, detections) or ``tp``
    (``shard_inference_tp`` of the decoded head maps), on the spec's
    weights."""
    from eop_tpu_torch.exp import get_exp
    from eop_tpu_torch.models.yolox import YOLOX, inference_outputs

    mesh = make_mesh(spec.get("spatial", 1), spec.get("tensor", 1))
    if spec["kind"] == "exp":
        exp = get_exp(exp_name=spec["exp_name"])
        exp.merge(spec["opts"])
        model = exp.get_model("cpu")
        model.load_state_dict(spec["weights"])
        fn = exp.get_sharded_infer_fn(model.eval(), "cpu", mesh=mesh)
        return fn(spec["imgs"])
    model = YOLOX(**spec["model"]).to(memory_format=torch.channels_last)
    model.load_state_dict(spec["weights"])
    model.eval()

    def body(imgs):
        with torch.no_grad():
            return inference_outputs(model(imgs.permute(0, 3, 1, 2))[0])

    return shard_inference_tp(body, model, mesh)(spec["imgs"])


def draw_batches(spec):
    """Two batches of the bbox exp's mosaic loader, built as the trainer
    builds it under ``spec``'s ``spatial`` / ``tensor`` (keyed by the data
    rank, the augmentations by one shared seed), with this rank's place."""
    from types import SimpleNamespace

    from eop_tpu_torch.exp import get_exp
    from eop_tpu_torch.train.trainer import Parallel

    par = Parallel.of(SimpleNamespace(device="cpu", fsdp=False, **{
        k: spec[k] for k in ("spatial", "tensor")}))
    exp = get_exp(exp_name="yolox-s")
    exp.merge(spec["opts"])
    loader = exp.get_data_loader(
        spec["batch"], is_distributed=par.data_world > 1,
        rank=par.data_rank, world_size=par.data_world,
        seed=par.loader_seed())
    it = iter(loader)
    batches = [next(it)[:2] for _ in range(2)]
    del it
    return {"coords": (par.data_rank, par.mesh.space_rank,
                       par.mesh.model_rank), "batches": batches}


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


def job_zoo(inp, rank, world):
    """For each model of the payload and each layout (``spatial`` /
    ``tensor``), a float64 forward of the payload's images under the
    layout (this rank's rows, or its channel slices) and the input
    gradient of the maps' sum of squares (the space ranks' rows summed):
    the head maps and the whole input's gradient."""
    from eop_tpu_torch.exp import get_exp
    from eop_tpu_torch.parallel.spatial import convert_spatial, shard_rows
    from eop_tpu_torch.parallel.tensor import convert_tensor

    out = {}
    for name in inp["models"]:
        for layout in ("spatial", "tensor"):
            mesh = make_mesh(**{layout: world})
            exp = get_exp(exp_name=name)
            exp.merge(inp["opts"])
            model = to_float64(exp.get_model("cpu", seed=0)).eval()
            if mesh.space is not None:
                convert_spatial(model, mesh.space)
            else:
                convert_tensor(model, mesh.model)
            x = inp["imgs"].double().requires_grad_()
            local = shard_rows(x.permute(0, 2, 3, 1), mesh.space_rank,
                               mesh.spatial).permute(0, 3, 1, 2)
            maps = model(local)[0]
            (dx,) = torch.autograd.grad(sum(m.square().sum() for m in maps),
                                        x)
            if mesh.space is not None:
                dist.all_reduce(dx, group=mesh.space)
            out[name, layout] = {"maps": [m.detach() for m in maps],
                                 "dx": dx}
    return out


JOBS = {"bn": job_bn, "objects": job_objects, "steps": job_steps,
        "eval": job_eval, "zoo": job_zoo}


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
