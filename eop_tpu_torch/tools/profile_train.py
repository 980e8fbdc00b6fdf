"""Profile the 24p training step on the card: step time, images a second
and the device time by kernel (counterpart of ``tools/profile_train.py``).

    python -m eop_tpu_torch.tools.profile_train [--batch 32] [--size 640] \
        [--steps 20] [--trace-steps 3] [--top 25] [--logdir DIR] \
        [--no-trace] [--device cuda]
    python -m eop_tpu_torch.tools.profile_train --attach HOST:PORT \
        [--duration-ms 3000] [--top 25] [--logdir DIR]

Local mode builds ``eop_tpu``'s model (24p head, ``--depth`` / ``--width``,
80 classes, bf16 compute), nesterov SGD at 0.01 with EMA and the DWA loss
weights, and one seeded ``synthetic_24p_batch`` (8 polygons an image),
then prints ``compile+first step`` (the first step: the kernels' build and
load, cuDNN's search), the best of 3 passes of ``--steps`` steps, and,
unless ``--no-trace``, one warm-up step and ``--trace-steps`` steps under
``torch.profiler`` (``utils/profiler.py::trace``) whose device time it
prints by category and by kernel, summed over the traced steps, beside the
launch counters of ``phase_conv``'s wrappers over the same steps.
``--attach`` asks a trainer started with ``--profile-port`` for a capture
of ``--duration-ms`` of its steps (``utils/profiler.py::ProfileServer``)
and prints the same tables and the trainer's launch counters over the
recorded steps from its answer.  On the CPU (``--device cpu``)
the tables hold the operators' host time.  ``--packed`` is accepted and
ignored; ``--hlo-cost`` raises (XLA's cost model is not ported).
"""

from __future__ import annotations

import argparse
import tempfile
import time


def make_parser():
    ap = argparse.ArgumentParser("eop_tpu_torch.tools.profile_train")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--trace-steps", type=int, default=3)
    ap.add_argument("--logdir", default=None)
    ap.add_argument("--depth", type=float, default=0.33)
    ap.add_argument("--width", type=float, default=0.50)
    ap.add_argument("--no-trace", action="store_true")
    ap.add_argument("--hlo-cost", action="store_true",
                    help="not ported: raises (XLA's cost model by source "
                         "line; ROADMAP.md, 'Not ported, on purpose')")
    ap.add_argument("--packed", default="train",
                    choices=["train", "true", "false"],
                    help="accepted and ignored: the packed early layout is "
                         "ROADMAP.md queue 1 item 9 and changes no result")
    ap.add_argument("--attach", default=None, metavar="HOST:PORT",
                    help="capture a live trace from a running trainer "
                         "started with --profile-port (no local model is "
                         "built); prints the same per-op device tables")
    ap.add_argument("--duration-ms", type=int, default=3000,
                    help="capture window for --attach")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap


def print_tables(tables: dict, what: str) -> None:
    """``eop_tpu``'s two tables, ``{ms:10.3f} ms  {name}`` a row."""
    for title in ("by category", "top ops"):
        print(f"--- device time {title}{what} ---")
        for name, ms, _ in tables[title]:
            print(f"{ms:10.3f} ms  {name}")


def attach(args) -> dict:
    """Print the tables of a live trainer's capture; returns its answer."""
    from ..utils.profiler import attach as capture

    answer = capture(args.attach, args.duration_ms, args.logdir, args.top)
    print(f"live trace ({args.duration_ms} ms window, {answer['steps']} "
          f"steps in {answer['window_ms']:.0f} ms) in {answer['logdir']}")
    print_tables(answer["tables"], "")
    print_launches(answer["launches"], "recorded")
    return answer


def print_launches(launches: dict, what: str) -> None:
    print(f"phase_conv launches over the {what} steps: "
          + ", ".join(f"{k} {n}" for k, n in launches.items()))


def build(args):
    """(step, state, images, labels) of local mode on ``args.device``."""
    import torch

    from ..exp import Exp24P
    from ..losses import Loss24PConfig
    from ..train.optimizer import build_sgd
    from ..train.steps import create_train_state, make_train_step_24p
    from ..utils.device import resolve_device
    from ..utils.synth import synthetic_24p_batch

    device = resolve_device(args.device)
    exp = Exp24P()
    exp.depth, exp.width, exp.num_classes = args.depth, args.width, 80
    exp.compute_dtype = "bfloat16"
    model = exp.get_model(device, seed=0).train()
    state = create_train_state(model, build_sgd(model, 0.01),
                               use_ema=True, with_dwa=True)
    step = make_train_step_24p(Loss24PConfig(num_classes=80),
                               ema_decay=0.9998)
    # about 8 plausible 24-gons an image
    imgs, labels = synthetic_24p_batch(
        torch.Generator(device).manual_seed(0), args.batch, args.size, ngt=8)
    return step, state, imgs, labels


def main(argv=None) -> dict:
    """Runs the tool; returns what it printed as numbers: ``first_step_s``,
    ``step_ms``, ``images_per_s``, ``logdir``, ``tables`` (rows ``(name,
    ms, calls)``) and ``launches`` (``utils/profiler.py::launch_counts``
    over the traced steps), or the answer of ``--attach``."""
    args = make_parser().parse_args(argv)
    if args.hlo_cost:
        raise NotImplementedError(
            "--hlo-cost: XLA's cost model is not ported (ROADMAP.md, 'Not "
            "ported, on purpose': utils/{xplane,hlo_cost}.py)")
    if args.attach:
        return attach(args)

    import torch

    from ..utils.profiler import launch_counts, launches_since, tables, \
        trace

    step, state, imgs, labels = build(args)
    cuda = imgs.is_cuda

    def sync(metrics):
        float(metrics["total_loss"])  # one fetch waits for the device

    t0 = time.perf_counter()
    state, metrics = step(state, imgs, labels)
    sync(metrics)
    out = {"first_step_s": time.perf_counter() - t0}
    print(f"compile+first step: {out['first_step_s']:.1f}s")

    dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, metrics = step(state, imgs, labels)
        sync(metrics)
        dt = min(dt, (time.perf_counter() - t0) / args.steps)
    out.update(step_ms=dt * 1e3, images_per_s=args.batch / dt)
    print(f"train step: {dt * 1e3:.2f} ms  ({args.batch / dt:.1f} img/s)  "
          f"B={args.batch} @{args.size}px  (best of 3 passes)")
    if args.no_trace:
        return out

    logdir = args.logdir or tempfile.mkdtemp(prefix="eop_trace_")
    with trace(logdir, warmup=1) as prof:
        # the profiler misses a trace's first kernels: one warm-up step
        state, metrics = step(state, imgs, labels)
        sync(metrics)
        prof.step()
        before = launch_counts()
        for _ in range(args.trace_steps):
            state, metrics = step(state, imgs, labels)
        sync(metrics)
        prof.step()
    out["launches"] = launches_since(before)
    out.update(logdir=logdir, tables=tables(logdir, args.top))
    print(f"trace in {logdir}")
    print_tables(out["tables"], f" (sum over {args.trace_steps} steps)")
    print_launches(out["launches"], "traced")
    if cuda:
        torch.cuda.synchronize()
    return out


if __name__ == "__main__":
    main()
