#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``eop_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

1. prints the card (``nvidia-smi`` name and power limit, torch's name and
   count);
2. builds every CUDA kernel of the port from ``eop_tpu_torch/csrc``;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes the serving path (batch 8) and the training path (batch 32) give
   it (and the JAX package's test cases), with and without the fused scale +
   shift + SiLU epilogue, and times kernel, plain version and the PyTorch
   library calls;
4. serves the 24p-s detector (depth 0.33, width 0.50, 80 classes, 640 px)
   with seeded random weights behind the threaded HTTP front end, answers
   concurrent raw-body requests and checks every kernel of the path ran;
5. times the stages of one serving call on the device;
6. runs one image through the port on the card and on the CPU and compares;
7. holds the backward kernels of ``phase_conv`` (data and weight gradient,
   and the data gradients' weight packing) against their plain versions at
   the main-path shapes, at the training step's batch 32 and at batch 8,
   and at ragged ones, checks that the main-path shapes run the tensor-core
   variants and that the weight gradient is the same bits twice, and times
   them beside the CUDA-core kernels they replaced, the plain versions and
   ``aten::convolution_backward``;
8. trains the 24p-s detector for a few steps through ``Trainer24P`` (batch
   32, 640 px, fp32, seeded weights, one seeded synthetic batch repeated),
   checks the losses and the kernel launches of every step (and, under the
   profiler, which kernels ran), and splits the step's device time into
   forward, loss, backward and optimizer + EMA;
9. takes one training step's loss, assignment and gradients on the card and
   on the CPU from one state and compares;
10. writes a seeded synthetic 24p dataset of 720x1280 images (BMP content
    under ``.jpg`` names, numpy only) and txt labels to a temporary
    directory;
11. trains 24p-s from those files through the exp file
    ``load_train/yolox_24p_train.py`` and the exp's own loader (spawned
    workers, pinned batches), timing the step and the host's wait for the
    loader beside the repeated-batch step of 8, and checking the launches
    of every step;
12. evaluates the seeded model over the files with ``Evaluator24P`` through
    ``Exp24P.eval`` (batch 8, fused epilogue on every early conv), and an
    oracle whose detections are the labels, on the card, which must score
    AP 1 through the native COCO matcher;
13. runs the two command lines, ``python -m eop_tpu_torch.tools.train_24p
    ... --eval`` and ``python -m eop_tpu_torch.tools.eval`` on its
    checkpoint, and checks each prints an AP line;
14. drops the training loader with batches in flight a few more times, and
    checks that no loader worker died in any of the file phases.

``python3 chip_smoke.py --probe-worker-exit`` runs only a probe: the
training loader dropped with batches in flight with and without its
workers' exit hook (``data/dataloading.py::WorkerInit``), and the workers
that died in each.

Every phase raises on failure.  Each phase prints one JSON line; the line
before the last holds the kernels, the last line is the result.  Exits
non-zero, printing no result, where there is no card or no ``eop_tpu_torch``.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request

import numpy as np
import torch

# peak rates of one H100 SXM at its 700 W limit (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12   # CUDA cores, no tensor cores
PEAK_TF32_FLOPS = 495e12  # tensor cores, dense; fp32 accuracy takes 3 products
PEAK_BF16_FLOPS = 989e12  # tensor cores, dense
PEAK_BYTES = 3.35e12      # HBM3
BN_EPS = 1e-3
FP32_TOL, BF16_TOL = 1e-4, 1e-2  # max |kernel - plain| / max(1, max |plain|)

# the JAX package's phase_conv cases (tests/test_pallas_conv.py), batch 2:
# (k, stride, padding, H, W, C, Co)
JAX_CASES = [
    (1, 1, 0, 20, 20, 64, 32),
    (3, 1, 1, 16, 24, 32, 32),
    (3, 2, 1, 32, 40, 32, 64),
    (6, 2, 2, 32, 32, 3, 32),
    (3, 2, 1, 16, 16, 64, 128),
]
# the 8 convs of the 24p-s serving path that run phase_conv, at 640 px
MAIN_PATH = [
    ("stem", (6, 2, 2, 640, 640, 3, 32)),
    ("dark2_conv", (3, 2, 1, 320, 320, 32, 64)),
    ("dark2_csp.conv1", (1, 1, 0, 160, 160, 64, 32)),
    ("dark2_csp.conv2", (1, 1, 0, 160, 160, 64, 32)),
    ("dark2_csp.m0.conv1", (1, 1, 0, 160, 160, 32, 32)),
    ("dark2_csp.m0.conv2", (3, 1, 1, 160, 160, 32, 32)),
    ("dark2_csp.conv3", (1, 1, 0, 160, 160, 64, 64)),
    ("dark3_conv", (3, 2, 1, 160, 160, 64, 128)),
]
SERVE_BATCH = 8
N_REQUESTS, N_CLIENTS = 32, 16
# shapes off the tensor-core predicates, odd sizes, parity classes without
# taps: the backward kernels' ragged cases, batch 3
RAGGED_BACKWARD = [
    (3, 1, 1, 12, 20, 32, 33),
    (3, 2, 1, 16, 12, 48, 64),
    (5, 1, 2, 9, 11, 32, 32),
    (6, 2, 2, 12, 10, 3, 32),
    (1, 2, 0, 8, 6, 16, 24),
    (3, 2, 1, 26, 38, 32, 32),
    (3, 1, 1, 5, 7, 70, 130),
]
TRAIN_BATCH, TRAIN_GTS = 32, 8
TRAIN_WARMUP, TRAIN_TIMED = 2, 6
ROOT = os.path.dirname(os.path.abspath(__file__))
TRAIN_EXP_FILE = os.path.join(ROOT, "load_train", "yolox_24p_train.py")
# the file dataset: raw fisheye-camera frames, BMP content under .jpg names
DATASET_IMAGES, DATASET_HW = 64, (720, 1280)
EVAL_BATCH = 8
# launches of one training step: 8 forward convs, 8 weight gradients, 7 data
# gradients (the stem's input is the image and takes none), each data
# gradient's weight packing
STEP_LAUNCHES = {"forward": 8, "wgrad": 8, "dgrad": 7, "pack": 7}
# the tensor-core variant of each main-path gradient (dgrad: stem excluded)
WGRAD_VARIANT = "wgmma"
DGRAD_VARIANTS = {1: "flipped:wgmma_taps", 2: "wgmma_classes"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def conv_inputs(case, batch, dtype, seed):
    k, _, _, h, w, c, co = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((batch, h, w, c), generator=g, device="cuda")
    wgt = torch.randn((k, k, c, co), generator=g, device="cuda")
    return x.to(dtype), (wgt / (k * k * c) ** 0.5).to(dtype)


def sass_summary(_build):
    """What the built libraries hold, from ``cuobjdump -sass``: counts and one
    sample of the tensor-core (HGMMA), TMA (UTMALDG), bulk-copy (UBLKCP) and
    mbarrier (SYNCS) instructions.  The tensor-core libraries must have the
    first two."""
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = {}
    for name in sorted(n for n in _build.BUILD_INFO if not _build.is_host(n)):
        sass = subprocess.run([tool, "-sass", str(_build._target(name))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout.splitlines()
        row = {}
        for op in ("HGMMA", "UTMALDG", "UBLKCP", "SYNCS", "FFMA"):
            hits = [ln for ln in sass if f" {op}" in ln]
            row[op] = len(hits)
            if hits and op != "FFMA":
                row[f"{op}_sample"] = " ".join(hits[0].split("/*")[1].split()[1:])
        out[name] = row
    for lib in ("phase_conv", "phase_conv_backward_tc"):
        if not (out[lib]["HGMMA"] and out[lib]["UTMALDG"]):
            raise AssertionError(f"{lib}: no tensor-core or TMA instructions: "
                                 f"{out[lib]}")
    return out


def epilogue_inputs(co, seed):
    g = torch.Generator(device="cuda").manual_seed(1000 + seed)
    scale = torch.rand(co, generator=g, device="cuda") * 1.5 + 0.5   # 0.5 .. 2
    shift = torch.rand(co, generator=g, device="cuda") * 2.0 - 1.0   # -1 .. 1
    return scale, shift


def check_phase_conv():
    """Kernel vs plain version on every shape, fp32 and bf16, with and
    without the fused epilogue; times at the main-path shapes, at the
    serving batch and at the training step's."""
    import torch.nn.functional as F

    from eop_tpu_torch.ops.phase_conv import (
        out_hw,
        phase_conv,
        phase_conv_reference,
    )

    cases = ([(f"jax_case_{i}", c, 2) for i, c in enumerate(JAX_CASES)]
             + [(n, c, SERVE_BATCH) for n, c in MAIN_PATH]
             + [(n, c, TRAIN_BATCH) for n, c in MAIN_PATH])
    rows, err32, err16 = [], 0.0, 0.0
    for seed, (name, case, batch) in enumerate(cases):
        k, s, p, h, w, c, co = case
        row = {"name": name, "case": list(case), "batch": batch}
        scale, shift = epilogue_inputs(co, seed)
        fused = {"scale": scale, "shift": shift, "act": "silu"}
        for dtype, tol, key in ((torch.float32, FP32_TOL, "fp32"),
                                (torch.bfloat16, BF16_TOL, "bf16")):
            x, wgt = conv_inputs(case, batch, dtype, seed)
            for tag, kwargs in (("", {}), ("_fused", fused)):
                got = phase_conv(x, wgt, s, p, **kwargs)
                want = phase_conv_reference(x, wgt, s, p, **kwargs)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ref = want.float().abs().max().item()
                row[f"max_abs_err_{key}{tag}"] = err
                row[f"scale_{key}{tag}"] = ref
                if not err <= tol * max(1.0, ref):
                    raise AssertionError(
                        f"phase_conv {name} {key}{tag}: max abs err {err} > "
                        f"{tol} x {max(1.0, ref)}")
                if key == "fp32":
                    err32 = max(err32, err)
                else:
                    err16 = max(err16, err)
            row[f"variant_{key}"] = phase_conv.last_variant
        row["variant"] = row["variant_fp32"]
        del got, want
        if batch in (SERVE_BATCH, TRAIN_BATCH):
            x, wgt = conv_inputs(case, batch, torch.float32, seed)
            x16, wgt16 = x.bfloat16(), wgt.bfloat16()
            x_nchw = x.permute(0, 3, 1, 2)           # channels_last view
            w_oihw = wgt.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            # an eval-mode BatchNorm with the same folded scale and shift
            var = torch.ones_like(scale)
            gamma, mean = scale * (1.0 + BN_EPS) ** 0.5, torch.zeros_like(scale)

            def library_fused():
                y = F.conv2d(x_nchw, w_oihw, stride=s, padding=p)
                return F.silu(F.batch_norm(y, mean, var, gamma, shift, False,
                                           0.0, BN_EPS))

            row["ms"] = cuda_ms(lambda: phase_conv(x, wgt, s, p))
            row["ms_fused"] = cuda_ms(lambda: phase_conv(x, wgt, s, p, **fused))
            row["ms_bf16"] = cuda_ms(lambda: phase_conv(x16, wgt16, s, p))
            row["plain_ms"] = cuda_ms(
                lambda: phase_conv_reference(x, wgt, s, p))
            row["library_ms"] = cuda_ms(
                lambda: F.conv2d(x_nchw, w_oihw, stride=s, padding=p))
            row["library_fused_ms"] = cuda_ms(library_fused)
            ho, wo = out_hw(h, w, k, s, p)
            flops = 2.0 * batch * ho * wo * co * k * k * c
            elems = x.numel() + wgt.numel() + batch * ho * wo * co
            t_bytes = 4.0 * elems / PEAK_BYTES
            t_cores = flops / PEAK_FP32_FLOPS
            # the least the card could take: fp32 on the CUDA cores, or three
            # TF32 products on the tensor cores, whichever is faster
            t_ops = min(t_cores, 3.0 * flops / PEAK_TF32_FLOPS)
            row.update(
                flops=flops, bytes=4.0 * elems,
                bound_cuda_core_ms=1e3 * max(t_cores, t_bytes),
                bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_bf16_ms=1e3 * max(flops / PEAK_BF16_FLOPS,
                                        2.0 * elems / PEAK_BYTES))
        rows.append(row)
    return rows, err32, err16


def serving_exp():
    from eop_tpu_torch.exp import get_exp

    exp = get_exp(exp_name="yolox_24p_s")
    # seeded random weights score near the squared 0.01 prior (1e-4): a low
    # threshold keeps detections flowing so the NMS does real work
    exp.test_conf = 1e-5
    return exp


def serve_main_path(smi: str, exp, model):
    """The 24p-s server on the card behind HTTP; returns its report and the
    launch counts of this run."""
    from eop_tpu_torch.data.coco_classes import COCO_CLASSES
    from eop_tpu_torch.ops.phase_conv import phase_conv
    from eop_tpu_torch.serving.http import make_http_server
    from eop_tpu_torch.serving.service import DetectionService

    phase_conv.launches = 0
    t0 = time.perf_counter()
    svc = DetectionService.from_exp(exp, model, SERVE_BATCH, (640, 640),
                                    device="cuda", max_wait_ms=20.0,
                                    class_names=COCO_CLASSES)
    warmup_s = time.perf_counter() - t0
    server = make_http_server(svc, host="127.0.0.1", port=0)
    srv = threading.Thread(target=server.serve_forever, daemon=True)
    srv.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/v1/detect"
    rng = np.random.RandomState(0)
    bodies = [rng.randint(0, 256, (640, 640, 3), np.uint8).tobytes()
              for _ in range(N_REQUESTS)]
    codes, lat_ms, n_dets = [None] * N_REQUESTS, [0.0] * N_REQUESTS, [0] * N_REQUESTS

    def client(j):
        for i in range(j, N_REQUESTS, N_CLIENTS):
            req = urllib.request.Request(url, data=bodies[i], method="POST",
                                         headers={"X-Raw-Shape": "640,640,3"})
            t = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as r:
                codes[i] = r.status
                n_dets[i] = len(json.loads(r.read())["detections"])
            lat_ms[i] = (time.perf_counter() - t) * 1e3

    try:
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(j,))
                   for j in range(N_CLIENTS)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=600)
        wall_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = {"phase_conv": phase_conv.launches}
        stats = svc.stats()
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
        srv.join(timeout=30)
    if any(t.is_alive() for t in clients) or codes != [200] * N_REQUESTS:
        raise AssertionError(f"HTTP codes {codes}")
    forwards = stats["device_calls"]  # batches + one warmup per bucket
    report = {
        "phase": "serve", "card": smi, "model": "yolox_24p_s",
        "depth": exp.depth, "width": exp.width,
        "num_classes": exp.num_classes, "test_size": list(exp.test_size),
        "batch": SERVE_BATCH, "requests": N_REQUESTS, "clients": N_CLIENTS,
        "http_200": codes.count(200), "batches": stats["batches"],
        "mean_batch_occupancy": stats["mean_batch_occupancy"],
        "forward_calls": forwards, "bucket_hits": stats["bucket_hits"],
        "valid_detections": sum(n_dets),
        "phase_conv_launches": launches["phase_conv"],
        "request_ms_p50": float(np.percentile(lat_ms, 50)),
        "request_ms_max": float(max(lat_ms)),
        "wall_s": wall_s, "warmup_s": warmup_s,
    }
    if sum(n_dets) <= 0:
        raise AssertionError("no valid detections: the NMS did no work")
    if launches["phase_conv"] != 8 * forwards:
        raise AssertionError(f"phase_conv launches {launches['phase_conv']} "
                             f"!= 8 x {forwards} forward calls")
    return report, launches


def serving_stages(smi: str, exp, model, iters: int = 10):
    """Device time of each stage of one serving call at the full batch
    (CUDA events, median of ``iters`` after warmup), beside the host's wall
    time of the whole call."""
    from eop_tpu_torch.data.transforms import letterbox_batch_device
    from eop_tpu_torch.eval.postprocess import postprocess_24p_heads

    raw = np.random.RandomState(2).randint(0, 256, (SERVE_BATCH, 640, 640, 3),
                                           np.uint8)
    samples = []
    for i in range(iters + 2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t0 = time.perf_counter()
        with torch.inference_mode():
            ev[0].record()
            x = torch.as_tensor(raw).to("cuda")
            imgs, _ = letterbox_batch_device(x.float(), (640, 640),
                                             exp.test_size)
            ev[1].record()
            heads, _ = model(imgs.permute(0, 3, 1, 2))
            ev[2].record()
            dets = postprocess_24p_heads(
                heads, exp.num_classes, conf_thre=exp.test_conf,
                nms_thre=exp.nmsthre, nms_fixpoint_iters=exp._nms_iters())
            ev[3].record()
            dets.rows.cpu()
        wall = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if i >= 2:
            samples.append([ev[0].elapsed_time(ev[1]),
                            ev[1].elapsed_time(ev[2]),
                            ev[2].elapsed_time(ev[3]), wall])
    med = np.median(np.asarray(samples), axis=0)
    # one profiled call: device time by kernel, and the busy share of wall
    serve = exp.get_serving_fn(model, (640, 640), "cuda")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        serve(raw).rows.cpu()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    calls = {e.key: e.count for e in prof.key_averages()}
    return {"phase": "stages", "card": smi, "batch": SERVE_BATCH,
            "iters": iters, "h2d_letterbox_ms": float(med[0]),
            "forward_ms": float(med[1]), "postprocess_ms": float(med[2]),
            "call_wall_ms": float(med[3]),
            "profiled_call_wall_ms": wall, "profiled_device_busy_ms": busy_ms,
            "batch_norm_calls": calls.get("aten::batch_norm", 0),
            "silu_calls": (calls.get("aten::silu", 0)
                           + calls.get("aten::silu_", 0)),
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def card_vs_cpu(exp):
    """One image through the port on the card (kernels, BN and SiLU fused
    into their epilogue) and on the CPU (plain versions with the same folded
    epilogue), same seeded weights."""
    from eop_tpu_torch.data.transforms import letterbox_batch_device
    from eop_tpu_torch.eval.postprocess import postprocess_24p_heads

    raw = np.random.RandomState(1).randint(0, 256, (1, 640, 640, 3), np.uint8)
    out = {}
    for dev in ("cuda", "cpu"):
        model = exp.get_model(dev)
        with torch.inference_mode():
            x = torch.from_numpy(raw).to(dev).float()
            imgs, _ = letterbox_batch_device(x, (640, 640), exp.test_size)
            heads, _ = model(imgs.permute(0, 3, 1, 2))
            dets = postprocess_24p_heads(heads, exp.num_classes,
                                         conf_thre=exp.test_conf,
                                         nms_thre=exp.nmsthre)
        out[dev] = ([h.float().cpu() for h in heads], dets.valid.cpu())
    errs = [(g - c).abs().max().item() for g, c in zip(out["cuda"][0],
                                                       out["cpu"][0])]
    scale = max(c.abs().max().item() for c in out["cpu"][0])
    tol = 1e-3 * max(1.0, scale)  # fp32, TF32 off, ~100 layers deep
    valid = [int(out[d][1].sum()) for d in ("cuda", "cpu")]
    report = {"phase": "card_vs_cpu", "head_max_abs_err": max(errs),
              "head_scale": scale, "tol": tol, "valid_cuda": valid[0],
              "valid_cpu": valid[1]}
    if not max(errs) <= tol or valid[0] != valid[1] or valid[0] == 0:
        raise AssertionError(f"card and CPU disagree: {report}")
    return report


def conv_bound(flops: float, n_bytes: float):
    """(bound ms, what binds): the larger of bytes over the memory rate and
    the operations at fp32 accuracy, on the CUDA cores or as three TF32
    products on the tensor cores, whichever is faster."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = min(flops / PEAK_FP32_FLOPS, 3.0 * flops / PEAK_TF32_FLOPS)
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def check_phase_conv_backward():
    """dgrad and wgrad against their plain versions on the main-path shapes
    (at the training step's batch 32, which is what the path gives them, and
    at batch 8) and ragged ones, fp32 and bf16; wgrad twice, bit-equal; the
    main-path shapes on their tensor-core variants.  Times at the main-path
    shapes: the tensor-core kernels, the CUDA-core ones they replaced (forced
    through the wrappers' private ``_cuda_cores``, which nothing on the
    main path passes), the plain versions and ``aten::convolution_backward`` (TF32
    off; measured only); the data gradients' weight packing alone against
    its plain version, bit-equal."""
    from eop_tpu_torch.ops.phase_conv import (
        dgrad_class_plan,
        dgrad_variant,
        flip_taps,
        out_hw,
        pack_taps,
        pack_taps_reference,
        phase_conv,
        phase_conv_dgrad,
        phase_conv_dgrad_reference,
        phase_conv_wgrad,
        phase_conv_wgrad_reference,
        wgrad_variant,
    )

    cases = ([(n, c, TRAIN_BATCH) for n, c in MAIN_PATH]
             + [(n, c, SERVE_BATCH) for n, c in MAIN_PATH]
             + [(f"ragged_{i}", c, 3) for i, c in enumerate(RAGGED_BACKWARD)])
    rows = []
    worst = {"dgrad": {"fp32": 0.0, "bf16": 0.0},
             "wgrad": {"fp32": 0.0, "bf16": 0.0}}
    for seed, (name, case, batch) in enumerate(cases):
        k, s, p, h, w, c, co = case
        ho, wo = out_hw(h, w, k, s, p)
        main = not name.startswith("ragged")
        row = {"name": name, "case": list(case), "batch": batch}
        for dtype, tol, key in ((torch.float32, FP32_TOL, "fp32"),
                                (torch.bfloat16, BF16_TOL, "bf16")):
            x, wgt = conv_inputs(case, batch, dtype, seed)
            g = torch.Generator(device="cuda").manual_seed(500 + seed)
            dy = torch.randn((batch, ho, wo, co), generator=g,
                             device="cuda").to(dtype)
            dw = phase_conv_wgrad(x, dy, k, s, p)
            dw2 = phase_conv_wgrad(x, dy, k, s, p)
            row[f"wgrad_variant_{key}"] = phase_conv.last_wgrad_variant
            dx = phase_conv_dgrad(dy, wgt, x.shape, s, p)
            row[f"dgrad_variant_{key}"] = phase_conv.last_dgrad_variant
            torch.cuda.synchronize()
            if not torch.equal(dw, dw2):
                raise AssertionError(f"wgrad {name} {key}: two launches on "
                                     f"one input differ")
            if main and (row[f"wgrad_variant_{key}"] != WGRAD_VARIANT or (
                    name != "stem" and row[f"dgrad_variant_{key}"]
                    != DGRAD_VARIANTS[s])):
                raise AssertionError(f"{name} {key}: not on the tensor-core "
                                     f"variants: {row}")
            for kind, got, want in (
                    ("wgrad", dw, phase_conv_wgrad_reference(x, dy, k, s, p)),
                    ("dgrad", dx, phase_conv_dgrad_reference(
                        dy, wgt, x.shape, s, p))):
                err = (got.float() - want.float()).abs().max().item()
                ref = want.float().abs().max().item()
                row[f"{kind}_max_abs_err_{key}"] = err
                row[f"{kind}_scale_{key}"] = ref
                if not err <= tol * max(1.0, ref):
                    raise AssertionError(
                        f"{kind} {name} {key}: max abs err {err} > {tol} x "
                        f"{max(1.0, ref)}")
                worst[kind][key] = max(worst[kind][key], err)
        del dw, dw2, dx, got, want
        if batch in (SERVE_BATCH, TRAIN_BATCH):
            x, wgt = conv_inputs(case, batch, torch.float32, seed)
            g = torch.Generator(device="cuda").manual_seed(500 + seed)
            dy = torch.randn((batch, ho, wo, co), generator=g, device="cuda")
            x_nchw, dy_nchw = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
            w_oihw = wgt.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)

            def library(mask):
                return torch.ops.aten.convolution_backward(
                    dy_nchw, x_nchw, w_oihw, None, [s, s], [p, p], [1, 1],
                    False, [0, 0], 1, mask)

            flops = 2.0 * batch * ho * wo * co * k * k * c
            row["flops"] = flops
            row["wgrad_variant"] = wgrad_variant(x.shape, co, k, s,
                                                 torch.float32)
            row["wgrad_ms"] = cuda_ms(lambda: phase_conv_wgrad(x, dy, k, s, p))
            row["wgrad_cuda_cores_ms"] = cuda_ms(lambda: phase_conv_wgrad(
                x, dy, k, s, p, _cuda_cores=True))
            row["wgrad_plain_ms"] = cuda_ms(
                lambda: phase_conv_wgrad_reference(x, dy, k, s, p), iters=5,
                warmup=1)
            row["wgrad_library_ms"] = cuda_ms(
                lambda: library([False, True, False]))
            row["wgrad_bytes"] = 4.0 * (x.numel() + dy.numel() + wgt.numel())
            row["wgrad_bound_ms"], row["wgrad_bound_by"] = conv_bound(
                flops, row["wgrad_bytes"])
            # the stem's input is the image: no data gradient on the path
            row["dgrad_on_path"] = name != "stem"
            row["dgrad_variant"] = dgrad_variant(dy.shape, wgt.shape, s, p,
                                                 torch.float32)
            row["dgrad_ms"] = cuda_ms(
                lambda: phase_conv_dgrad(dy, wgt, x.shape, s, p))
            row["dgrad_cuda_cores_ms"] = cuda_ms(lambda: phase_conv_dgrad(
                dy, wgt, x.shape, s, p, _cuda_cores=True))
            row["dgrad_plain_ms"] = cuda_ms(
                lambda: phase_conv_dgrad_reference(dy, wgt, x.shape, s, p),
                iters=5, warmup=1)
            row["dgrad_library_ms"] = cuda_ms(
                lambda: library([True, False, False]))
            row["dgrad_bytes"] = 4.0 * (x.numel() + dy.numel() + wgt.numel())
            row["dgrad_bound_ms"], row["dgrad_bound_by"] = conv_bound(
                flops, row["dgrad_bytes"])
            if row["dgrad_on_path"]:
                # the weight packing of this data gradient, alone
                taps = (flip_taps(k) if s == 1 else
                        [ky * k + kx for _, _, ts in dgrad_class_plan(k, p)
                         for ky, kx, _, _ in ts])
                got = pack_taps(wgt, taps)
                want = pack_taps_reference(wgt, taps)
                row["pack_max_abs_err"] = (got - want).abs().max().item()
                if not torch.equal(got, want):
                    raise AssertionError(f"pack_taps {name}: not bit-equal")
                row["pack_ms"] = cuda_ms(lambda: pack_taps(wgt, taps))
                row["pack_plain_ms"] = cuda_ms(
                    lambda: pack_taps_reference(wgt, taps))
                # read w once, write hi and lo of every packed tap
                row["pack_bytes"] = 4.0 * wgt.numel() * (1 + 2 * len(taps)
                                                         / (k * k))
                row["pack_bound_ms"] = 1e3 * row["pack_bytes"] / PEAK_BYTES
        rows.append(row)
    return rows, worst


def training_exp():
    """24p-s at full width whose loader repeats one seeded synthetic batch
    that already lies on the card."""
    from eop_tpu_torch.exp import Exp24P
    from eop_tpu_torch.utils.synth import synthetic_24p_batch

    class RepeatLoader:
        def __init__(self, batch_size):
            g = torch.Generator(device="cuda").manual_seed(0)
            self.batch = synthetic_24p_batch(g, batch_size, size=640,
                                             ngt=TRAIN_GTS)

        def __len__(self):
            return TRAIN_WARMUP + TRAIN_TIMED

        def __iter__(self):
            while True:
                yield (*self.batch, None, None)

    class SmokeTrainExp(Exp24P):
        def get_data_loader(self, batch_size, is_distributed=False, rank=0,
                            world_size=1):
            self.loader = RepeatLoader(batch_size)
            return self.loader

    exp = SmokeTrainExp()
    exp.depth, exp.width, exp.num_classes = 0.33, 0.50, 80
    exp.seed = 0
    exp.max_epoch, exp.L1_epoch = 1, 0
    exp.ema = True
    exp.print_interval = 10 ** 9  # no host fetch inside the loop
    exp.exp_name = "chip_smoke_train"
    return exp


def _launch_counts():
    from eop_tpu_torch.ops.phase_conv import packed_weights, phase_conv

    return {"forward": phase_conv.launches, "wgrad": phase_conv.wgrad_launches,
            "dgrad": phase_conv.dgrad_launches,
            "pack": phase_conv.pack_launches,
            "weight_packs": packed_weights.packs,
            "dy_copies": phase_conv.dy_copies}


def _reset_counts():
    from eop_tpu_torch.ops.phase_conv import packed_weights, phase_conv

    phase_conv.launches = phase_conv.wgrad_launches = 0
    phase_conv.dgrad_launches = phase_conv.dy_copies = 0
    phase_conv.pack_launches = phase_conv.fused_launches = 0
    packed_weights.packs = 0


def run_trainer(exp):
    """``Trainer24P(exp, ...).train()`` on the card at batch 32 for
    ``TRAIN_WARMUP + TRAIN_TIMED`` steps, the counts set to 0 just before
    it; checks the steps and the launches of every step.  Returns the state,
    the trainer, the per-step metrics and the timing summary."""
    from eop_tpu_torch.train.trainer_24p import Trainer24P

    events, steps = [], []

    def hook(name, metrics=None):
        if name == "step":
            steps.append((metrics, _launch_counts(), time.perf_counter()))
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))

    exp.output_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    try:
        trainer = Trainer24P(exp, types.SimpleNamespace(
            batch_size=TRAIN_BATCH, device="cuda"))
        trainer.hook = hook
        t0 = time.perf_counter()
        state = trainer.train()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(exp.output_dir, ignore_errors=True)
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()

    n = TRAIN_WARMUP + TRAIN_TIMED
    if len(steps) != n or state.step != n:
        raise AssertionError(f"{len(steps)} steps ran, state.step "
                             f"{state.step}, expected {n}")
    per_step, prev = [], {k: 0 for k in launches}
    for _, counts, _ in steps:
        per_step.append({k: counts[k] - prev[k] for k in counts})
        prev = counts
    for i, d in enumerate(per_step):
        if {k: d[k] for k in STEP_LAUNCHES} != STEP_LAUNCHES:
            raise AssertionError(f"step {i} launched {d}, expected "
                                 f"{STEP_LAUNCHES}")
    names = ["start", "forward", "loss", "backward", "optimizer"]
    if [nm for nm, _ in events] != names * n:
        raise AssertionError("unexpected phase marks")
    split = []
    for i in range(TRAIN_WARMUP, n):
        ev = [e for _, e in events[5 * i: 5 * i + 5]]
        split.append([ev[j].elapsed_time(ev[j + 1]) for j in range(4)]
                     + [ev[0].elapsed_time(ev[4])])
    med = np.median(np.asarray(split), axis=0)
    # the host's clock from one step's end of enqueueing to the next: the
    # device's pace once the launch queue is full, or the host's where it
    # (the loader included) is the slower
    host_ms = [1e3 * (steps[i][2] - steps[i - 1][2])
               for i in range(TRAIN_WARMUP, n)]
    host = [{k: v.float().cpu() for k, v in m.items()} for m, _, _ in steps]
    timing = {
        "steps": n, "warmup_steps": TRAIN_WARMUP,
        "losses": [float(m["total_loss"]) for m in host],
        "num_fg": [float(m["num_fg"]) for m in host],
        "cand_dropped": [int(m["cand_dropped"]) for m in host],
        "step_ms": float(med[4]), "forward_ms": float(med[0]),
        "loss_ms": float(med[1]), "backward_ms": float(med[2]),
        "optimizer_ema_ms": float(med[3]),
        "step_ms_all": [r[4] for r in split],
        "host_step_ms": float(np.median(host_ms)),
        "host_step_ms_all": host_ms,
        "images_per_s": 1e3 * TRAIN_BATCH / float(np.median(host_ms)),
        "launches_per_step": per_step[-1],
        "launches": launches,
        "max_memory_allocated_bytes": peak,
        "wall_s": wall_s,
    }
    return state, trainer, timing


def train_main_path(smi: str):
    """A few steps of ``Trainer24P`` on the card over one batch already on
    the card; returns the report and the launch counts of this run."""
    from eop_tpu_torch.train.steps import make_train_step_24p
    from eop_tpu_torch.losses import Loss24PConfig

    exp = training_exp()
    state, _, timing = run_trainer(exp)
    losses = timing["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite or not falling: {losses}")

    # one more step under the profiler: device time by kernel name
    step_fn = make_train_step_24p(
        Loss24PConfig(num_classes=exp.num_classes), ema_decay=exp.ema_decay)
    imgs, labels = exp.loader.batch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step_fn(state, imgs, labels)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]

    def own(fragment):
        hits = [e for e in kernels if fragment in e.key]
        return {"count": sum(e.count for e in hits),
                "ms": sum(e.self_device_time_total for e in hits) / 1e3}

    # "::name<": the port's kernels are templates in an anonymous namespace
    own_kernels = {f: own(f"::{f}<") for f in (
        "conv_taps_kernel", "conv_rows_kernel", "wgrad_tc_kernel",
        "wgrad_tc_reduce_kernel", "dgrad_tc_kernel", "pack_taps_kernel",
        "wgrad_partial_kernel", "wgrad_reduce_kernel", "dgrad_kernel")}
    # 8 forward convs and 5 stride-1 data gradients run the forward's
    # tensor-core kernels, the 8 weight gradients and 2 stride-2 data
    # gradients the backward's, each data gradient packs its weights once;
    # the CUDA-core backward kernels do not run
    want = {"conv_taps_kernel": 12, "conv_rows_kernel": 1,
            "wgrad_tc_kernel": 8, "wgrad_tc_reduce_kernel": 8,
            "dgrad_tc_kernel": 2, "pack_taps_kernel": 7,
            "wgrad_partial_kernel": 0, "wgrad_reduce_kernel": 0,
            "dgrad_kernel": 0}
    if {k: v["count"] for k, v in own_kernels.items()} != want:
        raise AssertionError(f"profiled kernels {own_kernels}, expected "
                             f"counts {want}")
    report = {
        "phase": "train", "card": smi, "model": "yolox_24p_s",
        "depth": exp.depth, "width": exp.width,
        "num_classes": exp.num_classes, "input_size": list(exp.input_size),
        "batch": TRAIN_BATCH, "gts_per_image": TRAIN_GTS, **timing,
        "profiled_device_busy_ms": busy_ms,
        "own_kernels": own_kernels,
        "top_kernels": [{"name": e.key[:80], "count": e.count,
                         "ms": e.self_device_time_total / 1e3} for e in top],
    }
    return report, timing["launches"]


def train_card_vs_cpu():
    """Forward, assignment, loss and backward of one batch (B = 2, 640 px)
    on the card and on the CPU from the same seeded state."""
    from eop_tpu_torch.exp import get_exp
    from eop_tpu_torch.losses import (
        DWAState,
        Loss24PConfig,
        loss_24p,
        simota_assign_24p,
    )
    from eop_tpu_torch.models.yolox import training_outputs
    from eop_tpu_torch.utils.synth import synthetic_24p_batch

    exp = get_exp(exp_name="yolox_24p_s")
    config = Loss24PConfig(num_classes=exp.num_classes)
    imgs, labels = synthetic_24p_batch(torch.Generator().manual_seed(1), 2,
                                       size=640, ngt=TRAIN_GTS)
    out = {}
    for dev in ("cuda", "cpu"):
        model = exp.get_model(dev, seed=0).train()
        heads, _ = model(imgs.to(dev).permute(0, 3, 1, 2))
        decoded, origin, grids, strides = training_outputs(heads, reg_dim=26)
        lab = labels.to(dev)
        with torch.no_grad():
            d = decoded.float()
            assign = simota_assign_24p(
                lab[..., 1:], lab[..., 0], lab.sum(dim=2) > 0, d[..., :26],
                d[..., 26], d[..., 27:], grids, strides, config)
        total, _, _ = loss_24p(decoded, origin, lab, grids, strides,
                               DWAState.init(dev), config)
        total.backward()
        out[dev] = (total.item(), assign.fg_mask.cpu(),
                    assign.matched_gt.cpu(),
                    {n: p.grad.cpu() for n, p in model.named_parameters()})
    rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    same = (torch.equal(out["cuda"][1], out["cpu"][1])
            and torch.equal(out["cuda"][2], out["cpu"][2]))
    worst, worst_name = 0.0, None
    for name, g in out["cpu"][3].items():
        err = ((out["cuda"][3][name] - g).abs().max()
               / g.abs().max().clamp(min=1e-30)).item()
        if err > worst:
            worst, worst_name = err, name
    report = {"phase": "train_card_vs_cpu", "batch": 2,
              "loss_cuda": out["cuda"][0], "loss_cpu": out["cpu"][0],
              "loss_rel_err": rel, "loss_tol": 1e-4,
              "assignment_equal": same,
              "num_fg": int(out["cpu"][1].sum()),
              "grad_tensors": len(out["cpu"][3]),
              "grad_worst_rel_to_max": worst, "grad_worst_tensor": worst_name,
              "grad_tol": 1e-3}
    if not (rel <= 1e-4 and same and worst <= 1e-3
            and report["num_fg"] > 0):
        raise AssertionError(f"card and CPU disagree: {report}")
    return report


def write_dataset(root: str):
    """The seeded synthetic 24p dataset the file phases read
    (``utils/synth.write_24p_dataset``: BMP content under ``.jpg`` names)."""
    from eop_tpu_torch.utils.synth import write_24p_dataset

    t0 = time.perf_counter()
    img_dir, lab_dir = write_24p_dataset(root, DATASET_IMAGES, DATASET_HW)
    seconds = time.perf_counter() - t0
    n_bytes = sum(e.stat().st_size for d in (img_dir, lab_dir)
                  for e in os.scandir(d))
    report = {"phase": "dataset", "images": DATASET_IMAGES,
              "height": DATASET_HW[0], "width": DATASET_HW[1],
              "format": "24-bit BMP under .jpg names", "bytes": n_bytes,
              "seconds": seconds}
    return img_dir, lab_dir, report


class TimedLoader:
    """A loader whose iterator records the host's wait for each batch."""

    def __init__(self, loader):
        self.loader, self.waits = loader, []

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            batch = next(it)
            self.waits.append(time.perf_counter() - t0)
            yield batch


def train_files(smi: str, img_dir: str, lab_dir: str, repeated: dict):
    """24p-s trained from the files through the exp file and the exp's own
    loader (workers from the file), at the repeated-batch phase's batch and
    steps; returns the report and the launch counts of this run."""
    from eop_tpu_torch.exp import get_exp

    exp = get_exp(TRAIN_EXP_FILE)
    own_loader = exp.get_data_loader

    def timed_loader(*args, **kwargs):
        exp.timed_loader = TimedLoader(own_loader(*args, **kwargs))
        return exp.timed_loader

    exp.get_data_loader = timed_loader
    iters = DATASET_IMAGES // TRAIN_BATCH
    exp.merge(["max_epoch", str(-(-(TRAIN_WARMUP + TRAIN_TIMED) // iters)),
               "L1_epoch", "0", "ema", "True", "seed", "0",
               "data_dir", img_dir, "label_dir", lab_dir,
               "print_interval", str(10 ** 9), "ckpt_interval", "1000",
               "exp_name", "chip_smoke_train_files"])
    state, trainer, timing = run_trainer(exp)
    if not all(np.isfinite(timing["losses"])):
        raise AssertionError(f"losses not finite: {timing['losses']}")
    waits = exp.timed_loader.waits
    wait_ms = [1e3 * t for t in waits[TRAIN_WARMUP:]]
    report = {
        "phase": "train_files", "card": smi, "exp_file":
        "load_train/yolox_24p_train.py", "depth": exp.depth,
        "width": exp.width, "num_classes": exp.num_classes,
        "input_size": list(exp.input_size), "batch": TRAIN_BATCH,
        "data_num_workers": exp.data_num_workers,
        "dataset_images": DATASET_IMAGES, "iters_per_epoch":
        trainer.iters_per_epoch, **timing,
        "data_wait_ms_median": float(np.median(wait_ms)),
        "data_wait_ms_max": float(max(wait_ms)),
        "data_wait_ms_all": wait_ms,
        "first_batch_wait_s": waits[0],
        "repeated_batch_step_ms": repeated["step_ms"],
        "repeated_batch_host_step_ms": repeated["host_step_ms"],
        "loader_cost_ms": timing["host_step_ms"] - repeated["host_step_ms"],
    }
    if exp.data_num_workers != 4 or trainer.iters_per_epoch != iters:
        raise AssertionError(f"exp file not applied: {report}")
    del state
    return report, timing["launches"]


def eval_files(smi: str, img_dir: str, lab_dir: str):
    """``Evaluator24P`` over the files at batch 8 through ``Exp24P.eval``
    with the seeded 24p-s model, then with the label oracle; returns the
    report and the launch counts of the model's run."""
    from eop_tpu_torch.eval import fast_cocoeval
    from eop_tpu_torch.ops.phase_conv import phase_conv
    from eop_tpu_torch.utils.synth import LabelOracle

    exp = serving_exp()
    exp.data_dir, exp.label_dir, exp.data_num_workers = img_dir, lab_dir, 4
    model = exp.get_model("cuda")
    evaluator = exp.get_evaluator(EVAL_BATCH)
    _reset_counts()
    t0 = time.perf_counter()
    ap5095, ap50, summary = exp.eval(model, evaluator)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"phase_conv": phase_conv.launches}
    fused = phase_conv.fused_launches
    tm = evaluator.timings
    forwards = tm["batches"] + 1  # the first batch runs twice
    report = {
        "phase": "eval", "card": smi, "model": "yolox_24p_s",
        "test_size": list(exp.test_size), "batch": EVAL_BATCH,
        "test_conf": exp.test_conf, "data_num_workers": exp.data_num_workers,
        **tm, "wall_s": wall_s, "images_per_s": tm["images"] / wall_s,
        "inference_ms_per_batch": 1e3 * tm["inference_s"] / tm["batches"],
        "data_wait_ms_per_batch": 1e3 * tm["data_wait_s"] / tm["batches"],
        "data_wait_ms_per_batch_after_first": 1e3 * (
            tm["data_wait_s"] - tm["first_batch_wait_s"]) / tm["batches"],
        "images_per_s_after_first_batch": tm["images"] / (
            wall_s - tm["first_batch_wait_s"]),
        "detections_per_image": tm["detections"] / tm["images"],
        "phase_conv_launches": launches["phase_conv"],
        "phase_conv_launches_per_batch": launches["phase_conv"] / forwards,
        "phase_conv_fused_launches": fused,
        "ap50_95": float(ap5095), "ap50": float(ap50),
        "summary": summary.splitlines(),
    }
    if (tm["images"] != DATASET_IMAGES or tm["detections"] == 0
            or launches["phase_conv"] != 8 * forwards
            or fused != launches["phase_conv"]):
        raise AssertionError(f"eval over the files: {report}")

    # the oracle: the labels as detections on the card; no workers, so the
    # oracle and the loader see one dataset
    exp.data_num_workers = 0
    oracle_ev = exp.get_evaluator(EVAL_BATCH)
    fast_cocoeval.match_image.native_calls = 0
    o5095, o50, o_summary = oracle_ev.evaluate(
        LabelOracle(oracle_ev.dataloader.dataset, "cuda"))
    report.update(oracle_ap50_95=float(o5095), oracle_ap50=float(o50),
                  oracle_native_matcher_calls=
                  fast_cocoeval.match_image.native_calls,
                  oracle_cocoeval_s=oracle_ev.timings["cocoeval_s"])
    if not (abs(o50 - 1.0) <= 1e-6 and abs(o5095 - 1.0) <= 1e-6
            and fast_cocoeval.match_image.native_calls > 0):
        raise AssertionError(f"oracle AP is not 1: {o_summary}")
    return report, launches


def drop_loaders(img_dir: str, lab_dir: str, drops: int = 6,
                 exit_hook: bool = True) -> dict:
    """The exp file's training loader started and dropped with batches in
    flight, ``drops`` times, as the trainer drops it when training ends.
    Without ``exit_hook``, the same dataset and batches through a plain
    spawned, pinned ``DataLoader`` whose workers go through the
    interpreter's teardown (no ``WorkerInit``)."""
    from eop_tpu_torch.data.dataloading import worker_init_reset_seed
    from eop_tpu_torch.exp import get_exp

    exp = get_exp(TRAIN_EXP_FILE)
    exp.merge(["data_dir", img_dir, "label_dir", lab_dir])
    t0 = time.perf_counter()
    errors = []
    for _ in range(drops):
        loader = exp.get_data_loader(TRAIN_BATCH)
        if not exit_hook:
            loader = torch.utils.data.DataLoader(
                loader.dataset, batch_sampler=loader.batch_sampler,
                num_workers=loader.num_workers, pin_memory=True,
                worker_init_fn=worker_init_reset_seed,
                multiprocessing_context="spawn")
        try:
            it = iter(loader)
            for _ in range(3):
                next(it)
            del it
        except RuntimeError as e:  # a dead worker seen by the loader
            if exit_hook:
                raise
            errors.append(str(e))
    return {"drops": drops, "data_num_workers": exp.data_num_workers,
            "drop_seconds": time.perf_counter() - t0, "errors": errors}


def run_cli(smi: str, img_dir: str, lab_dir: str):
    """The two command lines as users run them: train 24p-s for one epoch
    (2 iterations) with an evaluation, then evaluate its checkpoint."""
    import re

    out = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    ap_line = re.compile(r"AP50:95\s*=\s*([0-9.]+)\s+AP50\s*=\s*([0-9.]+)")
    report = {"phase": "cli", "card": smi}
    try:
        for name, cmd in (
                ("train_24p", [
                    sys.executable, "-m", "eop_tpu_torch.tools.train_24p",
                    "-f", "load_train/yolox_24p_train.py", "-b",
                    str(TRAIN_BATCH), "--data-dir", img_dir, "--label-dir",
                    lab_dir, "--max-epoch", "1", "--eval", "eval_interval",
                    "1", "output_dir", out]),
                ("eval", None)):
            if cmd is None:
                ckpt_dir = os.path.join(out, "yolox_24p")
                best = os.path.join(ckpt_dir, "best_ckpt.pth")
                ckpt = best if os.path.exists(best) else os.path.join(
                    ckpt_dir, "last_epoch_ckpt.pth")
                report["eval_ckpt"] = os.path.basename(ckpt)
                cmd = [sys.executable, "-m", "eop_tpu_torch.tools.eval",
                       "-f", "load_eval/yolox_24p_eval.py", "-c", ckpt, "-b",
                       str(EVAL_BATCH), "--data-dir", img_dir, "--label-dir",
                       lab_dir]
            t0 = time.perf_counter()
            r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                               timeout=600)
            report[f"{name}_wall_s"] = time.perf_counter() - t0
            report[f"{name}_rc"] = r.returncode
            # loader workers that ended abnormally when the loader stopped
            report[f"{name}_worker_aborts"] = r.stderr.count(
                "killed by signal")
            hits = ap_line.findall(r.stdout + r.stderr)
            if r.returncode != 0 or not hits:
                raise AssertionError(
                    f"{name}: rc {r.returncode}, no AP line\n"
                    f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
            report[f"{name}_ap50_95"], report[f"{name}_ap50"] = (
                float(v) for v in hits[-1])
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return report


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def probe_worker_exit(drops: int = 8) -> int:
    """``python3 chip_smoke.py --probe-worker-exit``: with a CUDA context in
    this process, drop the training loader with batches in flight ``drops``
    times as the port builds it and ``drops`` times without its workers'
    exit hook, and print the workers that died in each."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    torch.zeros(1, device="cuda")
    smi = nvidia_smi()
    print(smi, flush=True)
    unraisable, default_hook = [], sys.unraisablehook
    sys.unraisablehook = lambda u: unraisable.append(str(u.exc_value))
    root = tempfile.mkdtemp(prefix="chip_smoke_probe_")
    report = {"phase": "probe_worker_exit", "card": smi}
    try:
        img_dir, lab_dir, _ = write_dataset(root)
        for name, exit_hook in (("exit_hook", True), ("teardown", False)):
            seen = len(unraisable)
            report[name] = drop_loaders(img_dir, lab_dir, drops, exit_hook)
            gc.collect()
            report[name]["workers_died"] = sum(
                "killed by signal" in u or "exited unexpectedly" in u
                for u in unraisable[seen:] + report[name]["errors"])
    finally:
        sys.unraisablehook = default_hook
        shutil.rmtree(root, ignore_errors=True)
    emit(report)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from eop_tpu_torch import _build
    from eop_tpu_torch.utils.device import set_fp32_precision

    set_fp32_precision(torch.device("cuda"))
    smi = nvidia_smi()
    print(smi, flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    emit({"phase": "device", "nvidia_smi": smi, **device,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    info = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": info, "sass": sass_summary(_build)})

    shapes, err32, err16 = check_phase_conv()
    for row in shapes:
        emit({"phase": "phase_conv", "card": smi, **row})

    exp = serving_exp()
    model = exp.get_model("cuda")
    serve_report, launches = serve_main_path(smi, exp, model)
    emit(serve_report)
    emit(serving_stages(smi, exp, model))
    emit(card_vs_cpu(exp))
    del model

    back_rows, back_err = check_phase_conv_backward()
    for row in back_rows:
        emit({"phase": "phase_conv_backward", "card": smi, **row})
    train_report, repeat_launches = train_main_path(smi)
    emit(train_report)
    emit(train_card_vs_cpu())

    # a loader that finds a dead worker while it stops raises in __del__,
    # which reaches sys.unraisablehook: count those of the file phases
    unraisable, default_hook = [], sys.unraisablehook

    def count_unraisable(u):
        unraisable.append(str(u.exc_value))
        default_hook(u)

    data_root = tempfile.mkdtemp(prefix="chip_smoke_data_")
    sys.unraisablehook = count_unraisable
    try:
        img_dir, lab_dir, data_report = write_dataset(data_root)
        emit({**data_report, "card": smi})
        files_report, files_launches = train_files(smi, img_dir, lab_dir,
                                                   train_report)
        emit(files_report)
        eval_report, eval_launches = eval_files(smi, img_dir, lab_dir)
        emit(eval_report)
        cli_report = run_cli(smi, img_dir, lab_dir)
        emit(cli_report)
        drops = drop_loaders(img_dir, lab_dir)
        gc.collect()
    finally:
        sys.unraisablehook = default_hook
        shutil.rmtree(data_root, ignore_errors=True)
    died = [u for u in unraisable if "killed by signal" in u]
    emit({"phase": "loader_shutdown", "card": smi, **drops,
          "workers_died": len(died),
          "cli_workers_died": (cli_report["train_24p_worker_aborts"]
                               + cli_report["eval_worker_aborts"]),
          "unraisable": unraisable[:5]})
    if died or cli_report["train_24p_worker_aborts"] or (
            cli_report["eval_worker_aborts"]):
        raise AssertionError(f"loader workers died: {died}")
    # each path's launches, counted from 0 just before it ran: the forward
    # serves (serve) and evaluates (eval) at batch 8 and trains at batch 32
    # (train: one batch repeated; train_files: the file loader)
    by_path = {"serve": launches["phase_conv"],
               "eval": eval_launches["phase_conv"],
               "train": repeat_launches["forward"],
               "train_files": files_launches["forward"]}
    train_launches = {k: repeat_launches[k] + files_launches[k]
                      for k in STEP_LAUNCHES}

    # the serving path launches the forward at batch 8, the training step
    # all three kernels at batch 32
    main_rows = [r for r in shapes if "ms" in r and r["batch"] == SERVE_BATCH]
    train_rows = [r for r in shapes if "ms" in r and r["batch"] == TRAIN_BATCH]
    bound = {"operations": 0.0, "bytes": 0.0}
    for r in main_rows:
        bound[r["bound_by"]] += r["bound_ms"]

    def total(key, rows_=main_rows):
        return sum(r[key] for r in rows_)

    pack_rows = [r for r in back_rows if "pack_ms" in r
                 and r["batch"] == TRAIN_BATCH]

    def on_path(kind, batch):
        return [r for r in back_rows if "wgrad_ms" in r and r["batch"] == batch
                and (kind == "wgrad" or r["dgrad_on_path"])]

    def backward_row(kind, source_note):
        rows_, rows_b8 = on_path(kind, TRAIN_BATCH), on_path(kind, SERVE_BATCH)
        by = {"operations": 0.0, "bytes": 0.0}
        for r in rows_:
            by[r[f"{kind}_bound_by"]] += r[f"{kind}_bound_ms"]
        return {
            "name": f"phase_conv_{kind}",
            "route": "cuda",
            "source": "eop_tpu_torch/csrc/phase_conv_backward_tc.cu",
            # JAX differentiates the conv; the Pallas kernel has no VJP
            "replaces": "eop_tpu/ops/pallas/conv_small_c.py:215 (its VJP)",
            "launches": train_launches[kind],
            "launches_by_path": {"train": repeat_launches[kind],
                                 "train_files": files_launches[kind]},
            "max_abs_err": back_err[kind]["fp32"],
            "max_abs_err_bf16": back_err[kind]["bf16"],
            # per training step (B=32, 640 px): the main-path shapes summed
            "batch": TRAIN_BATCH,
            "ms": sum(r[f"{kind}_ms"] for r in rows_),
            "plain_ms": sum(r[f"{kind}_plain_ms"] for r in rows_),
            "bound_ms": sum(r[f"{kind}_bound_ms"] for r in rows_),
            "bound_by": max(by, key=by.get),
            "library_ms": sum(r[f"{kind}_library_ms"] for r in rows_),
            # the same shapes at B=8
            "ms_b8": sum(r[f"{kind}_ms"] for r in rows_b8),
            "plain_ms_b8": sum(r[f"{kind}_plain_ms"] for r in rows_b8),
            "bound_ms_b8": sum(r[f"{kind}_bound_ms"] for r in rows_b8),
            "library_ms_b8": sum(r[f"{kind}_library_ms"] for r in rows_b8),
            # the CUDA-core kernels these replaced, same shapes
            "cuda_cores_ms": sum(r[f"{kind}_cuda_cores_ms"] for r in rows_),
            "cuda_cores_ms_b8": sum(r[f"{kind}_cuda_cores_ms"]
                                    for r in rows_b8),
            "shapes": len(rows_),
            "variants": {r["name"]: r[f"{kind}_variant"] for r in rows_},
            "note": source_note,
            "card": smi,
        }

    emit({"kernels": [{
        "name": "phase_conv",
        "route": "cuda",
        "source": "eop_tpu_torch/csrc/phase_conv.cu",
        "replaces": "eop_tpu/ops/pallas/conv_small_c.py:181",
        "launches": by_path["serve"] + by_path["eval"],
        "launches_train": train_launches["forward"],
        "launches_by_path": by_path,
        "max_abs_err": err32,
        "max_abs_err_bf16": err16,
        # per forward at B=8, 640 px: the 8 main-path convs summed; "ms" is
        # the conv alone, "ms_fused" with scale, shift and SiLU as served
        "ms": total("ms"),
        "ms_fused": total("ms_fused"),
        "ms_bf16": total("ms_bf16"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": max(bound, key=bound.get),
        "bound_cuda_core_ms": total("bound_cuda_core_ms"),
        "bound_bf16_ms": total("bound_bf16_ms"),
        "library_ms": total("library_ms"),
        "library_fused_ms": total("library_fused_ms"),
        # the same 8 convs as the training step's forward launches them
        # (B=32, no epilogue)
        "ms_b32": total("ms", train_rows),
        "plain_ms_b32": total("plain_ms", train_rows),
        "bound_ms_b32": total("bound_ms", train_rows),
        "library_ms_b32": total("library_ms", train_rows),
        "variants": {r["name"]: r["variant"] for r in main_rows},
        "card": smi,
    }, backward_row("dgrad", "stride 2: parity classes on the tensor cores; "
                    "stride 1: phase_conv.cu's wgmma_taps on flipped "
                    "weights; both after one packing launch"),
        backward_row("wgrad", "tensor cores, split-K partial sums + "
                     "ordered reduction"),
        {
            "name": "phase_conv_pack_taps",
            "route": "cuda",
            "source": "eop_tpu_torch/csrc/phase_conv_backward_tc.cu",
            "replaces": "eop_tpu/ops/pallas/conv_small_c.py:215 (its VJP)",
            "launches": train_launches["pack"],
            "launches_by_path": {"train": repeat_launches["pack"],
                                 "train_files": files_launches["pack"]},
            "max_abs_err": max(r["pack_max_abs_err"] for r in pack_rows),
            # per training step: the 7 data gradients' packings at B=32
            "batch": TRAIN_BATCH,
            "ms": sum(r["pack_ms"] for r in pack_rows),
            "plain_ms": sum(r["pack_plain_ms"] for r in pack_rows),
            "bound_ms": sum(r["pack_bound_ms"] for r in pack_rows),
            "bound_by": "bytes",
            "library_ms": None,
            "shapes": len(pack_rows),
            "card": smi,
        },
    ]})
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(probe_worker_exit() if sys.argv[1:] == ["--probe-worker-exit"]
             else main())
