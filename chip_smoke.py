#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``eop_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

1. prints the card (``nvidia-smi`` name and power limit, torch's name and
   count);
2. builds every CUDA kernel of the port from ``eop_tpu_torch/csrc``;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it (and the JAX package's test cases), and
   times kernel, plain version and the PyTorch library call;
4. serves the 24p-s detector (depth 0.33, width 0.50, 80 classes, 640 px)
   with seeded random weights behind the threaded HTTP front end, answers
   concurrent raw-body requests and checks every kernel of the path ran;
5. times the stages of one serving call on the device;
6. runs one image through the port on the card and on the CPU and compares.

Every phase raises on failure.  Each phase prints one JSON line; the line
before the last holds the kernels, the last line is the result.  Exits
non-zero, printing no result, where there is no card or no ``eop_tpu_torch``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

# peak rates of one H100 SXM at its 700 W limit (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12   # CUDA cores, no tensor cores
PEAK_BYTES = 3.35e12      # HBM3
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


def check_phase_conv():
    """Kernel vs plain version on every shape, fp32 and bf16; times at the
    main-path shapes in fp32 (the serving path's type)."""
    import torch.nn.functional as F

    from eop_tpu_torch.ops.phase_conv import (
        out_hw,
        phase_conv,
        phase_conv_reference,
    )

    cases = ([(f"jax_case_{i}", c, 2) for i, c in enumerate(JAX_CASES)]
             + [(n, c, SERVE_BATCH) for n, c in MAIN_PATH])
    rows, err32, err16 = [], 0.0, 0.0
    for seed, (name, case, batch) in enumerate(cases):
        k, s, p, h, w, c, co = case
        row = {"name": name, "case": list(case), "batch": batch}
        for dtype, tol, key in ((torch.float32, FP32_TOL, "fp32"),
                                (torch.bfloat16, BF16_TOL, "bf16")):
            x, wgt = conv_inputs(case, batch, dtype, seed)
            got = phase_conv(x, wgt, s, p)
            want = phase_conv_reference(x, wgt, s, p)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            row[f"max_abs_err_{key}"] = err
            row[f"scale_{key}"] = scale
            if not err <= tol * max(1.0, scale):
                raise AssertionError(f"phase_conv {name} {key}: max abs err "
                                     f"{err} > {tol} x {max(1.0, scale)}")
            if key == "fp32":
                err32 = max(err32, err)
            else:
                err16 = max(err16, err)
        if batch == SERVE_BATCH:
            x, wgt = conv_inputs(case, batch, torch.float32, seed)
            x_nchw = x.permute(0, 3, 1, 2)           # channels_last view
            w_oihw = wgt.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            row["ms"] = cuda_ms(lambda: phase_conv(x, wgt, s, p))
            row["plain_ms"] = cuda_ms(
                lambda: phase_conv_reference(x, wgt, s, p))
            row["library_ms"] = cuda_ms(
                lambda: F.conv2d(x_nchw, w_oihw, stride=s, padding=p))
            ho, wo = out_hw(h, w, k, s, p)
            flops = 2.0 * batch * ho * wo * co * k * k * c
            nbytes = 4.0 * (x.numel() + wgt.numel() + batch * ho * wo * co)
            t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
            row.update(flops=flops, bytes=nbytes,
                       bound_ms=1e3 * max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes else "bytes")
        rows.append(row)
    return rows, err32, err16


def serving_exp():
    from eop_tpu_torch.exp import get_exp

    exp = get_exp("yolox_24p_s")
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
    return {"phase": "stages", "card": smi, "batch": SERVE_BATCH,
            "iters": iters, "h2d_letterbox_ms": float(med[0]),
            "forward_ms": float(med[1]), "postprocess_ms": float(med[2]),
            "call_wall_ms": float(med[3]),
            "profiled_call_wall_ms": wall, "profiled_device_busy_ms": busy_ms,
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def card_vs_cpu(exp):
    """One image through the port on the card (kernels) and on the CPU
    (plain versions), same seeded weights."""
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from eop_tpu_torch import _build
    from eop_tpu_torch.utils.device import set_fp32_precision

    set_fp32_precision(torch.device("cuda"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    emit({"phase": "device", "nvidia_smi": smi, **device,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    info = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": info})

    shapes, err32, err16 = check_phase_conv()
    for row in shapes:
        emit({"phase": "phase_conv", "card": smi, **row})

    exp = serving_exp()
    model = exp.get_model("cuda")
    serve_report, launches = serve_main_path(smi, exp, model)
    emit(serve_report)
    emit(serving_stages(smi, exp, model))
    emit(card_vs_cpu(exp))

    main_rows = [r for r in shapes if "ms" in r]
    bound = {"operations": 0.0, "bytes": 0.0}
    for r in main_rows:
        bound[r["bound_by"]] += r["bound_ms"]
    emit({"kernels": [{
        "name": "phase_conv",
        "route": "cuda",
        "source": "eop_tpu_torch/csrc/phase_conv.cu",
        "replaces": "eop_tpu/ops/pallas/conv_small_c.py:181",
        "launches": launches["phase_conv"],
        "max_abs_err": err32,
        "max_abs_err_bf16": err16,
        # per forward at B=8, 640 px: the 8 main-path convs summed
        "ms": sum(r["ms"] for r in main_rows),
        "plain_ms": sum(r["plain_ms"] for r in main_rows),
        "bound_ms": sum(r["bound_ms"] for r in main_rows),
        "bound_by": max(bound, key=bound.get),
        "library_ms": sum(r["library_ms"] for r in main_rows),
        "card": smi,
    }]})
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
