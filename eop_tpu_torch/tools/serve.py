"""Detection server: dynamic batching over the fused serving function.

    python -m eop_tpu_torch.tools.serve [-n yolox_24p_s | -n yolox-l | \
        -f exp.py] [-w model.pth] [--device cuda] [--batch 16] \
        [--src-hw 720,1280] [--port 8000] [--frontend async|threaded] \
        [--int8 [--calib IMG_DIR] [--quant-min-channels 64]] \
        [key value ...]
    python -m eop_tpu_torch.tools.serve --artifact serving.pt2 \
        [--device cuda] [--port 8000] [--test-size H,W]

``-n`` names the 24p preset ``yolox_24p_s`` (the default) or a bbox exp of
``exps/default/`` (``yolox-s|m|l|x|nano|tiny``, ``yolov3``); ``-f`` reads an
exp file of either family (e.g. ``load_eval/yolox_24p_eval.py``) without
importing it (``exp/build.py``) and takes precedence over ``-n``.  The exp's
family decides the answer: a bbox exp's detections carry ``bbox``, a 24p
exp's ``center``, ``radii`` and ``points``.  ``--batch`` (16, as the JAX
package's) is the largest batch the batcher forms.  ``-w`` takes the port's
checkpoint (its EMA weights where it has them), the reference's ``.pth``
or a bare state_dict in the reference's key names, loaded strictly;
without it the model serves seeded random weights.  Trailing ``key value``
pairs override exp attributes (e.g. ``test_conf 0.3``, ``compute_dtype
bfloat16``).  ``--frontend async`` (the default, as the JAX package's
``tools/serve.py``) serves every connection from one event-loop thread
(``serving/http_async.py``); ``--frontend threaded`` takes a thread per
connection (``serving/http.py``).  ``--int8`` serves the int8 program
(BatchNorms folded, activation scales calibrated on ``--calib``'s images,
uniform noise without them; ``ops/quant.py``).  ``--artifact`` serves a
``torch.export`` artifact of ``tools/export_serving.py`` instead of an exp:
its batch, ``src_hw``, ``test_size`` and class names come from the file
(``--test-size`` only for one without that metadata), and ``--batch``,
``--src-hw``, ``-n``, ``-f``, ``-w``, ``--int8``, ``--calib`` or exp
overrides beside it exit with an error.

Client:

    curl -s -X POST -H 'X-Raw-Shape: 720,1280,3' --data-binary @frame.rgb \
        localhost:8000/v1/detect
    curl -s localhost:8000/v1/stats
"""

from __future__ import annotations

import argparse


def make_parser():
    p = argparse.ArgumentParser("eop_tpu_torch.tools.serve")
    p.add_argument("-n", "--name", type=str, default="yolox_24p_s")
    p.add_argument("-f", "--exp_file", type=str, default=None,
                   help="exp file (takes precedence over -n)")
    p.add_argument("-w", "--weights", type=str, default=None,
                   help="the port's checkpoint, the reference's .pth or "
                        "a reference-keyed state_dict")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--src-hw", type=str, default=None,
                   help="H,W of the serving canvas (default: test_size); "
                        "pick the camera's native size for no host resize")
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="batching window after the first request")
    p.add_argument("--max-queue", type=int, default=256)
    p.add_argument("--frontend", choices=["async", "threaded"],
                   default="async",
                   help="HTTP front end: one selectors event loop (default) "
                        "or a thread per connection")
    p.add_argument("--artifact", type=str, default=None,
                   help="a torch.export artifact of tools/export_serving.py "
                        "(replaces -n/-f/-w)")
    p.add_argument("--test-size", type=str, default=None,
                   help="model input H,W for an artifact without that "
                        "metadata (a wrong one mis-scales every coordinate)")
    p.add_argument("--int8", action="store_true",
                   help="int8 PTQ (calibrate on --calib images)")
    p.add_argument("--calib", type=str, default=None,
                   help="directory of images for int8 calibration (uniform "
                        "noise if omitted: smoke use only)")
    p.add_argument("--quant-min-channels", type=int, default=64)
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                   help="exp overrides: key value ...")
    return p


def parse_hw(text: str):
    parts = tuple(int(v) for v in text.split(","))
    if len(parts) != 2 or min(parts) <= 0:
        raise SystemExit(f"expected H,W (two positive ints), got {text!r}")
    return parts


def load_exp(args):
    """The exp ``-f`` / ``-n`` names, with the trailing overrides."""
    from ..exp import get_exp

    exp = get_exp(args.exp_file, args.name)
    if args.opts:
        exp.merge(args.opts)
    return exp


# what an artifact fixes: each of these beside --artifact exits
_ARTIFACT_FIXES = (("--batch", "batch"), ("--src-hw", "src_hw"),
                   ("-n", "name"), ("-f", "exp_file"), ("-w", "weights"),
                   ("--int8", "int8"), ("--calib", "calib"),
                   ("--quant-min-channels", "quant_min_channels"),
                   ("exp overrides", "opts"))


def build_service(args):
    from ..data.coco_classes import COCO_CLASSES
    from ..serving.service import DetectionService
    from .eval import eval_weights

    if args.artifact:
        defaults = make_parser().parse_args([])
        for flag, name in _ARTIFACT_FIXES:
            if getattr(args, name) != getattr(defaults, name):
                raise SystemExit(f"{flag} is baked into the artifact; export "
                                 "it again to change it")
        ts = parse_hw(args.test_size) if args.test_size else None
        return DetectionService.from_artifact(
            args.artifact, ts, device=args.device,
            max_wait_ms=args.max_wait_ms, max_queue=args.max_queue)

    exp = load_exp(args)
    model = exp.get_model(args.device)
    if args.weights:
        model.load_state_dict(eval_weights(args.weights), strict=True)
    else:
        print("WARNING: serving RANDOM weights (seed 0, no -w) — smoke use "
              "only", flush=True)
    src_hw = parse_hw(args.src_hw) if args.src_hw else tuple(exp.test_size)
    quant_scales = None
    if args.int8:
        from ..ops.quant import quantized_keys
        from ..utils.serving_export import calibration_batch

        calib = calibration_batch(args.calib, src_hw, exp.test_size,
                                  device=args.device)
        model, quant_scales = exp.quantize_for_inference(
            model, [calib], args.quant_min_channels)
        n = len(quantized_keys(model, quant_scales,
                               args.quant_min_channels))
        print(f"int8 PTQ: {n} convs quantized "
              f"(min_channels={args.quant_min_channels})", flush=True)
    class_names = COCO_CLASSES if exp.num_classes == 80 else None
    return DetectionService.from_exp(
        exp, model, args.batch, src_hw, device=args.device,
        class_names=class_names, quant_scales=quant_scales,
        quant_min_channels=args.quant_min_channels,
        max_wait_ms=args.max_wait_ms, max_queue=args.max_queue,
    )


def main(argv=None):
    args = make_parser().parse_args(argv)
    from ..serving.http import make_http_server
    from ..serving.http_async import make_async_http_server

    service = build_service(args)
    make_server = (make_http_server if args.frontend == "threaded"
                   else make_async_http_server)
    server = make_server(service, args.host, args.port)
    print(f"serving on http://{args.host}:{server.server_address[1]}  "
          f"frontend={args.frontend} device={args.device} "
          f"batch={service.batch} "
          f"src_hw={service.src_hw} test_size={service.test_size}",
          flush=True)
    print("  POST /v1/detect | GET /v1/stats | GET /healthz", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if args.frontend == "threaded":
            server.server_close()
        service.close()


if __name__ == "__main__":
    main()
