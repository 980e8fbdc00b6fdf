"""Detection server: dynamic batching over the fused serving function.

    python -m eop_tpu_torch.tools.serve [-n yolox_24p_s | -n yolox-l | \
        -f exp.py] [-w model.pth] [--device cuda] [--batch 16] \
        [--src-hw 720,1280] [--port 8000] [--frontend async|threaded] \
        [key value ...]

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
connection (``serving/http.py``).

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


def build_service(args):
    from ..data.coco_classes import COCO_CLASSES
    from ..serving.service import DetectionService
    from .eval import eval_weights

    exp = load_exp(args)
    model = exp.get_model(args.device)
    if args.weights:
        model.load_state_dict(eval_weights(args.weights), strict=True)
    else:
        print("WARNING: serving RANDOM weights (seed 0, no -w) — smoke use "
              "only", flush=True)
    src_hw = parse_hw(args.src_hw) if args.src_hw else tuple(exp.test_size)
    class_names = COCO_CLASSES if exp.num_classes == 80 else None
    return DetectionService.from_exp(
        exp, model, args.batch, src_hw, device=args.device,
        class_names=class_names, max_wait_ms=args.max_wait_ms,
        max_queue=args.max_queue,
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
