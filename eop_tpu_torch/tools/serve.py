"""Detection server: dynamic batching over the fused serving function.

    python -m eop_tpu_torch.tools.serve [-n yolox_24p_s | -f exp.py] \
        [-w model.pth] [--device cuda] [--batch 8] [--src-hw 720,1280] \
        [--port 8000] [key value ...]

``-f`` reads an exp file (e.g. ``load_eval/yolox_24p_eval.py``) without
importing it (``exp/build.py``) and takes precedence over ``-n``.  ``-w``
takes a PyTorch state_dict in the reference's key names (loaded strictly);
without it the model serves seeded random weights.  Trailing ``key value``
pairs override exp attributes (e.g. ``test_conf 0.3``, ``compute_dtype
bfloat16``).

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
                   help="PyTorch state_dict (.pth) in reference key names")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--src-hw", type=str, default=None,
                   help="H,W of the serving canvas (default: test_size); "
                        "pick the camera's native size for no host resize")
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="batching window after the first request")
    p.add_argument("--max-queue", type=int, default=256)
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                   help="exp overrides: key value ...")
    return p


def parse_hw(text: str):
    parts = tuple(int(v) for v in text.split(","))
    if len(parts) != 2 or min(parts) <= 0:
        raise SystemExit(f"expected H,W (two positive ints), got {text!r}")
    return parts


def build_service(args):
    import torch

    from ..data.coco_classes import COCO_CLASSES
    from ..exp import get_exp
    from ..serving.service import DetectionService

    exp = get_exp(args.exp_file, args.name)
    if args.opts:
        exp.merge(args.opts)
    model = exp.get_model(args.device)
    if args.weights:
        sd = torch.load(args.weights, map_location="cpu", weights_only=True)
        model.load_state_dict(sd, strict=True)
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

    service = build_service(args)
    server = make_http_server(service, args.host, args.port)
    print(f"serving on http://{args.host}:{server.server_address[1]}  "
          f"device={args.device} batch={service.batch} "
          f"src_hw={service.src_hw} test_size={service.test_size}",
          flush=True)
    print("  POST /v1/detect | GET /v1/stats | GET /healthz", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
