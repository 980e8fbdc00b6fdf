"""Export the fused serving program to a ``torch.export`` artifact
(counterpart of ``tools/export_serving.py``):

    python -m eop_tpu_torch.tools.export_serving [-n yolox_24p_s | -n \
        yolox-l | -f exp.py] [-w model.pth] --batch 8 --src-hw 720,1280 \
        --out serving_24p.pt2 [--platforms cuda,cpu] [--device cuda] \
        [--int8 [--calib IMG_DIR] [--quant-min-channels 64]] [--smoke] \
        [key value ...]

Letterbox, forward, decode and NMS with the weights inside, at one input
shape, uint8 ``[batch, *src_hw, 3]``; the JSON metadata (``test_size``,
``src_hw``, ``batch``, ``num_classes``, ``int8``, ``platforms``, COCO's
class names for an 80-class exp) rides in the file.  ``-w`` takes what
``tools.eval -c`` takes (``tools/eval.py::eval_weights``); without it the
model has seeded random weights (smoke use only).  ``--int8`` folds the
BatchNorms and calibrates on ``--calib``'s images (uniform noise without
them), then exports the int8 program.  ``--platforms`` lists the devices
the artifact may load on (``cuda``, ``cpu``; default the export device).
``--smoke`` loads the artifact and runs it once on zeros.  Load side:

    from eop_tpu_torch.utils.serving_export import load_serving_artifact
    prog, meta = load_serving_artifact("serving_24p.pt2", with_meta=True)
    rows, valid = prog.module()(raw_uint8_on_the_device)

or ``python -m eop_tpu_torch.tools.serve --artifact serving_24p.pt2``.
"""

from __future__ import annotations

import argparse
import time


def make_parser():
    p = argparse.ArgumentParser("eop_tpu_torch.tools.export_serving")
    p.add_argument("-n", "--name", type=str, default="yolox_24p_s")
    p.add_argument("-f", "--exp_file", type=str, default=None,
                   help="exp file (takes precedence over -n)")
    p.add_argument("-w", "--weights", type=str, default=None,
                   help="the port's checkpoint, the reference's .pth or a "
                        "reference-keyed state_dict (omit for random "
                        "weights: smoke use only)")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--src-hw", type=str, default=None,
                   help="H,W of the raw serving input (default: test_size)")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="the device the program is exported on")
    p.add_argument("--platforms", type=str, default=None,
                   help="comma list of devices the artifact loads on, e.g. "
                        "cuda,cpu (default: --device)")
    p.add_argument("--smoke", action="store_true",
                   help="load the artifact and run it once on zeros")
    p.add_argument("--int8", action="store_true",
                   help="int8 PTQ: fold BatchNorm, calibrate on --calib, "
                        "export the int8 program")
    p.add_argument("--calib", type=str, default=None,
                   help="directory of images for int8 calibration (uniform "
                        "noise if omitted: smoke use only)")
    p.add_argument("--quant-min-channels", type=int, default=64)
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                   help="exp overrides: key value ...")
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    import torch

    from ..data.coco_classes import COCO_CLASSES
    from ..ops.quant import quantized_keys
    from ..utils.serving_export import (
        artifact_input_shape,
        calibration_batch,
        check_platforms,
        export_serving,
        load_serving_artifact,
        save_serving_artifact,
    )
    from .eval import eval_weights
    from .serve import load_exp, parse_hw

    platforms = check_platforms(args.platforms.split(",") if args.platforms
                                else [args.device])
    exp = load_exp(args)
    model = exp.get_model(args.device)
    if args.weights:
        model.load_state_dict(eval_weights(args.weights), strict=True)
    src_hw = parse_hw(args.src_hw) if args.src_hw else tuple(exp.test_size)
    quant_scales = None
    if args.int8:
        calib = calibration_batch(args.calib, src_hw, exp.test_size,
                                  device=args.device)
        model, quant_scales = exp.quantize_for_inference(
            model, [calib], args.quant_min_channels)
        n = len(quantized_keys(model, quant_scales,
                               args.quant_min_channels))
        print(f"int8 PTQ: {n} convs quantized "
              f"(min_channels={args.quant_min_channels})", flush=True)
    t0 = time.perf_counter()
    exported = export_serving(exp, model, args.batch, src_hw, args.device,
                              quant_scales, args.quant_min_channels)
    export_s = time.perf_counter() - t0
    meta = {"test_size": list(exp.test_size), "src_hw": list(src_hw),
            "batch": args.batch, "num_classes": exp.num_classes,
            "int8": bool(args.int8), "platforms": list(platforms)}
    if exp.num_classes == 80:
        meta["class_names"] = list(COCO_CLASSES)
    size = save_serving_artifact(exported, args.out, meta)
    print(f"exported {args.out}: {size / 1e6:.1f} MB in {export_s:.1f} s, "
          f"platforms={','.join(platforms)}, "
          f"input=uint8[{args.batch},{src_hw[0]},{src_hw[1]},3]", flush=True)
    if args.smoke:
        prog = load_serving_artifact(args.out, args.device)
        raw = torch.zeros(artifact_input_shape(prog), dtype=torch.uint8,
                          device=args.device)
        with torch.no_grad():
            rows, valid = prog.module()(raw)
        print(f"smoke: rows{tuple(rows.shape)} valid{tuple(valid.shape)} "
              f"n_det={int(valid.sum())}", flush=True)
    return args.out


if __name__ == "__main__":
    main()
