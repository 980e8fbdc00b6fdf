"""24-point labels from COCO instance masks by ray casting (counterpart of
``tools/labels_create_24p.py``).

    python -m eop_tpu_torch.tools.labels_create_24p \
        --json annotations/instances_train2017.json --images train2017 \
        --out COCO_24p_label [--mode Cord|Radius] [--area-low 0.5] \
        [--area-high 1.5]

Writes one ``{image_id:012}.txt`` for each image of the json whose
``{image_id:012}.jpg`` is in ``--images``: "Cord" rows (class, centre, 24
points, normalised; the 51 columns ``COCO24PDataset`` reads) or "Radius"
rows (class, centre, 24 radii over the diagonal).  Runs on the host (numpy,
no OpenCV); it prints its progress every 1000 annotations.
"""

from __future__ import annotations

import argparse


def make_parser():
    parser = argparse.ArgumentParser("eop_tpu_torch.tools.labels_create_24p")
    parser.add_argument("--json", required=True,
                        help="COCO instances json with segmentation")
    parser.add_argument("--images", required=True, help="images directory")
    parser.add_argument("--out", default="./COCO_24p_label")
    parser.add_argument("--mode", choices=["Cord", "Radius"],
                        default="Cord")
    parser.add_argument("--area-low", type=float, default=0.5)
    parser.add_argument("--area-high", type=float, default=1.5)
    return parser


def main(argv=None):
    args = make_parser().parse_args(argv)
    from ..data.labels24p import Polygon24

    gen = Polygon24(args.json, args.images, args.out, mode=args.mode)
    gen.process(area_t_low=args.area_low, area_t_high=args.area_high,
                progress=True)
    gen.save()
    print(f"labels written to {args.out}", flush=True)
    return gen


if __name__ == "__main__":
    main()
