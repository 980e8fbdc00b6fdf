"""The mask contours of one COCO image drawn on it (counterpart of
``tools/show_mask.py``): a check of the segmentations before the 24-point
labels are made from them.

    python -m eop_tpu_torch.tools.show_mask --json instances.json \
        --images DIR [--image-id 42] [--out mask_vis.png]

Each annotation's mask (``COCO.annToMask``) gives its outer contours
(``data/geometry.find_contours_external``, ``cv2.findContours``' external
borders point for point), drawn closed at thickness 2 in the category's
colour, with the category id written at the box's corner where cv2 is
installed.  The image is read with ``data/image_io.imread`` and written
as ``--out``'s extension names (PNG, JPEG, BMP).  Host only, numpy.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def make_parser():
    parser = argparse.ArgumentParser("eop_tpu_torch.tools.show_mask")
    parser.add_argument("--json", required=True)
    parser.add_argument("--images", required=True)
    parser.add_argument("--image-id", type=int, default=None,
                        help="defaults to the first image in the json")
    parser.add_argument("--out", default="mask_vis.png")
    return parser


def main(argv=None):
    args = make_parser().parse_args(argv)
    from ..data.coco_api import COCO
    from ..data.geometry import find_contours_external
    from ..data.image_io import imread
    from ..utils.synth import write_image
    from ..utils.visualize import _COLORS, _cv2_or_none, polylines

    coco = COCO(args.json)
    img_id = args.image_id or sorted(coco.imgs.keys())[0]
    info = coco.loadImgs(img_id)[0]
    image = imread(os.path.join(args.images, info["file_name"]))
    anns = coco.loadAnns(coco.getAnnIds(imgIds=img_id))
    cv2 = _cv2_or_none("show_mask")
    for ann in anns:
        color = (_COLORS[ann["category_id"] % len(_COLORS)] * 255).astype(
            np.uint8).tolist()
        for contour in find_contours_external(coco.annToMask(ann)):
            polylines(image, contour, color, thickness=2)
        if cv2 is not None:
            x, y, _, _ = (int(v) for v in ann["bbox"])
            cv2.putText(image, str(ann["category_id"]), (x, max(y - 3, 10)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
    write_image(args.out, image)
    print(f"{len(anns)} masks -> {args.out}", flush=True)
    return args.out


if __name__ == "__main__":
    main()
