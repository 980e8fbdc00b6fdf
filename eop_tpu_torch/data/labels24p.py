"""COCO category ids (counterpart of part of ``eop_tpu/data/labels24p.py``):
``COCO_ID2IDX``, the published 2017 ids 1..90 (ten retired) to the
contiguous 0..79 training ids.  The 24-point label generator is not ported
yet."""

from __future__ import annotations

# ids removed before the 2017 release; the contiguous id is the rank among
# the survivors
_RETIRED_COCO_IDS = {12, 26, 29, 30, 45, 66, 68, 69, 71, 83}
COCO_ID2IDX = {
    cid: idx
    for idx, cid in enumerate(
        c for c in range(1, 91) if c not in _RETIRED_COCO_IDS)
}
