"""Serving artifacts through ``torch.export`` (counterpart of
``eop_tpu/utils/serving_export.py``, which writes a StableHLO blob).

The fused serving program (uint8 letterbox on the device, forward, decode,
NMS: ``exp.get_serving_module``) is exported at one fixed input shape as one
``ExportedProgram`` and saved with ``torch.export.save``; the weights travel
inside it, and the JSON metadata (``test_size``, ``src_hw``, ``batch``,
``num_classes``, ``int8``, ``platforms``, ``class_names`` where set) rides
in the same file.  Loading needs this package only for its registered
operators, ``eop_tpu_torch::phase_conv`` (the Hopper kernels on the card,
the plain version on the CPU) and ``eop_tpu_torch::int8_conv``: no model
code, checkpoint or exp.
"""

from __future__ import annotations

import glob
import json
import os
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

PLATFORMS = ("cuda", "cpu")
META_FILE = "eop_serving_meta.json"
# the JAX package's artifact container (magic, length, JSON, StableHLO)
EOPSRV1_MAGIC = b"EOPSRV1\n"


def check_platforms(platforms: Sequence[str]) -> Tuple[str, ...]:
    """``platforms`` as a tuple of devices an artifact may load on
    (``cuda``, ``cpu``); any other name raises, naming itself."""
    out = tuple(str(p).strip().lower() for p in platforms)
    for p in out:
        if p not in PLATFORMS:
            raise ValueError(f"platform {p!r}: an artifact loads on "
                             f"{', '.join(PLATFORMS)}")
    if not out:
        raise ValueError("no platform given")
    return out


def export_serving(exp, model, batch_size: int, src_hw: Tuple[int, int],
                   device=None, quant_scales=None,
                   quant_min_channels: int = 64):
    """``exp.get_serving_module`` (int8 where ``quant_scales`` is given,
    with the deploy model of ``exp.quantize_for_inference``) exported for
    uint8 ``[batch_size, *src_hw, 3]`` on ``device`` (the card unless
    ``"cpu"``).  The program returns ``(rows, valid)``."""
    from ..utils.device import resolve_device

    device = resolve_device(device)
    module = exp.get_serving_module(model, src_hw, device, quant_scales,
                                    quant_min_channels).eval()
    raw = torch.zeros((batch_size, *src_hw, 3), dtype=torch.uint8,
                      device=device)
    with torch.no_grad():
        exported = torch.export.export(module, (raw,))
    # the zero frames it was traced with would be saved with it (22 MB at
    # B=8, 720x1280): the program needs none of them
    exported.example_inputs = None
    return exported


def calibration_batch(calib_dir: Optional[str], src_hw: Tuple[int, int],
                      test_size: Tuple[int, int], n_max: int = 32,
                      device=None) -> torch.Tensor:
    """One int8 calibration batch, preprocessed as serving preprocesses
    traffic: the images of ``calib_dir`` (sorted, at most ``n_max``,
    decoded by ``data/image_io.py``; unreadable files skipped) letterboxed
    onto the ``src_hw`` canvas on the host, then the device letterbox to
    ``test_size``; NHWC fp32 on ``device``.  With no images it calibrates
    on uniform noise (seed 0) and warns: smoke use only."""
    from ..data.image_io import UnsupportedImageError, imread
    from ..data.transforms import letterbox_batch_device, letterbox_host
    from ..utils.device import resolve_device

    device = resolve_device(device)
    raws = []
    if calib_dir:
        paths = sorted(
            p for p in glob.glob(os.path.join(calib_dir, "*"))
            if p.lower().endswith((".jpg", ".jpeg", ".png", ".bmp"))
        )[:n_max]
        for path in paths:
            try:
                img = imread(path)
            except (OSError, ValueError, UnsupportedImageError):
                continue
            raws.append(letterbox_host(img, src_hw)[0])
    if raws:
        raw = np.stack(raws)
    else:
        warnings.warn("no calibration images: calibrating on uniform noise; "
                      "the int8 program's accuracy is unvalidated")
        raw = np.random.RandomState(0).randint(
            0, 255, (8, src_hw[0], src_hw[1], 3), np.uint8)
    imgs, _ = letterbox_batch_device(
        torch.as_tensor(raw).to(device).float(), src_hw, test_size)
    return imgs


def save_serving_artifact(exported, path: str,
                          meta: Optional[dict] = None) -> int:
    """``torch.export.save`` the program with the JSON ``meta`` in the same
    file; returns the file's size in bytes.  ``meta`` carries at least
    ``test_size``, which the serving site needs to undo the letterbox."""
    torch.export.save(exported, path,
                      extra_files={META_FILE: json.dumps(meta or {})})
    return os.path.getsize(path)


def load_serving_artifact(path: str, device=None, with_meta: bool = False):
    """Load an artifact onto ``device`` (the card unless ``"cpu"``):
    returns the ``ExportedProgram`` (``.module()(raw_uint8)`` -> ``(rows,
    valid)``), and its metadata with ``with_meta``; TF32 off on the card,
    as the live serving path has it.  A device outside the
    artifact's ``platforms`` raises, as does a program whose weights end up
    elsewhere than on ``device``; a StableHLO blob of the JAX package
    raises a ``ValueError`` naming that format."""
    from torch.export.passes import move_to_device_pass

    from ..ops import phase_conv, quant  # noqa: F401  (register the ops)
    from ..utils.device import resolve_device, set_fp32_precision

    device = resolve_device(device)
    # the program's fp32 convs run as the live serving path runs them
    set_fp32_precision(device)
    with open(path, "rb") as f:
        head = f.read(len(EOPSRV1_MAGIC))
    if head == EOPSRV1_MAGIC:
        raise ValueError(
            f"{path} is an EOPSRV1 StableHLO artifact of the JAX package "
            "(eop_tpu/utils/serving_export.py): export it again with "
            "python -m eop_tpu_torch.tools.export_serving")
    extra = {META_FILE: ""}
    exported = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[META_FILE] or "{}")
    platforms = meta.get("platforms")
    if platforms is not None and device.type not in platforms:
        raise ValueError(f"{path} was exported for {platforms}, not "
                         f"{device.type}")
    exported = move_to_device_pass(exported, device)
    tensors = list(exported.state_dict.values()) + [
        v for v in exported.constants.values()
        if isinstance(v, torch.Tensor)]
    wrong = {str(t.device) for t in tensors if t.device.type != device.type}
    if wrong:
        raise RuntimeError(f"{path}: weights on {sorted(wrong)} after "
                           f"loading onto {device}")
    return (exported, meta) if with_meta else exported


def artifact_input_shape(exported) -> Tuple[int, ...]:
    """The one input's shape, ``(batch, H, W, 3)``."""
    spec = next(s for s in exported.graph_signature.input_specs
                if s.kind == torch.export.graph_signature.InputKind.USER_INPUT)
    node = next(n for n in exported.graph.nodes if n.name == spec.arg.name)
    return tuple(int(v) for v in node.meta["val"].shape)
