"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` or ``"cuda"`` -> the card, which must be there; ``"cpu"``
    only when the caller asks for it.  Never falls back silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def set_fp32_precision(device: torch.device) -> None:
    """Full fp32 convs and matmuls on the card.  cuDNN runs fp32 convs in
    TF32 by default (about three decimal digits); the fp32 serving path
    turns that off so the card agrees with the CPU and the JAX numbers.
    These are process-wide PyTorch flags."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
