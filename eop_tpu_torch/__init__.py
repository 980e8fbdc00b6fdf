"""eop_tpu_torch — the PyTorch / CUDA port of ``eop_tpu`` for NVIDIA Hopper.

It imports torch, numpy and the standard library, never JAX or ``eop_tpu``;
module names follow ``eop_tpu`` so each counterpart is easy to find.  Entry
points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
