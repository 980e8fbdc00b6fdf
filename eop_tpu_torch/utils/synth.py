"""Synthetic 24-point training batches (counterpart of
``eop_tpu/utils/synth.py``): the label row layout ``[cls, cx, cy,
24 x (x, y)]`` zero-padded to ``max_labels`` rows, with the same ranges.
The random stream is a ``torch.Generator``'s, not JAX's, so a comparison of
the two packages feeds both the same numpy arrays instead."""

from __future__ import annotations

import math

import torch


def synthetic_24p_batch(generator: torch.Generator, batch: int,
                        size: int = 640, ngt: int = 8, max_labels: int = 50,
                        r_lo: float = 10.0, r_hi: float = 80.0):
    """Returns (images ``[B, S, S, 3]`` f32 in 0..255, labels
    ``[B, max_labels, 51]`` f32 with ``ngt`` valid star-polygon rows), on the
    generator's device."""
    dev = generator.device

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=dev)
        return lo + (hi - lo) * u

    imgs = uniform((batch, size, size, 3), 0.0, 255.0)
    margin = r_hi + 20.0
    cx = uniform((batch, max_labels, 1), margin, size - margin)
    cy = uniform((batch, max_labels, 1), margin, size - margin)
    r = uniform((batch, max_labels, 24), r_lo, r_hi)
    theta = torch.arange(24, device=dev) * (2 * math.pi / 24)
    pts = torch.stack([cx + r * torch.cos(theta), cy + r * torch.sin(theta)],
                      dim=-1).reshape(batch, max_labels, 48)
    labels = torch.cat([torch.zeros_like(cx), cx, cy, pts], dim=-1)
    keep = torch.arange(max_labels, device=dev)[None, :, None] < ngt
    return imgs, labels * keep
