"""Spatial sharding: one image's rows over the ranks of a space group
(counterpart of ``eop_tpu/parallel/mesh.py``'s ``image_spec`` and
``unshard_space``, and of the halo exchanges GSPMD inserts around every
conv of a height-sharded activation).

* :func:`row_split` cuts the height at multiples of :data:`ROW_BLOCK` input
  rows (dark4's stride), as evenly as the blocks allow, the first ranks
  taking one block more (416 px over 4 ranks: 7, 7, 6 and 6 blocks), so
  that every stride-2 conv of the sharded region sees an even local
  height and every multiscale size splits;
* :func:`halo_rows` gives the rows a conv reads beyond the ones it owns;
  :func:`halo_exchange` fetches them from the neighbours (zero rows at the
  image's edges) and sends their gradient back to the rank that owns them;
  a conv then runs on the extended rows with its own symmetric padding and
  keeps the output rows it owns (``ops/blocks.py::BaseConv``);
* :func:`gather_rows` is the fence: every rank of the space group gets the
  whole height; its backward keeps the rank's own rows, since every space
  rank computes the same thing after the fence;
* :func:`convert_spatial` puts a model's sharded region (the backbone's
  stem through dark4) under a space group, and its fence before dark5.

The collectives are ``all_gather`` only, which gloo takes on CUDA tensors
as well (its ``send`` / ``recv`` take host tensors only): two ranks on one
card run over gloo, as NCCL refuses two ranks on one device.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

__all__ = [
    "ROW_BLOCK",
    "convert_spatial",
    "gather_rows",
    "halo_exchange",
    "halo_rows",
    "region_modules",
    "row_split",
    "shard_rows",
]

# the rows of the input image a space rank's share is a multiple of: the
# stride of dark4, the last stage of the sharded region
ROW_BLOCK = 16


def row_split(height: int, parts: int) -> List[Tuple[int, int]]:
    """The ``(start, stop)`` input rows of each of ``parts`` space ranks:
    whole blocks of :data:`ROW_BLOCK` rows, as even as they go, the first
    ranks one block more.  Raises where the height is no multiple of the
    block or has fewer blocks than ranks."""
    if height % ROW_BLOCK:
        raise ValueError(f"height {height} is no multiple of {ROW_BLOCK} "
                         "rows: it does not split over a space group")
    blocks = height // ROW_BLOCK
    if blocks < parts:
        raise ValueError(f"height {height} has {blocks} blocks of "
                         f"{ROW_BLOCK} rows: fewer than {parts} space ranks")
    base, extra = divmod(blocks, parts)
    out, start = [], 0
    for i in range(parts):
        stop = start + (base + (i < extra)) * ROW_BLOCK
        out.append((start, stop))
        start = stop
    return out


def shard_rows(images, rank: int, parts: int):
    """Space rank ``rank``'s rows (:func:`row_split`) of NHWC ``images``
    (dim 1 the height); ``images`` as they are for one rank."""
    if parts == 1:
        return images
    start, stop = row_split(images.shape[1], parts)[rank]
    return images[:, start:stop]


def halo_rows(k: int, stride: int, padding: int) -> Tuple[int, int]:
    """``(above, below)``: the rows beyond its own a space rank's input
    needs so that a ``k x k`` conv with this ``stride`` and symmetric
    ``padding`` computes every output row the rank owns (output rows
    ``start / stride`` up to ``stop / stride`` of its input rows
    ``[start, stop)``): ``padding`` above and ``k - stride - padding``
    below, each rounded up to a multiple of the stride so that the
    extended height keeps its parity (3x3/s1: 1 and 1; 3x3/s2: 2 and 0;
    the folded 6x6/s2 stem: 2 and 2; 1x1: none)."""
    def up(n):
        return -(-max(n, 0) // stride) * stride

    return up(padding), up(k - stride - padding)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


class _HaloExchange(torch.autograd.Function):
    """NCHW ``x`` (this rank's rows) -> ``above`` rows of the rank before,
    ``x``, ``below`` rows of the rank after (zero rows at the edges), in
    channels_last memory; one ``all_gather`` of every rank's edge rows.
    The backward sends each halo's gradient back to the rank owning those
    rows (one ``all_gather`` of the halos' gradients) and adds it there."""

    @staticmethod
    def forward(ctx, x, above, below, group):
        rank, size = dist.get_rank(group), dist.get_world_size(group)
        xh = _nhwc(x)
        h = xh.shape[1]
        if h < max(above, below):
            raise ValueError(f"a space rank's {h} rows cannot give a halo of "
                             f"{above} rows above and {below} below")
        parts = _all_gather(torch.cat([xh[:, :below], xh[:, h - above:]], 1),
                            group)

        def edge(n):
            return xh.new_zeros((xh.shape[0], n, *xh.shape[2:]))

        top = parts[rank - 1][:, below:] if rank > 0 else edge(above)
        bottom = parts[rank + 1][:, :below] if rank + 1 < size else edge(below)
        ctx.halo = (above, below, h, group)
        return _nchw(torch.cat([top, xh, bottom], 1))

    @staticmethod
    def backward(ctx, g):
        above, below, h, group = ctx.halo
        rank, size = dist.get_rank(group), dist.get_world_size(group)
        gh = _nhwc(g)
        parts = _all_gather(torch.cat([gh[:, :above], gh[:, above + h:]], 1),
                            group)
        dx = gh[:, above:above + h].contiguous()
        if rank + 1 < size:  # the next rank's rows above are my last rows
            dx[:, h - above:] += parts[rank + 1][:, :above]
        if rank > 0:         # the rank before's rows below are my first rows
            dx[:, :below] += parts[rank - 1][:, above:]
        return _nchw(dx), None, None, None


def halo_exchange(x: torch.Tensor, above: int, below: int,
                  group) -> torch.Tensor:
    """NCHW ``x``, this space rank's rows, extended by ``above`` rows of
    the rank before and ``below`` rows of the rank after (zero rows at the
    image's top and bottom edges), differentiable."""
    if not (above or below):
        return x
    return _HaloExchange.apply(x, above, below, group)


class _GatherRows(torch.autograd.Function):
    """NCHW ``x`` (this rank's rows) -> every space rank's rows in rank
    order; the backward keeps this rank's rows of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        rank = dist.get_rank(group)
        xh = _nhwc(x)
        h = xh.shape[1]
        heights = [int(v) for v in torch.cat(_all_gather(
            torch.tensor([h], device=x.device), group)).tolist()]
        hmax = max(heights)
        if h < hmax:
            xh = torch.cat([xh, xh.new_zeros((xh.shape[0], hmax - h,
                                              *xh.shape[2:]))], 1)
        parts = _all_gather(xh, group)
        ctx.rows = (sum(heights[:rank]), h)
        return _nchw(torch.cat([p[:, :n] for p, n in zip(parts, heights)], 1))

    @staticmethod
    def backward(ctx, g):
        first, h = ctx.rows
        return _nchw(_nhwc(g)[:, first:first + h].contiguous()), None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The fence (``eop_tpu``'s ``unshard_space``): NCHW ``x``, this space
    rank's rows, gathered whole on every rank of ``group``; ``x`` itself
    without a group.  Differentiable: the gradient a rank keeps is its own
    rows'."""
    if group is None:
        return x
    return _GatherRows.apply(x, group)


def region_modules(model: nn.Module) -> List[nn.Module]:
    """The modules of ``model``'s sharded region: the stem, dark2, dark3
    and dark4 of each ``CSPDarknet`` / ``Darknet`` in it (the stages
    before the fence)."""
    from ..models.darknet import CSPDarknet, Darknet

    return [getattr(m, name) for m in model.modules()
            if isinstance(m, (CSPDarknet, Darknet))
            for name in m.SPACE_REGION]


def convert_spatial(model: nn.Module, group) -> nn.Module:
    """Put ``model``'s backbone under the space ``group``, in place: every
    conv of its sharded region exchanges halo rows (``BaseConv.space``)
    and the backbone gathers the rows before dark5 and the taps the neck
    reads (``space`` of ``CSPDarknet`` / ``Darknet``).  The study's VGG19,
    ResNet50 and DenseNet121 have no fence yet and raise
    ``NotImplementedError``.  Returns ``model``."""
    from ..models.darknet import CSPDarknet, Darknet
    from ..ops.blocks import BaseConv, SPPBottleneck

    backbones = [m for m in model.modules()
                 if isinstance(m, (CSPDarknet, Darknet))]
    if not backbones:
        raise NotImplementedError(
            f"--spatial: {type(model).__name__} has no CSPDarknet or Darknet "
            "backbone; the study's VGG19, ResNet50 and DenseNet121 have no "
            "fence in the port yet (ROADMAP.md queue 1 item 10)")
    for b in backbones:
        b.space = group
    for region in region_modules(model):
        for m in region.modules():
            if isinstance(m, (BaseConv, SPPBottleneck)):
                m.space = group
    return model
