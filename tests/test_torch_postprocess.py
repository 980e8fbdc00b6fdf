"""The port's geometry, NMS and 24p post-processing against the JAX
package's, on seeded inputs with planted ties and an adversarial
suppression chain."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eop_tpu.eval import postprocess as jpp
from eop_tpu.ops import boxes as jboxes
from eop_tpu.ops.nms import nms_on_candidates as jax_nms_on_candidates
from eop_tpu.ops import polygon as jpoly
from eop_tpu_torch.eval import postprocess as pp
from eop_tpu_torch.ops import boxes, nms, polygon


def random_boxes(rng, n, spread=60.0):
    xy = rng.rand(n, 2).astype(np.float32) * spread
    wh = rng.rand(n, 2).astype(np.float32) * 40 + 4
    return np.concatenate([xy, xy + wh], axis=1)


def chain_boxes(k, iou_target=0.75, width=10.0):
    """K boxes on a line, each overlapping its neighbour above the
    threshold: greedy keeps every other box and the chain is K deep."""
    overlap = 2 * width * iou_target / (1 + iou_target)
    x1 = np.arange(k) * (width - overlap)
    return np.stack([x1, np.zeros(k), x1 + width, np.ones(k)],
                    axis=1).astype(np.float32)


@pytest.mark.parametrize("xyxy", [True, False])
def test_bboxes_iou_and_cxcywh_match_jax(xyxy):
    rng = np.random.RandomState(0)
    a, b = random_boxes(rng, 17), random_boxes(rng, 9)
    want = jboxes.bboxes_iou(jnp.asarray(a), jnp.asarray(b), xyxy=xyxy)
    got = boxes.bboxes_iou(torch.from_numpy(a), torch.from_numpy(b), xyxy)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # batched leading dims give the per-image answer
    got_b = boxes.bboxes_iou(torch.from_numpy(np.stack([a, a])),
                             torch.from_numpy(np.stack([b, b])), xyxy)
    np.testing.assert_allclose(got_b[1].numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(
        boxes.cxcywh2xyxy(torch.from_numpy(a)).numpy(),
        np.asarray(jboxes.cxcywh2xyxy(jnp.asarray(a))), atol=1e-6)


@pytest.mark.parametrize("parity", [False, True])
def test_polygon_points_match_jax(parity):
    rng = np.random.RandomState(1)
    centers = rng.rand(3, 5, 2).astype(np.float32) * 64
    radii = rng.rand(3, 5, 24).astype(np.float32) * 20
    want = jpoly.polygon_points_from_radii(jnp.asarray(centers),
                                           jnp.asarray(radii), parity)
    got = polygon.polygon_points_from_radii(torch.from_numpy(centers),
                                            torch.from_numpy(radii), parity)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("mode", ["exact", 3, 64])
@pytest.mark.parametrize("classful", [False, True])
def test_suppress_matches_jax(mode, classful):
    rng = np.random.RandomState(2)
    k = 96
    bx = random_boxes(rng, k)
    valid = rng.rand(k) > 0.2
    cls = rng.randint(0, 3, k) if classful else None
    want = jax_nms_on_candidates(
        jnp.asarray(bx), jnp.asarray(valid), 0.3,
        class_ids=None if cls is None else jnp.asarray(cls),
        fixpoint_iters=mode)
    got = nms.nms_on_candidates(
        torch.from_numpy(bx)[None], torch.from_numpy(valid)[None], 0.3,
        class_ids=None if cls is None else torch.from_numpy(cls)[None],
        fixpoint_iters=mode)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


def test_exact_suppress_survives_adversarial_chain():
    k = 200
    bx = chain_boxes(k)
    valid = np.ones(k, bool)
    want = np.asarray(jax_nms_on_candidates(
        jnp.asarray(bx), jnp.asarray(valid), 0.65, fixpoint_iters="exact"))
    truth = np.arange(k) % 2 == 0  # greedy: every other box
    np.testing.assert_array_equal(want, truth)
    # batched: the chain beside an image that converges at once
    bxs = torch.from_numpy(np.stack([bx, np.broadcast_to(bx[0], bx.shape)]))
    got = nms.nms_on_candidates(bxs, torch.ones(2, k, dtype=torch.bool),
                                0.65, fixpoint_iters="exact")
    np.testing.assert_array_equal(got[0].numpy(), truth)
    assert got[1].sum() == 1  # identical boxes: only the first survives
    budget = nms.nms_on_candidates(torch.from_numpy(bx)[None],
                                   torch.ones(1, k, dtype=torch.bool), 0.65,
                                   fixpoint_iters=16)
    assert not np.array_equal(budget[0].numpy(), truth)


def head_maps(rng, b=2, sizes=((8, 8), (4, 4), (2, 2)), nc=3):
    """Random raw 24p head maps, NHWC, with planted ties: identical anchors
    (equal scores) and equal top class logits."""
    maps = []
    for h, w in sizes:
        m = rng.randn(b, h, w, 27 + nc).astype(np.float32)
        m[..., 2:26] = m[..., 2:26] * 0.3 + 1.0   # radii ~ e^1 * stride
        m[..., 26:] += 1.0                         # scores well above conf
        maps.append(m)
    maps[0][:, 3, 5] = maps[0][:, 1, 2]          # tied anchors in a scale
    maps[1][:, 0, 1] = maps[0][:, 1, 2]          # ...and across scales
    maps[0][:, 2, :, 28] = maps[0][:, 2, :, 27]  # tied class logits
    return maps


@pytest.mark.parametrize("parity", [False, True])
@pytest.mark.parametrize("agnostic", [False, True])
def test_postprocess_24p_heads_matches_jax(parity, agnostic):
    maps = head_maps(np.random.RandomState(4))
    kw = dict(num_classes=3, conf_thre=0.3, nms_thre=0.3,
              class_agnostic=agnostic, reference_parity=parity,
              max_detections=40, nms_candidates=64)
    want = jpp.postprocess_24p_heads([jnp.asarray(m) for m in maps], **kw)
    got = pp.postprocess_24p_heads(
        [torch.from_numpy(m).permute(0, 3, 1, 2) for m in maps], **kw)
    assert got.rows.shape == (2, 40, 29)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert 0 < int(got.valid.sum()) < got.valid.numel()
    np.testing.assert_allclose(got.rows.numpy(), np.asarray(want.rows),
                               atol=1e-5, rtol=1e-5)


def test_select_rows_drops_surplus_past_capacity():
    cand = torch.arange(2 * 6 * 2, dtype=torch.float32).reshape(2, 6, 2)
    keep = torch.tensor([[1, 0, 1, 1, 1, 1], [0, 0, 0, 1, 0, 0]], dtype=bool)
    rows, valid = pp._select_rows(cand, keep, 3)
    for i in range(2):
        want = jpp._select_rows(jnp.asarray(cand[i].numpy()),
                                jnp.asarray(keep[i].numpy()), 3)
        np.testing.assert_array_equal(rows[i].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(want[1]))
