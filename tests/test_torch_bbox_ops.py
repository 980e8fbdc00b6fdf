"""The bbox family's geometry, NMS, post-processing, SimOTA and loss in the
port against the JAX package's, on seeded numpy inputs: box helpers, NMS
keep masks, detection rows and assignments equal; losses within 1e-5
relative."""

from importlib import import_module

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eop_tpu.eval import postprocess as jpp
from eop_tpu.losses import simota as jsimota
from eop_tpu.losses import yolox_loss as jyl
from eop_tpu.models.yolox import training_outputs as j_training_outputs
from eop_tpu.ops import boxes as jboxes
from eop_tpu_torch.eval import postprocess as pp
from eop_tpu_torch.losses import iou_loss as tiou
from eop_tpu_torch.losses import simota as tsimota
from eop_tpu_torch.losses import yolox_loss as tyl
from eop_tpu_torch.models.yolox import training_outputs
from eop_tpu_torch.ops import boxes, nms

# the JAX package exports functions of these modules' names
jnms = import_module("eop_tpu.ops.nms")
jiou = import_module("eop_tpu.losses.iou_loss")
SIZE, BATCH, CLASSES, GTS = 128, 2, 5, 6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores, and
    PyTorch's default of a thread per core in each worker oversubscribes
    them (the CLI test took 465 s in a 6-worker run, 8 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_xyxy(rng, n, spread=60.0):
    xy = rng.rand(n, 2).astype(np.float32) * spread
    wh = rng.rand(n, 2).astype(np.float32) * 40 + 4
    return np.concatenate([xy, xy + wh], axis=1)


def head_maps(seed, size=SIZE, batch=BATCH):
    """Raw per-scale bbox head maps, NHWC numpy [B, s, s, 4+1+C]."""
    rng = np.random.RandomState(seed)
    return [rng.randn(batch, size // s, size // s, 5 + CLASSES).astype(
        np.float32) * 1.5 for s in (8, 16, 32)]


def labels(seed, batch=BATCH, gts=GTS, max_labels=10):
    """[B, max_labels, 5] (cls, cx, cy, w, h), zero-padded."""
    rng = np.random.RandomState(seed)
    out = np.zeros((batch, max_labels, 5), np.float32)
    for b in range(batch):
        for g in range(gts):
            w, h = rng.uniform(8, 60, 2)
            out[b, g] = (rng.randint(CLASSES), *rng.uniform(w / 2, SIZE - w / 2,
                                                            1),
                         rng.uniform(h / 2, SIZE - h / 2), w, h)
    return out


def nchw(maps):
    return [torch.from_numpy(m).permute(0, 3, 1, 2) for m in maps]


@pytest.mark.parametrize("name", ["xyxy2cxcywh", "xyxy2xywh", "matrix_iou",
                                  "adjust_box_anns", "filter_box"])
def test_box_helpers_equal_jax(name):
    rng = np.random.RandomState(0)
    a, b = random_xyxy(rng, 13), random_xyxy(rng, 7)
    if name in ("xyxy2cxcywh", "xyxy2xywh"):
        got = getattr(boxes, name)(torch.from_numpy(a)).numpy()
        want = np.asarray(getattr(jboxes, name)(jnp.asarray(a)))
    elif name == "matrix_iou":
        got, want = boxes.matrix_iou(a, b), jboxes.matrix_iou(a, b)
    elif name == "adjust_box_anns":
        rows = np.concatenate([a, rng.randint(0, 3, (13, 1))], 1)
        got = boxes.adjust_box_anns(rows.copy(), 1.7, -10, 5, 80, 90)
        want = jboxes.adjust_box_anns(rows.copy(), 1.7, -10, 5, 80, 90)
    else:
        got, want = boxes.filter_box(a, (10, 30)), jboxes.filter_box(a, (10, 30))
        assert 0 < len(got) < len(a)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("per_class", [False, True])
def test_nms_keep_masks_equal_jax(per_class):
    """Class-agnostic and per-class NMS over clustered boxes, with planted
    score ties and a score threshold that invalidates some: keep and order
    equal to the JAX functions', per image of a batch."""
    rng = np.random.RandomState(1)
    bx = np.stack([random_xyxy(rng, 40, spread=30.0) for _ in range(3)])
    sc = rng.rand(3, 40).astype(np.float32)
    sc[:, 5:9] = 0.5  # ties keep the lower index first
    cls = rng.randint(0, 3, (3, 40))
    kw = dict(iou_threshold=0.45, score_threshold=0.2, max_candidates=32)
    if per_class:
        got_keep, got_order = nms.batched_class_nms(
            torch.from_numpy(bx), torch.from_numpy(sc), torch.from_numpy(cls),
            **kw)
    else:
        got_keep, got_order = nms.nms(torch.from_numpy(bx),
                                      torch.from_numpy(sc), **kw)
    # one compile for the three images
    jax_nms = jax.jit(lambda b, s, c: (
        jnms.batched_class_nms(b, s, c, **kw) if per_class
        else jnms.nms(b, s, **kw)))
    for i in range(3):
        keep, order = jax_nms(jnp.asarray(bx[i]), jnp.asarray(sc[i]),
                              jnp.asarray(cls[i]))
        np.testing.assert_array_equal(got_order[i].numpy(), np.asarray(order))
        np.testing.assert_array_equal(got_keep[i].numpy(), np.asarray(keep))
        assert 0 < int(np.asarray(keep).sum()) < 32


@pytest.mark.parametrize("entry", ["heads", "decoded"])
def test_postprocess_bbox_rows_equal_jax(entry):
    """Detection rows [B, 300, 7] and their valid mask, class-aware NMS, from
    the raw head maps and from the decoded tensor: the same detections in
    the same slots with the same classes; boxes and scores within 1e-6
    relative plus 1e-5 px (XLA's exp and sigmoid and PyTorch's differ in the
    last bit, and x1 = cx - w / 2 cancels near 0)."""
    maps = head_maps(2)
    kw = dict(num_classes=CLASSES, conf_thre=0.05, nms_thre=0.45,
              nms_candidates=256)
    if entry == "heads":
        want = jax.jit(lambda m: jpp.postprocess_bbox_heads(m, **kw))(
            [jnp.asarray(m) for m in maps])
        got = pp.postprocess_bbox_heads(nchw(maps), **kw)
    else:
        from eop_tpu.models.yolox import inference_outputs as j_inference
        from eop_tpu_torch.models.yolox import inference_outputs

        want = jax.jit(lambda m: jpp.postprocess_bbox(j_inference(m), **kw))(
            [jnp.asarray(m) for m in maps])
        got = pp.postprocess_bbox(inference_outputs(nchw(maps)), **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    rows, want_rows = got.rows.numpy(), np.asarray(want.rows)
    np.testing.assert_array_equal(rows[..., 6], want_rows[..., 6])
    np.testing.assert_allclose(rows[..., :6], want_rows[..., :6], rtol=1e-6,
                               atol=1e-5)
    n = got.valid.sum(dim=1)
    assert got.rows.shape == (BATCH, 300, 7) and (n > 10).all()
    # boxes of different classes may overlap (per-class NMS)
    assert len(set(got.rows[0, : int(n[0]), 6].tolist())) > 1


@pytest.mark.parametrize("loss_type", ["iou", "giou"])
def test_iou_loss_matches_jax(loss_type):
    rng = np.random.RandomState(3)
    p = np.concatenate([rng.rand(64, 2) * 50, rng.rand(64, 2) * 30 + 1],
                       1).astype(np.float32)
    t = p + rng.randn(64, 4).astype(np.float32) * 6
    t[:, 2:] = np.abs(t[:, 2:]) + 1
    got = tiou.iou_loss(torch.from_numpy(p), torch.from_numpy(t), loss_type)
    want = jiou.iou_loss(jnp.asarray(p), jnp.asarray(t), loss_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.fixture(scope="module")
def decoded_pair():
    """Both packages' training decode of the same raw head maps, and the
    same labels."""
    maps = head_maps(4)
    lab = labels(5)
    jdec = j_training_outputs([jnp.asarray(m) for m in maps], reg_dim=4)
    tdec = training_outputs(nchw(maps), reg_dim=4)
    return jdec, tdec, lab


def _jax_assign(jdec, lab, cfg):
    dec, _, grids, strides = jdec

    @jax.jit
    def assign(lab, dec):
        return jax.vmap(lambda l, bp, ol, cl: jsimota.simota_assign(
            l, bp, ol, cl, grids, strides, CLASSES, cfg))(
                lab, dec[..., :4], dec[..., 4], dec[..., 5:])

    return assign(jnp.asarray(lab), dec)


@pytest.mark.parametrize("cand_cap", [0, 1536, 40])
def test_simota_assign_equals_jax(decoded_pair, cand_cap):
    """The full lattice (0), compaction that fits (1536 > A = 336: the full
    lattice path) and compaction that binds (40 slots for more candidates,
    which sheds anchors): fg mask, matched GT, matched IoU, counts equal."""
    jdec, tdec, lab = decoded_pair
    want = _jax_assign(jdec, lab, jsimota.SimOTAConfig(cand_cap=cand_cap))
    dec, _, grids, strides = tdec
    got = tsimota.simota_assign(
        torch.from_numpy(lab), dec[..., :4], dec[..., 4], dec[..., 5:], grids,
        strides, CLASSES, tsimota.SimOTAConfig(cand_cap=cand_cap))
    np.testing.assert_array_equal(got.fg_mask.numpy(), np.asarray(want.fg_mask))
    np.testing.assert_array_equal(got.matched_gt.numpy(),
                                  np.asarray(want.matched_gt))
    np.testing.assert_allclose(got.pred_iou.numpy(), np.asarray(want.pred_iou),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got.num_fg.numpy(), np.asarray(want.num_fg))
    np.testing.assert_array_equal(got.num_dropped.numpy(),
                                  np.asarray(want.num_dropped))
    assert got.fg_mask.sum() >= GTS
    assert (got.num_dropped > 0).all() == (cand_cap == 40)


@pytest.mark.parametrize("use_l1", [False, True])
def test_yolox_losses_match_jax(decoded_pair, use_l1):
    """Total and every term within 1e-5 relative; the L1 term zero without
    ``use_l1`` and positive with it."""
    jdec, tdec, lab = decoded_pair
    want, jaux = jax.jit(lambda d, o, lb, g, s: jyl.yolox_losses(
        d, o, lb, g, s, jyl.YoloxLossConfig(num_classes=CLASSES,
                                            use_l1=use_l1)))(
        jdec[0], jdec[1], jnp.asarray(lab), jdec[2], jdec[3])
    got, aux = tyl.yolox_losses(*tdec[:2], torch.from_numpy(lab), *tdec[2:],
                                tyl.YoloxLossConfig(num_classes=CLASSES,
                                                    use_l1=use_l1))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for k in ("loss_iou", "loss_obj", "loss_cls", "loss_l1", "num_fg_per_gt",
              "cand_dropped"):
        np.testing.assert_allclose(getattr(aux, k).item(),
                                   float(getattr(jaux, k)), rtol=1e-5,
                                   err_msg=k)
    assert (aux.loss_l1.item() > 0) == use_l1
