"""The port's 24p loss path (ops/polygon, ops/circle_iou, losses/) against
the JAX package's, function by function, on the same numpy inputs.  Discrete
results (masks, indices, the SimOTA assignment) must be equal; continuous
ones carry the tolerance stated at each test."""

from importlib import import_module

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eop_tpu.losses import simota as j_sim
from eop_tpu.models.head import make_grids_and_strides as j_grids
from eop_tpu.ops import circle_iou as j_circ
from eop_tpu.ops import polygon as j_poly
from eop_tpu_torch.losses import iou_loss as t_iou
from eop_tpu_torch.losses import simota as t_sim
from eop_tpu_torch.models.head import make_grids_and_strides as t_grids
from eop_tpu_torch.ops import circle_iou as t_circ
from eop_tpu_torch.ops import polygon as t_poly

# both packages export a function under the name of its module
j_iou = import_module("eop_tpu.losses.iou_loss")
j_l24 = import_module("eop_tpu.losses.loss_24p")
t_l24 = import_module("eop_tpu_torch.losses.loss_24p")

T = torch.from_numpy
M = 50  # label rows per image


def lattice(size):
    hw = [(size // s, size // s) for s in (8, 16, 32)]
    jg, js = j_grids(hw, (8, 16, 32), jnp.float32)
    tg, ts = t_grids(hw, (8, 16, 32))
    np.testing.assert_array_equal(np.asarray(jg), tg.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    return np.array(jg), np.array(js)


def make_labels(rng, batch, size, ngt, num_classes, r_lo=8.0, r_hi=40.0):
    """[B, M, 51] rows (cls, cx, cy, 24 x (x, y)); the first image carries a
    duplicated row, so two GTs tie in cost at every anchor."""
    labels = np.zeros((batch, M, 51), np.float32)
    theta = np.arange(24) * (2 * np.pi / 24)
    for b in range(batch):
        for g in range(ngt):
            cx, cy = rng.uniform(r_hi, size - r_hi, 2)
            r = rng.uniform(r_lo, r_hi, 24)
            labels[b, g, 0] = rng.randint(num_classes)
            labels[b, g, 1:3] = cx, cy
            labels[b, g, 3::2] = cx + r * np.cos(theta)
            labels[b, g, 4::2] = cy + r * np.sin(theta)
    labels[0, ngt] = labels[0, 0]
    return labels


def make_preds(rng, batch, grids, strides, num_classes):
    """decoded [B, A, 27 + C] (cx, cy, radii decoded; obj/cls logits) and the
    raw regression [B, A, 26]."""
    a = grids.shape[0]
    raw = rng.randn(batch, a, 26).astype(np.float32) * 0.5
    raw[..., 2:] += 0.7
    xy = (raw[..., :2] + grids[None]) * strides[None, :, None]
    radii = np.exp(raw[..., 2:]) * strides[None, :, None]
    logits = rng.randn(batch, a, 1 + num_classes).astype(np.float32) * 2.0
    decoded = np.concatenate([xy, radii, logits], -1).astype(np.float32)
    return decoded, raw


# ---------------------------------------------------------------- geometry


def test_polygon_functions_match_jax():
    rng = np.random.RandomState(0)
    labels = make_labels(rng, 2, 128, 4, 3)
    lxy = labels[..., 1:]
    np.testing.assert_allclose(
        t_poly.radii_from_points(T(lxy)).numpy(),
        np.asarray(j_poly.radii_from_points(jnp.asarray(lxy))), atol=1e-5)
    px = rng.uniform(0, 128, 300).astype(np.float32)
    py = rng.uniform(0, 128, 300).astype(np.float32)
    got = t_poly.pts_in_poly_from_labels(T(lxy), T(px), T(py))  # batched
    inside = 0
    for b in range(2):
        want = np.asarray(j_poly.pts_in_poly_from_labels(
            jnp.asarray(lxy[b]), jnp.asarray(px), jnp.asarray(py)))
        np.testing.assert_array_equal(got[b].numpy(), want)
        inside += want[:4].sum()
    assert inside > 20  # the test is not vacuous
    # unbatched call, explicit vertices and another threshold
    want = np.asarray(j_poly.pts_in_poly(
        jnp.asarray(lxy[0, :, 2::2]), jnp.asarray(lxy[0, :, 3::2]),
        jnp.asarray(px), jnp.asarray(py), 300.0))
    got = t_poly.pts_in_poly(T(lxy[0, :, 2::2]), T(lxy[0, :, 3::2]), T(px),
                             T(py), 300.0)
    np.testing.assert_array_equal(got.numpy(), want)


def _circle_cases(rng, n):
    """Radii and distances covering overlap, containment and disjoint
    pairs, with exact boundary cases (dist == r_a + r_b, dist == |r_a -
    r_b|, dist == 0) where the branch precedence shows."""
    r_a = rng.uniform(1, 50, (n, 24)).astype(np.float32)
    r_b = rng.uniform(1, 50, (n, 24)).astype(np.float32)
    dist = rng.uniform(0, 120, (n, 1)).astype(np.float32)
    r_a[0], r_b[0], dist[0] = 8.0, 8.0, 16.0     # touching: disjoint wins
    r_a[1], r_b[1], dist[1] = 10.0, 4.0, 6.0     # internally touching
    r_a[2], r_b[2], dist[2] = 5.0, 5.0, 0.0      # concentric and equal
    return dist, r_a, r_b


def test_circle_functions_match_jax():
    """Areas up to 8e3: 1e-5 relative (+1e-3 absolute for acos/sqrt near the
    clips); GIoU values in [-1, 1]: 1e-5 absolute."""
    rng = np.random.RandomState(1)
    dist, r_a, r_b = _circle_cases(rng, 64)
    np.testing.assert_allclose(
        t_circ.circle_inter(T(dist), T(r_a), T(r_b)).numpy(),
        np.asarray(j_circ.circle_inter(*map(jnp.asarray, (dist, r_a, r_b)))),
        rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(
        t_circ.circle_giou_24(T(dist), T(r_a), T(r_b)).numpy(),
        np.asarray(j_circ.circle_giou_24(
            *map(jnp.asarray, (dist, r_a, r_b)))), atol=1e-5)
    gc = rng.uniform(0, 100, (64, 2)).astype(np.float32)
    pc_ = gc + rng.randn(64, 2).astype(np.float32) * 10
    pc_[3] = gc[3]  # a predicted centre exactly on the GT centre
    np.testing.assert_allclose(
        t_circ.matched_circle_giou_loss(T(gc), T(r_a), T(pc_), T(r_b)).numpy(),
        np.asarray(j_circ.matched_circle_giou_loss(
            *map(jnp.asarray, (gc, r_a, pc_, r_b)))), atol=1e-5)
    for parity in (False, True):
        want = np.asarray(j_circ.pairwise_circle_similarity(
            jnp.asarray(gc[:7]), jnp.asarray(r_a[:7]), jnp.asarray(pc_),
            jnp.asarray(r_b), reference_parity=parity))
        got = t_circ.pairwise_circle_similarity(
            T(gc[:7]), T(r_a[:7]), T(pc_), T(r_b), reference_parity=parity)
        assert got.shape == (7, 64)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(
        t_circ.pairwise_circle_giou_loss(
            T(gc[:7]), T(r_a[:7]), T(pc_), T(r_b)).numpy(),
        np.asarray(j_circ.pairwise_circle_giou_loss(
            jnp.asarray(gc[:7]), jnp.asarray(r_a[:7]), jnp.asarray(pc_),
            jnp.asarray(r_b))), atol=1e-5)


def test_matched_circle_loss_gradient_is_finite_and_matches_jax():
    """The +1e-9 under the root keeps the gradient finite where the centres
    coincide; gradient 1e-4 x its scale."""
    rng = np.random.RandomState(2)
    _, r_a, r_b = _circle_cases(rng, 16)
    gc = rng.uniform(0, 100, (16, 2)).astype(np.float32)
    pc_ = gc + rng.randn(16, 2).astype(np.float32) * 5
    pc_[0] = gc[0]
    want = jax.grad(lambda c, r: j_circ.matched_circle_giou_loss(
        jnp.asarray(gc), jnp.asarray(r_a), c, r).sum(), argnums=(0, 1))(
            jnp.asarray(pc_), jnp.asarray(r_b))
    c, r = T(pc_).requires_grad_(), T(r_b).requires_grad_()
    t_circ.matched_circle_giou_loss(T(gc), T(r_a), c, r).sum().backward()
    for got, ref in ((c.grad, want[0]), (r.grad, want[1])):
        ref = np.asarray(ref)
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=1e-4 * np.abs(ref).max())


def test_bce_with_logits_matches_jax():
    rng = np.random.RandomState(3)
    logits = (rng.randn(40, 7) * 8).astype(np.float32)
    targets = rng.uniform(0, 1, (40, 7)).astype(np.float32)
    np.testing.assert_allclose(
        t_iou.bce_with_logits(T(logits), T(targets)).numpy(),
        np.asarray(j_iou.bce_with_logits(jnp.asarray(logits),
                                         jnp.asarray(targets))),
        atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------ SimOTA pieces


def test_constants_and_config_match_jax():
    assert (t_sim.BIG_COST, t_sim.CENTER_RADIUS, t_sim.MAX_K,
            t_sim.CAND_CAP) == (j_sim.BIG_COST, j_sim.CENTER_RADIUS,
                                j_sim.MAX_K, j_sim.CAND_CAP)
    assert t_sim.SimOTAConfig()._asdict() == j_sim.SimOTAConfig()._asdict()
    tc, jc = t_l24.Loss24PConfig(), j_l24.Loss24PConfig()
    assert tc._asdict().keys() == jc._asdict().keys()
    assert tc[:4] == jc[:4]


@pytest.mark.parametrize("cap", [5, 16, 40])
def test_compact_and_scatter_match_jax(cap):
    rng = np.random.RandomState(4)
    score = rng.randint(0, 4, (3, 40)).astype(np.int32)
    score[1] = 0                      # an image without candidates
    score[2, 10:] = 0
    idx, valid, dropped = t_sim.compact_candidates(T(score), cap)
    fg_k = rng.rand(3, cap) > 0.5
    matched_k = rng.randint(0, 9, (3, cap))
    iou_k = rng.rand(3, cap).astype(np.float32)
    fg, matched, iou = t_sim.scatter_assignment(
        idx, valid, 40, T(fg_k), T(matched_k), T(iou_k))
    for b in range(3):
        j_idx, j_valid, j_drop = j_sim.compact_candidates(
            jnp.asarray(score[b]), cap)
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(j_idx))
        np.testing.assert_array_equal(valid[b].numpy(), np.asarray(j_valid))
        assert int(dropped[b]) == int(j_drop)
        want = j_sim.scatter_assignment(
            j_idx, j_valid, 40, jnp.asarray(fg_k[b]),
            jnp.asarray(matched_k[b], jnp.int32), jnp.asarray(iou_k[b]))
        for got, ref in zip((fg[b], matched[b], iou[b]), want):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_gather_foreground_and_geometry_match_jax():
    """A 0/1 mask is all ties: lax.top_k keeps the lower index first."""
    rng = np.random.RandomState(5)
    a, max_labels, max_k = 60, 4, 5
    fg = rng.rand(2, a) > 0.8
    matched = rng.randint(0, max_labels, (2, a))
    iou = rng.rand(2, a).astype(np.float32)
    j_assign = j_sim.Assignment(jnp.asarray(fg), jnp.asarray(matched, jnp.int32),
                                jnp.asarray(iou), None, None)
    t_assign = t_sim.Assignment(T(fg), T(matched), T(iou), None, None)
    want = j_sim.gather_foreground(j_assign, max_labels, max_k)
    got = t_sim.gather_foreground(t_assign, max_labels, max_k)
    assert got[0].shape == (2, max_labels * max_k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    grids, strides = lattice(32)
    fg_idx = rng.randint(0, grids.shape[0], (2, 6))
    want = j_sim.gather_anchor_geometry(jnp.asarray(grids), jnp.asarray(strides),
                                        jnp.asarray(fg_idx))
    got = t_sim.gather_anchor_geometry(T(grids), T(strides), T(fg_idx))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pairwise_cls_cost_matches_jax():
    """Sums of C log terms of size <= 100: 1e-5 relative; saturated logits
    reach the -100 clamp on both sides."""
    rng = np.random.RandomState(6)
    cls_logits = (rng.randn(2, 30, 5) * 4).astype(np.float32)
    obj_logits = (rng.randn(2, 30) * 4).astype(np.float32)
    cls_logits[0, 0], obj_logits[0, 0] = 200.0, 200.0    # p == 1: log(1-p)
    cls_logits[0, 1] = -200.0                            # p == 0: log(p)
    classes = rng.randint(0, 5, (2, 6)).astype(np.float32)
    got = t_sim.pairwise_cls_cost(T(cls_logits), T(obj_logits), T(classes), 5)
    assert got.shape == (2, 6, 30)
    for b in range(2):
        want = np.asarray(j_sim.pairwise_cls_cost(
            jnp.asarray(cls_logits[b]), jnp.asarray(obj_logits[b]),
            jnp.asarray(classes[b]), 5))
        np.testing.assert_allclose(got[b].numpy(), want, rtol=1e-5, atol=1e-5)
    assert got.max() >= 100.0


def test_topk_small_breaks_ties_like_jax():
    """Values from a set of four: every row is full of ties; the first index
    among equals wins each round."""
    rng = np.random.RandomState(7)
    x = rng.randint(0, 4, (3, 6, 25)).astype(np.float32)
    x[0, 0] = 1.0                                   # a constant row
    vals, idxs = t_sim.topk_small(T(x), 10)
    j_vals, j_idxs = j_sim.topk_small(jnp.asarray(x), 10)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals))
    np.testing.assert_array_equal(idxs.numpy(), np.asarray(j_idxs))
    np.testing.assert_array_equal(
        t_sim.first_argmax(T(x), -1).numpy(), np.argmax(x, -1))
    np.testing.assert_array_equal(
        t_sim.first_argmin(T(x), -2).numpy(), np.argmin(x, -2))


def test_simota_match_with_engineered_ties_matches_jax():
    """Integer costs and similarities: anchors tie within a GT's top-k and
    GTs tie for an anchor (the dedup goes to the first cheapest GT)."""
    rng = np.random.RandomState(8)
    b, m, a = 3, 6, 30
    cost = rng.randint(0, 5, (b, m, a)).astype(np.float32)
    cost[:, 1] = cost[:, 0]                          # two GTs, equal costs
    iou = (rng.randint(0, 4, (b, m, a)) / 4.0).astype(np.float32)
    cand = rng.rand(b, 1, a) > 0.2
    cand = np.broadcast_to(cand, (b, m, a)).copy()
    gt_valid = np.ones((b, m), bool)
    gt_valid[:, -1] = False
    got = t_sim.simota_match(T(cost), T(iou), T(cand), T(gt_valid), 10)
    claimed_twice = 0
    for i in range(b):
        want = j_sim.simota_match(jnp.asarray(cost[i]), jnp.asarray(iou[i]),
                                  jnp.asarray(cand[i]),
                                  jnp.asarray(gt_valid[i]), 10)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))
        claimed_twice += int(np.asarray(want[1]).sum())
    assert claimed_twice > 0


# ------------------------------------------------------- the full assignment


def _assign_inputs(size, batch=2, ngt=5, num_classes=4, seed=9):
    rng = np.random.RandomState(seed)
    grids, strides = lattice(size)
    labels = make_labels(rng, batch, size, ngt, num_classes)
    decoded, raw = make_preds(rng, batch, grids, strides, num_classes)
    return grids, strides, labels, decoded, raw


def _jax_assign(labels, decoded, grids, strides, config):
    lab = jnp.asarray(labels)
    dec = jnp.asarray(decoded)
    return jax.vmap(lambda lxy, gc, gv, pp, ol, cl: j_l24.simota_assign_24p(
        lxy, gc, gv, pp, ol, cl, jnp.asarray(grids), jnp.asarray(strides),
        config))(lab[..., 1:], lab[..., 0], jnp.sum(lab, axis=2) > 0,
                 dec[..., :26], dec[..., 26], dec[..., 27:])


@pytest.mark.parametrize("cap", [0, 1536, 120])
@pytest.mark.parametrize("parity", [False, True])
def test_simota_assign_24p_bit_equal(cap, parity):
    """A = 2100 anchors (a 320 px lattice), so cap 1536 compacts without
    dropping, cap 120 drops, cap 0 is the full lattice: fg_mask and
    matched_gt equal, counts equal, pred_iou 1e-5."""
    grids, strides, labels, decoded, _ = _assign_inputs(320)
    assert grids.shape[0] == 2100
    want = _jax_assign(labels, decoded, grids, strides, j_l24.Loss24PConfig(
        num_classes=4, reference_parity=parity,
        simota=j_sim.SimOTAConfig(cand_cap=cap)))
    lab, dec = T(labels), T(decoded)
    got = t_l24.simota_assign_24p(
        lab[..., 1:], lab[..., 0], lab.sum(dim=2) > 0, dec[..., :26],
        dec[..., 26], dec[..., 27:], T(grids), T(strides),
        t_l24.Loss24PConfig(num_classes=4, reference_parity=parity,
                            simota=t_sim.SimOTAConfig(cand_cap=cap)))
    np.testing.assert_array_equal(got.fg_mask.numpy(), np.asarray(want.fg_mask))
    np.testing.assert_array_equal(got.matched_gt.numpy(),
                                  np.asarray(want.matched_gt))
    np.testing.assert_array_equal(got.num_fg.numpy(), np.asarray(want.num_fg))
    np.testing.assert_array_equal(got.num_gt.numpy(), np.asarray(want.num_gt))
    np.testing.assert_array_equal(got.num_dropped.numpy(),
                                  np.asarray(want.num_dropped))
    np.testing.assert_allclose(got.pred_iou.numpy(), np.asarray(want.pred_iou),
                               atol=1e-5)
    assert int(got.fg_mask.sum()) >= 10
    dropped = int(got.num_dropped.sum())
    assert (dropped > 0) == (cap == 120)


def test_compaction_within_capacity_equals_full_lattice():
    grids, strides, labels, decoded, _ = _assign_inputs(320, seed=10)
    lab, dec = T(labels), T(decoded)
    out = []
    for cap in (0, 1536):
        out.append(t_l24.simota_assign_24p(
            lab[..., 1:], lab[..., 0], lab.sum(dim=2) > 0, dec[..., :26],
            dec[..., 26], dec[..., 27:], T(grids), T(strides),
            t_l24.Loss24PConfig(num_classes=4,
                                simota=t_sim.SimOTAConfig(cand_cap=cap))))
    assert torch.equal(out[0].fg_mask, out[1].fg_mask)
    assert torch.equal(out[0].matched_gt, out[1].matched_gt)


# ------------------------------------------------------------------ the loss


def _loss_both(size, use_l1, parity, cap, seed=11):
    grids, strides, labels, decoded, raw = _assign_inputs(size, seed=seed)
    kw = dict(num_classes=4, use_l1=use_l1, reference_parity=parity)
    jcfg = j_l24.Loss24PConfig(simota=j_sim.SimOTAConfig(cand_cap=cap), **kw)
    tcfg = t_l24.Loss24PConfig(simota=t_sim.SimOTAConfig(cand_cap=cap), **kw)

    def j_loss(dec, reg, dwa):
        return j_l24.loss_24p(dec, reg, jnp.asarray(labels),
                              jnp.asarray(grids), jnp.asarray(strides), dwa,
                              jcfg)

    def t_loss(dec, reg, dwa):
        return t_l24.loss_24p(dec, reg, T(labels), T(grids), T(strides), dwa,
                              tcfg)

    return decoded, raw, j_loss, t_loss


@pytest.mark.parametrize("size,cap,use_l1,parity", [
    (320, 1536, False, False),   # the default path, compacted
    (128, 1536, True, False),    # A = 336 < cap: full lattice, L1 on
    (128, 0, True, True),        # both reference quirks
    (128, 60, False, True),      # overflowing capacity
])
def test_loss_24p_value_and_gradient_match_jax(size, cap, use_l1, parity):
    """Total and every aux entry 1e-5 relative; the gradients w.r.t. the
    decoded predictions and the raw regression 1e-4 x their scale."""
    decoded, raw, j_loss, t_loss = _loss_both(size, use_l1, parity, cap)
    (j_total, (j_aux, j_dwa)), j_grads = jax.value_and_grad(
        lambda d, r: (lambda t, a, s: (t, (a, s)))(
            *j_loss(d, r, j_l24.DWAState.init())),
        argnums=(0, 1), has_aux=True)(jnp.asarray(decoded), jnp.asarray(raw))
    dec, reg = T(decoded).requires_grad_(), T(raw).requires_grad_()
    total, aux, dwa = t_loss(dec, reg, t_l24.DWAState.init())
    total.backward()
    np.testing.assert_allclose(total.item(), float(j_total), rtol=1e-5)
    for name in j_aux._fields:
        np.testing.assert_allclose(
            getattr(aux, name).detach().numpy(),
            np.asarray(getattr(j_aux, name)), rtol=1e-5, atol=1e-6,
            err_msg=name)
    for name in j_dwa._fields:
        np.testing.assert_allclose(getattr(dwa, name).numpy(),
                                   np.asarray(getattr(j_dwa, name)),
                                   rtol=1e-5, atol=1e-6)
    assert float(aux.num_fg_per_gt) > 1.0
    assert (aux.loss_l1.item() > 0) == use_l1
    assert (int(aux.cand_dropped) > 0) == (cap == 60)
    want = np.asarray(j_grads[0])
    np.testing.assert_allclose(dec.grad.numpy(), want,
                               atol=1e-4 * np.abs(want).max(), rtol=0)
    if use_l1:
        want = np.asarray(j_grads[1])
        np.testing.assert_allclose(reg.grad.numpy(), want,
                                   atol=1e-4 * np.abs(want).max(), rtol=0)
    else:
        assert reg.grad is None


def test_dwa_state_over_three_calls_matches_jax():
    """The previous losses travel through an explicit state: three calls on
    changing predictions, weights and state 1e-5 relative at each."""
    decoded, raw, j_loss, t_loss = _loss_both(128, False, False, 0, seed=12)
    rng = np.random.RandomState(13)
    j_dwa, t_dwa = j_l24.DWAState.init(), t_l24.DWAState.init()
    seen = []
    for _ in range(3):
        j_total, j_aux, j_dwa = j_loss(jnp.asarray(decoded), jnp.asarray(raw),
                                       j_dwa)
        total, aux, t_dwa = t_loss(T(decoded), T(raw), t_dwa)
        np.testing.assert_allclose(total.item(), float(j_total), rtol=1e-5)
        for name in ("reg_w", "obj_w", "cls_w"):
            np.testing.assert_allclose(getattr(aux, name).numpy(),
                                       np.asarray(getattr(j_aux, name)),
                                       rtol=1e-5)
        for name in j_dwa._fields:
            np.testing.assert_allclose(getattr(t_dwa, name).numpy(),
                                       np.asarray(getattr(j_dwa, name)),
                                       rtol=1e-5, atol=1e-6)
        w_sum = float(aux.reg_w.sum() + aux.obj_w + aux.cls_w)
        np.testing.assert_allclose(w_sum, 26.0, rtol=1e-5)
        seen.append(aux.obj_w.item())
        decoded = decoded.copy()
        decoded[..., 26:] += rng.randn(*decoded[..., 26:].shape).astype(
            np.float32)
    assert len(set(seen)) == 3   # the weights did move with the state


def test_loss_path_has_no_host_synchronisation_ops():
    """Static shapes on the card mean no nonzero, item, tolist, host copy or
    boolean-mask selection anywhere in the code of the loss path."""
    import ast
    import inspect

    from eop_tpu_torch.ops import circle_iou, polygon
    banned = {"item", "nonzero", "tolist", "masked_select", "cpu", "numpy",
              "argwhere", "unique"}
    for mod in (t_l24, t_sim, t_iou, circle_iou, polygon):
        tree = ast.parse(inspect.getsource(mod))
        used = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
        assert not used & banned, (mod.__name__, used & banned)
