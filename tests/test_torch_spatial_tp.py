"""Spatial and tensor sharding (``--spatial``, ``--tensor``) on the CPU:
ranks over gloo, spawned by ``tests/_torch_dist_child.py``, against
``eop_tpu``'s mesh and against one process.

* a halo'd conv in one process (the exchange stood in for by the whole
  input's rows): each ``(k, stride, padding)`` of ``chip_smoke.JAX_CASES``
  and the folded 6x6/s2 stem, with the height split into 2 and 4 uneven
  shards of whole blocks (also at the 2- and 1-row blocks of the deeper
  levels), ``phase_conv``'s plain version and ``F.conv2d``, values and
  input and weight gradients equal to the whole conv's in float64;
* the rank layout and its faults against ``make_mesh``;
* the two-rank 24p step under ``spatial=2`` and under ``tensor=2``
  against ``eop_tpu``'s ``shard_train_step`` over ``make_mesh(2,
  spatial=2)`` / ``make_mesh(2, tensor=2)``, with
  ``tests/test_torch_parallel.py``'s construction and bounds;
* four ranks of ``spatial=2 x tensor=2`` and of ``data=2 x spatial=2``
  with ``fsdp`` (24p), and ``spatial=2 x tensor=2`` with ``accum=2``
  (bbox), in float64 against the one-process step on the global batch,
  within test_torch_parallel.py's ``TIGHT`` bounds; the ranks' replicated
  state bit-equal;
* inference: ``spatial=2`` detections against ``eop_tpu``'s over
  ``make_mesh(2, spatial=2)`` (rows 1e-4, valid equal), and
  ``shard_inference_tp`` against ``eop_tpu``'s (rtol 2e-4, atol 2e-5);
* the share of state bytes off a rank under ``tensor=2`` within 0.5
  points of ``eop_tpu``'s ``param_specs``; a checkpoint written under
  ``tensor=2`` loading strictly into one process's model;
* the bbox trainer's loader: a data row's ranks draw bit-equal batches;
* YOLOv3 (``Darknet``'s fence) and YOLOX-Nano (depthwise convs) under
  ``spatial=2`` and ``tensor=2``: head maps and input gradient equal to
  one process's in float64.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from eop_tpu.exp.yolox_24p_base import Exp24P as JaxExp24P
from eop_tpu.losses import Loss24PConfig as JLossConfig
from eop_tpu.models import init_model
from eop_tpu.models import YOLOX as JYOLOX
from eop_tpu.models import inference_outputs as j_inference_outputs
from eop_tpu.parallel import make_mesh as j_make_mesh
from eop_tpu.parallel import param_specs
from eop_tpu.parallel import place_state as j_place_state
from eop_tpu.parallel import shard_batch as j_shard_batch
from eop_tpu.parallel import shard_inference_tp as j_shard_inference_tp
from eop_tpu.parallel import shard_train_step as j_shard_train_step
from eop_tpu.train.steps import make_train_step_24p as j_make_step
from eop_tpu_torch.models.yolox import YOLOX
from eop_tpu_torch.ops.blocks import BaseConv, Focus
from eop_tpu_torch.parallel import dist as pdist
from eop_tpu_torch.parallel import spatial
from eop_tpu_torch.parallel.tensor import kept_whole
from eop_tpu_torch.train.checkpoint import load_checkpoint, state_to_payload
from eop_tpu_torch.utils.synth import write_coco_dataset
from eop_tpu_torch.utils.weights import state_dict_from_jax

import chip_smoke
from _torch_dist_child import run_ranks
from test_torch_parallel import (
    TIGHT,
    assert_payloads_close,
    assert_rel_close,
    batches_24p,
    batches_bbox,
    bbox_start,
    one_process,
    port_state_of,
    spec,
)
from test_torch_train_step import (
    CLASSES,
    DEPTH,
    EMA_DECAY,
    N_STEPS,
    WIDTH,
    assert_state_close,
    carried,
    jax_side,
    port_side,
    start_state,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the halo'd conv in one process

# (k, stride, padding, C, Co) of chip_smoke.JAX_CASES; the 6x6/s2 case is
# the folded Focus stem
HALO_CASES = sorted({(k, s, p, c, co)
                     for k, s, p, _, _, c, co in chip_smoke.JAX_CASES})


def halo_module(case, phase_conv):
    k, stride, _, c, co = case
    if k == 6:
        return Focus(c, co, 3, phase_conv=phase_conv,
                     dtype=torch.float64).double().conv
    return BaseConv(c, co, k, stride, phase_conv=phase_conv,
                    dtype=torch.float64).double()


def sharded(module, x, bounds, monkeypatch):
    """``module`` on each shard's rows of ``x`` under a space group whose
    exchange gives the whole input's rows around the shard (zero rows
    outside), the outputs stacked."""
    outs = []
    for start, stop in bounds:
        def exchange(local, above, below, group, start=start, stop=stop):
            assert local.shape[2] == stop - start
            return F.pad(x, (0, 0, above, below))[
                :, :, start:stop + above + below]

        monkeypatch.setattr(spatial, "halo_exchange", exchange)
        module.space = "space"
        outs.append(module(x[:, :, start:stop]))
    module.space = None
    return torch.cat(outs, 2)


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("case", HALO_CASES,
                         ids=[f"k{c[0]}s{c[1]}p{c[2]}" for c in HALO_CASES])
def test_halo_conv_is_the_whole_conv(case, parts, monkeypatch):
    """7 blocks over 2 ranks (4 + 3) and over 4 (2, 2, 2, 1), at the
    16-row blocks of the image and, where the conv sits deeper, the 2- and
    1-row blocks of dark3's and dark4's inputs; eval BatchNorm (per pixel:
    the train statistics are the global BatchNorm's, tested with the
    steps)."""
    k, stride, pad, c, _ = case
    gen = torch.Generator().manual_seed(k * 10 + stride)
    units = [16] + [u for u in (2, 1) if k != 6 and u % stride == 0]
    for phase_conv in (True, False):
        module = halo_module(case, phase_conv).eval()
        with torch.no_grad():
            for prm in module.parameters():
                prm.copy_(torch.randn(prm.shape, generator=gen,
                                      dtype=prm.dtype))
        for unit in units:
            bounds = [(a * unit // 16, b * unit // 16)
                      for a, b in spatial.row_split(16 * 7, parts)]
            x = torch.randn(2, c, 7 * unit, 12, generator=gen,
                            dtype=torch.float64).requires_grad_()
            y = module(x)
            g = torch.randn(y.shape, generator=gen, dtype=torch.float64)
            want = torch.autograd.grad(y, (x, module.conv.weight), g)
            ys = sharded(module, x, bounds, monkeypatch)
            got = torch.autograd.grad(ys, (x, module.conv.weight), g)
            what = f"{case} phase_conv={phase_conv} unit={unit}"
            torch.testing.assert_close(ys, y, rtol=1e-12, atol=1e-12,
                                       msg=what)
            for a, b, name in zip(got, want, ("dx", "dw")):
                torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12,
                                           msg=f"{what}: {name}")
            with torch.no_grad():   # the fused eval epilogue
                torch.testing.assert_close(
                    sharded(module, x, bounds, monkeypatch), module(x),
                    rtol=1e-12, atol=1e-12, msg=f"{what}: fused")


def test_row_split_and_halo_rows():
    assert [(b - a) // 16 for a, b in spatial.row_split(416, 4)] == [
        7, 7, 6, 6]
    assert spatial.row_split(64, 2) == [(0, 32), (32, 64)]
    for bad in ((40, 2), (32, 3)):
        with pytest.raises(ValueError):
            spatial.row_split(*bad)
    assert spatial.halo_rows(3, 1, 1) == (1, 1)
    assert spatial.halo_rows(3, 2, 1) == (2, 0)
    assert spatial.halo_rows(6, 2, 2) == (2, 2)
    assert spatial.halo_rows(1, 1, 0) == (0, 0)


def test_rank_layout_is_make_mesh_and_its_faults():
    """Rank ``(d, s, t)`` is the device at ``make_mesh``'s grid position
    ``[d, s, t]``; the split and host faults raise with ``make_mesh``'s
    messages; without a process group ``spatial=2`` does not split."""
    from types import SimpleNamespace

    mesh = j_make_mesh(8, spatial=2, tensor=2)
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    first = min(d.id for d in jax.devices()[:8])
    for r in range(8):
        assert ids[r // 4, r // 2 % 2, r % 2] - first == r
    hosts = [0, 1, 0, 1]
    fake = [SimpleNamespace(process_index=h) for h in hosts]
    for ours, theirs in (
            (lambda: pdist.check_layout(4, 2, 1, hosts),
             lambda: j_make_mesh(devices=fake, spatial=2)),
            (lambda: pdist.check_layout(3, 2, 1),
             lambda: j_make_mesh(devices=fake[:3], spatial=2))):
        with pytest.raises(ValueError) as want:
            theirs()
        with pytest.raises(ValueError) as got:
            ours()
        key = ("must not cross hosts" if "cross" in str(want.value)
               else "do not split")
        assert key in str(got.value) and key in str(want.value)
    pdist.check_layout(4, 2, 1, [0, 0, 1, 1])
    with pytest.raises(ValueError, match="1 devices do not split"):
        pdist.make_mesh(spatial=2)
    assert pdist.make_mesh() == pdist.Mesh()


def test_kept_whole_convs():
    """No ``phase_conv`` conv of 24p-s keeps whole at ``tensor=2`` or 4;
    YOLOX-Tiny's 24- and 12-channel early convs do at 2 (their slices of
    12 and 6 channels would take ``direct``), YOLOX-M's 48-channel stem
    at 4."""
    from eop_tpu_torch.exp import get_exp

    def model(name):
        return get_exp(exp_name=name).get_model("cpu")

    pre = "backbone.backbone."
    assert kept_whole(model("yolox_24p_s"), 2) == []
    assert kept_whole(model("yolox_24p_s"), 4) == []
    assert kept_whole(model("yolox-tiny"), 2) == [
        pre + n for n in ("stem.conv", "dark2.1.conv1", "dark2.1.conv2",
                          "dark2.1.m.0.conv1", "dark2.1.m.0.conv2")]
    assert pre + "stem.conv" in kept_whole(model("yolox-m"), 4)


# ---------------------------------------------------------------------------
# the ranks

INFER_SIZE, INFER_BATCH = 128, 8


def jax_infer(tmp):
    """eop_tpu's spatial (make_mesh(2, spatial=2), get_sharded_infer_fn)
    and tensor-parallel (shard_inference_tp over make_mesh(2, tensor=2))
    inference, as tests/test_spatial.py and tests/test_fsdp_tp.py run
    them, and the port's specs for the same weights and images."""
    jexp = JaxExp24P()
    jexp.num_classes = 4
    jexp.depth, jexp.width = 0.33, 0.25
    jexp.test_size = (INFER_SIZE, INFER_SIZE)
    jexp.test_conf = 1e-4
    jmodel = jexp.get_model()
    variables = init_model(jmodel, jax.random.PRNGKey(0),
                           jnp.zeros((1, INFER_SIZE, INFER_SIZE, 3)))
    imgs = (np.random.RandomState(3).rand(INFER_BATCH, INFER_SIZE,
                                          INFER_SIZE, 3)
            * 255).astype(np.float32)
    mesh = j_make_mesh(2, spatial=2)
    with mesh:
        s2 = jax.device_get(jexp.get_sharded_infer_fn(jmodel, variables, mesh)(
            j_shard_batch(mesh, imgs)))

    bbox = JYOLOX(depth=0.33, width=0.25, num_classes=4)
    bvars = init_model(bbox, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    bimgs = np.random.RandomState(1).rand(8, 64, 64, 3).astype(np.float32)

    def body(v, x):
        head_outs, _ = bbox.apply(v, x, False)
        return j_inference_outputs(head_outs)

    mesh = j_make_mesh(2, tensor=2)
    with mesh:
        t2 = np.asarray(jax.device_get(
            j_shard_inference_tp(body, bvars, mesh)(bimgs)))
    opts = ["num_classes", "4", "depth", "0.33", "width", "0.25",
            "test_size", f"({INFER_SIZE},{INFER_SIZE})", "test_conf", "1e-4"]
    specs = {
        "infer_s2": dict(kind="exp", exp_name="yolox_24p_s", opts=opts,
                         spatial=2, imgs=torch.from_numpy(imgs),
                         weights=state_dict_from_jax(variables)),
        "infer_t2": dict(kind="tp", tensor=2, imgs=torch.from_numpy(bimgs),
                         model=dict(depth=0.33, width=0.25, num_classes=4),
                         weights=state_dict_from_jax(bvars)),
    }
    return {"s2": s2, "t2": t2}, specs


def jax_bytes_share(jstate):
    """The share of the 24p state's bytes ``eop_tpu``'s ``place_state``
    holds off a device of ``make_mesh(2, tensor=2)`` (its formula)."""
    mesh = j_make_mesh(2, tensor=2)
    leaves = jax.tree_util.tree_leaves(jstate)
    specs = jax.tree_util.tree_leaves(param_specs(jstate, mesh))
    total = off = 0.0
    for leaf, sh in zip(leaves, specs):
        nbytes = float(np.prod(np.shape(leaf) or (1,))) * np.dtype(
            leaf.dtype).itemsize
        total += nbytes
        if any(ax is not None for ax in sh.spec):
            off += nbytes / 2
    return off / total


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """eop_tpu's spatial and tensor steps and inference, two ranks of each,
    four ranks of each composition, and the one-process steps."""
    tmp = tmp_path_factory.mktemp("spatial_tp")
    jmodel, tx = jax_side()
    cfg = JLossConfig(num_classes=CLASSES)
    data = batches_24p(1 + N_STEPS)
    meshes = {"s2": j_make_mesh(2, spatial=2), "t2": j_make_mesh(2, tensor=2)}
    jstep = j_make_step(jmodel, tx, cfg, ema_decay=EMA_DECAY)

    def jrun(name, jstate, batches):
        mesh = meshes[name]
        template = jax.device_get(jstate)
        step = j_shard_train_step(jstep, mesh, state=template)
        ms = []
        with mesh:
            jstate = j_place_state(template, mesh)
            for i, (imgs, labels) in enumerate(batches):
                sb = j_shard_batch(mesh, {"i": imgs, "l": labels})
                jstate, m = step(jstate, sb["i"], sb["l"],
                                 jax.random.PRNGKey(i))
                ms.append(jax.device_get(m))
        return jax.device_get(jstate), ms

    jstart, _ = jrun("s2", start_state(jmodel, tx), data[:1])
    start = state_to_payload(port_side(carried(jstart)))
    jax_out, infer = jax_infer(tmp)
    two = {"s2": spec("24p", start, data[1:], spatial=2),
           "t2": spec("24p", start, data[1:], tensor=2,
                      ckpt_dir=str(tmp / "t2_ckpt"))}
    four = {
        "s2t2_64": spec("24p", start, data[1:], float64=True, spatial=2,
                        tensor=2),
        "d2s2_fsdp_64": spec("24p", start, data[1:], float64=True,
                             spatial=2, fsdp=True),
        "bbox_s2t2_64": spec("bbox", bbox_start(), batches_bbox(N_STEPS),
                             accum=2, float64=True, spatial=2, tensor=2),
    }
    coco = write_coco_dataset(str(tmp / "coco"), 6, 1, (64, 64),
                              num_classes=3, seed=2)
    loader = dict(spatial=2, tensor=1, batch=4,
                  opts=["num_classes", "3", "input_size", "(64,64)",
                        "data_num_workers", "1", "data_dir", coco])
    ranks2 = run_ranks("steps", {"runs": two, "infer": infer}, str(tmp))
    ranks4 = run_ranks("steps", {"runs": four, "loader": loader}, str(tmp),
                       world=4, timeout=300)
    return dict(
        jstart=jstart, jax={k: jrun(k, jstart, data[1:]) for k in meshes},
        jax_infer=jax_out, two=two, four=four, ranks2=ranks2, ranks4=ranks4,
        one={k: one_process(four[k]) for k in four}, tmp=tmp,
        jax_bytes=jax_bytes_share(jstart))


@pytest.mark.parametrize("name", ["s2", "t2"])
def test_two_ranks_match_eop_tpu_sharded_step(runs, name):
    """Per-step loss 1e-4 relative, num_fg equal, every metric 1e-3; the
    state after the steps within test_torch_train_step.py's bounds."""
    jstate, jms = runs["jax"][name]
    for rank in runs["ranks2"]:
        for i, (tm, jm) in enumerate(zip(rank[name]["metrics"], jms)):
            assert set(tm) == set(jm)
            np.testing.assert_allclose(tm["total_loss"].item(),
                                       float(jm["total_loss"]), rtol=1e-4)
            assert tm["num_fg"].item() == float(jm["num_fg"])
            for k in jm:
                np.testing.assert_allclose(
                    tm[k].float().numpy(), np.asarray(jm[k], np.float32),
                    rtol=1e-3, atol=1e-5, err_msg=f"step {i}: {k}")
    tstate = port_state_of(runs["ranks2"][0][name]["state"], runs["jstart"])
    assert_state_close(tstate, jstate, runs["jstart"], f"two ranks, {name}")


@pytest.mark.parametrize("name", ["s2t2_64", "d2s2_fsdp_64", "bbox_s2t2_64"])
def test_four_ranks_match_one_process_on_the_global_batch(runs, name):
    tight = TIGHT["bbox_64" if name.startswith("bbox") else "a1_64"]
    metrics, payload = runs["one"][name]
    for r in runs["ranks4"]:
        for i, (tm, om) in enumerate(zip(r[name]["metrics"], metrics)):
            assert tm["num_fg"].item() == om["num_fg"].item(), i
            for k, v in om.items():
                assert_rel_close(tm[k], v, tight, f"{name} step {i}: {k}")
        assert_payloads_close(r[name]["state"], payload,
                              runs["four"][name]["start"], name, tight)


def test_ranks_hold_bit_equal_state(runs):
    """Every rank's gathered state and metrics are the same bits, and each
    rank held its place of the layout."""
    for ranks, specs in ((runs["ranks2"], runs["two"]),
                         (runs["ranks4"], runs["four"])):
        for name in specs:
            a = ranks[0][name]
            for b in (r[name] for r in ranks[1:]):
                for part in ("model", "ema_params", "ema_batch_stats"):
                    for k, v in a["state"][part].items():
                        assert torch.equal(v, b["state"][part][k]), (
                            name, part, k)
                for i, s in a["state"]["optimizer"]["state"].items():
                    assert torch.equal(
                        s["momentum_buffer"],
                        b["state"]["optimizer"]["state"][i]["momentum_buffer"])
                for m0, m1 in zip(a["metrics"], b["metrics"]):
                    assert all(torch.equal(m0[k], m1[k]) for k in m0), name
    assert [r["s2t2_64"]["coords"] for r in runs["ranks4"]] == [
        (0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1)]
    assert [r["d2s2_fsdp_64"]["coords"] for r in runs["ranks4"]] == [
        (0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)]


def test_spatial_inference_matches_eop_tpu(runs):
    """eop_tpu's bounds (tests/test_spatial.py): rows 1e-4, valid equal."""
    want = runs["jax_infer"]["s2"]
    for r in runs["ranks2"]:
        got = r["infer_s2"]
        np.testing.assert_array_equal(got.valid.numpy(),
                                      np.asarray(want.valid))
        np.testing.assert_allclose(got.rows.numpy(), np.asarray(want.rows),
                                   rtol=1e-4, atol=1e-4)
        assert got.valid.sum() > 0


def test_tensor_parallel_inference_matches_eop_tpu(runs):
    """eop_tpu's bounds (tests/test_fsdp_tp.py): rtol 2e-4, atol 2e-5."""
    for r in runs["ranks2"]:
        np.testing.assert_allclose(r["infer_t2"].numpy(),
                                   runs["jax_infer"]["t2"], rtol=2e-4,
                                   atol=2e-5)


def test_tensor_state_bytes_and_checkpoint(runs):
    """The share off a rank within 0.5 points of eop_tpu's; rank 0's
    checkpoint holds the whole state and loads strictly into one
    process's model."""
    for r in runs["ranks2"]:
        local, total = r["t2"]["bytes_placed"]
        share = 1.0 - local / total
        assert abs(share - runs["jax_bytes"]) <= 0.005, (share,
                                                          runs["jax_bytes"])
        assert 0.3 < share < 0.5
    ckpt = load_checkpoint(str(runs["tmp"] / "t2_ckpt" / "t2_ckpt.pth"))
    model = YOLOX(depth=DEPTH, width=WIDTH, num_classes=CLASSES, reg_dim=26)
    model.load_state_dict(ckpt["state"]["model"], strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, runs["ranks2"][0]["t2"]["state"]["model"][k])


def test_a_data_rows_ranks_draw_equal_batches(runs):
    """The mosaic loader keyed by the data rank and one shared seed: the
    two space ranks of a data row draw the same bits, the data rows
    differ."""
    by_row = {}
    for r in runs["ranks4"]:
        d, s, _ = r["loader"]["coords"]
        by_row.setdefault(d, []).append(r["loader"]["batches"])
    assert len(by_row) == 2
    for rows in by_row.values():
        a, b = rows
        for (ia, la), (ib, lb) in zip(a, b):
            assert torch.equal(torch.as_tensor(ia), torch.as_tensor(ib))
            assert torch.equal(torch.as_tensor(la), torch.as_tensor(lb))
    assert not torch.equal(torch.as_tensor(by_row[0][0][0][0]),
                           torch.as_tensor(by_row[1][0][0][0]))


ZOO = ("yolov3", "yolox-nano")


@pytest.fixture(scope="module")
def zoo_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial_tp_zoo")
    opts = ["num_classes", "3"]
    imgs = torch.rand(2, 3, 64, 64,
                      generator=torch.Generator().manual_seed(1)) * 255
    ranks = run_ranks("zoo", {"models": ZOO, "opts": opts, "imgs": imgs},
                      str(tmp))
    from eop_tpu_torch.exp import get_exp
    from _torch_dist_child import to_float64

    one = {}
    for name in ZOO:
        exp = get_exp(exp_name=name)
        exp.merge(opts)
        model = to_float64(exp.get_model("cpu", seed=0)).eval()
        x = imgs.double().requires_grad_()
        maps = model(x)[0]
        (dx,) = torch.autograd.grad(sum(m.square().sum() for m in maps), x)
        one[name] = {"maps": [m.detach() for m in maps], "dx": dx}
    return ranks, one


@pytest.mark.parametrize("layout", ["spatial", "tensor"])
@pytest.mark.parametrize("name", ZOO)
def test_zoo_models_match_one_process_in_float64(zoo_runs, name, layout):
    ranks, one = zoo_runs
    for r in ranks:
        got = r[name, layout]
        for a, b in zip(got["maps"], one[name]["maps"]):
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
        scale = float(one[name]["dx"].abs().max())
        torch.testing.assert_close(got["dx"], one[name]["dx"], rtol=1e-12,
                                   atol=1e-12 * scale)
