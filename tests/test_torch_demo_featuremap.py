"""The feature-map study end to end: ``python -m
eop_tpu_torch.tools.demo_featuremap`` against ``tools/demo_featuremap.py``
on one synthesized fixture (``utils/synth.write_featuremap_fixture``), a
YOLOX-S-named exp at depth 0.33 / width 0.25 over the ResNet50 backbone,
64 px, the sweeps ``none`` and theta 30, 60, 90, the JAX demo's own
``PRNGKey(0)`` weights (as its ``init_model`` returns them) carried into a
port checkpoint (``-c``).

The port runs on the CPU with cv2, matplotlib, seaborn and tabulate made
unimportable.  Held: every sweep's ``gt.json`` equal, its ``dt.json`` boxes
and scores within 1e-4 (boxes of the image's size), the AP summaries equal
as printed and the COCO stats within 1e-6, the activation table within
1e-5 relative, and every output file written."""

import importlib.util
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEPS = ("none", "theta_30", "theta_60", "theta_90")
ARGS = ["-n", "yolox-s", "--backbone", "resnet", "--tsize", "64",
        "--theta-range", "30,95,30", "--conf", "0.003"]
OPTS = ["depth", "0.33", "width", "0.25"]
BLOCKED = ("cv2", "matplotlib", "seaborn", "tabulate")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_demo_module():
    spec = importlib.util.spec_from_file_location(
        "_jax_demo_featuremap", os.path.join(ROOT, "tools",
                                             "demo_featuremap.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_checkpoint(variables, path):
    """The JAX demo's variables as a port checkpoint."""
    import jax

    from eop_tpu_torch.utils.weights import state_dict_from_jax

    tree = jax.tree_util.tree_map(np.asarray, dict(variables))
    torch.save({"state": {"model": state_dict_from_jax(tree)}}, path)


def ap_lines(text):
    return re.findall(r"Average (?:Precision|Recall).*= *(-?[0-9.]+)", text)


def table_values(text):
    tail = text[text.index("===== Feature Map Size"):]
    return [float(v) for v in re.findall(r"(-?[0-9]+\.[0-9]+|nan)(?= *\|)",
                                         tail)]


def read_json(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both demos on one fixture: (JAX output dir, its stdout, port output
    dir, its stdout).  The JAX demo's heatmap figures are not drawn
    (``seaborn.heatmap`` and ``Figure.savefig`` do nothing while it runs:
    no test reads them, and drawing them took most of its time); the
    variables its ``init_model`` returns are the port's checkpoint."""
    import matplotlib.figure
    import seaborn

    import eop_tpu.models as jmodels
    from eop_tpu_torch.utils.synth import write_featuremap_fixture

    root = tmp_path_factory.mktemp("demo_featuremap")
    fixture = write_featuremap_fixture(str(root / "fixture"), (240, 320))

    capture = pytest.MonkeyPatch()
    import io
    from contextlib import redirect_stdout

    made = []
    init_model = jmodels.init_model

    def recording_init(*args, **kwargs):
        made.append(init_model(*args, **kwargs))
        return made[-1]

    capture.setattr(jmodels, "init_model", recording_init)
    capture.setattr(seaborn, "heatmap", lambda *args, **kwargs: None)
    capture.setattr(matplotlib.figure.Figure, "savefig",
                    lambda *args, **kwargs: None)
    jax_out = str(root / "jax")
    buf = io.StringIO()
    capture.setattr(sys, "argv", ["demo_featuremap.py", *ARGS, "--json",
                                  fixture, *OPTS, "output_dir", jax_out])
    try:
        with redirect_stdout(buf):
            jax_demo_module().main()
    finally:
        capture.undo()
    jax_text = buf.getvalue()
    assert len(made) == 1
    ckpt = str(root / "jax_init.pth")
    port_checkpoint(made[0], ckpt)

    from eop_tpu_torch.tools import demo_featuremap

    port_out = str(root / "port")
    buf = io.StringIO()
    for name in BLOCKED:
        capture.setitem(sys.modules, name, None)
    try:
        with redirect_stdout(buf):
            demo_featuremap.main([*ARGS, "--json", fixture, "-c", ckpt,
                                  "--device", "cpu", *OPTS, "output_dir",
                                  port_out])
    finally:
        capture.undo()
    return jax_out, jax_text, port_out, buf.getvalue()


def test_gt_json_equal_and_outputs_written(runs):
    jax_out, _, port_out, _ = runs
    for sweep in SWEEPS:
        want = read_json(os.path.join(jax_out, "new_data", sweep, "gt.json"))
        got = read_json(os.path.join(port_out, "new_data", sweep, "gt.json"))
        assert got == want, sweep
        names = sorted(os.listdir(os.path.join(port_out, "new_data", sweep)))
        assert names == sorted(os.listdir(os.path.join(
            jax_out, "new_data", sweep))), sweep
        vis = os.listdir(os.path.join(port_out, "yolox_s_resnet", "vis_res",
                                      sweep))
        assert len([n for n in vis if n.endswith("_fm.png")]) == 5, sweep
        assert len(vis) == 10, sweep
        assert os.path.exists(os.path.join(port_out, "yolox_s_resnet",
                                           "dt_json", sweep, "dt.json"))


def test_dt_json_within_1e4(runs):
    """Every sweep's detections: the same images, classes and count; boxes
    within 1e-4 of the image's longer side (the 64 px frame's fp32 noise,
    1e-6 of it, grows by the inverse letterbox ratio, up to 22 on the
    1,400 px wide theta-90 images), scores within 1e-4; some sweep has
    some."""
    jax_out, _, port_out, _ = runs
    total = 0
    for sweep in SWEEPS:
        rel = os.path.join("yolox_s_resnet", "dt_json", sweep, "dt.json")
        want, got = (read_json(os.path.join(d, rel))
                     for d in (jax_out, port_out))
        side = {im["id"]: max(im["height"], im["width"]) for im in read_json(
            os.path.join(jax_out, "new_data", sweep, "gt.json"))["images"]}
        assert len(got) == len(want), sweep
        total += len(got)
        for g, w in zip(got, want):
            assert (g["image_id"], g["category_id"]) == (
                w["image_id"], w["category_id"]), sweep
            np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0,
                                       atol=1e-4 * side[w["image_id"]],
                                       err_msg=sweep)
            np.testing.assert_allclose(g["score"], w["score"], rtol=1e-4,
                                       atol=1e-6, err_msg=sweep)
    assert total > 0


def test_ap_lines_and_table_match(runs):
    """Four AP summaries equal as printed; the activation table within
    1e-5 relative (NaN where the GT box leaves a map)."""
    _, jax_text, _, port_text = runs
    for sweep in SWEEPS:
        assert f"{'*' * 24}{sweep}{'*' * 24}" in port_text
    want, got = ap_lines(jax_text), ap_lines(port_text)
    assert len(want) == 4 * 12 and got == want
    want, got = table_values(jax_text), table_values(port_text)
    assert len(got) == len(want) == 3 * 4 * 5
    np.testing.assert_allclose(got, want, rtol=1e-5, equal_nan=True)
    assert np.isfinite(got).sum() > 10
    assert "Model Summary: Params:" in port_text


def test_ap_stats_within_1e6(runs):
    """Each sweep's 12 COCO stats: the port's coco_ap on its dt.json
    against eop_tpu's on the JAX demo's, within 1e-6."""
    from eop_tpu.tools.featuremap import coco_ap as j_coco_ap
    from eop_tpu_torch.tools.featuremap import coco_ap

    jax_out, _, port_out, _ = runs
    for sweep in SWEEPS:
        gt = os.path.join(jax_out, "new_data", sweep, "gt.json")
        rel = os.path.join("yolox_s_resnet", "dt_json", sweep, "dt.json")
        want = j_coco_ap(gt, os.path.join(jax_out, rel))
        got = coco_ap(gt, os.path.join(port_out, rel))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                   err_msg=sweep)


def test_missing_fixture_raises_naming_it(tmp_path):
    from eop_tpu_torch.tools import demo_featuremap

    with pytest.raises(FileNotFoundError,
                       match=re.escape(demo_featuremap.DEFAULT_FIXTURE)):
        demo_featuremap.main(["--device", "cpu"])
    assert demo_featuremap.make_parser().parse_args([]).json == (
        jax_demo_module().DEFAULT_FIXTURE)
