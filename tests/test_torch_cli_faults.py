"""The command-line faults a user of ``eop_tpu`` meets first, repaired and
held here on the CPU:

* the reference's checkpoint form ``{"model": state_dict, "optimizer":
  ..., "start_epoch": ...}`` (which ``eop_tpu/utils/torch_import.py``
  unwraps) loads strictly through ``eval -c``, ``serve -w`` (the service
  built), ``demo_featuremap -c`` and ``show_24p -w``; a file of neither
  form still raises ``load_state_dict``'s error;
* ``train`` and ``train_24p`` parse ``eop_tpu``'s ``--no-prewarm`` (it does
  nothing) and its parallel and profiling flags: ``--profile-port`` raises
  the named ``NotImplementedError`` and, in one process, ``--spatial 2``
  and ``--tensor 2`` raise ``make_mesh``'s "do not split" ``ValueError``,
  before any data is read; the others work;
* ``serve --batch`` defaults to 16, as ``eop_tpu``'s ``tools/serve.py``.
"""

import os

import numpy as np
import pytest
import torch

from _torch_dist_child import free_port

from eop_tpu_torch.exp import get_exp
from eop_tpu_torch.tools import demo_featuremap, serve, show_24p
from eop_tpu_torch.tools import eval as eval_cli
from eop_tpu_torch.tools import train as train_cli
from eop_tpu_torch.tools import train_24p as train_24p_cli
from eop_tpu_torch.tools.eval import eval_weights
from eop_tpu_torch.utils.synth import (
    write_coco_dataset,
    write_24p_dataset,
    write_featuremap_fixture,
    write_png,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_24P = ["depth", "0.33", "width", "0.125", "num_classes", "3",
            "test_size", "(64, 64)"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_pth(state_dict, path):
    """``state_dict`` saved as the reference's training checkpoint."""
    torch.save({"model": state_dict, "optimizer": {"state": {}},
                "start_epoch": 3}, path)
    return str(path)


@pytest.fixture(scope="module")
def tiny_24p(tmp_path_factory):
    """A tiny 24p model of seed 1 (not the factories' seed 0), its weights
    in the reference's form, and a file of neither form."""
    root = tmp_path_factory.mktemp("faults24p")
    exp = get_exp(exp_name="yolox_24p_s")
    exp.merge(TINY_24P)
    model = exp.get_model("cpu", seed=1)
    sd = model.state_dict()
    bad = root / "bad.pth"
    torch.save({"weights": sd}, bad)
    return exp, sd, reference_pth(sd, root / "ref.pth"), str(bad)


def same_weights(model, sd):
    got = model.state_dict()
    return got.keys() == sd.keys() and all(
        torch.equal(got[k], sd[k]) for k in sd)


def test_eval_weights_unwraps_each_form(tiny_24p, tmp_path):
    _, sd, ref, bad = tiny_24p
    assert eval_weights(ref).keys() == sd.keys()
    bare = tmp_path / "bare.pth"
    torch.save(sd, bare)
    assert eval_weights(str(bare)).keys() == sd.keys()
    port = tmp_path / "port.pth"
    ema = {k: v + 1 for k, v in sd.items() if k.endswith("weight")}
    torch.save({"state": {"model": sd, "ema_params": ema}}, port)
    got = eval_weights(str(port))
    assert all(torch.equal(got[k], ema[k]) for k in ema)
    assert eval_weights(bad).keys() == {"weights"}


def test_eval_c_loads_the_reference_form(tiny_24p, tmp_path, monkeypatch):
    exp, sd, ref, bad = tiny_24p
    img_dir, lab_dir = write_24p_dataset(str(tmp_path / "d"), 2, (64, 64),
                                         seed=2)
    loaded = {}
    argv = ["-n", "yolox_24p_s", "-b", "2", "--data-dir", img_dir,
            "--label-dir", lab_dir, "--device", "cpu", *TINY_24P,
            "data_num_workers", "0"]
    real_eval = type(exp).eval

    def capture(self, model, evaluator, **k):
        loaded["same"] = same_weights(model, sd)
        return real_eval(self, model, evaluator, **k)

    monkeypatch.setattr(type(exp), "eval", capture)
    ap50_95, ap50 = eval_cli.main(["-c", ref, *argv])
    assert loaded["same"] and 0.0 <= ap50 <= 1.0
    with pytest.raises(RuntimeError, match="Missing key"):
        eval_cli.main(["-c", bad, *argv])


def test_serve_w_builds_from_the_reference_form(tiny_24p):
    _, sd, ref, bad = tiny_24p
    argv = ["--device", "cpu", "--batch", "2", *TINY_24P]
    svc = serve.build_service(serve.make_parser().parse_args(
        ["-w", ref, *argv]))
    try:
        assert svc.batch == 2
    finally:
        svc.close()
    with pytest.raises(RuntimeError, match="Missing key"):
        serve.build_service(serve.make_parser().parse_args(
            ["-w", bad, *argv]))


class _Loaded(Exception):
    pass


def test_demo_featuremap_c_loads_the_reference_form(tmp_path, monkeypatch):
    exp = get_exp(exp_name="yolox-s")
    exp.merge(["depth", "0.33", "width", "0.125"])
    sd = exp.get_model("cpu", seed=1).state_dict()
    ref = reference_pth(sd, tmp_path / "ref.pth")
    fixture = write_featuremap_fixture(str(tmp_path / "fx"), (64, 96))
    seen = {}

    def stop(model, *a, **k):
        seen["same"] = same_weights(model, sd)
        raise _Loaded

    monkeypatch.setattr(demo_featuremap, "Predictor", stop)
    with pytest.raises(_Loaded):
        demo_featuremap.main(["-n", "yolox-s", "-c", ref, "--json", fixture,
                              "--tsize", "64", "--device", "cpu", "depth",
                              "0.33", "width", "0.125", "output_dir",
                              str(tmp_path / "out")])
    assert seen["same"]


def test_show_24p_w_loads_the_reference_form(tiny_24p, tmp_path):
    _, sd, ref, bad = tiny_24p
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    write_png(str(img_dir / "a.png"),
              np.random.RandomState(0).randint(0, 256, (48, 80, 3),
                                               np.uint8))
    argv = ["-n", "yolox_24p_s", "-p", str(img_dir), "--device", "cpu",
            *TINY_24P, "output_dir", str(tmp_path / "out")]
    ev = show_24p.main(["-w", ref, *argv])
    assert same_weights(ev.load_model(), sd)
    assert [r["file"] for r in ev.results] == ["a.png"]
    with pytest.raises(RuntimeError, match="Missing key"):
        show_24p.main(["-w", bad, *argv])


def test_no_prewarm_parses_in_both_train_command_lines():
    args = train_cli.make_parser().parse_args(
        ["-n", "yolox-s", "--no-prewarm", "max_epoch", "1"])
    assert args.prewarm is False and args.opts == ["max_epoch", "1"]
    assert train_cli.make_parser().parse_args(["-n", "yolox-s"]).prewarm
    args = train_24p_cli.make_parser().parse_args(["--no-prewarm"])
    assert args.prewarm is False


UNPORTED = [("--spatial", "2"), ("--tensor", "2"), ("--fsdp",),
            ("--profile-port", "9012"), ("--multi-host",),
            ("--coordinator", "127.0.0.1:5555"), ("--num-processes", "2"),
            ("--process-id", "1"), ("--platform", "cpu")]
TINY_TRAIN = ["depth", "0.33", "width", "0.125", "num_classes", "3",
              "input_size", "(64,64)", "test_size", "(64,64)",
              "data_num_workers", "0", "max_epoch", "1"]


@pytest.fixture(scope="module")
def train_data(tmp_path_factory):
    """Two training images for each family (one step of B=2)."""
    root = tmp_path_factory.mktemp("trainflags")
    coco = write_coco_dataset(str(root / "coco"), 2, 2, (64, 64),
                              num_classes=3, seed=2)
    return coco, write_24p_dataset(str(root / "d24p"), 2, (64, 64), seed=4)


def _strict_load(cli, out):
    """The run's checkpoint loads strictly into the exp's model."""
    exp = (get_exp(exp_name="yolox-s") if cli == "train"
           else get_exp("load_train/yolox_24p_train.py"))
    exp.merge(TINY_TRAIN[:10])
    found = [os.path.join(d, f) for d, _, fs in os.walk(out) for f in fs
             if f.endswith("_ckpt.pth")]
    assert found
    model = exp.get_model("cpu")
    model.load_state_dict(eval_weights(found[0]), strict=True)


@pytest.mark.parametrize("flag", UNPORTED, ids=[f[0] for f in UNPORTED])
@pytest.mark.parametrize("cli", ["train", "train_24p"])
def test_parallel_flags_raise_by_name(cli, flag, tmp_path, train_data):
    """Each flag parses with ``eop_tpu``'s default.  ``--profile-port``
    raises ``NotImplementedError`` naming itself and its ROADMAP item, and
    ``--spatial 2`` / ``--tensor 2`` raise ``make_mesh``'s ``ValueError``
    (one process does not split into two space or model ranks, as one
    device does not in ``eop_tpu``), before any data is read (the data
    directories do not exist).  The others work: ``--coordinator``,
    ``--num-processes`` and ``--process-id`` without ``--multi-host`` stop
    before any data is read, naming it; ``--fsdp`` (no group: it warns that
    it shards nothing), ``--multi-host`` (a group of one over gloo,
    destroyed at the end) and ``--platform cpu`` (no ``--device``) each
    train one step whose checkpoint loads strictly, and ``--platform tpu``
    raises."""
    missing = str(tmp_path / "missing")
    coco, (img_dir, lab_dir) = train_data
    if cli == "train":
        parser, main = train_cli.make_parser(), train_cli.main
        argv = ["-n", "yolox-s", "--data-dir", missing]
        real = ["-n", "yolox-s", "-b", "2", "--data-dir", coco]
        opts = TINY_TRAIN + ["no_aug_epochs", "0", "multiscale_range", "0"]
    else:
        parser, main = train_24p_cli.make_parser(), train_24p_cli.main
        argv = ["--data-dir", missing, "--label-dir", missing]
        real = ["-b", "2", "--data-dir", img_dir, "--label-dir", lab_dir]
        opts = TINY_TRAIN
    name = flag[0][2:].replace("-", "_")
    default = getattr(parser.parse_args(argv), name)
    assert default == {"spatial": 1, "tensor": 1, "fsdp": False,
                       "multi_host": False}.get(name)
    out = str(tmp_path / "out")
    if name == "profile_port":
        with pytest.raises(NotImplementedError,
                           match=rf"{name}=.*queue 1 item 8"):
            main([*flag, "--device", "cpu", *argv, "output_dir", out])
        assert not os.path.exists(out)
        return
    if name in ("spatial", "tensor"):
        with pytest.raises(ValueError, match=rf"1 devices do not split into "
                           rf".*{name}=2"):
            main([*flag, "--device", "cpu", *argv, "output_dir", out])
        assert not os.path.exists(out)
        return
    if name in ("coordinator", "num_processes", "process_id"):
        with pytest.raises(SystemExit, match=f"{flag[0]} needs --multi-host"):
            main([*flag, "--device", "cpu", *argv, "output_dir", out])
        assert not os.path.exists(out)
        return
    given = {"fsdp": ["--fsdp", "--device", "cpu"],
             "multi_host": ["--multi-host", "--coordinator",
                            f"127.0.0.1:{free_port()}", "--num-processes",
                            "1", "--process-id", "0", "--device", "cpu"],
             "platform": ["--platform", "cpu"]}[name]
    main([*given, *real, *opts, "output_dir", out])
    assert not torch.distributed.is_initialized()
    _strict_load(cli, out)
    log = "".join(open(os.path.join(d, f)).read()
                  for d, _, fs in os.walk(out) for f in fs
                  if f == "train_log.txt")
    if name == "fsdp":
        assert "fsdp shards nothing" in log
    if name == "multi_host":
        assert "world 1, fsdp=False" in log
    if name == "platform":
        with pytest.raises(ValueError, match="cpu or gpu"):
            main(["--platform", "tpu", *argv, "output_dir", out])


def test_serve_batch_defaults_to_16():
    assert serve.make_parser().parse_args([]).batch == 16
    assert serve.make_parser().parse_args(["--batch", "8"]).batch == 8
