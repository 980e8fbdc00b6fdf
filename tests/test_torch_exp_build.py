"""The port reads the exp files of load_train/ and load_eval/ without
importing them: the same settings as the JAX package's ``get_exp`` gives,
and a clear error, naming file and line, for anything but literal
settings."""

import pytest
import torch

from eop_tpu.exp import Exp24P as JaxExp24P
from eop_tpu.exp import get_exp as j_get_exp
from eop_tpu_torch.exp import Exp24P, get_exp
from eop_tpu_torch.exp.build import read_exp_file

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("exp_file", ["load_train/yolox_24p_train.py",
                                      "load_eval/yolox_24p_eval.py"])
def test_exp_files_match_jax(exp_file):
    path = str(ROOT / exp_file)
    exp, j_exp = get_exp(path), j_get_exp(path)
    assert isinstance(exp, Exp24P)
    names = [k for k in vars(exp) if not k.startswith("_")]
    assert {"depth", "width", "exp_name", "data_num_workers", "data_dir",
            "label_dir"} <= set(names)
    for name in names:
        assert getattr(exp, name) == getattr(j_exp, name), name
    assert (exp.depth, exp.width, exp.exp_name) == (0.33, 0.50, "yolox_24p")
    # the default name follows the JAX base module's file name
    assert Exp24P().exp_name == "yolox_24p_base"


def test_name_presets_and_overrides():
    exp = get_exp(exp_name="yolox_24p_s")
    assert (exp.depth, exp.width, exp.num_classes) == (0.33, 0.50, 80)
    with pytest.raises(ValueError, match="unknown exp"):
        get_exp(exp_name="yolox_24p_x")
    with pytest.raises(ValueError, match="exp file or an exp name"):
        get_exp()
    exp.merge(["data_dir", "/data/imgs", "seed", "7", "label_dir", "labels"])
    assert (exp.data_dir, exp.seed, exp.label_dir) == ("/data/imgs", 7,
                                                       "labels")


@pytest.mark.parametrize("body,line", [
    ("        self.depth = 0.33\n        self.width = compute()\n", 9),
    ("        self.depth = 0.33\n        if True:\n            pass\n", 9),
    ("        self.depth, self.width = 0.33, 0.5, 1\n", 8),
    ("        other.depth = 1\n", 8),
])
def test_non_literal_statements_raise_with_their_line(tmp_path, body, line):
    path = tmp_path / "exp.py"
    path.write_text('"""doc"""\nfrom eop_tpu.exp import Exp24P as _Base\n\n\n'
                    "class Exp(_Base):\n    def __init__(self):\n"
                    "        super().__init__()\n" + body)
    with pytest.raises(ValueError, match=f"{path}:{line}:"):
        read_exp_file(str(path))


def test_module_statements_and_missing_super_raise(tmp_path):
    path = tmp_path / "exp.py"
    path.write_text("import os\nX = os.getcwd()\n")
    with pytest.raises(ValueError, match=f"{path}:2:"):
        read_exp_file(str(path))
    path.write_text("class Exp:\n    def __init__(self):\n"
                    "        self.depth = 1.0\n")
    with pytest.raises(ValueError, match="super"):
        read_exp_file(str(path))
    path.write_text("class Other:\n    pass\n")
    with pytest.raises(ValueError, match=f"{path}:1:"):
        read_exp_file(str(path))
    path.write_text('"""only a docstring"""\n')
    with pytest.raises(ValueError, match="no class named 'Exp'"):
        read_exp_file(str(path))


def _exp_file(tmp_path, body):
    path = tmp_path / "exp.py"
    path.write_text("from eop_tpu.exp import Exp24P as _Base\n\n\n"
                    "class Exp(_Base):\n    def __init__(self):\n"
                    "        super().__init__()\n" + body)
    return str(path)


def test_misspelt_field_raises_naming_file_line_and_name(tmp_path):
    path = _exp_file(tmp_path, "        self.depth = 0.33\n"
                               "        self.widht = 0.5\n")
    with pytest.raises(ValueError, match=f"{path}:8: Exp24P has no "
                                         "attribute 'widht'"):
        read_exp_file(path)
    with pytest.raises(ValueError, match="'widht'"):
        get_exp(path)
    # a tuple target is checked name by name
    path = _exp_file(tmp_path, "        self.depth, self.wdth = 0.33, 0.5\n")
    with pytest.raises(ValueError, match=f"{path}:7: .*'wdth'"):
        read_exp_file(path)


@pytest.mark.parametrize("body,what", [
    ('        self.compute_dtype = "bfloat16"\n', "compute_dtype 'bfloat16'"),
    ("        self.remat = True\n", "remat"),
])
def test_bf16_and_remat_settings_load(tmp_path, body, what):
    """An exp file (and ``merge``) with ``compute_dtype "bfloat16"`` or
    ``remat True`` loads, and ``get_model("cpu")`` computes in bf16 (bf16
    head maps over fp32 parameters) or checkpoints its backbone + neck
    (run again in the backward of a training step)."""
    path = _exp_file(tmp_path, body + "        self.depth = 0.33\n"
                                      "        self.width = 0.125\n"
                                      "        self.num_classes = 3\n")
    exp = get_exp(path)
    cli = get_exp(exp_name="yolox_24p_s")
    cli.merge(["compute_dtype", "bfloat16"] if "dtype" in what
              else ["remat", "True"])
    for e in (exp, cli):
        assert (e.compute_dtype, e.remat) == (
            ("bfloat16", False) if "dtype" in what else ("float32", True))
    model = exp.get_model("cpu")
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    x = torch.rand(1, 3, 64, 64) * 255
    if "dtype" in what:
        with torch.no_grad():
            heads, _ = model(x)
        assert {h.dtype for h in heads} == {torch.bfloat16}
        return
    stem_runs = []
    model.backbone.backbone.stem.register_forward_hook(
        lambda *_: stem_runs.append(1))
    heads, _ = model.train()(x)
    assert {h.dtype for h in heads} == {torch.float32} and stem_runs == [1]
    sum(h.sum() for h in heads).backward()
    assert stem_runs == [1, 1]


def test_tpu_layout_fields_are_accepted_with_jax_defaults(tmp_path):
    path = _exp_file(tmp_path, '        self.packed_early = "train"\n'
                               "        self.packed_infer_max_batch = 8\n"
                               '        self.act = "lrelu"\n')
    exp = get_exp(path)
    assert (exp.packed_early, exp.packed_infer_max_batch, exp.act) == (
        "train", 8, "lrelu")
    fresh, j_fresh = Exp24P(), JaxExp24P()
    for name in ("act", "compute_dtype", "remat", "packed_early",
                 "packed_infer_max_batch"):
        assert getattr(fresh, name) == getattr(j_fresh, name), name


def test_unknown_activation_raises():
    from eop_tpu_torch.ops.blocks import get_activation

    with pytest.raises(AttributeError, match="Unsupported act type: gelu"):
        get_activation("gelu")
    exp = get_exp(exp_name="yolox_24p_s")
    exp.act = "gelu"
    with pytest.raises(AttributeError, match="gelu"):
        exp.get_model("cpu")


@pytest.mark.parametrize("act", ["relu", "lrelu"])
def test_act_head_outputs_match_jax(act):
    """The 26-channel head maps of a ``relu`` / ``lrelu`` model equal
    eop_tpu's with the same ``act`` and the same (bridged) weights."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from eop_tpu.models import init_model
    from eop_tpu_torch.utils.weights import state_dict_from_jax

    def tiny(exp):
        exp.depth, exp.width, exp.num_classes, exp.act = 0.33, 0.25, 3, act
        return exp

    jmodel = tiny(JaxExp24P()).get_model()
    x = np.random.RandomState(5).uniform(0, 255, (2, 64, 64, 3)).astype(
        np.float32)
    variables = init_model(jmodel, jax.random.PRNGKey(1),
                           jnp.zeros((1, 64, 64, 3)))
    want, _ = jmodel.apply(variables, jnp.asarray(x), False)
    model = tiny(Exp24P()).get_model("cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got, _ = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape[1] == 26 + 1 + 3
        err = np.abs(g.permute(0, 2, 3, 1).numpy() - np.asarray(w)).max()
        assert err <= 1e-4 * max(1.0, scale), (act, err, scale)


@pytest.mark.parametrize("act,fused", [("silu", True), ("relu", False),
                                       ("lrelu", False)])
def test_only_silu_convs_take_the_fused_epilogue(monkeypatch, act, fused):
    """In eval mode without autograd the 8 kernel convs of a ``silu`` model
    pass BN and SiLU to ``phase_conv``; those of another ``act`` call it
    bare (never ``F.conv2d``) and apply BN and ``act`` after it."""
    import torch

    from eop_tpu_torch.ops import blocks

    calls = []
    real = blocks._phase_conv

    def spy(x, w, stride, pad, scale=None, shift=None, act=None):
        calls.append((scale is not None, act))
        return real(x, w, stride, pad, scale, shift, act)

    monkeypatch.setattr(blocks, "_phase_conv", spy)
    exp = get_exp(exp_name="yolox_24p_s")
    exp.depth, exp.width, exp.num_classes, exp.act = 0.33, 0.125, 3, act
    model = exp.get_model("cpu")
    with torch.no_grad():
        model(torch.zeros(1, 3, 64, 64))
    want = (True, "silu") if fused else (False, None)
    assert calls == [want] * 8
