"""The port reads the exp files of load_train/ and load_eval/ without
importing them: the same settings as the JAX package's ``get_exp`` gives,
and a clear error, naming file and line, for anything but literal
settings."""

import pytest

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
