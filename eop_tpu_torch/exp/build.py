"""Experiments by name or by file (counterpart of ``eop_tpu/exp/build.py``).

The exp files of ``load_train/``, ``load_eval/`` and ``exps/`` subclass
``eop_tpu``'s ``Exp24P`` or bbox ``Exp``, so importing them would import the
JAX package.  The port reads them instead: it parses the file, takes the
class ``Exp``, picks the port's class of the same name as its base (the
name the file imports it under), checks that ``__init__`` calls
``super().__init__()`` and then assigns literals to ``self`` attributes
(``self.depth, self.width = 0.33, 0.50`` and ``self.input_size =
self.test_size = (416, 416)`` included; ``config_name(__file__)`` is the
file's stem), and applies those assignments to a fresh instance.  Any other
statement, and an attribute the class does not have (a misspelt or unported
field), raises, naming its file and line.

By name: ``yolox-s``, ``-m``, ``-l``, ``-x`` read ``exps/default/``;
``yolox_24p_s`` is a preset of :class:`Exp24P`.
"""

from __future__ import annotations

import ast
from pathlib import Path

from .yolox_24p_base import Exp24P
from .yolox_base import Exp

# name -> attribute overrides of Exp24P.  "yolox_24p_s" equals
# load_eval/yolox_24p_eval.py.
PRESETS = {
    "yolox_24p_s": dict(depth=0.33, width=0.50, num_classes=80),
}
# the exp classes a file may subclass, by the name it imports
FAMILIES = {"Exp": Exp, "Exp24P": Exp24P}
DEFAULT_EXP_DIR = Path(__file__).resolve().parents[2] / "exps" / "default"
# names of exps/default the port cannot build yet, and what each needs
UNPORTED = {
    "yolox_nano": "depthwise convs (DWConv)",
    "yolox_tiny": "the 24-channel early convs (width 0.375) held on the "
                  "card, and the reference's input_scale field; it comes "
                  "with YOLOX-Nano's DWConv",
    "yolov3": "Darknet-53 and YOLOFPN (its exp overrides get_model)",
}


def _self_attrs(target, where: str):
    """``self.a`` -> ["a"]; ``self.a, self.b`` -> ["a", "b"]."""
    if (isinstance(target, ast.Attribute) and isinstance(target.value, ast.Name)
            and target.value.id == "self"):
        return [target.attr]
    if isinstance(target, ast.Tuple):
        return [n for t in target.elts for n in _self_attrs(t, where)]
    raise ValueError(f"{where}: only self.<name> targets are read")


def _is_super_init(stmt) -> bool:
    call = stmt.value if isinstance(stmt, ast.Expr) else None
    return (isinstance(call, ast.Call) and not call.args
            and isinstance(call.func, ast.Attribute)
            and call.func.attr == "__init__"
            and isinstance(call.func.value, ast.Call)
            and getattr(call.func.value.func, "id", None) == "super")


def _imported_names(tree) -> dict:
    """local name -> imported name, of the module's ``from ... import``s."""
    out = {}
    for stmt in tree.body:
        if isinstance(stmt, ast.ImportFrom):
            for a in stmt.names:
                out[a.asname or a.name] = a.name
    return out


def _literal(value, exp_file: str, where: str):
    """A literal, or ``config_name(__file__)`` (the file's stem)."""
    if (isinstance(value, ast.Call) and getattr(value.func, "id", None)
            == "config_name" and len(value.args) == 1 and not value.keywords
            and getattr(value.args[0], "id", None) == "__file__"):
        return Path(exp_file).stem
    try:
        return ast.literal_eval(value)
    except ValueError:
        raise ValueError(f"{where}: {ast.unparse(value)!r} is not a "
                         "literal") from None


def _is_docstring(stmt) -> bool:
    return (isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant)
            and isinstance(stmt.value.value, str))


def read_exp_file(exp_file: str):
    """(the port's exp class the file's ``Exp`` subclasses, the ``self``
    attribute assignments of its ``__init__`` in order as {name:
    value})."""
    path = Path(exp_file)
    tree = ast.parse(path.read_text(), str(path))
    exp_cls = None
    for stmt in tree.body:
        where = f"{exp_file}:{stmt.lineno}"
        if isinstance(stmt, ast.ClassDef) and stmt.name == "Exp":
            exp_cls = stmt
        elif not (_is_docstring(stmt)
                  or isinstance(stmt, (ast.Import, ast.ImportFrom))):
            raise ValueError(f"{where}: not a literal exp setting "
                             f"({type(stmt).__name__})")
    if exp_cls is None:
        raise ValueError(f"{exp_file} has no class named 'Exp'")
    body = [s for s in exp_cls.body if not _is_docstring(s)]
    if not (len(body) == 1 and isinstance(body[0], ast.FunctionDef)
            and body[0].name == "__init__"):
        raise ValueError(f"{exp_file}:{exp_cls.lineno}: class Exp must hold "
                         "only __init__")
    init = [s for s in body[0].body if not _is_docstring(s)]
    if not init or not _is_super_init(init[0]):
        raise ValueError(f"{exp_file}:{body[0].lineno}: Exp.__init__ must "
                         "start with super().__init__()")
    imported = _imported_names(tree)
    bases = [imported.get(getattr(b, "id", None)) for b in exp_cls.bases]
    if len(bases) != 1 or bases[0] not in FAMILIES:
        raise ValueError(f"{exp_file}:{exp_cls.lineno}: class Exp must "
                         f"subclass one of {sorted(FAMILIES)}")
    family = FAMILIES[bases[0]]
    known = vars(family())
    settings = {}
    for stmt in init[1:]:
        where = f"{exp_file}:{stmt.lineno}"
        if not isinstance(stmt, ast.Assign):
            raise ValueError(f"{where}: not a literal exp setting "
                             f"({type(stmt).__name__})")
        value = _literal(stmt.value, exp_file, where)
        for target in stmt.targets:  # a = b = value: each gets the value
            names = _self_attrs(target, where)
            for name in names:
                if name not in known:
                    raise ValueError(f"{where}: {family.__name__} has no "
                                     f"attribute {name!r}")
            if len(names) > 1:
                if not (isinstance(value, tuple)
                        and len(value) == len(names)):
                    raise ValueError(f"{where}: {len(names)} targets, value "
                                     f"{value!r}")
                settings.update(zip(names, value))
            else:
                settings[names[0]] = value
    return family, settings


def get_exp_by_file(exp_file: str):
    family, settings = read_exp_file(exp_file)
    exp = family()
    for k, v in settings.items():
        setattr(exp, k, v)
    return exp


def get_exp_by_name(exp_name: str):
    """``yolox-s`` / ``yolox_s`` ... from ``exps/default/``, or a preset."""
    if exp_name in PRESETS:
        exp = Exp24P()
        for k, v in PRESETS[exp_name].items():
            setattr(exp, k, v)
        return exp
    stem = exp_name.replace("-", "_")
    if stem in UNPORTED:
        raise NotImplementedError(
            f"exp {exp_name!r} needs {UNPORTED[stem]}, which the port does "
            "not have yet (ROADMAP.md queue 1)")
    path = DEFAULT_EXP_DIR / f"{stem}.py"
    if not path.exists():
        known = sorted([*PRESETS, *(p.stem.replace("_", "-") for p in
                                    DEFAULT_EXP_DIR.glob("*.py"))])
        raise ValueError(f"unknown exp {exp_name!r}; known: {known}")
    return get_exp_by_file(str(path))


def get_exp(exp_file=None, exp_name=None):
    """Exp by file (priority) or by name."""
    if exp_file is None and exp_name is None:
        raise ValueError("give an exp file or an exp name")
    if exp_file is not None:
        return get_exp_by_file(exp_file)
    return get_exp_by_name(exp_name)
