"""Experiments by name or by file (counterpart of ``eop_tpu/exp/build.py``).

The files of ``load_train/`` and ``load_eval/`` subclass ``eop_tpu``'s
``Exp24P``, so importing them would import the JAX package.  The port reads
them instead: it parses the file, takes the class ``Exp`` whose
``__init__`` calls ``super().__init__()`` and then assigns literals to
``self`` attributes (``self.depth, self.width = 0.33, 0.50`` included), and
applies those assignments to a fresh :class:`Exp24P`.  Any other statement
raises, naming its file and line.
"""

from __future__ import annotations

import ast
from pathlib import Path

from .yolox_24p_base import Exp24P

# name -> attribute overrides of Exp24P.  "yolox_24p_s" equals
# load_eval/yolox_24p_eval.py.
PRESETS = {
    "yolox_24p_s": dict(depth=0.33, width=0.50, num_classes=80),
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


def _is_docstring(stmt) -> bool:
    return (isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant)
            and isinstance(stmt.value.value, str))


def read_exp_file(exp_file: str) -> dict:
    """The ``self`` attribute assignments of ``Exp.__init__`` in
    ``exp_file``, in order, as {name: value}."""
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
    settings = {}
    for stmt in init[1:]:
        where = f"{exp_file}:{stmt.lineno}"
        if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1):
            raise ValueError(f"{where}: not a literal exp setting "
                             f"({type(stmt).__name__})")
        names = _self_attrs(stmt.targets[0], where)
        try:
            value = ast.literal_eval(stmt.value)
        except ValueError:
            raise ValueError(f"{where}: {ast.unparse(stmt.value)!r} is not a "
                             "literal") from None
        if len(names) > 1:
            if not (isinstance(value, tuple) and len(value) == len(names)):
                raise ValueError(f"{where}: {len(names)} targets, value "
                                 f"{value!r}")
            settings.update(zip(names, value))
        else:
            settings[names[0]] = value
    return settings


def get_exp_by_file(exp_file: str) -> Exp24P:
    exp = Exp24P()
    for k, v in read_exp_file(exp_file).items():
        setattr(exp, k, v)
    return exp


def get_exp_by_name(exp_name: str) -> Exp24P:
    if exp_name not in PRESETS:
        raise ValueError(f"unknown exp {exp_name!r}; known: "
                         f"{sorted(PRESETS)}")
    exp = Exp24P()
    for k, v in PRESETS[exp_name].items():
        setattr(exp, k, v)
    return exp


def get_exp(exp_file=None, exp_name=None) -> Exp24P:
    """Exp by file (priority) or by name."""
    if exp_file is None and exp_name is None:
        raise ValueError("give an exp file or an exp name")
    if exp_file is not None:
        return get_exp_by_file(exp_file)
    return get_exp_by_name(exp_name)
