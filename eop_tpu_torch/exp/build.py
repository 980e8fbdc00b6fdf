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
field), raises, naming its file and line.  Two kinds of method override
are read.  ``exps/default/yolov3.py``'s ``get_model``, which builds
``eop_tpu``'s ``YOLOv3(num_classes=self.num_classes, width=self.width,
dtype=...)``, becomes ``model_kind = "yolov3"``.  The four VOC methods of
``exps/example/yolox_voc/yolox_voc_s.py`` (``_devkit_dir``,
``get_data_loader``, ``get_eval_loader``, ``get_evaluator``), each as
written there but for its literal ``image_sets``, become ``data_kind =
"voc"``, ``voc_train_sets`` and ``voc_test_sets``; the port's ``Exp``
builds the same loaders and evaluator from them.  Any other method, or
one of those with another body, raises, naming the file, the line and the
method.

By name: ``yolox-s``, ``-m``, ``-l``, ``-x``, ``-nano``, ``-tiny`` and
``yolov3`` read ``exps/default/``; ``yolox_24p_s`` is a preset of
:class:`Exp24P`.
"""

from __future__ import annotations

import ast
import copy
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


def _self_attr(node, name: str) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == name
            and getattr(node.value, "id", None) == "self")


def _builds_yolov3(fn) -> bool:
    """``fn`` imports ``YOLOv3`` from ``eop_tpu.models`` and builds it with
    ``num_classes=self.num_classes, width=self.width, dtype=...``, once
    (``exps/default/yolov3.py``'s ``get_model``)."""
    imports = [a for n in ast.walk(fn) if isinstance(n, ast.ImportFrom)
               and n.module == "eop_tpu.models" for a in n.names]
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "YOLOv3"]
    if not (fn.name == "get_model" and len(calls) == 1
            and [(a.name, a.asname) for a in imports] == [("YOLOv3", None)]):
        return False
    kw = {k.arg: k.value for k in calls[0].keywords}
    return (not calls[0].args and set(kw) == {"num_classes", "width", "dtype"}
            and _self_attr(kw["num_classes"], "num_classes")
            and _self_attr(kw["width"], "width"))


# The VOC methods of exps/example/yolox_voc/yolox_voc_s.py as the port reads
# them: a method must equal its template (as ``ast.dump`` shows it, without
# a docstring) once the literal value of its ``image_sets`` keyword, which
# the port takes as the setting named beside it, stands in for IMAGE_SETS.
_VOC_METHODS = {
    "_devkit_dir": (None, """
def _devkit_dir(self):
    return os.path.join(self.data_dir or "datasets", "VOCdevkit")
"""),
    "get_data_loader": ("voc_train_sets", """
def get_data_loader(self, batch_size, is_distributed, no_aug=False,
                    cache_img=False, rank=0, world_size=1, seed=None):
    from eop_tpu.data.voc import VOCDetection

    dataset = VOCDetection(
        data_dir=self._devkit_dir(),
        image_sets=IMAGE_SETS,
        img_size=self.input_size,
        preproc=self.build_train_transform(max_labels=50),
        cache=cache_img,
    )
    return self.wrap_train_dataset(
        dataset, batch_size, is_distributed=is_distributed,
        no_aug=no_aug, rank=rank, world_size=world_size, seed=seed,
    )
"""),
    "get_eval_loader": ("voc_test_sets", """
def get_eval_loader(self, batch_size, is_distributed=False,
                    testdev=False, legacy=False):
    from eop_tpu.data.augment import ValTransform
    from eop_tpu.data.dataloading import DataLoader
    from eop_tpu.data.voc import VOCDetection

    valdataset = VOCDetection(
        data_dir=self._devkit_dir(),
        image_sets=IMAGE_SETS,
        img_size=self.test_size,
        preproc=ValTransform(legacy=legacy),
    )
    sampler = None
    if is_distributed:
        from eop_tpu.parallel import dist

        sampler = list(range(
            dist.get_rank(), len(valdataset), dist.get_world_size()
        ))
    return DataLoader(valdataset, batch_size=batch_size, shuffle=False,
                      sampler=sampler,
                      num_workers=self.data_num_workers)
"""),
    "get_evaluator": (None, """
def get_evaluator(self, batch_size, is_distributed=False, testdev=False,
                  legacy=False):
    from eop_tpu.eval.voc_evaluator import VOCEvaluator

    return VOCEvaluator(
        dataloader=self.get_eval_loader(batch_size, is_distributed,
                                        testdev, legacy),
        img_size=self.test_size,
        confthre=self.test_conf,
        nmsthre=self.nmsthre,
        num_classes=self.num_classes,
    )
"""),
}


def _without_docstring(fn) -> list:
    return [s for s in fn.body if not _is_docstring(s)]


def _voc_setting(fn):
    """``(setting name or None, its value)`` where ``fn`` is one of
    :data:`_VOC_METHODS` as written in the VOC exp file, else None."""
    if fn.name not in _VOC_METHODS:
        return None
    setting, template = _VOC_METHODS[fn.name]
    want = ast.parse(template).body[0]
    want.body = _without_docstring(want)
    fn = copy.deepcopy(fn)  # rewritten below
    fn.body = _without_docstring(fn)
    sets = [k for n in ast.walk(fn) if isinstance(n, ast.Call)
            for k in n.keywords if k.arg == "image_sets"]
    value = None
    if setting is not None:
        if len(sets) != 1:
            return None
        try:
            value = [tuple(p) for p in ast.literal_eval(sets[0].value)]
        except (ValueError, TypeError):
            return None
        if not value or not all(len(p) == 2 and all(isinstance(v, str)
                                                    for v in p)
                                for p in value):
            return None
        sets[0].value = ast.Name(id="IMAGE_SETS", ctx=ast.Load())
    if ast.dump(fn) != ast.dump(want):
        return None
    return setting, value


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
    if not (body and isinstance(body[0], ast.FunctionDef)
            and body[0].name == "__init__"):
        raise ValueError(f"{exp_file}:{exp_cls.lineno}: class Exp must start "
                         "with __init__")
    overrides, voc = {}, []
    for fn in body[1:]:
        name = getattr(fn, "name", type(fn).__name__)
        is_fn = isinstance(fn, ast.FunctionDef)
        if is_fn and _builds_yolov3(fn):
            overrides["model_kind"] = "yolov3"
            continue
        read = _voc_setting(fn) if is_fn else None
        if read is None:
            raise ValueError(
                f"{exp_file}:{fn.lineno}: method {name!r} of class Exp is not "
                "read (the port reads __init__, a get_model that builds "
                "eop_tpu.models.YOLOv3, and yolox_voc_s.py's four VOC "
                "methods as written there)")
        voc.append(name)
        setting, value = read
        if setting is not None:
            overrides[setting] = value
    if voc:
        if sorted(voc) != sorted(_VOC_METHODS):
            raise ValueError(
                f"{exp_file}:{exp_cls.lineno}: the VOC methods come as "
                f"yolox_voc_s.py's four, each once: given {voc}")
        overrides["data_kind"] = "voc"
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
    for name, value in overrides.items():
        if name not in known:
            raise ValueError(f"{exp_file}:{exp_cls.lineno}: {family.__name__}"
                             f" has no attribute {name!r}")
        settings[name] = value
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
