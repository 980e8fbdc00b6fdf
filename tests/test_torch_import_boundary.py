"""The port stands alone: no module of eop_tpu_torch imports JAX, flax or
the eop_tpu package, so it runs where JAX is not installed; nor PIL or
tabulate, and OpenCV, matplotlib and seaborn only inside functions (the
decoder of other formats, ``vis``'s labels), never at module level,
because the H100 hosts it targets may have none of them.  chip_smoke.py
and tests/_torch_dist_child.py (the multi-process tests' ranks) keep to
the same rules."""

import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import eop_tpu_torch

PKG_DIR = Path(eop_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex", "eop_tpu",
             "PIL", "tabulate")
NOT_AT_MODULE_LEVEL = ("cv2", "matplotlib", "seaborn")


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in FORBIDDEN


def test_every_module_imports_without_jax():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import eop_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "eop_tpu_torch.__path__, 'eop_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(json.dumps({'imported': names, 'modules': sorted(sys.modules)}))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(PKG_DIR.parent)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=str(PKG_DIR.parent),
                       timeout=120)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    for name in ("serving.http", "tools.serve", "tools.train_24p",
                 "tools.eval", "data.image_io", "data.coco24p",
                 "data.dataloading", "data.coco_api", "eval.coco_eval",
                 "eval.fast_cocoeval", "eval.evaluator_24p", "exp.build",
                 "utils.synth", "tools.train", "train.trainer",
                 "exp.yolox_base", "eval.coco_evaluator", "data.mosaic",
                 "data.coco_dataset", "losses.yolox_loss",
                 # Nano / Tiny / YOLOv3 and bbox serving
                 "ops.blocks", "models.darknet", "models.pafpn",
                 "models.head", "models.yolox", "exp.base_exp",
                 "serving.service", "utils.weights",
                 # the event-loop front end and the load generator
                 "serving.http_async", "tools.load_test_serving",
                 # the feature-map study
                 "models.vgg", "models.resnet", "models.densenet",
                 "data.labels24p", "tools.featuremap",
                 "tools.demo_featuremap", "utils.visualize",
                 "utils.model_utils",
                 # PASCAL VOC
                 "data.voc", "data.voc_classes", "eval.voc_eval",
                 "eval.voc_evaluator",
                 # the 24p family's label generator and drawing tools
                 "data.geometry", "tools.labels_create_24p",
                 "tools.show_24p", "tools.show_mask",
                 # the deployment path: export, int8 PTQ
                 "ops.quant", "utils.serving_export",
                 "tools.export_serving",
                 # data parallelism over processes
                 "parallel", "parallel.dist", "parallel.global_bn",
                 "parallel.mesh",
                 # spatial and tensor sharding
                 "parallel.spatial", "parallel.tensor"):
        assert f"eop_tpu_torch.{name}" in out["imported"], name
    bad = [m for m in out["modules"]
           if _forbidden(m) or m.split(".")[0] in NOT_AT_MODULE_LEVEL]
    assert not bad, bad


def _imports(nodes):
    for node in nodes:
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_source_file_imports_jax_or_eop_tpu():
    found = []
    # the ranks the multi-process tests start run where JAX need not be
    children = [PKG_DIR.parent / "tests" / "_torch_dist_child.py"]
    for path in [*PKG_DIR.rglob("*.py"), PKG_DIR.parent / "chip_smoke.py",
                 *children]:
        tree = ast.parse(path.read_text(), str(path))
        found += [(str(path), n) for n in _imports(ast.walk(tree))
                  if _forbidden(n)]
        # module level, and the bodies of module-level if / try blocks
        top = [n for stmt in tree.body for n in ast.walk(stmt)
               if not isinstance(stmt, (ast.FunctionDef, ast.ClassDef))]
        found += [(str(path), n) for n in _imports(top)
                  if n.split(".")[0] in NOT_AT_MODULE_LEVEL]
    assert not found, found
    assert len(list(pkgutil.walk_packages(eop_tpu_torch.__path__))) >= 8
