"""The port stands alone: no module of eop_tpu_torch imports JAX, flax or
the eop_tpu package, so it runs where JAX is not installed."""

import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import eop_tpu_torch

PKG_DIR = Path(eop_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex", "eop_tpu")


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
    assert "eop_tpu_torch.serving.http" in out["imported"]
    assert "eop_tpu_torch.tools.serve" in out["imported"]
    bad = [m for m in out["modules"] if _forbidden(m)]
    assert not bad, bad


def test_no_source_file_imports_jax_or_eop_tpu():
    found = []
    for path in PKG_DIR.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [(str(path), n) for n in names if _forbidden(n)]
    assert not found, found
    assert len(list(pkgutil.walk_packages(eop_tpu_torch.__path__))) >= 8
