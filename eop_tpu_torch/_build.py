"""Build the port's CUDA sources and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface under ``eop_tpu_torch/_build/`` on first use; the
file name carries a hash of the source, the shared ``csrc/*.cuh`` headers and
the flags, so an edited source builds anew and an unchanged one loads at once.
Nothing is built at import time.

Only the repository's own sources are built: no PyTorch headers, so a build
takes seconds (``torch.utils.cpp_extension.load`` takes minutes).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": float, "cached": bool, "ptxas": [lines]}
BUILD_INFO: Dict[str, dict] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    parts = [(SRC_DIR / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(SRC_DIR.glob("*.cuh"))]
    parts.append(" ".join(NVCC_FLAGS).encode())
    digest = hashlib.sha256(b"\0".join(parts)).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns (process, tmp path, target)."""
    out = _target(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: Path, out: Path, t0: float) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    BUILD_INFO[name] = {
        "seconds": time.perf_counter() - t0,
        "cached": False,
        "ptxas": [ln.strip() for ln in log.splitlines()
                  if "ptxas" in ln or "spill" in ln],
    }


def build_all() -> Dict[str, dict]:
    """Build every ``csrc/*.cu`` not yet built, all ``nvcc`` runs started
    together; returns ``BUILD_INFO``."""
    with _lock:
        names = sorted(p.stem for p in SRC_DIR.glob("*.cu"))
        t0 = time.perf_counter()
        started = []
        for name in names:
            if _target(name).exists():
                BUILD_INFO.setdefault(name, {"seconds": 0.0, "cached": True,
                                             "ptxas": []})
            else:
                started.append((name, *_start(name)))
        for name, proc, tmp, out in started:
            _finish(name, proc, tmp, out, t0)
        return dict(BUILD_INFO)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        out = _target(name)
        if not out.exists():
            t0 = time.perf_counter()
            _finish(name, *_start(name), t0)
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
        return lib
