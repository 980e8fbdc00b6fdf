"""Build the port's native sources and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` and each host source
``csrc/<name>.cpp`` with the host's C++ compiler (never ``nvcc``) into its
own shared library with a plain C interface under ``eop_tpu_torch/_build/``
on first use; the file name carries a hash of the source, of the shared
``csrc/*.cuh`` headers (CUDA sources) and of the flags, so an edited source
builds anew and an unchanged one loads at once.  Nothing is built at import
time.

Only the repository's own sources are built: no PyTorch headers, so a build
takes seconds (``torch.utils.cpp_extension.load`` takes minutes).
:func:`build_all` leaves out the diagnostics of ``ON_REQUEST``, which are
built when a caller loads them.
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

HOST_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
# built only by load(): no path of the port runs them
ON_REQUEST = ("terminate_probe",)

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


def cxx_path() -> str:
    cand = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cand:
        raise RuntimeError("no host C++ compiler: set CXX or put c++ on PATH")
    return cand


def is_host(name: str) -> bool:
    """Whether ``name`` is a host source (``.cpp``) rather than CUDA."""
    return (SRC_DIR / f"{name}.cpp").exists()


def _source(name: str) -> Path:
    return SRC_DIR / f"{name}.{'cpp' if is_host(name) else 'cu'}"


def _target(name: str) -> Path:
    parts = [_source(name).read_bytes()]
    if is_host(name):
        parts.append(" ".join(HOST_FLAGS).encode())
    else:
        parts += [h.read_bytes() for h in sorted(SRC_DIR.glob("*.cuh"))]
        parts.append(" ".join(NVCC_FLAGS).encode())
    digest = hashlib.sha256(b"\0".join(parts)).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start the compiler for one source; returns (process, tmp path,
    target)."""
    out = _target(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    compiler = ([cxx_path(), *HOST_FLAGS] if is_host(name)
                else [nvcc_path(), *NVCC_FLAGS])
    cmd = [*compiler, "-o", str(tmp), str(_source(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: Path, out: Path, t0: float) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{'c++' if is_host(name) else 'nvcc'} failed for "
                           f"{_source(name).name}:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    BUILD_INFO[name] = {
        "seconds": time.perf_counter() - t0,
        "cached": False,
        "ptxas": [ln.strip() for ln in log.splitlines()
                  if "ptxas" in ln or "spill" in ln],
    }


def build_all() -> Dict[str, dict]:
    """Build every ``csrc/*.cu`` and ``csrc/*.cpp`` not yet built but those
    of ``ON_REQUEST``, all compiler runs started together; returns
    ``BUILD_INFO``."""
    with _lock:
        names = sorted(p.stem for p in (*SRC_DIR.glob("*.cu"),
                                        *SRC_DIR.glob("*.cpp"))
                       if p.stem not in ON_REQUEST)
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
    """The loaded library of ``csrc/<name>.cu`` or ``.cpp``, built on first
    use."""
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
