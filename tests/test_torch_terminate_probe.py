"""The native terminate / SIGABRT probe (``csrc/terminate_probe.cpp``) that
``chip_smoke.py --probe-worker-exit`` installs in its loader workers: in a
child process, either way of aborting writes the aborting thread, its
frames' shared objects and the process's threads, then hands the signal on
to faulthandler, which dumps the Python stack, and the process dies of
SIGABRT."""

import signal
import subprocess
import sys
import textwrap

import pytest

from eop_tpu_torch import _build

CHILD = textwrap.dedent("""
    import ctypes, faulthandler, os, sys, threading
    from eop_tpu_torch import _build

    how, path = sys.argv[1], sys.argv[2]
    faulthandler.enable(open(path + ".faulthandler", "w"), all_threads=True)
    install = _build.load("terminate_probe").terminate_probe_install
    install.argtypes, install.restype = [ctypes.c_char_p], ctypes.c_int
    assert install(path.encode()) == 0
    started = threading.Event()

    def idler():  # a native thread name, as a library's thread has one
        ctypes.CDLL(None).prctl(15, b"idler")  # PR_SET_NAME
        started.set()
        threading.Event().wait()

    threading.Thread(target=idler, daemon=True).start()
    started.wait()
    if how == "abort":
        os.abort()
    # what a joinable std::thread's destructor calls
    ctypes.CDLL("libstdc++.so.6")._ZSt9terminatev()
""")


def test_probe_is_built_only_on_request():
    assert "terminate_probe" in _build.ON_REQUEST
    assert _build.is_host("terminate_probe")


@pytest.mark.parametrize("how,why", [
    ("abort", "== SIGABRT on thread"),
    ("terminate", "== std::terminate without an active exception on thread"),
])
def test_probe_names_the_aborting_thread_and_library(tmp_path, how, why):
    _build.load("terminate_probe")  # built once here, not in the child
    path = tmp_path / "dump.native.txt"
    r = subprocess.run([sys.executable, "-c", CHILD, how, str(path)],
                       capture_output=True, text=True, timeout=120,
                       cwd=str(_build.SRC_DIR.parent.parent))
    assert r.returncode == -signal.SIGABRT, r.stderr
    text = path.read_text()
    assert text.count("== ") == 2 and why in text, text
    objects = text.split("-- objects")[1].split("-- threads")[0]
    # the frames name their shared objects: the probe's own handler, and
    # the C library's abort or the C++ runtime's terminate below it
    assert "libterminate_probe" in objects
    assert ("libc.so" if how == "abort" else "libstdc++") in objects
    threads = text.split("-- threads (tid comm)")[1]
    assert "idler" in threads, threads
    # the signal went on to faulthandler, which names the Python thread
    assert "Fatal Python error: Aborted" in (
        tmp_path / "dump.native.txt.faulthandler").read_text()
