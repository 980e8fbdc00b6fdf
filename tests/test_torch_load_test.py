"""The port's load generator (``eop_tpu_torch/tools/load_test_serving.py``)
on the CPU, held against the JAX package's ``tools/load_test_serving.py``
(loaded by path): the same rows and the same accounting against one slow
stub server, ``--procs 2`` merging its children's samples, one ``--spawn``
run of the port's server, and ``serve --frontend``."""

import http.server
import importlib.util
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from eop_tpu_torch.serving import (
    AsyncHTTPServer,
    DynamicBatcher,
    make_async_http_server,
)
from eop_tpu_torch.tools import load_test_serving as port_tool

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 60.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_load_test_serving", ROOT / "tools" / "load_test_serving.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class SlowService:
    """A batcher of 2 whose every batch takes ``batch_s``, with a queue of
    ``max_queue``: saturates (429) under a modest load."""

    def __init__(self, batch_s=0.02, max_queue=2):
        def run(items):
            time.sleep(batch_s)
            return [[] for _ in items]

        self._batcher = DynamicBatcher(run, max_batch=2, max_wait_ms=1.0,
                                       max_queue=max_queue)

    def detect_async(self, img, callback):
        self._batcher.submit_nowait(img, callback)

    def stats(self):
        return self._batcher.stats()

    def close(self):
        self._batcher.close()


@pytest.fixture
def slow_server():
    svc = SlowService()
    server = make_async_http_server(svc, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        thread.join(TIMEOUT)
        svc.close()
    assert not thread.is_alive()


BODY = np.zeros((8, 8, 3), np.uint8).tobytes()
HEADERS = {"X-Raw-Shape": "8,8,3"}


def test_closed_loop_rows_match_the_jax_tool(slow_server):
    """The same keys; every sample is ok, shed or an error; the batcher of
    2 is saturated by 8 clients, so both tools see 429s."""
    rows = [tool.run_closed(slow_server, 8, 1.0, BODY, HEADERS, 10.0)
            for tool in (port_tool, load_jax_tool())]
    assert list(rows[0]) == list(rows[1])
    for row in rows:
        assert row["concurrency"] == 8 and row["errors"] == 0
        assert row["ok"] > 0 and row["shed_429"] > 0
        assert row["throughput_rps"] == round(row["ok"] / 1.0, 1)
        assert 1.0 <= row["batch_occupancy"] <= 2.0
        assert row["p50_ms"] <= row["p95_ms"] <= row["p99_ms"]


def test_open_loop_accounting_matches_the_jax_tool(slow_server,
                                                   monkeypatch):
    """An open-loop step that two workers cannot keep up with: every tick
    is sent or recorded as dropped late (-2), and each sent request is ok,
    shed or an error, in both tools alike."""
    rows = []
    for tool in (port_tool, load_jax_tool()):
        monkeypatch.setattr(tool._Worker, "LATE_CAP_S", 0.1)
        rows.append(tool.run_rate(slow_server, 100.0, 1.0, 2, BODY, HEADERS,
                                  10.0, 1, None))
    assert list(rows[0]) == list(rows[1])
    for row in rows:
        assert row["sent"] == 100 and row["errors"] == 0
        assert row["ok"] > 0 and row["client_dropped_late"] > 0
        assert (row["ok"] + row["shed_429"] + row["client_dropped_late"]
                == row["sent"])
        assert row["achieved_rps"] == round(row["ok"] / 1.0, 1)


def test_open_loop_sheds_like_the_jax_tool(slow_server):
    """16 workers at 200 req/s against a batcher that serves ~100: both
    tools count 429s, and nothing is dropped late or lost."""
    rows = [tool.run_rate(slow_server, 200.0, 1.0, 16, BODY, HEADERS, 10.0,
                          1, None)
            for tool in (port_tool, load_jax_tool())]
    for row in rows:
        assert row["sent"] == 200 and row["errors"] == 0
        assert row["ok"] > 0 and row["shed_429"] > 0
        assert row["ok"] + row["shed_429"] + row["client_dropped_late"] == 200


def test_procs_merge_their_childrens_samples(slow_server):
    """``--procs 2``: two generator processes, each half the rate, their
    samples merged into one row."""
    child = [sys.executable, "-m", "eop_tpu_torch.tools.load_test_serving",
             "--url", slow_server, "--duration", "1.0", "--hw", "8,8",
             "--timeout", "10.0"]
    row = port_tool.run_rate(slow_server, 40.0, 1.0, 16, BODY, HEADERS, 10.0,
                             2, child)
    assert row["sent"] == 40 and row["errors"] == 0
    assert row["ok"] + row["shed_429"] + row["client_dropped_late"] == 40
    assert row["ok"] > 0


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_spawn_runs_the_ports_server_and_stops_it():
    """``--spawn``: ``python -m eop_tpu_torch.tools.serve --device cpu`` on
    a tiny 24p exp, a closed-loop step of 2 clients, an all-200 table; the
    server is gone afterwards."""
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    cmd = [sys.executable, "-m", "eop_tpu_torch.tools.load_test_serving",
           "--url", url, "--closed", "2", "--duration", "1", "--hw", "64,64",
           "--health-timeout", "120", "--spawn",
           "--device cpu --batch 2 --host 127.0.0.1 depth 0.33 width 0.125 "
           "num_classes 3 test_size '(64, 64)' test_conf 5e-5"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       env=env, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    banner = next(ln for ln in lines if ln.startswith("serving on"))
    assert "frontend=async" in banner and "device=cpu" in banner
    (row,) = json.loads(lines[-1])
    assert row["concurrency"] == 2 and row["ok"] > 0
    assert row["errors"] == 0 and row["shed_429"] == 0
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=5).close()


def test_spawned_server_that_dies_fails_at_once():
    """A spawned server that exits before it is healthy ends the wait."""
    t0 = time.monotonic()
    r = subprocess.run(
        [sys.executable, "-m", "eop_tpu_torch.tools.load_test_serving",
         "--url", f"http://127.0.0.1:{free_port()}", "--closed", "1",
         "--spawn", "--device cpu no_such_key 1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "before it became healthy" in r.stderr
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("argv,cls", [
    ([], AsyncHTTPServer),
    (["--frontend", "threaded"], http.server.ThreadingHTTPServer),
])
def test_serve_frontend_defaults_to_async(argv, cls, monkeypatch, capsys):
    """``serve`` builds the event-loop server unless ``--frontend
    threaded``; the banner names the front end."""
    from eop_tpu_torch.tools import serve as cli

    assert cli.make_parser().parse_args([]).frontend == "async"
    started, serve = [], cls.serve_forever

    def serve_forever(self, *a, **kw):  # stopped from another thread
        started.append(type(self))
        stop = threading.Timer(0.2, self.shutdown)
        stop.start()
        serve(self, *a, **kw)
        stop.join(TIMEOUT)

    monkeypatch.setattr(cls, "serve_forever", serve_forever)
    cli.main(["--device", "cpu", "--batch", "1", "--host", "127.0.0.1",
              "--port", "0", *argv, "width", "0.125", "num_classes", "3",
              "test_size", "(64, 64)"])
    assert started == [cls]
    frontend = "threaded" if argv else "async"
    assert f"frontend={frontend} device=cpu" in capsys.readouterr().out
