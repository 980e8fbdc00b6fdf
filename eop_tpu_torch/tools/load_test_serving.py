"""Load-test the port's detection server (the port's copy of the JAX
package's ``tools/load_test_serving.py``).

Open loop (``--rates``): for each offered rate the send times are fixed on
a clock, not gated on answers (a closed-loop generator hides saturation by
slowing down with the server); a pool of workers posts one frame per tick,
and a tick more than ``LATE_CAP_S`` past due is recorded as dropped by the
client.  Closed loop (``--closed``): N workers send back to back, the
capacity probe where the generator shares the host's cores with the server.
The tool reports client-side latency percentiles, throughput, the error mix
(429 = shed load) and the server's batch occupancy from ``/v1/stats``.

Against a running server:

    python -m eop_tpu_torch.tools.load_test_serving \\
        --url http://127.0.0.1:8000 --rates 50,100,200 --duration 10

Or spawn ``python -m eop_tpu_torch.tools.serve`` on ``--url``'s port with
the given arguments, and kill it after the sweep:

    python -m eop_tpu_torch.tools.load_test_serving \\
        --spawn "--batch 8 --frontend async" --closed 1,16,64 --duration 5

``--procs N`` splits an open-loop rate over N generator processes (one
process tops out on the GIL).  Output: one JSON line with the table, each
row also printed to stderr as text.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import queue
import shlex
import subprocess
import sys
import threading
import time
import urllib.parse
import urllib.request

import numpy as np

# the directory that holds the eop_tpu_torch package
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def make_parser():
    p = argparse.ArgumentParser("eop_tpu_torch.tools.load_test_serving")
    p.add_argument("--url", default="http://127.0.0.1:8000")
    p.add_argument("--spawn", default=None,
                   help="eop_tpu_torch.tools.serve arguments; the server is "
                        "started on --url's port and killed after the sweep")
    p.add_argument("--rates", default="50,100,200,400,800,1600",
                   help="offered req/s sweep")
    p.add_argument("--closed", default=None,
                   help="comma list of concurrency levels: run CLOSED-loop "
                        "steps (N workers send back to back) instead of the "
                        "open-loop rate sweep")
    p.add_argument("--duration", type=float, default=10.0,
                   help="seconds per step")
    p.add_argument("--workers", type=int, default=128)
    p.add_argument("--procs", type=int, default=1,
                   help="split the offered load over N generator processes")
    p.add_argument("--timeout", type=float, default=30.0,
                   help="per-request client timeout")
    p.add_argument("--health-timeout", type=float, default=1800.0,
                   help="seconds to wait for the (spawned) server to become "
                        "healthy")
    p.add_argument("--_emit-samples", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--hw", default="640,640",
                   help="H,W of the test frame")
    p.add_argument("--jpeg", action="store_true",
                   help="send baseline JPEG bodies (the server decodes them) "
                        "instead of raw X-Raw-Shape frames")
    return p


def _wait_healthy(url: str, deadline_s: float = 600.0, proc=None):
    """Poll ``/healthz`` until 200; a spawned server (``proc``) that exits
    first fails at once."""
    t0 = time.time()
    while time.time() - t0 < deadline_s:
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(f"server exited with {proc.returncode} "
                               "before it became healthy")
        try:
            with urllib.request.urlopen(url + "/healthz", timeout=2) as r:
                if r.status == 200:
                    return
        except Exception:  # noqa: BLE001 — not up yet
            time.sleep(1.0)
    raise RuntimeError(f"server at {url} never became healthy")


def _get_stats(url: str) -> dict:
    with urllib.request.urlopen(url + "/v1/stats", timeout=10) as r:
        return json.loads(r.read())


class _Worker(threading.Thread):
    """Posts frames at the send times it pulls from the shared schedule."""

    LATE_CAP_S = 5.0  # a tick this far past due is recorded as dropped by
    # the client instead of sent: with finite workers a saturated server
    # would otherwise turn the open-loop schedule into a closed loop

    def __init__(self, host, port, path, body, headers, timeout,
                 schedule, results):
        super().__init__(daemon=True)
        self.host, self.port, self.path = host, port, path
        self.body, self.headers, self.timeout = body, headers, timeout
        self.schedule, self.results = schedule, results
        self.conn = None

    def _post_once(self):
        if self.conn is None:
            self.conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout)
        self.conn.request("POST", self.path, body=self.body,
                          headers=self.headers)
        resp = self.conn.getresponse()
        resp.read()
        return resp.status

    def close(self):
        if self.conn is not None:
            self.conn.close()
            self.conn = None

    def run(self):
        try:
            while True:
                try:
                    t_send = self.schedule.get_nowait()
                except queue.Empty:
                    return
                now = time.perf_counter()
                if t_send > now:
                    time.sleep(t_send - now)
                elif now - t_send > self.LATE_CAP_S:
                    self.results.append((t_send, 0.0, -2))  # dropped late
                    continue
                t0 = time.perf_counter()
                try:
                    status = self._post_once()
                except Exception:  # noqa: BLE001 — counted as an error
                    status = -1
                    self.close()  # reconnect next time
                self.results.append((t_send, time.perf_counter() - t0,
                                     status))
        finally:
            self.close()


def _generate(url: str, rate: float, duration: float, workers: int,
              body: bytes, headers: dict, timeout: float) -> list:
    """Run the open-loop schedule in this process; return the samples
    ``(t_send, latency_s, status)``."""
    parsed = urllib.parse.urlparse(url)
    n = max(1, int(rate * duration))
    start = time.perf_counter() + 0.5
    schedule: "queue.Queue[float]" = queue.Queue()
    for i in range(n):
        schedule.put(start + i / rate)
    results: list = []
    pool = [_Worker(parsed.hostname, parsed.port or 80, "/v1/detect", body,
                    headers, timeout, schedule, results)
            for _ in range(min(workers, n))]
    for w in pool:
        w.start()
    for w in pool:
        w.join(timeout=duration + timeout + 30)
    return results


class _ClosedWorker(threading.Thread):
    """Sends back to back until the deadline (closed loop)."""

    def __init__(self, host, port, body, headers, timeout, deadline,
                 results):
        super().__init__(daemon=True)
        self.w = _Worker(host, port, "/v1/detect", body, headers, timeout,
                         queue.Queue(), results)
        self.deadline = deadline
        self.results = results

    def run(self):
        try:
            while time.perf_counter() < self.deadline:
                t0 = time.perf_counter()
                try:
                    status = self.w._post_once()
                except Exception:  # noqa: BLE001 — counted as an error
                    status = -1
                    self.w.close()
                self.results.append((t0, time.perf_counter() - t0, status))
        finally:
            self.w.close()


def _pct(lats):
    def pct(q):
        return (round(lats[min(len(lats) - 1, int(q * len(lats)))] * 1e3, 1)
                if lats else None)
    return pct


def run_closed(url: str, concurrency: int, duration: float, body: bytes,
               headers: dict, timeout: float) -> dict:
    parsed = urllib.parse.urlparse(url)
    stats0 = _get_stats(url)
    results: list = []
    deadline = time.perf_counter() + duration
    pool = [_ClosedWorker(parsed.hostname, parsed.port or 80, body, headers,
                          timeout, deadline, results)
            for _ in range(concurrency)]
    for w in pool:
        w.start()
    for w in pool:
        w.join(timeout=duration + timeout + 30)
    stats1 = _get_stats(url)
    pct = _pct(sorted(r[1] for r in results if r[2] == 200))
    n_ok = sum(1 for r in results if r[2] == 200)
    batches = stats1["batches"] - stats0["batches"]
    served = stats1["requests"] - stats0["requests"]
    return {
        "concurrency": concurrency,
        "ok": n_ok,
        "shed_429": sum(1 for r in results if r[2] == 429),
        "errors": sum(1 for r in results if r[2] not in (200, 429)),
        "throughput_rps": round(n_ok / duration, 1),
        "p50_ms": pct(0.50),
        "p95_ms": pct(0.95),
        "p99_ms": pct(0.99),
        "batch_occupancy": round(served / batches, 1) if batches else None,
    }


def run_rate(url: str, rate: float, duration: float, workers: int,
             body: bytes, headers: dict, timeout: float, procs: int,
             child_argv) -> dict:
    stats0 = _get_stats(url)
    if procs <= 1:
        results = _generate(url, rate, duration, workers, body, headers,
                            timeout)
    else:
        children = [
            subprocess.Popen(
                child_argv + ["--rates", str(rate / procs),
                              "--workers", str(max(8, workers // procs)),
                              "--_emit-samples"],
                stdout=subprocess.PIPE, cwd=ROOT)
            for _ in range(procs)]
        results = []
        try:
            for c in children:
                out, _ = c.communicate(
                    timeout=duration + timeout + _Worker.LATE_CAP_S + 90)
                if c.returncode:
                    raise RuntimeError(
                        f"generator process exited with {c.returncode}")
                results.extend(tuple(s) for s in json.loads(out))
        finally:
            for c in children:
                if c.poll() is None:
                    c.kill()
                    c.wait(timeout=30)
    stats1 = _get_stats(url)
    # open loop: the send schedule spans `duration` by construction (and
    # the processes' clocks have other bases under --procs)
    pct = _pct(sorted(r[1] for r in results if r[2] == 200))
    n_ok = sum(1 for r in results if r[2] == 200)
    batches = stats1["batches"] - stats0["batches"]
    served = stats1["requests"] - stats0["requests"]
    return {
        "offered_rps": rate,
        "sent": len(results),
        "ok": n_ok,
        "shed_429": sum(1 for r in results if r[2] == 429),
        "client_dropped_late": sum(1 for r in results if r[2] == -2),
        "errors": sum(1 for r in results if r[2] not in (200, 429, -2)),
        "achieved_rps": round(n_ok / max(duration, 1e-9), 1),
        "p50_ms": pct(0.50),
        "p95_ms": pct(0.95),
        "p99_ms": pct(0.99),
        "batch_occupancy": round(served / batches, 1) if batches else None,
        "server_queue_depth_end": stats1["queue_depth"],
    }


def request_body(hw: str, jpeg: bool):
    """The seeded test frame as a request body and its headers."""
    h, w = (int(v) for v in hw.split(","))
    frame = np.random.RandomState(0).randint(0, 255, (h, w, 3),
                                             dtype=np.uint8)
    if jpeg:
        from ..utils.synth import encode_jpeg

        return encode_jpeg(frame), {"Content-Type": "image/jpeg"}
    return frame.tobytes(), {"X-Raw-Shape": f"{h},{w},3",
                             "Content-Type": "application/octet-stream"}


def main(argv=None):
    args = make_parser().parse_args(argv)
    body, headers = request_body(args.hw, args.jpeg)

    if getattr(args, "_emit_samples"):
        results = _generate(args.url, float(args.rates), args.duration,
                            args.workers, body, headers, args.timeout)
        print(json.dumps([[r[0], r[1], r[2]] for r in results]))
        return

    child_argv = [
        sys.executable, "-m", "eop_tpu_torch.tools.load_test_serving",
        "--url", args.url, "--duration", str(args.duration),
        "--hw", args.hw, "--timeout", str(args.timeout),
    ] + (["--jpeg"] if args.jpeg else [])

    proc = None
    try:
        if args.spawn:
            port = urllib.parse.urlparse(args.url).port or 8000
            # --port goes before the user's arguments: serve's trailing
            # `opts` is an argparse REMAINDER, which would swallow anything
            # appended after key-value overrides
            cmd = [sys.executable, "-m", "eop_tpu_torch.tools.serve",
                   "--port", str(port), *shlex.split(args.spawn)]
            print("spawning:", " ".join(cmd), file=sys.stderr, flush=True)
            proc = subprocess.Popen(cmd, cwd=ROOT)
        _wait_healthy(args.url, args.health_timeout, proc)

        # discarded warm pass: the measured steps see steady-state dispatch
        run_closed(args.url, 8, 4.0, body, headers, args.timeout)

        table = []
        if args.closed:
            for n in (int(v) for v in args.closed.split(",")):
                row = run_closed(args.url, n, args.duration, body, headers,
                                 args.timeout)
                table.append(row)
                print(" ".join(f"{k}={v}" for k, v in row.items()),
                      file=sys.stderr, flush=True)
                time.sleep(1.0)
        else:
            for rate in (float(r) for r in args.rates.split(",")):
                row = run_rate(args.url, rate, args.duration, args.workers,
                               body, headers, args.timeout, args.procs,
                               child_argv)
                table.append(row)
                print(" ".join(f"{k}={v}" for k, v in row.items()),
                      file=sys.stderr, flush=True)
                time.sleep(1.0)  # drain between steps
        print(json.dumps(table), flush=True)
    finally:
        if proc is not None:
            proc.terminate()
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=20)


if __name__ == "__main__":
    main()
