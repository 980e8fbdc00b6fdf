"""Profiling and tracing (counterpart of ``eop_tpu/utils/profiler.py``, with
``device_op_table`` in place of ``eop_tpu/utils/xplane.py``'s):
``torch.profiler`` where ``eop_tpu`` has ``jax.profiler``.

    with trace("/tmp/eop_trace", warmup=1) as prof:
        for _ in range(1 + steps):
            state, metrics = step(state, imgs, labels)
            prof.step()
    for name, ms in device_op_table("/tmp/eop_trace", top=20):
        print(f"{ms:10.3f} ms  {name}")

A trace writes ``trace.json`` (Chrome's trace format: ``chrome://tracing``
or Perfetto) and ``ops.json`` (the operators' totals that
:func:`device_op_table` reads) into its directory.  Device time is the
CUDA kernels' (and copies' and sets') where the profile holds any; a
profile of a CPU run has none, and its operators' self time on the host
stands in for it.  Kernels are named by their function, without template
arguments or namespace (``conv_taps_kernel``), and fall into the
categories of :data:`CATEGORIES`, every name into exactly one.

``ProfileServer`` is the trainers' ``--profile-port``: PyTorch has no
profiler server, so rank 0 answers ``GET /capture?duration_ms=N`` on that
port over HTTP.  A request arms ``torch.profiler`` at the next step
boundary; the step after it is a warm-up (the profiler misses a trace's
first kernels otherwise), then the steps are recorded until ``N`` ms have
passed (at least one step).  The answer is JSON: the trace's directory,
the steps recorded, the two tables (``by category``, ``top ops``) as
``[name, ms, calls]`` rows and the hand kernels' launch counters over the
recorded steps (:func:`launch_counts`).  :func:`attach` is the client
(``tools/profile_train.py --attach``).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch

TRACE_FILE = "trace.json"
OPS_FILE = "ops.json"

# the port's hand-written kernels (csrc/*.cu), by function name
HAND_KERNELS = (
    "conv_taps_kernel", "conv_rows_kernel", "conv1x1_small_kernel",
    "conv_nhwc_kernel", "wgrad_tc_kernel", "wgrad_tc_reduce_kernel",
    "wgrad_partial_kernel", "wgrad_reduce_kernel", "dgrad_tc_kernel",
    "dgrad_kernel", "pack_taps_kernel")

# (category, fragments of a lower-cased name): the first that matches
# names the category; a name matching none is "other"
CATEGORIES = (
    ("collective", ("nccl", "allreduce", "all_reduce", "allgather",
                    "all_gather", "reduce_scatter", "reducescatter",
                    "broadcast", "gloo", "c10d")),
    ("cuDNN convolution", ("conv", "cudnn", "implicit_gemm", "fprop",
                           "dgrad", "wgrad", "winograd", "im2col")),
    ("GEMM", ("gemm", "gemv", "cutlass", "matmul", "aten::mm", "aten::bmm",
              "aten::addmm", "aten::linear", "_int_mm")),
    ("copy and set", ("memcpy", "memset", "copy", "fill", "zero",
                      "catarray", "aten::cat", "clone", "contiguous",
                      "aten::index", "gather", "scatter", "aten::stack",
                      "aten::pad")),
    ("reduction", ("reduce", "aten::sum", "aten::mean", "norm", "aten::max",
                   "aten::min", "aten::argmax", "topk", "sort", "scan",
                   "softmax", "statistics", "nonzero", "unique", "pool",
                   "aten::any", "aten::all")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "pointwise",
                     "silu", "sigmoid", "aten::add", "aten::mul",
                     "aten::sub", "aten::div", "aten::exp", "aten::log",
                     "aten::where", "aten::clamp", "aten::pow", "aten::sqrt",
                     "aten::rsqrt", "aten::abs", "aten::relu", "aten::neg",
                     "aten::lerp", "aten::sin", "aten::cos", "aten::atan",
                     "aten::eq", "aten::ne", "aten::lt", "aten::gt",
                     "aten::le", "aten::ge", "aten::round", "aten::floor",
                     "aten::bitwise", "aten::logical", "aten::minimum",
                     "aten::maximum")),
)
CATEGORY_NAMES = ("hand kernels",) + tuple(c for c, _ in CATEGORIES) + (
    "other",)


def kernel_name(key: str) -> str:
    """A profiler key (a demangled kernel signature or an operator name)
    without ``void``, the anonymous namespace, template arguments and
    parameters: ``void (anonymous namespace)::conv_taps_kernel<float,
    3>(...)`` -> ``conv_taps_kernel``."""
    name = key.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in ("<", "("):
        if stop in name:
            name = name[:name.index(stop)]
    return name.strip() or key


def category(name: str) -> str:
    """The category of a :func:`kernel_name`."""
    if name.rsplit("::", 1)[-1] in HAND_KERNELS:
        return "hand kernels"
    low = name.lower()
    for cat, fragments in CATEGORIES:
        if any(f in low for f in fragments):
            return cat
    return "other"


def launch_counts() -> dict:
    """``phase_conv``'s launch counters (the hand kernels' wrappers count
    where they launch): ``forward``, ``wgrad``, ``dgrad``, ``pack``, and
    the first three by variant (``"forward:wgmma_taps"``, ...)."""
    from ..ops.phase_conv import phase_conv

    counts = {"forward": phase_conv.launches,
              "wgrad": phase_conv.wgrad_launches,
              "dgrad": phase_conv.dgrad_launches,
              "pack": phase_conv.pack_launches}
    for kind, by in (("forward", phase_conv.variant_launches),
                     ("wgrad", phase_conv.wgrad_variant_launches),
                     ("dgrad", phase_conv.dgrad_variant_launches)):
        counts.update({f"{kind}:{v}": n for v, n in by.items()})
    return counts


def launches_since(before: dict) -> dict:
    """:func:`launch_counts` less ``before`` (variants that did not
    launch left out)."""
    return {k: n - before.get(k, 0) for k, n in launch_counts().items()
            if n - before.get(k, 0) or ":" not in k}


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def op_rows(prof) -> List[dict]:
    """The device's operators of a finished profile: ``{"key", "device",
    "calls", "us"}`` each, CUDA kernels where the profile holds any, else
    the CPU operators' self time.  Annotated ranges (the profiler's
    ``ProfilerStep#N``, ``record_function``'s) are not operators: on the
    device they span kernels counted already."""
    events = [e for e in prof.key_averages()
              if not (getattr(e, "is_user_annotation", False)
                      or e.key.startswith("ProfilerStep"))]
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type == cuda]
    if kernels:
        return [{"key": e.key, "device": "cuda", "calls": int(e.count),
                 "us": float(e.self_device_time_total)} for e in kernels]
    return [{"key": e.key, "device": "cpu", "calls": int(e.count),
             "us": float(e.self_cpu_time_total)} for e in events]


def write_trace(prof, logdir: str) -> None:
    """``prof``'s Chrome trace and operator totals into ``logdir``."""
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
    with open(os.path.join(logdir, OPS_FILE), "w") as f:
        json.dump(op_rows(prof), f)


@contextlib.contextmanager
def trace(logdir: str, warmup: int = 0) -> Iterator:
    """Profile the body (CPU operators, and CUDA kernels where a card is
    present) and write its trace into ``logdir`` at the end.  With
    ``warmup`` the body marks its steps with ``prof.step()``: the first
    ``warmup`` run under the profiler unrecorded, the rest are recorded."""
    schedule = None
    if warmup:
        schedule = torch.profiler.schedule(wait=0, warmup=warmup,
                                           active=1 << 30, repeat=1)
    prof = torch.profiler.profile(activities=_activities(),
                                  schedule=schedule)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
    write_trace(prof, logdir)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region inside a trace (a range on the timeline)."""
    with torch.profiler.record_function(name):
        yield


class StepTimer:
    """Rolling step timer that waits for the device once a report
    interval."""

    def __init__(self, interval: int = 50):
        self.interval = interval
        self._count = 0
        self._start: Optional[float] = None

    def tick(self, sync_handle=None) -> Optional[float]:
        """Returns steps/sec every ``interval`` calls, else None; with a
        CUDA tensor as ``sync_handle`` the card is waited for first."""
        if self._start is None:
            self._start = time.perf_counter()
            self._count = 0
            return None
        self._count += 1
        if self._count % self.interval == 0:
            if getattr(sync_handle, "is_cuda", False):
                torch.cuda.synchronize(sync_handle.device)
            now = time.perf_counter()
            rate = self.interval / (now - self._start)
            self._start = now
            self._count = 0
            return rate
        return None


def _rows_of(src) -> List[dict]:
    if isinstance(src, (str, os.PathLike)):
        path = os.path.join(src, OPS_FILE)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no {OPS_FILE} under {src}")
        with open(path) as f:
            return json.load(f)
    return op_rows(src)


def op_table(src, top: int = 25,
             by_category: bool = False) -> List[Tuple[str, float, int]]:
    """``(name, ms, calls)`` rows of device time, by kernel name or by
    category, most time first, the first ``top``.  ``src`` is a finished
    profile or a directory :func:`trace` wrote."""
    totals: Dict[str, List[float]] = {}
    for r in _rows_of(src):
        name = kernel_name(r["key"])
        key = category(name) if by_category else name
        t = totals.setdefault(key, [0.0, 0])
        t[0] += r["us"] / 1e3
        t[1] += r["calls"]
    rows = sorted(((k, ms, int(n)) for k, (ms, n) in totals.items()),
                  key=lambda r: (-r[1], r[0]))
    return rows[:top]


def device_op_table(src, top: int = 25,
                    by_category: bool = False) -> List[Tuple[str, float]]:
    """``(name, ms)`` rows of :func:`op_table` (``eop_tpu``'s
    ``device_op_table``)."""
    return [(name, ms) for name, ms, _ in op_table(src, top, by_category)]


def tables(src, top: int = 25) -> Dict[str, list]:
    """Both tables of ``src``, ``{"by category": rows, "top ops": rows}``
    (rows as :func:`op_table`'s)."""
    return {"by category": op_table(src, top, True),
            "top ops": op_table(src, top, False)}


class _Request:
    def __init__(self, duration_ms: float, logdir: Optional[str], top: int):
        self.duration_ms = duration_ms
        self.logdir = logdir
        self.top = top
        self.done = threading.Event()
        self.answer: Tuple[int, dict] = (503, {"error": "no answer"})

    def reply(self, code: int, body: dict) -> None:
        self.answer = (code, body)
        self.done.set()


class ProfileServer:
    """Live profiling of a training run (``--profile-port``): an HTTP
    listener on ``port`` in a thread of its own, and :meth:`step`, which
    the trainer calls in its loop after every optimizer step (and which
    costs one attribute read while no capture is asked for).  A capture
    waits for the device at each of its step boundaries and changes
    nothing the step computes.  ``root`` holds the traces whose request
    names no directory (``profile_<time>``); :meth:`close` ends a capture
    in progress with what it recorded and stops the listener."""

    def __init__(self, port: int, root: str, host: str = ""):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qs, urlparse

        self.root = root
        self._lock = threading.Lock()
        self._pending: Optional[_Request] = None
        self._capture = None
        self._closed = False
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                url = urlparse(self.path)
                if url.path != "/capture":
                    return self._send(404, {"error": "GET /capture"})
                q = {k: v[-1] for k, v in parse_qs(url.query).items()}
                try:
                    req = _Request(float(q.get("duration_ms", 3000)),
                                   q.get("logdir"), int(q.get("top", 25)))
                except ValueError as e:
                    return self._send(400, {"error": str(e)})
                code, body = server._submit(req)
                self._send(code, body)

            def _send(self, code, body):
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="profile-server", daemon=True)
        self._thread.start()

    def _submit(self, req: _Request):
        with self._lock:
            if self._closed:
                return 503, {"error": "the training run has ended"}
            if self._pending is not None or self._capture is not None:
                return 409, {"error": "another capture is in progress"}
            self._pending = req
        req.done.wait()
        return req.answer

    def step(self) -> None:
        """A step boundary: start a capture asked for, move one in
        progress on, and finish it once its window has passed."""
        cap = self._capture
        if cap is None:
            if self._pending is None:
                return
            prof = torch.profiler.profile(
                activities=_activities(),
                schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                 active=1 << 30, repeat=1))
            with self._lock:  # a request sees the pending one or this
                req, self._pending = self._pending, None
                self._capture = {"req": req, "prof": prof, "t0": None,
                                 "steps": 0}
            prof.start()
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        cap["prof"].step()
        if cap["t0"] is None:  # the warm-up step has ended
            cap["t0"] = time.perf_counter()
            cap["counts"] = launch_counts()
            return
        cap["steps"] += 1
        if (time.perf_counter() - cap["t0"]) * 1e3 >= cap["req"].duration_ms:
            self._finish()

    def _finish(self) -> None:
        with self._lock:
            cap, self._capture = self._capture, None
        req, prof = cap["req"], cap["prof"]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window_ms = (time.perf_counter() - (cap["t0"] or 0.0)) * 1e3
        prof.stop()
        if not cap["steps"]:
            req.reply(503, {"error": "the training run ended before a step "
                                     "was recorded"})
            return
        logdir = req.logdir or os.path.join(
            self.root, time.strftime("profile_%Y_%m_%d_%H_%M_%S"))
        write_trace(prof, logdir)
        req.reply(200, {"logdir": os.path.abspath(logdir),
                        "steps": cap["steps"],
                        "window_ms": window_ms,
                        "tables": tables(logdir, req.top),
                        "launches": launches_since(cap["counts"])})

    def close(self) -> None:
        """End of training: finish a capture in progress, refuse what is
        asked from now on, stop listening."""
        with self._lock:
            self._closed = True
            pending, self._pending = self._pending, None
        if self._capture is not None:
            self._finish()
        if pending is not None:
            pending.reply(503, {"error": "the training run ended before a "
                                         "step was recorded"})
        self.httpd.shutdown()
        self.httpd.server_close()


def profile_server(args, is_main: bool, root: str) -> Optional[ProfileServer]:
    """The trainers' ``--profile-port``: a :class:`ProfileServer` on
    ``args.profile_port`` on rank 0 (its traces under ``root``), else
    None."""
    port = getattr(args, "profile_port", None)
    if not port or not is_main:
        return None
    from .logger import logger

    server = ProfileServer(port, root)
    logger.info(f"profiler listening on port {server.port}: GET "
                f"/capture?duration_ms=N, or tools.profile_train --attach "
                f"HOST:{server.port}")
    return server


def attach(address: str, duration_ms: float = 3000, logdir: str = None,
           top: int = 25, timeout: float = 3600.0) -> dict:
    """Ask the trainer at ``address`` (``HOST:PORT``, its
    ``--profile-port``) for a capture of ``duration_ms`` and return its
    answer (``logdir``, ``steps``, ``window_ms``, ``tables``); a refusal
    raises ``RuntimeError`` with the trainer's reason."""
    import urllib.error
    import urllib.parse
    import urllib.request

    host, _, port = address.rpartition(":")
    query = {"duration_ms": duration_ms, "top": top}
    if logdir:
        query["logdir"] = os.path.abspath(logdir)
    url = (f"http://{host or '127.0.0.1'}:{int(port)}/capture?"
           + urllib.parse.urlencode(query))
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        raise RuntimeError(f"{address}: {json.loads(e.read()).get('error')}"
                           ) from None
