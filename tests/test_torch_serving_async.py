"""The port's event-loop HTTP front end and ``DetectionService.detect_async``
on the CPU, held against ``eop_tpu``'s: the same scripted byte sequences
answered alike by both servers over a stub service, many persistent
connections, the three faults of the JAX package's front end that the port
does not carry (read backpressure, duplicate Content-Length, a GET's
body), ``detect_async`` against ``detect``, and one POST through both async
servers on the same bridged weights."""

import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eop_tpu.exp.yolox_24p_base import Exp24P as JaxExp24P
from eop_tpu.models import init_model
from eop_tpu.serving import make_async_http_server as jax_make_async
from eop_tpu.serving.service import DetectionService as JaxService
from eop_tpu_torch.exp import Exp24P
from eop_tpu_torch.serving import (
    AsyncHTTPServer,
    BatcherClosedError,
    DetectionService,
    QueueFullError,
    make_async_http_server,
)
from eop_tpu_torch.serving.http_async import MAX_HEAD_BYTES
from eop_tpu_torch.utils.synth import encode_png
from eop_tpu_torch.utils.weights import state_dict_from_jax

TIMEOUT = 20.0  # every socket, join and wait in this file is bounded


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StubService:
    """Answers every detect with no detections; ``hold()`` parks the
    callbacks until ``release()`` fires them from another thread, as the
    batcher's dispatcher would."""

    def __init__(self):
        self.n = 0
        self._lock = threading.Lock()
        self._held = None

    def detect_async(self, img, callback):
        with self._lock:
            self.n += 1
            if self._held is not None:
                self._held.append(callback)
                return
        callback([], None)

    def stats(self):
        return {"requests": self.n}

    def hold(self):
        self._held = []

    def release(self):
        with self._lock:
            held, self._held = self._held, None

        def fire():
            for cb in held:
                cb([], None)

        t = threading.Thread(target=fire)
        t.start()
        t.join(TIMEOUT)


class Running:
    """A server of ``make`` over ``service`` on its own thread; stopped and
    joined on exit."""

    def __init__(self, make, service, **kw):
        self.server = make(service, host="127.0.0.1", port=0, **kw)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.thread.join(TIMEOUT)
        assert not self.thread.is_alive()


def connect(port):
    s = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT)
    s.settimeout(TIMEOUT)
    return s


def read_answers(sock, n, until_close=False):
    """Read ``n`` HTTP answers (then, with ``until_close``, on to EOF):
    ``[(status line, Connection header, JSON body without "ms")]`` and
    whether the server closed."""
    buf, out, closed = b"", [], False
    deadline = time.monotonic() + TIMEOUT
    while len(out) < n or (until_close and not closed):
        end = buf.find(b"\r\n\r\n")
        if end >= 0 and len(out) < n:
            head = buf[:end].decode("latin1").split("\r\n")
            fields = {k.lower(): v.strip() for k, _, v in
                      (ln.partition(":") for ln in head[1:])}
            length = int(fields["content-length"])
            if len(buf) >= end + 4 + length:
                body = json.loads(buf[end + 4:end + 4 + length])
                body.pop("ms", None)
                out.append((head[0], fields.get("connection"), body))
                buf = buf[end + 4 + length:]
                continue
        if time.monotonic() > deadline:
            raise AssertionError(f"no answer: {out} {buf[:200]!r}")
        try:
            chunk = sock.recv(65536)
        except ConnectionResetError:
            chunk = b""
        if not chunk:
            closed = True
            break
        buf += chunk
    return out, closed


PNG = encode_png(np.zeros((8, 8, 3), np.uint8))


def post(path, body, extra=b""):
    return (f"POST {path} HTTP/1.1\r\nHost: x\r\nContent-Length: "
            f"{len(body)}\r\n".encode() + extra + b"\r\n" + body)


def get(path, version="HTTP/1.1", extra=b""):
    return f"GET {path} {version}\r\nHost: x\r\n".encode() + extra + b"\r\n"


# name -> (bytes sent on one connection, answers expected)
SCRIPTS = {
    "healthz": (get("/healthz"), 1),
    "stats": (get("/v1/stats"), 1),
    "not_found": (get("/nope") + post("/v1/other", PNG), 2),
    "method": (b"DELETE /v1/detect HTTP/1.1\r\nHost: x\r\n\r\n"
               + get("/healthz"), 2),
    "too_large": (post("/v1/detect", b"z" * 4096), 1),
    "malformed_length": (b"POST /v1/detect HTTP/1.1\r\nContent-Length: "
                         b"abc\r\n\r\n", 1),
    "zero_length": (b"POST /v1/detect HTTP/1.1\r\nContent-Length: 0\r\n\r\n",
                    1),
    "malformed_line": (b"GARBAGE\r\n\r\n", 1),
    "head_too_large": (b"GET /healthz HTTP/1.1\r\nX-Big: "
                       + b"a" * (MAX_HEAD_BYTES + 2048), 1),
    "http10_close": (get("/healthz", "HTTP/1.0"), 1),
    "http10_keep_alive": (get("/healthz", "HTTP/1.0",
                              b"Connection: keep-alive\r\n")
                          + get("/v1/stats"), 2),
    "client_close": (get("/healthz", extra=b"Connection: close\r\n"), 1),
    "bad_raw_shape": (post("/v1/detect", b"\0" * 12,
                           b"X-Raw-Shape: 3,3,3\r\n") + get("/v1/stats"), 2),
    "pipelined": (post("/v1/detect", PNG) + post("/v1/detect", PNG)
                  + get("/v1/stats"), 3),
    "raw_detect": (post("/v1/detect", b"\0" * 48, b"X-Raw-Shape: 4,4,3\r\n"),
                   1),
}


def run_script(make, name):
    data, n = SCRIPTS[name]
    with Running(make, StubService(), max_body=1024) as srv:
        s = connect(srv.port)
        try:
            s.sendall(data)
            answers, closed = read_answers(s, n, until_close=True) \
                if name in CLOSES else read_answers(s, n)
        finally:
            s.close()
        if name == "too_large":  # a reconnect is served as usual
            s = connect(srv.port)
            try:
                s.sendall(post("/v1/detect", PNG))
                answers += read_answers(s, 1)[0]
            finally:
                s.close()
    return answers, closed


CLOSES = {"too_large", "malformed_length", "zero_length", "malformed_line",
          "head_too_large", "http10_close", "client_close"}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_scripted_sequences_answered_as_eop_tpu(name):
    """Status lines, Connection headers and JSON bodies (``ms`` aside) equal
    to ``eop_tpu.serving.make_async_http_server``'s, byte sequence by byte
    sequence; the connection closed where it closes."""
    got, got_closed = run_script(make_async_http_server, name)
    want, want_closed = run_script(jax_make_async, name)
    if name == "bad_raw_shape":
        # the decoder's 400 is shared with the threaded front end, whose
        # message also names the H, W > 0 check eop_tpu lacks: keys only
        got, want = ([(st, c, sorted(b)) for st, c, b in x]
                     for x in (got, want))
    assert got == want
    assert len(got) == SCRIPTS[name][1] + (name == "too_large")
    if name in CLOSES:
        assert got_closed and want_closed
        assert got[0][1] == "close"
    if name == "pipelined":  # in request order: two detects, then stats
        assert [sorted(b) for *_, b in got] == [
            ["detections", "image_hw"]] * 2 + [["requests"]]
        assert got[2][2] == {"requests": 2}


def test_many_persistent_connections():
    """160 persistent connections, every one usable in two rounds."""
    import http.client

    with Running(make_async_http_server, StubService()) as srv:
        conns = []
        try:
            for _ in range(160):
                c = http.client.HTTPConnection("127.0.0.1", srv.port,
                                               timeout=TIMEOUT)
                c.connect()
                conns.append(c)
            for rnd in range(2):
                for i, c in enumerate(conns):
                    c.request("GET", "/healthz")
                    resp = c.getresponse()
                    assert resp.status == 200, (rnd, i)
                    resp.read()
        finally:
            for c in conns:
                c.close()


# ---- the three faults of eop_tpu's front end, repaired ----

def test_reads_pause_while_a_detect_is_pending():
    """A client pipelines several ``max_body`` requests while the detect is
    held: the connection buffers at most one whole request
    (``MAX_HEAD_BYTES + max_body``), and every request is answered once the
    service lets go."""
    max_body, n = 64 * 64 * 3, 8
    body = b"\x07" * max_body
    data = post("/v1/detect", body, b"X-Raw-Shape: 64,64,3\r\n") * n
    stub = StubService()
    stub.hold()
    with Running(make_async_http_server, stub, max_body=max_body) as srv:
        s = connect(srv.port)
        sender = threading.Thread(target=s.sendall, args=(data,),
                                  daemon=True)
        try:
            sender.start()
            most, deadline = 0, time.monotonic() + 1.0
            while time.monotonic() < deadline:
                for c in list(srv.server._conns):
                    most = max(most, len(c.inbuf))
                time.sleep(0.005)
            assert stub.n == 1  # the rest wait unread
            assert 0 < most <= MAX_HEAD_BYTES + max_body
            stub.release()
            answers, _ = read_answers(s, n)
        finally:
            sender.join(TIMEOUT)
            s.close()
        assert not sender.is_alive()
    assert [a[0] for a in answers] == ["HTTP/1.1 200 OK"] * n
    assert stub.n == n


def test_duplicate_content_length_is_400_and_closes():
    with Running(make_async_http_server, StubService()) as srv:
        s = connect(srv.port)
        try:
            s.sendall(b"POST /v1/detect HTTP/1.1\r\nContent-Length: 3\r\n"
                      b"Content-Length: 48\r\nX-Raw-Shape: 4,4,3\r\n\r\n"
                      + b"\0" * 48)
            answers, closed = read_answers(s, 1, until_close=True)
        finally:
            s.close()
    assert answers == [("HTTP/1.1 400 Bad Request", "close",
                        {"error": "duplicate Content-Length"})]
    assert closed


@pytest.mark.parametrize("body_len,closes", [(5, False), (4096, True)])
def test_get_body_is_dropped_or_the_connection_closed(body_len, closes):
    """A GET with a body, then a POST on the same connection: the body goes
    with the GET's head and the POST is answered; a body over ``max_body``
    cannot be skipped, so the GET's answer closes."""
    stub = StubService()
    with Running(make_async_http_server, stub, max_body=1024) as srv:
        s = connect(srv.port)
        try:
            s.sendall(get("/healthz",
                          extra=f"Content-Length: {body_len}\r\n".encode())
                      + b"x" * min(body_len, 5) + post("/v1/detect", PNG))
            answers, closed = read_answers(s, 1 if closes else 2,
                                           until_close=closes)
        finally:
            s.close()
    assert answers[0] == ("HTTP/1.1 200 OK", "close" if closes
                          else "keep-alive", {"status": "ok"})
    if closes:
        assert closed and stub.n == 0
    else:
        assert answers[1] == ("HTTP/1.1 200 OK", "keep-alive",
                              {"detections": [], "image_hw": [8, 8]})


def test_stale_callback_after_close_is_dropped():
    """The client hangs up while its detect is pending; the late callback
    finds the connection gone (``gen``) and the loop serves on."""
    stub = StubService()
    stub.hold()
    with Running(make_async_http_server, stub) as srv:
        s = connect(srv.port)
        s.sendall(post("/v1/detect", PNG))
        deadline = time.monotonic() + TIMEOUT
        while stub.n == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        conn = next(iter(srv.server._conns))
        gen = conn.gen
        srv.server._close_conn(conn)  # as the idle reaper or an error would
        s.close()
        stub.release()
        assert conn.gen == gen + 1
        s = connect(srv.port)
        try:
            s.sendall(get("/v1/stats"))
            answers, _ = read_answers(s, 1)
        finally:
            s.close()
    assert answers[0][2] == {"requests": 1}


# ---- detect_async on the port's service ----

def tiny(exp):
    exp.depth, exp.width, exp.num_classes = 0.33, 0.125, 3
    exp.test_size = (64, 64)
    exp.test_conf = 5e-5  # random-init scores sit near 1e-4
    return exp


@pytest.fixture(scope="module")
def bridged():
    jexp = tiny(JaxExp24P())
    jmodel = jexp.get_model()
    variables = jax.tree_util.tree_map(np.asarray, init_model(
        jmodel, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    exp = tiny(Exp24P())
    model = exp.get_model("cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jexp, jmodel, variables, exp, model


def images(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape, np.uint8)


def call_async(svc, img):
    done, out = threading.Event(), []

    def cb(dets, error):
        out.append((dets, error))
        done.set()

    svc.detect_async(img, cb)
    assert done.wait(TIMEOUT)
    return out


def test_detect_async_equals_detect(bridged):
    *_, exp, model = bridged
    svc = DetectionService.from_exp(exp, model, batch=2, src_hw=(48, 80),
                                    device="cpu", max_wait_ms=1.0)
    try:
        for seed, hw in ((10, (48, 80)), (11, (72, 100))):
            img = images(seed, (*hw, 3))
            want = svc.detect(img)
            (got, error), = call_async(svc, img)
            assert error is None and len(want) > 0
            assert got == want
        with pytest.raises(ValueError, match="uint8 HWC"):
            svc.detect_async(np.zeros((8, 8), np.uint8), None)
    finally:
        svc.close()


class Rows:
    def __init__(self, n):
        self.rows = torch.zeros(n, 4, 29)
        self.valid = torch.zeros(n, 4, dtype=torch.bool)


def test_detect_async_admission_errors_raise_without_callback():
    """QueueFullError and BatcherClosedError raise at once and never call
    the callback; a request still queued when the service closes gets
    BatcherClosedError through its callback."""
    busy, release, armed = threading.Event(), threading.Event(), []

    def serve_fn(canvases):
        if armed:  # not during the warmup call
            busy.set()
            release.wait(TIMEOUT)
        return Rows(len(canvases))

    svc = DetectionService(serve_fn, batch=1, src_hw=(8, 8),
                           test_size=(8, 8), max_wait_ms=0.0, max_queue=1)
    armed.append(True)
    img, calls = np.zeros((8, 8, 3), np.uint8), []
    closer = threading.Thread(target=svc.close)
    try:
        svc.detect_async(img, lambda d, e: calls.append(("first", e)))
        assert busy.wait(TIMEOUT)  # the dispatcher holds the first
        svc.detect_async(img, lambda d, e: calls.append(("queued", e)))
        with pytest.raises(QueueFullError):
            svc.detect_async(img, lambda d, e: calls.append(("shed", e)))
        closer.start()
        deadline = time.monotonic() + TIMEOUT
        while not svc._batcher._closed and time.monotonic() < deadline:
            time.sleep(0.005)
    finally:
        release.set()
        if closer.is_alive() or not svc._batcher._closed:
            closer.join(TIMEOUT)
    assert not closer.is_alive()
    assert [(c, type(e)) for c, e in calls] == [
        ("first", type(None)), ("queued", BatcherClosedError)]
    with pytest.raises(BatcherClosedError):
        svc.detect_async(img, lambda d, e: calls.append(("closed", e)))
    assert len(calls) == 2


def test_callbacks_after_shutdown_are_dropped():
    """The loop has stopped when the service fails its queued requests (as
    ``service.close()`` does after ``server.shutdown()``): the callbacks
    return quietly and queue nothing that is ever sent."""
    stub = StubService()
    stub.hold()
    with Running(make_async_http_server, stub) as srv:
        s = connect(srv.port)
        try:
            s.sendall(post("/v1/detect", PNG))
            deadline = time.monotonic() + TIMEOUT
            while stub.n == 0 and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            s.close()
    held, stub._held = stub._held, None
    for cb in held:
        cb(None, BatcherClosedError("batcher closed"))
    assert len(held) == 1 and not srv.server._conns


def test_port_async_server_matches_jax_async_server(bridged):
    """One POST through each package's event-loop server on the same
    bridged weights (B=2, 64 px): the same detections within the 1e-4
    relative bar of the serving-function parity test."""
    import http.client

    jexp, jmodel, variables, exp, model = bridged
    img = images(12, (64, 64, 3))
    svcs = (DetectionService.from_exp(exp, model, batch=2, device="cpu"),
            JaxService.from_exp(jexp, jmodel, variables, batch=2,
                                warmup=False))
    answers = []
    try:
        for make, svc in ((make_async_http_server, svcs[0]),
                          (jax_make_async, svcs[1])):
            with Running(make, svc) as srv:
                c = http.client.HTTPConnection("127.0.0.1", srv.port,
                                               timeout=120)
                try:
                    c.request("POST", "/v1/detect", body=img.tobytes(),
                              headers={"X-Raw-Shape": "64,64,3"})
                    r = c.getresponse()
                    answers.append((r.status, json.loads(r.read())))
                finally:
                    c.close()
    finally:
        for svc in svcs:
            svc.close()
    (code, got), (jcode, want) = answers
    assert code == jcode == 200
    assert len(got["detections"]) == len(want["detections"]) > 0
    for g, w in zip(got["detections"], want["detections"]):
        assert g["class_id"] == w["class_id"]
        for key in ("center", "radii", "points", "score"):
            np.testing.assert_allclose(g[key], w[key], atol=1e-4, rtol=1e-4)


def test_async_server_class_and_surface():
    server = make_async_http_server(StubService(), host="127.0.0.1", port=0)
    assert isinstance(server, AsyncHTTPServer)
    assert server.server_address[0] == "127.0.0.1"
    server.shutdown()  # never started: returns at once
