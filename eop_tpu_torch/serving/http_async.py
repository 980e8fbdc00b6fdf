"""Event-loop HTTP front end for ``DetectionService`` (stdlib selectors;
counterpart of ``eop_tpu/serving/http_async.py``).

Same endpoints and answers as the threaded front end (``http.py``), but one
IO thread multiplexes every connection:

* N idle persistent connections cost N registered sockets: no thread stack
  each, no accept-queue resets at a few hundred persistent clients.
* ``POST /v1/detect`` parks no thread per request in flight: the body is
  decoded inline and handed to ``DetectionService.detect_async``; the
  batcher's dispatcher thread fires the completion callback, which queues
  the answer and wakes the loop through a self-pipe.  Saturation
  (``QueueFullError``) is answered 429 at once.
* HTTP/1.1 keep-alive and pipelining: the parser stops after a request
  whose answer is pending, so answers go out in request order.  An error
  that leaves a declared body unread closes the connection.

Three faults of the JAX package's front end are not carried over:

* Reads stop while a detect is pending or once a connection has buffered
  ``MAX_HEAD_BYTES + max_body`` bytes (its read event is dropped, and
  re-armed once the answer is out), so a pipelining client cannot make
  the server buffer without bound.  A head whose end lies past
  ``MAX_HEAD_BYTES`` is answered 431, so one whole request always fits.
* A head with two ``Content-Length`` headers is answered 400 and the
  connection closed (not the last one wins).
* A GET (or any other method but POST) with a declared body drops the
  body with the head; where it cannot (over ``max_body``) the answer
  closes the connection.

The public surface is ``ThreadingHTTPServer``'s: ``server_address``,
``serve_forever()``, ``shutdown()``.
"""

from __future__ import annotations

import json
import selectors
import socket
import threading
import time
from collections import deque

from .batcher import BatcherClosedError, QueueFullError
from .http import MAX_BODY_BYTES, decode_request_image

MAX_HEAD_BYTES = 32 * 1024
IDLE_TIMEOUT_S = 600.0  # connections idle this long are closed
REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
           405: "Method Not Allowed", 413: "Payload Too Large",
           415: "Unsupported Media Type", 429: "Too Many Requests",
           431: "Header Too Large", 500: "Internal Server Error",
           503: "Service Unavailable"}


class _Conn:
    __slots__ = ("sock", "inbuf", "outbuf", "awaiting", "closing", "events",
                 "last_active", "gen")

    def __init__(self, sock):
        self.sock = sock
        self.inbuf = bytearray()
        self.outbuf = bytearray()
        self.awaiting = False   # a detect answer is pending: parse, read no more
        self.closing = False    # close once outbuf drains
        self.events = selectors.EVENT_READ  # as registered with the selector
        self.last_active = time.monotonic()
        self.gen = 0  # bumped on close; stale callbacks check it


def _parse_head(head: bytes):
    """Request head bytes -> (method, path, version, headers lower-cased).
    Raises ``ValueError`` on a malformed request line or a second
    ``Content-Length``."""
    lines = head.split(b"\r\n")
    parts = lines[0].split()
    if len(parts) != 3:
        raise ValueError(f"malformed request line {lines[0][:64]!r}")
    method, path, version = (p.decode("latin1") for p in parts)
    headers = {}
    for ln in lines[1:]:
        if not ln:
            continue
        k, _, v = ln.partition(b":")
        key = k.strip().lower().decode("latin1")
        if key == "content-length" and key in headers:
            raise ValueError("duplicate Content-Length")
        headers[key] = v.strip().decode("latin1")
    return method, path, version, headers


class AsyncHTTPServer:
    """selectors-based single-thread HTTP server over a DetectionService."""

    def __init__(self, service, host: str = "0.0.0.0", port: int = 8000,
                 max_body: int = MAX_BODY_BYTES):
        self._service = service
        self._max_body = max_body
        # what one connection may buffer: one whole request
        self._max_inbuf = MAX_HEAD_BYTES + max_body
        self._listen = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listen.bind((host, port))
        self._listen.listen(1024)
        self._listen.setblocking(False)
        self.server_address = self._listen.getsockname()
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._listen, selectors.EVENT_READ, "accept")
        # self-pipe: batcher callbacks (the dispatcher thread) queue answers
        # and poke the loop awake.  The write end never blocks the
        # dispatcher: a full pipe already holds a wake-up.
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        self._done: deque = deque()  # (conn, gen, status, payload, close)
        self._running = False
        self._stopped = threading.Event()
        self._stopped.set()  # not running yet: shutdown() must not block
        self._conns: set = set()

    # ------------------------------------------------------------ lifecycle

    def serve_forever(self):
        self._running = True
        self._stopped.clear()
        try:
            last_reap = time.monotonic()
            while self._running:
                for key, _ in self._sel.select(timeout=0.2):
                    if key.data == "accept":
                        self._accept()
                    elif key.data == "wake":
                        self._drain_wake()
                    else:
                        self._service_conn(key.data)
                self._flush_done()
                now = time.monotonic()
                if now - last_reap > 30.0:
                    last_reap = now
                    for c in [c for c in self._conns
                              if not c.awaiting
                              and now - c.last_active > IDLE_TIMEOUT_S]:
                        self._close_conn(c)
        finally:
            for c in list(self._conns):
                self._close_conn(c)
            self._sel.unregister(self._listen)
            self._sel.unregister(self._wake_r)
            self._listen.close()
            self._wake_r.close()
            self._wake_w.close()
            self._sel.close()
            self._stopped.set()

    def shutdown(self):
        self._running = False
        self._wake()
        self._stopped.wait(timeout=10)

    def _wake(self):
        try:
            self._wake_w.send(b"x")
        except OSError:  # full (a wake-up is pending) or closed
            pass

    # ------------------------------------------------------------ IO events

    def _accept(self):
        while True:
            try:
                sock, _ = self._listen.accept()
            except OSError:  # BlockingIOError: nothing more to accept
                return
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _Conn(sock)
            self._conns.add(conn)
            self._sel.register(sock, selectors.EVENT_READ, conn)

    def _service_conn(self, conn: _Conn):
        conn.last_active = time.monotonic()
        if conn.events & selectors.EVENT_READ:
            try:
                while True:
                    room = min(65536, self._max_inbuf - len(conn.inbuf))
                    if room <= 0:
                        break
                    chunk = conn.sock.recv(room)
                    if not chunk:  # peer closed
                        if not conn.outbuf:
                            self._close_conn(conn)
                            return
                        conn.closing = True
                        break
                    conn.inbuf += chunk
                    if len(chunk) < room:
                        break
            except BlockingIOError:
                pass
            except OSError:
                self._close_conn(conn)
                return
            self._advance(conn)
        self._try_write(conn)

    def _advance(self, conn: _Conn):
        """Parse and handle as many complete requests as are buffered,
        stopping while an async answer is pending (ordering)."""
        while not conn.awaiting and not conn.closing:
            end = conn.inbuf.find(b"\r\n\r\n")
            if end < 0 or end + 4 > MAX_HEAD_BYTES:
                if end >= 0 or len(conn.inbuf) >= MAX_HEAD_BYTES:
                    self._respond(conn, 431,
                                  {"error": "request head too large"},
                                  close=True)
                return
            try:
                method, path, version, headers = _parse_head(
                    bytes(conn.inbuf[:end]))
            except ValueError as e:
                self._respond(conn, 400, {"error": str(e)}, close=True)
                return
            try:
                length = int(headers.get("content-length", "0"))
            except ValueError:
                # the body's end is unknowable: close
                self._respond(conn, 400,
                              {"error": "malformed Content-Length"},
                              close=True)
                return
            close = self._client_close(version, headers)

            if method != "POST":
                # a declared body goes with the head; one that cannot be
                # buffered (or measured) cannot be skipped: the answer closes
                if not 0 <= length <= self._max_body:
                    close = True
                elif len(conn.inbuf) < end + 4 + length:
                    return  # body not fully buffered yet
                del conn.inbuf[:end + 4 + length]
                if method == "GET":
                    self._handle_get(conn, path, close)
                else:
                    self._respond(conn, 405, {"error": "method not allowed"},
                                  close=close)
                continue

            if not 0 < length <= self._max_body:
                # refusing to read the declared body -> close
                self._respond(
                    conn, 413 if length > self._max_body else 400,
                    {"error": f"body length {length} not in "
                              f"(0, {self._max_body}]"},
                    close=True,
                )
                return
            if len(conn.inbuf) < end + 4 + length:
                return  # body not fully buffered yet
            body = bytes(conn.inbuf[end + 4:end + 4 + length])
            del conn.inbuf[:end + 4 + length]
            self._handle_post(conn, path, headers, body, close)

    @staticmethod
    def _client_close(version, headers) -> bool:
        c = headers.get("connection", "").lower()
        if version == "HTTP/1.0":
            return c != "keep-alive"
        return c == "close"

    # ------------------------------------------------------------ handlers

    def _handle_get(self, conn, path, close):
        if path == "/healthz":
            self._respond(conn, 200, {"status": "ok"}, close=close)
        elif path == "/v1/stats":
            self._respond(conn, 200, self._service.stats(), close=close)
        else:
            self._respond(conn, 404, {"error": "not found"}, close=close)

    def _handle_post(self, conn, path, headers, body, close):
        if path != "/v1/detect":
            self._respond(conn, 404, {"error": "not found"}, close=close)
            return
        img, err = decode_request_image(body, headers.get("x-raw-shape"))
        if err is not None:
            self._respond(conn, *err, close=close)
            return
        t0 = time.perf_counter()
        gen = conn.gen

        def on_done(dets, error):
            # runs on the batcher's dispatcher thread
            if error is None:
                status, payload = 200, {
                    "detections": dets,
                    "image_hw": [int(img.shape[0]), int(img.shape[1])],
                    "ms": round((time.perf_counter() - t0) * 1e3, 2),
                }
            elif isinstance(error, (BatcherClosedError, TimeoutError)):
                status, payload = 503, {"error": str(error)}
            else:
                status, payload = 500, {
                    "error": f"{type(error).__name__}: {error}"}
            self._done.append((conn, gen, status, payload, close))
            self._wake()

        try:
            self._service.detect_async(img, on_done)
        except QueueFullError as e:
            self._respond(conn, 429, {"error": str(e)}, close=close)
            return
        except BatcherClosedError as e:
            self._respond(conn, 503, {"error": str(e)}, close=close)
            return
        except Exception as e:  # noqa: BLE001 — answer, keep the loop alive
            self._respond(conn, 500,
                          {"error": f"{type(e).__name__}: {e}"}, close=close)
            return
        conn.awaiting = True

    # ------------------------------------------------------------ answers

    def _drain_wake(self):
        try:
            while self._wake_r.recv(4096):
                pass
        except OSError:  # BlockingIOError: drained
            pass

    def _flush_done(self):
        while self._done:
            conn, gen, status, payload, close = self._done.popleft()
            if conn not in self._conns or conn.gen != gen:
                continue  # the connection closed while the batch ran
            conn.awaiting = False
            self._respond(conn, status, payload, close=close)
            self._advance(conn)  # pipelined follow-up requests
            self._try_write(conn)

    def _respond(self, conn, status, payload, close=False):
        body = json.dumps(payload).encode()
        head = (
            f"HTTP/1.1 {status} {REASONS.get(status, '')}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: {'close' if close else 'keep-alive'}\r\n\r\n"
        ).encode("latin1")
        conn.outbuf += head + body
        if close:
            conn.closing = True
        self._try_write(conn)

    def _try_write(self, conn):
        if conn not in self._conns:
            return
        if conn.outbuf:
            try:
                n = conn.sock.send(conn.outbuf)
                del conn.outbuf[:n]
            except BlockingIOError:
                pass
            except OSError:
                self._close_conn(conn)
                return
        if conn.closing and not conn.outbuf:
            self._close_conn(conn)
            return
        self._arm(conn)

    def _arm(self, conn):
        """Register the events the connection can take now: reads only
        while no answer is pending and the buffer has room (backpressure),
        writes while output waits."""
        reading = (not conn.awaiting and not conn.closing
                   and len(conn.inbuf) < self._max_inbuf)
        events = ((selectors.EVENT_READ if reading else 0)
                  | (selectors.EVENT_WRITE if conn.outbuf else 0))
        if events == conn.events:
            return
        try:
            if not events:
                self._sel.unregister(conn.sock)
            elif not conn.events:
                self._sel.register(conn.sock, events, conn)
            else:
                self._sel.modify(conn.sock, events, conn)
        except (KeyError, ValueError, OSError):
            pass
        conn.events = events

    def _close_conn(self, conn):
        if conn not in self._conns:
            return
        self._conns.discard(conn)
        conn.gen += 1
        if conn.events:
            try:
                self._sel.unregister(conn.sock)
            except (KeyError, ValueError):
                pass
        try:
            conn.sock.close()
        except OSError:
            pass


def make_async_http_server(service, host: str = "0.0.0.0",
                           port: int = 8000,
                           max_body: int = MAX_BODY_BYTES) -> AsyncHTTPServer:
    """Build (not start) the event-loop server: the same call surface as
    ``make_http_server``."""
    return AsyncHTTPServer(service, host, port, max_body=max_body)
