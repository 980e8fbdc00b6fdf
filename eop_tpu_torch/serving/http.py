"""Threaded HTTP front end for ``DetectionService`` (stdlib only;
counterpart of ``eop_tpu/serving/http.py``).

Endpoints:

* ``POST /v1/detect`` — body: raw uint8 HWC bytes with an
  ``X-Raw-Shape: H,W,3`` header (no decode; every dim must be positive and
  H*W*3 must equal the body length), or an encoded JPEG/PNG/BMP image,
  decoded by ``data/image_io.imdecode`` (baseline JPEG, PNG and 24-bit BMP
  without OpenCV; other kinds through OpenCV where it is installed, 415
  naming the kind where it is not; a corrupt body 400).
  Response: ``{"detections": [...], "image_hw": [H, W], "ms": float}``
  with coordinates in the posted image's pixel space.
* ``GET /v1/stats`` — batcher/service counters.
* ``GET /healthz`` — liveness.

One thread per in-flight request; each blocks in ``DynamicBatcher.submit``
so concurrent requests coalesce into device batches.  Saturation returns
429, malformed requests 400, batcher errors 500.
"""

from __future__ import annotations

import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..data.image_io import UnsupportedImageError, declared_size, imdecode
from .batcher import BatcherClosedError, QueueFullError

MAX_BODY_BYTES = 32 * 1024 * 1024
# cap on DECODED pixels: a small PNG can declare a huge image, so dims are
# read from the container header (image_io.declared_size) before any decode
MAX_PIXELS = 64 * 1024 * 1024


def _raw_image(raw: bytes, shape_hdr: str):
    try:
        shape = tuple(int(v) for v in shape_hdr.split(","))
    except ValueError:
        shape = ()
    if (len(shape) != 3 or shape[2] != 3 or min(shape) <= 0
            or shape[0] * shape[1] * 3 != len(raw)):
        return None, (400, {
            "error": f"X-Raw-Shape {shape_hdr!r} does not describe the "
                     f"{len(raw)}-byte body as uint8 [H,W,3] with H, W > 0",
        })
    return np.frombuffer(raw, np.uint8).reshape(shape), None


def decode_request_image(raw: bytes, shape_hdr):
    """Request body -> ``(img, None)`` or ``(None, (status, payload))``."""
    if shape_hdr:
        return _raw_image(raw, shape_hdr)
    try:
        dims = declared_size(raw)
    except ValueError as e:
        return None, (400, {"error": f"corrupt image header: {e}"})
    if dims is None:
        return None, (400, {
            "error": "unsupported or corrupt image format "
                     "(JPEG/PNG/BMP, or raw + X-Raw-Shape)",
        })
    if dims[0] * dims[1] > MAX_PIXELS:
        return None, (413, {
            "error": f"image {dims[0]}x{dims[1]} (w x h) exceeds "
                     f"{MAX_PIXELS} decoded pixels",
        })
    try:
        return imdecode(raw), None
    except UnsupportedImageError as e:
        return None, (415, {
            "error": f"{e}; send raw uint8 with X-Raw-Shape: H,W,3"})
    except ValueError as e:
        return None, (400, {"error": f"could not decode image: {e}"})


def make_http_server(service, host: str = "0.0.0.0", port: int = 8000,
                     max_body: int = MAX_BODY_BYTES) -> ThreadingHTTPServer:
    """Build (not start) a ``ThreadingHTTPServer`` serving ``service``.
    Call ``.serve_forever()`` (and ``.shutdown()`` from another thread)."""

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive; every response sets Content-Length
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _send_json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if self.close_connection:
                # set on error paths that leave the body unread: advertise
                # the close so a keep-alive client reconnects
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                self._send_json(200, {"status": "ok"})
            elif self.path == "/v1/stats":
                self._send_json(200, service.stats())
            else:
                self._send_json(404, {"error": "not found"})

        def do_POST(self):  # noqa: N802
            if self.path != "/v1/detect":
                self._send_json(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                # the body boundary is unknowable: close the connection
                self.close_connection = True
                self._send_json(400, {"error": "malformed Content-Length"})
                return
            if not 0 < length <= max_body:
                self.close_connection = True
                self._send_json(
                    413 if length > max_body else 400,
                    {"error": f"body length {length} not in (0, {max_body}]"},
                )
                return
            raw = self.rfile.read(length)
            img, err = decode_request_image(raw, self.headers.get("X-Raw-Shape"))
            if err is not None:
                self._send_json(*err)
                return
            t0 = time.perf_counter()
            try:
                dets = service.detect(img)
            except QueueFullError as e:
                self._send_json(429, {"error": str(e)})
                return
            except (BatcherClosedError, TimeoutError) as e:
                self._send_json(503, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 — report, keep serving
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._send_json(200, {
                "detections": dets,
                "image_hw": [int(img.shape[0]), int(img.shape[1])],
                "ms": round((time.perf_counter() - t0) * 1e3, 2),
            })

    return ThreadingHTTPServer((host, port), Handler)
