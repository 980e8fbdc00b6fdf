"""Serving: dynamic batcher, detection service, HTTP front ends."""

from .batcher import (
    BatcherClosedError,
    DynamicBatcher,
    QueueFullError,
)
from .http import make_http_server
from .http_async import AsyncHTTPServer, make_async_http_server
from .service import DetectionService
