"""Dynamic request batching for the serving function (the port's copy of
``eop_tpu/serving/batcher.py``).

Clients send one image at a time; the device wants batches.  This module
owns the gap — requests queue up, a dispatcher thread coalesces up to
``max_batch`` of them (waiting at most ``max_wait_ms`` after the first
arrival), the whole batch runs as ONE device call, and each caller gets
its own slice back.  Design notes:

* Per-request latency is bounded by ``max_wait_ms`` + one device step:
  the dispatcher never waits for a full batch, it dispatches whatever
  arrived inside the window.
* Backpressure: a bounded queue; `submit` fails fast with
  ``QueueFullError`` when the server is saturated rather than growing
  an unbounded backlog (the caller should shed load / retry).
* One dispatcher thread, one device call in flight at a time — the call
  is already batched, so in-flight parallelism buys nothing.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional


class QueueFullError(RuntimeError):
    """The request queue is at capacity — shed load."""


class BatcherClosedError(RuntimeError):
    """The batcher was shut down while the request waited."""


@dataclass
class _Pending:
    item: Any
    done: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Optional[BaseException] = None
    t_enqueue: float = 0.0
    cost: float = 0.0
    # completion callback (submit_nowait): called exactly once with
    # (result, error) from the dispatcher thread after the batch settles
    callback: Optional[Callable[[Any, Optional[BaseException]], None]] = None


class DynamicBatcher:
    """Coalesce blocking single-item ``submit`` calls into batched runs.

    Args:
      run_batch: ``list[item] -> list[result]`` (same length/order).  Runs
        on the dispatcher thread; an exception fails every request in
        that batch (and only that batch).
      max_batch: hard upper bound per ``run_batch`` call (the compiled
        device batch).
      max_wait_ms: how long the dispatcher holds the first request of a
        batch open for stragglers.
      max_queue: bound on waiting requests beyond the batch in flight.
      max_queue_cost: optional bound on the summed ``cost`` of admitted
        but not-yet-completed requests (callers pass ``cost=`` bytes or
        any other unit).  Count-based bounds alone under-protect when
        each item holds a large buffer (e.g. a 4K letterbox canvas);
        this sheds load by memory, not just by depth.  A single request
        over the bound is still admitted when the batcher is idle, so
        one oversized item cannot deadlock itself.
    """

    def __init__(self, run_batch: Callable[[List[Any]], List[Any]],
                 max_batch: int, max_wait_ms: float = 5.0,
                 max_queue: int = 256,
                 max_queue_cost: Optional[float] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._run_batch = run_batch
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self._q: "queue.Queue[_Pending]" = queue.Queue(maxsize=max_queue)
        self._closed = False
        self._lock = threading.Lock()
        self._max_cost = max_queue_cost
        self._cost_used = 0.0  # under _lock
        # stats (under _lock)
        self._n_requests = 0
        self._n_batches = 0
        self._n_batched_items = 0
        self._n_errors = 0
        self._lat_ring: List[float] = []  # seconds, last 512 requests
        self._thread = threading.Thread(
            target=self._dispatch_loop, name="eop-batcher", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------- client

    def submit(self, item: Any, timeout: Optional[float] = None,
               cost: float = 0.0) -> Any:
        """Block until ``item``'s result is ready and return it.

        Raises ``QueueFullError`` on saturation (queue depth or summed
        ``cost`` over ``max_queue_cost``), ``BatcherClosedError`` after
        ``close()``, ``TimeoutError`` past ``timeout`` seconds, or
        whatever ``run_batch`` raised for this batch.
        """
        p = _Pending(item=item, t_enqueue=time.perf_counter(), cost=cost)
        # closed-check, cost admission and put are one atomic section so
        # close() (which sets _closed under the same lock before draining)
        # can never strand a request that raced past the check.
        with self._lock:
            if self._closed:
                raise BatcherClosedError("batcher is closed")
            if (self._max_cost is not None and self._cost_used > 0
                    and self._cost_used + cost > self._max_cost):
                raise QueueFullError(
                    f"queued request cost at capacity "
                    f"({self._cost_used:.0f}+{cost:.0f} > {self._max_cost:.0f})"
                )
            try:
                self._q.put_nowait(p)
            except queue.Full:
                raise QueueFullError(
                    f"request queue at capacity ({self._q.maxsize})"
                ) from None
            self._cost_used += cost
        if not p.done.wait(timeout):
            # the dispatcher may still complete it; the caller is gone
            raise TimeoutError("request timed out in the batcher")
        if p.error is not None:
            raise p.error
        return p.result

    def submit_nowait(
        self, item: Any,
        callback: Callable[[Any, Optional[BaseException]], None],
        cost: float = 0.0,
    ) -> None:
        """Enqueue ``item`` without blocking; ``callback(result, error)``
        fires exactly once from the dispatcher thread when its batch
        settles (``error`` is the batch exception, or a
        ``BatcherClosedError`` if the batcher closes first).

        Admission failures (``QueueFullError`` / ``BatcherClosedError``)
        are raised synchronously — the callback is NOT invoked for them.
        An event-loop front end builds on this: no thread is parked per
        in-flight request.
        """
        p = _Pending(item=item, t_enqueue=time.perf_counter(), cost=cost,
                     callback=callback)
        with self._lock:
            if self._closed:
                raise BatcherClosedError("batcher is closed")
            if (self._max_cost is not None and self._cost_used > 0
                    and self._cost_used + cost > self._max_cost):
                raise QueueFullError(
                    f"queued request cost at capacity "
                    f"({self._cost_used:.0f}+{cost:.0f} > {self._max_cost:.0f})"
                )
            try:
                self._q.put_nowait(p)
            except queue.Full:
                raise QueueFullError(
                    f"request queue at capacity ({self._q.maxsize})"
                ) from None
            self._cost_used += cost

    def stats(self) -> dict:
        with self._lock:
            lat = sorted(self._lat_ring)
            pct = (lambda q: lat[min(len(lat) - 1, int(q * len(lat)))]
                   if lat else 0.0)
            return {
                "requests": self._n_requests,
                "batches": self._n_batches,
                "errors": self._n_errors,
                "mean_batch_occupancy": (
                    self._n_batched_items / self._n_batches
                    if self._n_batches else 0.0
                ),
                "latency_ms_p50": round(pct(0.50) * 1e3, 2),
                "latency_ms_p99": round(pct(0.99) * 1e3, 2),
                "queue_depth": self._q.qsize(),
                "queue_cost": self._cost_used,
                "max_batch": self.max_batch,
                "max_wait_ms": self.max_wait * 1e3,
            }

    def close(self, timeout: float = 5.0) -> None:
        """Stop accepting work, fail queued requests, join the thread."""
        with self._lock:
            # after this, submit() cannot admit anything (same lock), so
            # the drain below sees every request that will ever exist
            self._closed = True
        self._thread.join(timeout)
        while True:
            try:
                p = self._q.get_nowait()
            except queue.Empty:
                break
            p.error = BatcherClosedError("batcher closed")
            p.done.set()
            if p.callback is not None:
                try:
                    p.callback(None, p.error)
                except Exception:  # noqa: BLE001
                    pass

    # --------------------------------------------------------- dispatcher

    def _collect(self) -> List[_Pending]:
        """One batch: block for the first request, then drain stragglers
        until the window closes or the batch fills."""
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_wait
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _dispatch_loop(self) -> None:
        while not self._closed:
            batch = self._collect()
            if not batch:
                continue
            try:
                results = self._run_batch([p.item for p in batch])
                if len(results) != len(batch):
                    raise RuntimeError(
                        f"run_batch returned {len(results)} results for "
                        f"{len(batch)} items"
                    )
                for p, r in zip(batch, results):
                    p.result = r
            except BaseException as e:  # noqa: BLE001 — fail the batch, not the server
                for p in batch:
                    p.error = e
            now = time.perf_counter()
            with self._lock:
                self._cost_used -= sum(p.cost for p in batch)
                self._n_requests += len(batch)
                self._n_batches += 1
                self._n_batched_items += len(batch)
                if batch[0].error is not None:
                    self._n_errors += len(batch)
                for p in batch:
                    self._lat_ring.append(now - p.t_enqueue)
                if len(self._lat_ring) > 512:
                    del self._lat_ring[:-512]
            for p in batch:
                p.done.set()
                if p.callback is not None:
                    try:
                        p.callback(p.result, p.error)
                    except Exception:  # noqa: BLE001 — a bad callback must
                        pass           # not take down the dispatcher
