"""Training-side meters and monitors (counterpart of
``eop_tpu/utils/metric.py``): windowed averages for the log lines, the
card's memory in use, and the SimOTA compaction warning."""

from __future__ import annotations

import functools
from collections import defaultdict, deque
from typing import Optional

import numpy as np
import torch


def fetch_metrics(rows):
    """``[(step, {name: device tensor})]`` -> the same with numpy arrays, in
    one device-to-host transfer."""
    flat = torch.cat([v.detach().reshape(-1).double()
                      for _, m in rows for v in m.values()]).cpu().numpy()
    out, at = [], 0
    for step, m in rows:
        host = {}
        for k, v in m.items():
            host[k] = flat[at:at + v.numel()].reshape(v.shape)
            at += v.numel()
        out.append((step, host))
    return out


def device_mem_usage(device=None) -> float:
    """MB of tensors allocated on the card (0 where there is none)."""
    if not torch.cuda.is_available():
        return 0.0
    return torch.cuda.memory_allocated(device) / (1024 * 1024)


class AverageMeter:
    """A series of values with a window: median and mean over the window,
    the global mean, the latest value."""

    def __init__(self, window_size: int = 50):
        self._deque = deque(maxlen=window_size)
        self._total = 0.0
        self._count = 0

    def update(self, value):
        self._deque.append(value)
        self._count += 1
        self._total += value

    @property
    def median(self):
        d = np.array(self._deque)
        return np.median(d) if len(d) else 0.0

    @property
    def avg(self):
        d = np.array(self._deque)
        return d.mean() if len(d) else 0.0

    @property
    def global_avg(self):
        return self._total / max(self._count, 1e-5)

    @property
    def latest(self):
        return self._deque[-1] if len(self._deque) > 0 else None

    @property
    def total(self):
        return self._total

    def reset(self):
        self._deque.clear()
        self._total = 0.0
        self._count = 0

    def clear(self):
        self._deque.clear()


class MeterBuffer(defaultdict):
    """``{name: AverageMeter}``, made on first use, with key filtering."""

    def __init__(self, window_size: int = 20):
        super().__init__(functools.partial(AverageMeter,
                                           window_size=window_size))

    def reset(self):
        for v in self.values():
            v.reset()

    def get_filtered_meter(self, filter_key: str = "time"):
        return {k: v for k, v in self.items() if filter_key in k}

    def update(self, values: Optional[dict] = None, **kwargs):
        values = dict(values or {}, **kwargs)
        for k, v in values.items():
            self[k].update(float(v))

    def clear_meters(self):
        for v in self.values():
            v.clear()


class CandidateDropMonitor:
    """Rate-limited warning when SimOTA candidate compaction sheds anchors.

    Compaction (``SimOTAConfig.cand_cap > 0``) is bit-exact while the
    candidate superset fits the capacity; on overflow it sheds only
    low-priority padded-box anchors, but those can legitimately match, so the
    assignment may then differ from the full-lattice SimOTA.  This logs a
    warning at most once per ``window`` updates while drops persist.
    """

    def __init__(self, log, window: int = 50):
        self._log = log
        self._window = window
        self._steps = 0
        self._dropped = 0

    def update(self, dropped) -> None:
        self._steps += 1
        self._dropped += int(dropped)
        if self._steps >= self._window:
            if self._dropped:
                self._log.warning(
                    "SimOTA compaction shed %d candidate anchors over the "
                    "last %d probes; the assignment may differ from the "
                    "full-lattice SimOTA; set cand_cap=0 (full-lattice path) "
                    "for reference-exact training",
                    self._dropped, self._steps,
                )
            self._steps = 0
            self._dropped = 0
