"""Training-side monitors (counterpart of ``eop_tpu/utils/metric.py``)."""

from __future__ import annotations


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
