"""Straggler mitigation: step deadlines from a robust moving estimate.

A copy of ``repro/runtime/straggler.py`` (the port imports nothing of the
reference). The watchdog tracks the median of recent step times and flags
steps exceeding ``deadline_factor`` x the P50; after ``tolerance``
consecutive flags the caller should escalate. The offload plane
(parallel/offload_sharding.py) keys its straggler-hedge and hard dispatch
deadlines off the same estimate.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from collections import deque
from typing import Deque, Optional


@dataclasses.dataclass
class WatchdogConfig:
    deadline_factor: float = 3.0
    warmup_steps: int = 10
    window: int = 50
    tolerance: int = 3


def _median(values) -> float:
    """Median (mean of the two middles on even-length windows): the upper
    median would inflate the deadline baseline on even windows."""
    return float(statistics.median(values))


class StepWatchdog:
    def __init__(self, cfg: Optional[WatchdogConfig] = None):
        self.cfg = cfg or WatchdogConfig()
        self.history: Deque[float] = deque(maxlen=self.cfg.window)
        self.consecutive_slow = 0
        self.flagged_steps = 0
        self._t0: Optional[float] = None

    def start_step(self, now: Optional[float] = None):
        self._t0 = now if now is not None else time.monotonic()

    def end_step(self, now: Optional[float] = None) -> bool:
        """Returns True if the step breached its deadline."""
        assert self._t0 is not None, "end_step without start_step"
        dt = (now if now is not None else time.monotonic()) - self._t0
        self._t0 = None
        slow = False
        if len(self.history) >= self.cfg.warmup_steps:
            slow = dt > self.cfg.deadline_factor * _median(self.history)
        self.history.append(dt)
        if slow:
            self.flagged_steps += 1
            self.consecutive_slow += 1
        else:
            self.consecutive_slow = 0
        return slow

    @property
    def should_escalate(self) -> bool:
        """The caller should escalate (the slow part keeps missing)."""
        return self.consecutive_slow >= self.cfg.tolerance

    @property
    def p50(self) -> Optional[float]:
        if not self.history:
            return None
        return _median(self.history)

    def deadline(self, factor: Optional[float] = None,
                 floor: float = 0.0,
                 cold: Optional[float] = None) -> Optional[float]:
        """``factor × P50`` once warm, else ``cold``.

        The one deadline baseline both consumers share: the offload
        plane's straggler-hedge trigger and its hard per-dispatch
        liveness timeout (parallel/offload_sharding.py) key off the same
        robust estimate, just with different factors. ``floor`` guards
        against sub-millisecond P50s turning scheduler jitter into
        timeouts; ``cold`` is the pre-warmup fallback (None = no
        deadline until the window warms)."""
        if len(self.history) < self.cfg.warmup_steps:
            return cold
        p50 = _median(self.history)
        f = self.cfg.deadline_factor if factor is None else factor
        return max(f * p50, floor)
