"""Unified metrics registry: every pipeline counter under one lock.

Port of ``repro/runtime/observability.py`` (a copy: plain Python, and the
port imports nothing of the reference). ``MetricsRegistry`` holds named
counters, gauges and bounded histograms behind a single re-entrant lock, so
a multi-field update (``inc_many``) is atomic and a ``snapshot()`` is a
consistent cut. Names are ``<surface>.<counter>``, dotted and lowercase
(``engine.submitted``, ``integrity.verify_checks``, ``shard.retries``).

Metrics carry aggregates only (counts, byte and flop totals, latency
quantiles); nothing request-identifying and no payload bytes enter the
registry, so exporting a snapshot is redaction-safe by construction.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Any, Dict, Iterable, Optional

HIST_WINDOW = 4096      # per-histogram sample bound (ring buffer)


def nearest_rank(sorted_vals, q: float) -> float:
    """Nearest-rank quantile over an ascending list: the ceil(q*n)-th
    order statistic, clamped to [1, n] (q=0 -> min, q=1 -> max). The one
    implementation both ``quantile()`` and ``snapshot()`` use."""
    n = len(sorted_vals)
    if not n:
        return 0.0
    return sorted_vals[min(n - 1, max(0, math.ceil(q * n) - 1))]


class MetricsRegistry:
    """Counters / gauges / histograms behind one RLock.

    The lock is re-entrant and exposed as ``.lock`` so legacy code that
    did ``with stats.lock: stats.x += 1; stats.y += 1`` keeps its
    multi-field atomicity when ``stats`` became a facade whose property
    setters each take the same lock.
    """

    def __init__(self) -> None:
        self.lock = threading.RLock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, deque] = {}

    # -- counters ----------------------------------------------------------
    def inc(self, name: str, n: int = 1) -> int:
        with self.lock:
            v = self._counters.get(name, 0) + n
            self._counters[name] = v
            return v

    def inc_many(self, **deltas: int) -> None:
        """Atomically apply several counter deltas (one lock acquisition)."""
        with self.lock:
            for name, n in deltas.items():
                if n:
                    self._counters[name] = self._counters.get(name, 0) + n

    def set_counter(self, name: str, value: int) -> None:
        with self.lock:
            self._counters[name] = value

    def get(self, name: str, default: int = 0) -> int:
        with self.lock:
            return self._counters.get(name, default)

    # -- gauges ------------------------------------------------------------
    def gauge(self, name: str, value: float) -> None:
        with self.lock:
            self._gauges[name] = value

    def gauges(self, mapping: Dict[str, float]) -> None:
        with self.lock:
            self._gauges.update(mapping)

    def get_gauge(self, name: str, default: float = 0.0) -> float:
        with self.lock:
            return self._gauges.get(name, default)

    # -- histograms --------------------------------------------------------
    def observe(self, name: str, value: float) -> None:
        with self.lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = deque(maxlen=HIST_WINDOW)
            h.append(float(value))

    def hist_values(self, name: str) -> list:
        with self.lock:
            return list(self._hists.get(name, ()))

    def quantile(self, name: str, q: float) -> float:
        return nearest_rank(sorted(self.hist_values(name)), q)

    # -- export ------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Consistent cut of every metric: counters and gauges verbatim,
        histograms summarized (count/mean/p50/p95/p99/max)."""
        with self.lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: list(v) for k, v in self._hists.items()}
        out: Dict[str, Any] = {"counters": counters, "gauges": gauges,
                               "histograms": {}}
        for name, vals in hists.items():
            sv = sorted(vals)
            n = len(sv)
            summ = {"count": n}
            if n:
                summ.update(mean=sum(sv) / n,
                            p50=nearest_rank(sv, 0.50),
                            p95=nearest_rank(sv, 0.95),
                            p99=nearest_rank(sv, 0.99),
                            max=sv[-1])
            out["histograms"][name] = summ
        return out

    def reset(self, prefix: Optional[str] = None) -> None:
        """Drop metrics (all, or those under a dotted prefix) — bench use."""
        with self.lock:
            if prefix is None:
                self._counters.clear()
                self._gauges.clear()
                self._hists.clear()
                return
            for store in (self._counters, self._gauges, self._hists):
                for k in [k for k in store if k.startswith(prefix)]:
                    del store[k]


def sync_struct(registry: MetricsRegistry, prefix: str,
                obj: Any, fields: Iterable[str]) -> None:
    """Publish a stats dataclass's numeric fields as gauges under
    ``<prefix>.<field>`` — the bridge that makes ``Telemetry`` /
    ``ShardReport`` / session stats readable from the one registry at
    snapshot time without rewriting their producers."""
    vals = {}
    for f in fields:
        v = getattr(obj, f, None)
        if isinstance(v, bool) or v is None:
            v = int(bool(v))
        if isinstance(v, (int, float)):
            vals[f"{prefix}.{f}"] = v
    registry.gauges(vals)
