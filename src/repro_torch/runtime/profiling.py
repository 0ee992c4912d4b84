"""Performance attribution: critical-path phase profiles + flight recorder.

Port of ``repro/runtime/profiling.py`` (a copy: plain Python over the span
trees of core/tracing.py). Completed request trees fold into a fixed phase
taxonomy (``PHASES``) with two decompositions per tree:

- **critical** (``critical_s``): every instant of the request's wall is
  attributed to exactly one span, the deepest child covering it; parents
  keep only their uncovered self-time, so the per-phase criticals sum to
  the request wall exactly.
- **total** (``total_s``): raw span durations summed per phase. Under
  parallel shard dispatch total > critical; the gap is the parallelism.

Compile attribution: ``OrigamiExecutor.infer`` stamps its ambient infer
span with ``first_call=True`` the first time a (trace kind, plan digest,
shape) signature is seen. In the port that call pays the CUDA-graph
capture (or, without a ``CompileCache``, the first eager run with its
kernel builds). The profiler prices compile as the first-call infer
duration minus the warm median for the same profile key (clamped at >= 0)
and moves it out of ``device_compute``.

``FlightRecorder`` is the post-mortem side: an always-on bounded ring of
redaction-enforced events. On a trigger it dumps the last events, the
tracer's span tail and the metric counter deltas since the previous dump.
"""
from __future__ import annotations

import json
import pathlib
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.tracing import Span, Tracer, redact

# the fixed taxonomy: every span name maps to exactly one phase.
# ``compile_aot`` is ahead-of-time capture at warm-up (runtime/aot.py): it
# happens before any request exists, so it shows up in warm-up spans rather
# than request trees, but it owns a phase so the taxonomy can say where
# cold-start seconds went once requests stop paying them.
PHASES = ("queue_wait", "compile", "compile_aot", "unseal", "blind",
          "dispatch_wait", "device_compute", "verify", "unblind", "seal",
          "other")

# span name -> phase. ``shard.matmul`` keeps only its *self*-time (host
# fan-out/join around the dispatches) -> dispatch_wait; the dispatches
# themselves are device_compute. ``op.blinded`` self-time is the
# unblind + re-encode work around the device call -> unblind.
_NAME_PHASE = {
    "queue": "queue_wait",
    "compile.aot": "compile_aot",
    "unseal": "unseal",
    "seal": "seal",
    "session.acquire": "blind",
    "kernel.blind_encode": "blind",
    "kernel.fused_blind_matmul": "device_compute",
    "kernel.limb_matmul": "device_compute",
    "kernel.unblind": "unblind",
    "kernel.fold": "verify",
    "op.blinded": "unblind",
    "op.trusted": "device_compute",
    "shard.matmul": "dispatch_wait",
    "shard.dispatch": "device_compute",
    "shard.enclave": "device_compute",
    "infer": "device_compute",
    "plan.segment": "device_compute",
    "verify": "verify",
    "batch": "other",
    "request": "other",
}

_PROFILE_WINDOW = 512           # per-profile bounded sample ring


def phase_of(name: str) -> str:
    return _NAME_PHASE.get(name, "other")


def _merge_intervals(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Union of (t0, t1) intervals — overlapping children (parallel shard
    dispatches) must not double-claim the parent's time."""
    if not iv:
        return []
    iv = sorted(iv)
    out = [list(iv[0])]
    for lo, hi in iv[1:]:
        if lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def _intersect(a: List[Tuple[float, float]],
               b: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Intersection of two sorted merged interval lists."""
    out = []
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _subtract(iv: List[Tuple[float, float]],
              sub: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """``iv`` minus ``sub`` (both sorted merged interval lists)."""
    out = []
    for lo, hi in iv:
        cur = lo
        for slo, shi in sub:
            if shi <= cur:
                continue
            if slo >= hi:
                break
            if slo > cur:
                out.append((cur, min(slo, hi)))
            cur = max(cur, shi)
            if cur >= hi:
                break
        if cur < hi:
            out.append((cur, hi))
    return out


def _measure(iv: List[Tuple[float, float]]) -> float:
    return sum(hi - lo for lo, hi in iv)


@dataclass
class TreeDecomposition:
    """One folded request tree."""
    key: Tuple[str, str, str]            # (model, plan digest, shape bucket)
    wall_s: float
    critical_s: Dict[str, float]         # phase -> path-attributed seconds
    total_s: Dict[str, float]            # phase -> raw span-duration sum
    first_call: bool                     # tree contains a first-call infer
    infer_s: float                       # summed infer-span durations
    quantities: Dict[str, float]         # measured cost-model features


@dataclass
class PhaseProfile:
    """Accumulated decompositions for one (model, digest, shape) key."""
    key: Tuple[str, str, str]
    count: int = 0
    critical_s: Dict[str, float] = field(
        default_factory=lambda: {p: 0.0 for p in PHASES})
    total_s: Dict[str, float] = field(
        default_factory=lambda: {p: 0.0 for p in PHASES})
    wall_s: float = 0.0
    walls: deque = field(default_factory=lambda: deque(maxlen=_PROFILE_WINDOW))
    # infer-span durations split cold/warm: compile = first-call excess
    # over the warm median (the cost model and the snapshot both need
    # compile OUT of device_compute)
    first_infer_s: List[float] = field(default_factory=list)
    warm_infer_s: deque = field(
        default_factory=lambda: deque(maxlen=_PROFILE_WINDOW))

    @property
    def compile_s(self) -> float:
        """Estimated compile seconds inside this profile's first calls.

        First-call duration minus the warm median (same executable, warm
        caches); with no warm sample yet the whole first call is cold and
        indistinguishable, so compile is conservatively 0 — it shows up
        the moment a second request lands in the bucket."""
        if not self.first_infer_s or not self.warm_infer_s:
            return 0.0
        warm = sorted(self.warm_infer_s)
        med = warm[len(warm) // 2]
        return sum(max(0.0, d - med) for d in self.first_infer_s)

    def summary(self) -> Dict[str, Any]:
        compile_s = self.compile_s
        crit = dict(self.critical_s)
        # compile time was measured inside infer spans -> carve it out of
        # device_compute so both decompositions still sum to wall
        crit["compile"] = crit.get("compile", 0.0) + compile_s
        crit["device_compute"] = max(
            0.0, crit["device_compute"] - compile_s)
        tot = dict(self.total_s)
        tot["compile"] = tot.get("compile", 0.0) + compile_s
        tot["device_compute"] = max(0.0, tot["device_compute"] - compile_s)
        walls = sorted(self.walls)
        return {
            "count": self.count,
            "wall_s": round(self.wall_s, 6),
            "wall_p50_s": round(walls[len(walls) // 2], 6) if walls else 0.0,
            "critical_s": {p: round(v, 6) for p, v in crit.items()},
            "total_s": {p: round(v, 6) for p, v in tot.items()},
            "compile_s": round(compile_s, 6),
            "critical_sum_s": round(sum(crit.values()), 6),
        }


class CriticalPathProfiler:
    """Folds completed tracer span trees into ``PhaseProfile``s.

    ``ingest`` is incremental (folded roots are remembered by span id) and
    thread-safe; ``report`` is what ``engine.snapshot()["phases"]``
    exports. ``cost_observations`` pairs each tree's measured phase
    seconds with the cost-model feature quantities its infer spans carry
    (core/trust.CalibratedCostModel consumes these).
    """

    def __init__(self) -> None:
        self.profiles: Dict[Tuple[str, str, str], PhaseProfile] = {}
        self._folded: set = set()
        self._observations: List[TreeDecomposition] = []
        self._lock = threading.Lock()

    # -- folding -----------------------------------------------------------
    def ingest(self, tracer: Optional[Tracer]) -> int:
        """Fold every *completed, not yet folded* request root. Returns the
        number of trees folded this call."""
        if tracer is None:
            return 0
        spans = tracer.spans()
        children: Dict[Optional[int], List[Span]] = {}
        for s in spans:
            children.setdefault(s.parent_id, []).append(s)
        folded = 0
        with self._lock:
            for root in children.get(None, ()):
                if (root.name != "request" or root.t1 is None
                        or root.span_id in self._folded):
                    continue
                self._folded.add(root.span_id)
                dec = self._fold_tree(root, children)
                prof = self.profiles.get(dec.key)
                if prof is None:
                    prof = self.profiles[dec.key] = PhaseProfile(dec.key)
                prof.count += 1
                prof.wall_s += dec.wall_s
                prof.walls.append(dec.wall_s)
                for p in PHASES:
                    prof.critical_s[p] += dec.critical_s.get(p, 0.0)
                    prof.total_s[p] += dec.total_s.get(p, 0.0)
                if dec.first_call:
                    prof.first_infer_s.append(dec.infer_s)
                elif dec.infer_s:
                    prof.warm_infer_s.append(dec.infer_s)
                self._observations.append(dec)
                folded += 1
        return folded

    def _fold_tree(self, root: Span,
                   children: Dict[Optional[int], List[Span]]
                   ) -> TreeDecomposition:
        critical = {p: 0.0 for p in PHASES}
        total = {p: 0.0 for p in PHASES}
        first_call = False
        infer_s = 0.0
        quantities: Dict[str, float] = {}
        # every instant of the wall goes to exactly ONE span: each child is
        # *allotted* its extent ∩ the parent's allotment, minus whatever an
        # earlier sibling already claimed (first-claim on overlap — parallel
        # shard dispatches cannot double-count), and the parent keeps the
        # unallotted remainder as self-time. Criticals therefore sum to the
        # request wall exactly, by construction, even under parallelism.
        stack: List[Tuple[Span, List[Tuple[float, float]]]] = [
            (root, [(root.t0, root.t1)])]
        while stack:
            s, allot = stack.pop()
            t1 = s.t1 if s.t1 is not None else root.t1
            dur = max(0.0, t1 - s.t0)
            kids = sorted((c for c in children.get(s.span_id, ())
                           if c.t0 < t1),      # clamp runaways to the parent
                          key=lambda c: c.t0)
            granted: List[Tuple[float, float]] = []
            for c in kids:
                c_t1 = c.t1 if c.t1 is not None else t1
                c_iv = (max(c.t0, s.t0), min(c_t1, t1))
                c_allot = (_subtract(_intersect(allot, [c_iv]), granted)
                           if c_iv[0] < c_iv[1] else [])
                granted = _merge_intervals(granted + c_allot)
                stack.append((c, c_allot))
            self_s = _measure(allot) - _measure(granted)
            phase = phase_of(s.name)
            critical[phase] += max(0.0, self_s)
            total[phase] += dur
            if s.name == "infer":
                infer_s += dur
                if s.attrs.get("first_call"):
                    first_call = True
                for attr in ("device_flops", "enclave_flops", "blind_bytes",
                             "unblind_bytes", "device_matmuls"):
                    v = s.attrs.get(attr)
                    if isinstance(v, (int, float)):
                        quantities[attr] = quantities.get(attr, 0.0) + v
            if s.name == "shard.dispatch":
                quantities["dispatches"] = quantities.get(
                    "dispatches", 0.0) + 1
        shape = root.attrs.get("shape")
        bucket = ("x".join(str(d) for d in shape)
                  if isinstance(shape, (list, tuple)) else "?")
        digest = str(root.attrs.get("plan", ""))
        if not digest:
            for c in children.get(root.span_id, ()):
                if c.name == "batch":
                    digest = str(c.attrs.get("plan", ""))
                    break
        key = (str(root.attrs.get("model", "?")), digest, bucket)
        return TreeDecomposition(key=key,
                                 wall_s=max(0.0, root.t1 - root.t0),
                                 critical_s=critical, total_s=total,
                                 first_call=first_call, infer_s=infer_s,
                                 quantities=quantities)

    # -- export ------------------------------------------------------------
    def report(self) -> Dict[str, Any]:
        """The ``engine.snapshot()["phases"]`` payload: one summary per
        (model, plan-digest, shape-bucket) profile plus a fleet rollup."""
        with self._lock:
            profiles = dict(self.profiles)
        out: Dict[str, Any] = {"profiles": {}, "taxonomy": list(PHASES)}
        rollup = {p: 0.0 for p in PHASES}
        n = 0
        wall = 0.0
        for key, prof in profiles.items():
            summ = prof.summary()
            out["profiles"]["|".join(key)] = summ
            for p in PHASES:
                rollup[p] += summ["critical_s"].get(p, 0.0)
            n += prof.count
            wall += prof.wall_s
        out["requests"] = n
        out["wall_s"] = round(wall, 6)
        out["critical_s"] = {p: round(v, 6) for p, v in rollup.items()}
        return out

    def cost_observations(self) -> List[Tuple[Dict[str, float],
                                              Dict[str, float]]]:
        """(quantities, phase seconds) pairs for CalibratedCostModel.fit —
        warm trees only (a first-call tree's device_compute is poisoned by
        compile, which has its own phase, not a unit cost)."""
        with self._lock:
            obs = list(self._observations)
        out = []
        for dec in obs:
            if dec.first_call or not dec.quantities:
                continue
            out.append((dict(dec.quantities), dict(dec.critical_s)))
        return out

    def export_gauges(self, registry) -> None:
        """Fleet-rollup phase criticals as ``phase.<phase>_s`` gauges."""
        rep = self.report()
        registry.gauges({f"phase.{p}_s": v
                         for p, v in rep["critical_s"].items()})
        registry.gauge("phase.requests", rep["requests"])


# -- flight recorder --------------------------------------------------------

_TRIGGERS = ("quarantine", "breaker_open", "degradation", "verify_failure",
             "manual")


class FlightRecorder:
    """Always-on bounded post-mortem ring (redaction-enforced).

    ``event`` appends one redacted event to the ring (cheap: one lock +
    one deque append). ``dump`` assembles a bundle — recent events, the
    tracer's last ``span_tail`` spans, metric counter deltas since the
    previous dump — and, when ``out_dir`` is set, writes it as
    ``postmortem_<n>_<trigger>.json``. Dumps are rate-limited per trigger
    kind (``min_interval_s``) so a persistently dishonest device cannot
    turn every batch into a file write; the in-memory ``last_bundle`` is
    always refreshed.
    """

    def __init__(self, capacity: int = 512, span_tail: int = 200,
                 out_dir: Optional[str] = None,
                 min_interval_s: float = 1.0, max_dumps: int = 64) -> None:
        self.capacity = capacity
        self.span_tail = span_tail
        self.out_dir = pathlib.Path(out_dir) if out_dir else None
        self.min_interval_s = min_interval_s
        self.max_dumps = max_dumps
        self.events: deque = deque(maxlen=capacity)
        self.dumps = 0
        self.suppressed = 0
        self.last_bundle: Optional[Dict[str, Any]] = None
        self._last_dump_t: Dict[str, float] = {}
        self._last_counters: Dict[str, int] = {}
        self._lock = threading.Lock()

    def event(self, kind: str, **attrs: Any) -> None:
        """Record one engine/plane event. Attributes pass through the
        ``redact`` allowlist — arrays/bytes raise before storage."""
        ev = {"t": time.time(), "kind": str(kind),
              "attrs": {k: redact(v) for k, v in attrs.items()}}
        with self._lock:
            self.events.append(ev)

    def dump(self, trigger: str, tracer: Optional[Tracer] = None,
             registry=None, **attrs: Any) -> Optional[Dict[str, Any]]:
        """Assemble (and maybe write) a post-mortem bundle. Returns the
        bundle, or None when rate-limited for this trigger kind."""
        now = time.monotonic()
        with self._lock:
            last = self._last_dump_t.get(trigger)
            if last is not None and now - last < self.min_interval_s:
                self.suppressed += 1
                return None
            self._last_dump_t[trigger] = now
            events = list(self.events)
            seq = self.dumps
            self.dumps += 1
        spans: List[Dict[str, Any]] = []
        dropped = 0
        if tracer is not None:
            tail = tracer.spans()[-self.span_tail:]
            spans = [s.as_dict() for s in tail]
            dropped = tracer.dropped
        metrics: Dict[str, Any] = {}
        if registry is not None:
            snap = registry.snapshot()
            counters = snap["counters"]
            with self._lock:
                delta = {k: v - self._last_counters.get(k, 0)
                         for k, v in counters.items()
                         if v != self._last_counters.get(k, 0)}
                self._last_counters = dict(counters)
            metrics = {"counter_delta": delta, "gauges": snap["gauges"]}
        bundle = {
            "trigger": str(trigger),
            "seq": seq,
            "ts_unix": time.time(),
            "attrs": {k: redact(v) for k, v in attrs.items()},
            "events": events,
            "spans": spans,
            "dropped_spans": dropped,
            "metrics": metrics,
        }
        with self._lock:
            self.last_bundle = bundle
        if self.out_dir is not None and seq < self.max_dumps:
            self.out_dir.mkdir(parents=True, exist_ok=True)
            path = self.out_dir / f"postmortem_{seq:03d}_{trigger}.json"
            path.write_text(json.dumps(bundle, indent=1) + "\n")
        return bundle

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"events": len(self.events), "dumps": self.dumps,
                    "suppressed": self.suppressed,
                    "last_trigger": (self.last_bundle or {}).get("trigger")}
