"""Request-scoped span tracing with mandatory privacy redaction.

Port of ``repro/core/tracing.py`` (a copy of its plain-Python parts: the
port imports nothing of the reference). ``Tracer`` records a span tree per
request; every stage (runtime/serving.py, core/origami.py, core/slalom.py,
parallel/offload_sharding.py, the kernel wrappers) attaches children via the
ambient context, and the tree exports as Chrome-trace JSON or JSONL.

Redaction is enforced at attach time: a span attribute must be a plain
scalar, a short string or a small container of them. Arrays (torch tensors,
numpy arrays), bytes and any object carrying a buffer raise
``RedactionError``, so blinding factors, session keys, activations and
logits cannot ride a span.

Threading: spans are created and closed on whatever thread runs the stage;
the store is lock-protected and parentage is explicit (``parent=``) or
ambient via a contextvar (``activate``). Worker threads (device slots,
refill threads) get the parent span passed explicitly.

Everything is a no-op when no tracer is active (one contextvar read). A
CUDA-graph replay (runtime/aot.py) is the port's counterpart of the
reference's jit: it emits the serving spans around the replay and none of
the inner ones, which are recorded only on an eager trace.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

_ids = itertools.count(1)          # CPython next() is atomic

# span kinds
KINDS = ("request", "queue", "batch", "session", "crypto", "infer",
         "step", "shard", "verify", "kernel")

_MAX_STR = 512                     # longest attribute string (digests fit)
_MAX_ITEMS = 64                    # longest attribute list/dict


class RedactionError(TypeError):
    """A span attribute carried a disallowed payload (array/bytes/object).
    Raised at attach time: secret-bearing values never reach the span
    store, let alone an export file."""


def redact(value: Any, _depth: int = 0) -> Any:
    """Validate one attribute value against the allowlist.

    Allowed: None, bool, int, float, str (truncated to ``_MAX_STR``), and
    lists/tuples/dicts of allowed values (bounded). Everything else —
    notably torch/numpy arrays, bytes-likes, and arbitrary objects — raises
    ``RedactionError``. Types are checked *exactly* (no duck-typing): a
    subclass with a buffer would sail through an isinstance check.
    """
    if value is None or type(value) in (bool, int, float):
        return value
    if isinstance(value, str):
        return value if len(value) <= _MAX_STR else value[:_MAX_STR] + "…"
    if isinstance(value, (bytes, bytearray, memoryview)):
        raise RedactionError(
            "span attributes must not carry raw bytes (key material, "
            "ciphertext, array buffers) — attach a digest or a shape")
    if hasattr(value, "__array__") or hasattr(value, "shape"):
        raise RedactionError(
            f"span attributes must not carry arrays ({type(value).__name__})"
            " — blinding factors / activations / logits are secret; attach "
            "the shape tuple or a digest instead")
    if isinstance(value, (list, tuple)):
        if _depth >= 3 or len(value) > _MAX_ITEMS:
            raise RedactionError("span attribute container too large/deep")
        return [redact(v, _depth + 1) for v in value]
    if isinstance(value, dict):
        if _depth >= 3 or len(value) > _MAX_ITEMS:
            raise RedactionError("span attribute container too large/deep")
        return {str(k)[:_MAX_STR]: redact(v, _depth + 1)
                for k, v in value.items()}
    raise RedactionError(
        f"span attribute type {type(value).__name__!r} is not on the "
        "redaction allowlist (scalars, short strings, small containers)")


@dataclass
class Span:
    """One timed stage. ``t0``/``t1`` are perf_counter seconds relative to
    the tracer's epoch; attributes are pre-redacted."""
    trace_id: int
    span_id: int
    parent_id: Optional[int]
    name: str
    kind: str
    t0: float
    t1: Optional[float] = None
    tid: int = 0
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration_s(self) -> Optional[float]:
        return None if self.t1 is None else self.t1 - self.t0

    def as_dict(self) -> Dict[str, Any]:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "kind": self.kind, "t0": self.t0, "t1": self.t1,
                "tid": self.tid, "attrs": dict(self.attrs)}


class Tracer:
    """Thread-safe bounded span store with redaction-enforced attributes.

    ``kernel_spans`` gates the synchronize-fenced kernel hooks
    (``profiled_kernel``), the only instrumentation that changes device
    scheduling (a fence serializes async launch), so it can be turned off
    independently of the request and stage spans.
    """

    MAX_SPANS = 200_000

    def __init__(self, *, enabled: bool = True, kernel_spans: bool = True,
                 max_spans: int = MAX_SPANS):
        self.enabled = enabled
        self.kernel_spans = kernel_spans
        self.max_spans = max_spans
        self.epoch = time.perf_counter()
        self.epoch_unix = time.time()
        self.dropped = 0                  # spans past the bound
        self._spans: List[Span] = []
        self._lock = threading.Lock()

    # -- recording ---------------------------------------------------------
    def start_span(self, name: str, kind: str = "step", *,
                   parent: Optional[Span] = None,
                   trace_id: Optional[int] = None,
                   **attrs: Any) -> Span:
        """Open a span. Parent resolution: explicit ``parent``, else the
        ambient current span (same thread), else a new root (fresh
        trace_id unless given)."""
        if parent is None:
            parent = current_span()
        sid = next(_ids)
        tid = (parent.trace_id if parent is not None
               else (trace_id if trace_id is not None else next(_ids)))
        span = Span(trace_id=tid, span_id=sid,
                    parent_id=parent.span_id if parent else None,
                    name=name, kind=kind,
                    t0=time.perf_counter() - self.epoch,
                    tid=threading.get_ident())
        if attrs:
            self.annotate(span, **attrs)
        with self._lock:
            if len(self._spans) < self.max_spans:
                self._spans.append(span)
            else:
                self.dropped += 1
        return span

    def annotate(self, span: Span, **attrs: Any) -> None:
        """Attach attributes (redaction enforced — raises on violations
        BEFORE anything is stored)."""
        clean = {k: redact(v) for k, v in attrs.items()}
        span.attrs.update(clean)

    def end(self, span: Span, **attrs: Any) -> Span:
        if attrs:
            self.annotate(span, **attrs)
        span.t1 = time.perf_counter() - self.epoch
        return span

    @contextmanager
    def span(self, name: str, kind: str = "step", *,
             parent: Optional[Span] = None, **attrs: Any):
        """Open + activate a span for the dynamic extent of the block: any
        span started inside (same thread) parents to it."""
        s = self.start_span(name, kind, parent=parent, **attrs)
        token = _CURRENT.set((self, s))
        try:
            yield s
        finally:
            _CURRENT.reset(token)
            if s.t1 is None:
                self.end(s)

    # -- reading / export --------------------------------------------------
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def by_id(self) -> Dict[int, Span]:
        return {s.span_id: s for s in self.spans()}

    def roots(self) -> List[Span]:
        return [s for s in self.spans() if s.parent_id is None]

    def children(self, span: Span) -> List[Span]:
        return [s for s in self.spans() if s.parent_id == span.span_id]

    def to_chrome(self) -> Dict[str, Any]:
        """Chrome trace event format (load in chrome://tracing/Perfetto).

        Complete ("X") events in microseconds; unfinished spans export with
        their open duration so a crashed run still renders."""
        now = time.perf_counter() - self.epoch
        events: List[Dict[str, Any]] = [{
            "ph": "M", "name": "process_name", "pid": 0, "tid": 0,
            "args": {"name": "repro-private-inference"}}]
        for s in self.spans():
            t1 = s.t1 if s.t1 is not None else now
            events.append({
                "name": s.name, "cat": s.kind, "ph": "X", "pid": 0,
                "tid": s.tid, "ts": round(s.t0 * 1e6, 3),
                "dur": round((t1 - s.t0) * 1e6, 3),
                "args": {**s.attrs, "trace_id": s.trace_id,
                         "span_id": s.span_id, "parent_id": s.parent_id}})
        # truncation marker: a bounded store drops the NEWEST spans once
        # full (children of stored parents may be missing) — consumers
        # must not read a truncated export as a connected tree
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"epoch_unix": self.epoch_unix,
                              "dropped_spans": self.dropped,
                              "truncated": self.dropped > 0}}

    def dump_chrome(self, path) -> int:
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        return len(doc["traceEvents"])

    def dump_jsonl(self, path) -> int:
        spans = self.spans()
        with open(path, "w") as f:
            for s in spans:
                f.write(json.dumps(s.as_dict()) + "\n")
            if self.dropped:
                # same truncation stamp the Chrome export carries — a
                # trailing marker line, so line-oriented consumers see it
                # without schema changes to the span records
                f.write(json.dumps({"truncated": True,
                                    "dropped_spans": self.dropped}) + "\n")
        return len(spans)


# -- ambient context -------------------------------------------------------
_CURRENT: ContextVar[Optional[Tuple[Tracer, Span]]] = ContextVar(
    "repro_trace_current", default=None)


def current_tracer() -> Optional[Tracer]:
    cur = _CURRENT.get()
    return cur[0] if cur is not None else None


def current_span() -> Optional[Span]:
    cur = _CURRENT.get()
    return cur[1] if cur is not None else None


@contextmanager
def activate(tracer: Optional[Tracer], span: Optional[Span] = None):
    """Install ``tracer`` (and optionally a current parent span) for the
    dynamic extent — the engine wraps each batch dispatch with this so the
    serving/executor/plane stages pick the tracer up ambiently. No-op when
    ``tracer`` is None."""
    if tracer is None or not tracer.enabled:
        yield None
        return
    token = _CURRENT.set((tracer, span))
    try:
        yield span
    finally:
        _CURRENT.reset(token)


@contextmanager
def suspended():
    """No tracer for the dynamic extent: a graph capture, its warm-up run
    and the CPU's eager executable record no inner spans, as a replay
    records none (the reference's jit records none of them either)."""
    token = _CURRENT.set(None)
    try:
        yield
    finally:
        _CURRENT.reset(token)


@contextmanager
def maybe_span(name: str, kind: str = "step", **attrs: Any):
    """Ambient-span helper for instrumented call sites: records a child of
    the current span when a tracer is active, yields None (one contextvar
    read) otherwise."""
    cur = _CURRENT.get()
    if cur is None or not cur[0].enabled:
        yield None
        return
    with cur[0].span(name, kind, **attrs) as s:
        yield s


def annotate(span: Optional[Span], **attrs: Any) -> None:
    """Attach attributes to a ``maybe_span`` result (None-safe)."""
    if span is None:
        return
    tr = current_tracer()
    if tr is not None:
        tr.annotate(span, **attrs)


def _capturing() -> bool:
    import torch
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _fence(tensors) -> None:
    import torch
    for dev in {t.device for t in tensors
                if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


def profiled_kernel(name: str, fn, *args, **kw):
    """Wall-time profile one kernel call, fenced with
    ``torch.cuda.synchronize`` on the card.

    Fires only when a tracer with ``kernel_spans`` is ambient and no stream
    is being captured into a CUDA graph (a synchronize inside a capture is
    illegal, and a captured launch has no wall time of its own: the
    counterpart of the reference recording nothing under a jit trace).
    Inputs are fenced before the span opens so pending upstream work is not
    attributed to this kernel, and the output before it closes so device
    time is attributed instead of hidden in async launch.
    """
    cur = _CURRENT.get()
    if cur is None or not (cur[0].enabled and cur[0].kernel_spans):
        return fn(*args, **kw)
    if _capturing():
        return fn(*args, **kw)
    leaves = [a for a in args if hasattr(a, "shape")]
    _fence(leaves)
    shapes = [tuple(a.shape) for a in leaves[:3]]
    with cur[0].span(name, "kernel", shapes=shapes):
        out = fn(*args, **kw)
        _fence(out if isinstance(out, (tuple, list)) else [out])
    return out
