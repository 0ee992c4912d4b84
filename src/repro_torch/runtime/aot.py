"""Compile-once serving: the executable cache of the plan interpreter.

Port of ``repro/runtime/aot.py``. The reference compiles one XLA executable
per (trace kind, plan digest, shape bucket) ahead of the first request; the
port's executable at one signature is a ``torch.cuda.CUDAGraph`` of the
executor's eager step (core/origami.py ``_ensure_executable``), captured
once with static input and output buffers and replayed per request. On the
CPU there are no graphs and the executable is the eager closure; the cache
and its counters behave the same either way.

``CompileCache.compile_once`` memoizes an executable per cache key and
serializes build calls with a per-key lock, so concurrent warm-ups and
mixed-shape requests build each signature exactly once. The key is
``sha256(plan digest, trace kind, input-shape signature, backend, framework
version, code version)``: the backend is ``cuda`` or ``cpu``, the framework
version is torch's and CUDA's, and the code version hashes the port's
sources that shape a captured step (``core``, ``kernels`` with its CUDA
sources, ``models``).

There is no disk tier: a CUDA graph cannot be serialized, and the kernel
library a restart would otherwise rebuild is already cached on disk by
``kernels/build.py``. ``CompileCache(cache_dir=...)`` raises.

Counters (``aot.<name>`` in a MetricsRegistry): ``compiles``,
``memo_hits``, ``disk_hits``, ``disk_errors``, ``stores`` (the last three
stay 0), ``exec_fallbacks``; gauges ``aot.compile_seconds`` (total) and
``aot.request_compile_seconds`` (the part paid on the request path, zero
when warm-up covered every bucket).
"""
from __future__ import annotations

import hashlib
import pathlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

# source roots whose content shapes a captured step
_CODE_ROOTS = ("core", "kernels", "models")
_CODE_SUFFIXES = (".py", ".cu", ".cuh")

_code_version_cache: Optional[str] = None
_code_version_lock = threading.Lock()


def code_version() -> str:
    """Content hash over the sources that determine a captured step, hashed
    once per process (sorted walk: deterministic across runs)."""
    global _code_version_cache
    with _code_version_lock:
        if _code_version_cache is not None:
            return _code_version_cache
        h = hashlib.sha256()
        pkg_root = pathlib.Path(__file__).resolve().parent.parent
        for root in _CODE_ROOTS:
            base = pkg_root / root
            if not base.is_dir():
                continue
            for path in sorted(base.rglob("*")):
                if path.suffix in _CODE_SUFFIXES and path.is_file():
                    h.update(path.relative_to(pkg_root).as_posix().encode())
                    h.update(path.read_bytes())
        _code_version_cache = h.hexdigest()[:16]
        return _code_version_cache


def _leaves(tree: Any) -> List[Any]:
    """Leaves in the reference's pytree order: dict values by sorted key,
    sequences in order, ``None`` an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _dtype_name(leaf: Any) -> str:
    dtype = getattr(leaf, "dtype", None)
    if dtype is None:
        return type(leaf).__name__
    return str(dtype).replace("torch.", "")


def shape_signature(tree: Any) -> str:
    """Stable string signature of a tree's leaves (shape + dtype)."""
    parts = []
    for leaf in _leaves(tree):
        shape = tuple(getattr(leaf, "shape", ()))
        parts.append(f"{'x'.join(map(str, shape))}:{_dtype_name(leaf)}")
    return ";".join(parts)


class CompileCache:
    """Memoized executable cache, shared by every executor attached to it
    (``OrigamiExecutor.attach_aot``): the memo deduplicates identical
    (digest, kind, bucket) captures across executors, the per-key locks
    make concurrent builds exactly-once, and the counters land in
    ``registry`` when one is given."""

    def __init__(self, cache_dir: Optional[str] = None,
                 registry=None) -> None:
        if cache_dir is not None:
            raise NotImplementedError(
                "CompileCache(cache_dir=...): a CUDA graph cannot be "
                "serialized, so the compile cache is memory only: a restart "
                "captures each (trace kind, bucket) again, and warm_aot "
                "takes that off the request path (the kernel library is "
                "already cached on disk by kernels/build.py)")
        self.cache_dir = None
        self.registry = registry
        self._memo: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self._key_locks: Dict[str, threading.Lock] = {}
        self.counters: Dict[str, int] = {
            "compiles": 0, "memo_hits": 0, "disk_hits": 0,
            "disk_errors": 0, "stores": 0, "exec_fallbacks": 0}
        self.compile_seconds = 0.0
        self.request_compile_seconds = 0.0
        # warm-ups flip this on so capture seconds count as warm-up, not
        # request path (thread-local: a serving thread never inherits it)
        self._tls = threading.local()

    # -- warmup attribution ------------------------------------------------
    class _WarmupScope:
        def __init__(self, cache: "CompileCache") -> None:
            self.cache = cache

        def __enter__(self) -> None:
            self.cache._tls.warmup = getattr(
                self.cache._tls, "warmup", 0) + 1

        def __exit__(self, *exc) -> None:
            self.cache._tls.warmup -= 1

    def warmup_scope(self) -> "CompileCache._WarmupScope":
        """Context manager: builds inside it count as warm-up, not request
        path, in the ``aot.request_compile_seconds`` split."""
        return CompileCache._WarmupScope(self)

    @property
    def in_warmup(self) -> bool:
        return getattr(self._tls, "warmup", 0) > 0

    # -- keys --------------------------------------------------------------
    def entry_key(self, plan_digest: str, kind: str, args: Any) -> str:
        """Plan digest + trace kind + shape signature + backend + framework
        version + code version, hashed."""
        backend = "cuda" if torch.cuda.is_available() else "cpu"
        raw = "|".join((str(plan_digest), str(kind), shape_signature(args),
                        backend, f"torch-{torch.__version__}",
                        f"cuda-{torch.version.cuda}", code_version()))
        return hashlib.sha256(raw.encode()).hexdigest()

    # -- counters ----------------------------------------------------------
    def _bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n
        if self.registry is not None:
            self.registry.inc(f"aot.{name}", n)

    def _add_seconds(self, dt: float) -> None:
        with self._lock:
            self.compile_seconds += dt
            if not self.in_warmup:
                self.request_compile_seconds += dt
        if self.registry is not None:
            self.registry.gauge("aot.compile_seconds", self.compile_seconds)
            self.registry.gauge("aot.request_compile_seconds",
                                self.request_compile_seconds)

    def record_fallback(self) -> None:
        """An executable raised at call time and the executor ran the eager
        step instead: count it (``aot.exec_fallbacks``)."""
        self._bump("exec_fallbacks")

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = dict(self.counters)
            out["compile_seconds"] = round(self.compile_seconds, 6)
            out["request_compile_seconds"] = round(
                self.request_compile_seconds, 6)
            out["persistent"] = False
        return out

    # -- the one build path ------------------------------------------------
    def compile_once(self, key: str, build: Callable[[], Any]
                     ) -> Tuple[Any, bool]:
        """``(executable, fresh)`` for ``key``: the memo, else a timed
        ``build()``. Per-key locking makes concurrent callers exactly-once:
        the loser of the race finds the winner's memo entry."""
        with self._lock:
            compiled = self._memo.get(key)
            if compiled is None:
                klock = self._key_locks.setdefault(key, threading.Lock())
        if compiled is not None:
            self._bump("memo_hits")
            return compiled, False
        with klock:
            with self._lock:
                compiled = self._memo.get(key)
            if compiled is not None:
                self._bump("memo_hits")
                return compiled, False
            t0 = time.monotonic()
            compiled = build()
            self._add_seconds(time.monotonic() - t0)
            self._bump("compiles")
            with self._lock:
                self._memo[key] = compiled
            return compiled, True


def bucket_ladder(max_batch: int) -> Tuple[int, ...]:
    """The shape-bucket ladder: powers of two up to (and including)
    ``max_batch`` — 1/2/4/max."""
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


def bucket_for(n: int, max_batch: int) -> int:
    """Smallest ladder bucket holding ``n`` requests (occupancy-driven
    padding: a lone request pads to 1, not to max_batch)."""
    assert 1 <= n <= max_batch, (n, max_batch)
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


# -- executables ------------------------------------------------------------

def _load(static: Any, new: Any) -> None:
    """Copy ``new``'s tensor leaves into the matching static buffers; a leaf
    that already is its buffer (a cache's weight planes) is not copied, and
    host leaves (session keys) do not enter a captured step."""
    if isinstance(static, torch.Tensor):
        if new is not static:
            static.copy_(new)
    elif isinstance(static, dict):
        assert static.keys() == new.keys(), (static.keys(), new.keys())
        for k in static:
            _load(static[k], new[k])
    elif isinstance(static, (list, tuple)):
        assert len(static) == len(new), (len(static), len(new))
        for a, b in zip(static, new):
            _load(a, b)
    else:
        assert (static is None) == (new is None), (static, new)


def clone_tree(tree: Any, keep: Tuple[str, ...] = ()) -> Any:
    """A copy of every tensor leaf of ``tree`` (dicts, lists, tuples and
    NamedTuples rebuilt); a dict entry whose key is in ``keep`` stays in
    place (a cache's weight material, which a captured step reads where
    it lies)."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: v if k in keep else clone_tree(v, keep)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [clone_tree(v, keep) for v in tree]
        # a NamedTuple (a KV cache) takes its fields positionally
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return tree


class GraphStep:
    """One eager step captured as a ``torch.cuda.CUDAGraph``.

    ``args`` are the static input buffers the graph reads (the caller's own
    copies, kept for the graph's lifetime); the step is warmed once on a
    side stream (kernel builds, library handles), then captured with
    ``capture_error_mode="thread_local"`` so another thread's work on the
    card (a SessionPool refill) cannot void the capture. The launches the
    kernel wrappers made while capturing are recorded, not counted
    (``kernels/build.recording_launches``), and credited on every replay.
    A call copies its inputs into the buffers, replays and clones the
    static outputs out (the next replay overwrites them), all under one
    lock, since warm-up and serving may share the step across threads."""

    def __init__(self, fn: Callable[..., Any], args: Tuple[Any, ...],
                 device: torch.device) -> None:
        from repro_torch.kernels import build as KB
        self.args = args
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn(*args)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with KB.recording_launches() as record:
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                self.outputs = fn(*args)
        self.launches = {k: n for k, n in record.items() if n}
        self._lock = threading.Lock()

    def load(self, args: Tuple[Any, ...]) -> None:
        """Copy a call's inputs into the static buffers."""
        _load(self.args, args)

    def replay(self) -> Any:
        """Replay the graph and credit its launches; the static outputs."""
        from repro_torch.kernels import build as KB
        self.graph.replay()
        for name, n in self.launches.items():
            KB.count_launch(name, n)
        return self.outputs

    def __call__(self, *args: Any) -> Any:
        with self._lock:
            self.load(args)
            return clone_tree(self.replay())


class EagerStep:
    """The CPU's executable: the eager step itself (there are no graphs on
    the CPU). Like a replay it records no span of its own inner stages."""

    def __init__(self, fn: Callable[..., Any]) -> None:
        self.fn = fn

    def __call__(self, *args: Any) -> Any:
        from repro_torch.core import tracing
        with tracing.suspended():
            return self.fn(*args)
