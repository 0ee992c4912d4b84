"""Blinding sessions: the forward ``SessionPool`` and the decode
``TokenSlotRing``.

Port of ``repro/runtime/sessions.py``.

``SessionPool`` keeps an N-deep ring of pre-generated blinding sessions for
one executor:

- **keys**: session keys are ``fold_in(root, counter)`` under a fresh
  64-bit entropy root per pool (``fresh_root``), bit-equal to the
  reference's keys for the same root;
- **refill**: a daemon thread keeps ``depth`` sessions prefetched into
  every BlindedLayerCache the executor has built (one per plan digest and
  batch shape), so each bucket's factors are drawn off the request path;
  a prefetched set carries (r, u), the Freivalds fold vectors under a
  policy and the per-shard fold vectors of an offload plane. On the card
  the refill's kernels launch on the same default stream as the
  consumer's. An ``acquire`` of the key the thread is drawing waits for
  that draw;
- **reuse guard**: every key handed out is remembered and a re-issue
  raises SessionReuseError: a one-time pad used twice is no pad;
- **fault containment**: a prefetch that raises counts in
  ``refill_errors`` and the loop goes on (the session's factors are then
  computed on the request path); ``refill_fault`` is a hook called with
  the session counter before each prefetch, for scripting that failure;
- **close**: stops the refill thread and drops the prefetched sets of the
  sessions it never handed out.

``TokenSlotRing`` streams the per-token factor sets of ONE decode session:
at every generated token, the (session, token, op) set of every offloaded
op of the scan segments: pads ``r``, factors ``u = r @ W_q`` and, under a
Freivalds policy, fold vectors. The ring keeps ``depth`` future tokens'
sets prefetched through ``BlindedLayerCache.session_factors(key,
step=token)`` — the token index rides the factor keying's ``step`` slot,
the stream a live decode step derives itself, so ring-fed and live steps
are bit-identical.

- **reuse guard**: ``take(token)`` remembers every token issued and raises
  SlotReuseError on a re-issue: pads are one-time per (session, token, op).
- **refill**: a daemon thread tops the ring up ahead of the consumer. A
  consumer that asks for the token the thread is drawing waits for that
  draw; one that outruns the thread computes the slot synchronously (a
  counted miss), never an error.
- **fault containment**: as in the pool, with ``refill_fault`` called
  with the token index.
"""
from __future__ import annotations

import os
import threading
from typing import Callable, Dict, Optional, Set

import numpy as np

from repro_torch.core import prng


class SessionReuseError(RuntimeError):
    """A blinding session key was issued twice: one-time pad violation."""


class SlotReuseError(RuntimeError):
    """A (session, token) factor slot was issued twice: the token's pads
    would blind two different activations."""


def fresh_root(seed: Optional[int] = None) -> np.ndarray:
    """A pool's key root: 64 entropy bits folded into a PRNGKey (from the
    OS, or from ``seed`` for a reproducible pool)."""
    if seed is not None:
        return prng.fold_in(prng.PRNGKey(seed & 0xFFFFFFFF),
                            (seed >> 32) & 0xFFFFFFFF)
    w0, w1 = np.frombuffer(os.urandom(8), np.uint32)
    return prng.fold_in(prng.PRNGKey(int(w0)), int(w1))


class SessionPool:
    """N-deep pre-generated blinding-session ring for one executor."""

    def __init__(self, executor=None, *, depth: int = 4,
                 root: Optional[np.ndarray] = None,
                 background: bool = True,
                 refill_fault: Optional[Callable[[int], None]] = None):
        assert depth >= 1, depth
        self.executor = executor
        self.depth = depth
        self.refill_fault = refill_fault
        self._root = root if root is not None else fresh_root()
        self._next = 0                     # next counter to prefetch
        self._head = 0                     # next counter to hand out
        self._issued: Set[bytes] = set()
        self._inflight: Set[int] = set()   # counters the refill is drawing
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._closed = False
        self.consumed = 0
        self.refilled = 0
        self.misses = 0                    # acquired with factors not ready
        self.refill_errors = 0
        self.reuse_checked = 0
        cache = self._cache()
        if cache is not None:
            cache.max_prefetched = max(depth, cache.max_prefetched)
        self._thread: Optional[threading.Thread] = None
        if background:
            self._thread = threading.Thread(
                target=self._refill_loop, name="session-pool-refill",
                daemon=True)
            self._thread.start()

    # -- internals ---------------------------------------------------------
    def _cache(self):
        return getattr(self.executor, "cache", None) if self.executor else None

    def _caches(self):
        """Every layer cache the executor has built (one per plan digest
        and batch shape), so each shape bucket's sessions are prefetched
        and mixed-shape traffic never thrashes one cache."""
        if self.executor is None:
            return []
        # the executor rebinds _caches copy-on-write: this dict never mutates
        by_shape = getattr(self.executor, "_caches", {})
        caches = {id(c): c for c in by_shape.values() if c is not None}
        cur = self._cache()
        if cur is not None:
            caches.setdefault(id(cur), cur)
        return list(caches.values())

    def _key_for(self, counter: int) -> np.ndarray:
        return prng.fold_in(self._root, counter)

    def _prefetch(self, counter: int) -> bool:
        """Generate factors for one future session. False if no cache yet."""
        if self.refill_fault is not None:
            self.refill_fault(counter)
        caches = self._caches()
        for cache in caches:
            cache.max_prefetched = max(self.depth + 1, cache.max_prefetched)
            cache.prefetch(self._key_for(counter))
        return bool(caches)

    def _refill_loop(self) -> None:
        while True:
            with self._cv:
                while not self._closed and (
                        self._next - self._head >= self.depth
                        or self._cache() is None):
                    # before the first batch builds a layer cache there is
                    # nothing to prefetch: poll instead of burning counters
                    self._cv.wait(
                        timeout=0.05 if self._cache() is None else None)
                if self._closed:
                    return
                counter = self._next
                self._next += 1
                self._inflight.add(counter)
            ok = False
            try:
                ok = self._prefetch(counter)
            except Exception:  # noqa: BLE001 — a dead refill thread would
                # put every factor matmul back on the request path; count
                # the failure and keep the loop alive
                with self._lock:
                    self.refill_errors += 1
            finally:
                with self._cv:
                    self._inflight.discard(counter)
                    if ok:
                        self.refilled += 1
                    self._cv.notify_all()

    # -- public API --------------------------------------------------------
    def acquire(self) -> np.ndarray:
        """Pop the next never-before-issued session key. Its factors are
        prefetched whenever the executor's layer cache exists; a miss is
        counted, not fatal (the executor computes them on first use)."""
        with self._cv:
            counter = self._head
            self._head += 1
            if self._head > self._next:     # outran the refill thread
                self._next = self._head
            key = self._key_for(counter)
            kb = np.asarray(key).tobytes()
            self.reuse_checked += 1
            if kb in self._issued:
                raise SessionReuseError(
                    f"blinding session {counter} issued twice")
            self._issued.add(kb)
            self.consumed += 1
            while counter in self._inflight:    # its draw lands first
                self._cv.wait()
            cache = self._cache()
            if cache is None or not cache.prefetched(key):
                self.misses += 1
            self._cv.notify_all()           # wake refill to top the pool up
        return key

    def prime(self) -> None:
        """Synchronously top the pool up (e.g. right after the first batch
        built the layer cache, or when running without the thread)."""
        with self._lock:
            start, self._next = self._next, max(self._next,
                                                self._head + self.depth)
            stop = self._next
        for c in range(start, stop):
            try:
                ok = self._prefetch(c)
            except Exception:  # noqa: BLE001 — same containment as the loop
                with self._lock:
                    self.refill_errors += 1
                continue
            if ok:
                with self._lock:
                    self.refilled += 1

    def ready(self) -> int:
        """How many handed-out-next sessions have factors prefetched."""
        cache = self._cache()
        if cache is None:
            return 0
        with self._lock:
            head, nxt = self._head, self._next
        return sum(cache.prefetched(self._key_for(c))
                   for c in range(head, nxt))

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"consumed": self.consumed, "refilled": self.refilled,
                    "misses": self.misses, "reuse_checked": self.reuse_checked,
                    "refill_errors": self.refill_errors,
                    "depth": self.depth, "pending": self._next - self._head}

    def close(self) -> None:
        """Stop the refill thread (waiting for a draw in progress), then
        drop the factor sets prefetched for sessions never handed out: a
        closed pool issues no more keys, and at full width each set pins
        hundreds of MB of device memory in the executor's caches."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=60.0)
        with self._lock:
            unissued = range(self._head, self._next)
        for cache in self._caches():
            for counter in unissued:
                cache.discard(self._key_for(counter))

    def acquire_stream(self, cache, *, lo: int = 0, depth: int = 8,
                       background: bool = True):
        """The next never-reused session key and a per-token factor stream
        bound to it: ``(key, TokenSlotRing | None)``. ``cache`` is the
        executor's decode-walk cache (``decode_cache``); ``None`` ring when
        the decode plan blinds nothing."""
        key = self.acquire()
        if cache is None:
            return key, None
        return key, TokenSlotRing(cache, key, lo=lo, depth=depth,
                                  background=background,
                                  refill_fault=self.refill_fault)


class TokenSlotRing:
    """Streaming per-token factor slots for ONE decode session."""

    def __init__(self, cache, session_key, *, lo: int = 0, depth: int = 8,
                 background: bool = True,
                 refill_fault: Optional[Callable[[int], None]] = None):
        assert depth >= 1, depth
        self.cache = cache
        self.session_key = session_key
        self.depth = depth
        self.refill_fault = refill_fault
        self._issued: Set[int] = set()
        self._inflight: Set[int] = set()   # tokens the refill is drawing
        self._head = lo                    # lowest token not yet taken
        self._next = lo                    # next token to prefetch
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._closed = False
        self.consumed = 0
        self.refilled = 0
        self.misses = 0
        self.refill_errors = 0
        # the ring's slots must not evict each other before they are taken;
        # leave slack for a take that jumps the head forward
        cache.max_prefetched = max(depth + 2, cache.max_prefetched)
        self._thread: Optional[threading.Thread] = None
        if background:
            self._thread = threading.Thread(
                target=self._refill_loop, name="token-slot-refill",
                daemon=True)
            self._thread.start()

    def _refill_loop(self) -> None:
        while True:
            with self._cv:
                while not self._closed and (
                        self._next - self._head >= self.depth):
                    self._cv.wait()
                if self._closed:
                    return
                token = self._next
                self._next += 1
                self._inflight.add(token)
            ok = False
            try:
                if self.refill_fault is not None:
                    self.refill_fault(token)
                self.cache.prefetch(self.session_key, step=token)
                ok = True
            except Exception:  # noqa: BLE001 — keep the stream alive: the
                # consumer computes this token's slot synchronously
                pass
            finally:
                with self._cv:
                    self._inflight.discard(token)
                    if ok:
                        self.refilled += 1
                    else:
                        self.refill_errors += 1
                    self._cv.notify_all()

    def take(self, token: int):
        """The factor set of decode step ``token``: prefetched if the ring
        kept up (waiting for a draw in progress), computed now otherwise (a
        counted miss). Raises SlotReuseError if this (session, token) was
        issued before."""
        token = int(token)
        with self._cv:
            if self._closed:
                raise RuntimeError("token-slot ring closed")
            if token in self._issued:
                raise SlotReuseError(
                    f"token slot {token} issued twice for this session")
            self._issued.add(token)
            self.consumed += 1
            if token >= self._head:
                self._head = token + 1
            if self._head > self._next:    # the consumer outran the refill
                self._next = self._head
            while token in self._inflight:  # its draw lands, then it is taken
                self._cv.wait()
            if not self.cache.prefetched(self.session_key, step=token):
                self.misses += 1
            self._cv.notify_all()          # wake the refill to top up
        return self.cache.take(self.session_key, step=token)

    def ready(self) -> int:
        """How many not-yet-taken upcoming slots are prefetched."""
        with self._lock:
            head, nxt = self._head, self._next
        return sum(self.cache.prefetched(self.session_key, step=t)
                   for t in range(head, nxt))

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"consumed": self.consumed, "refilled": self.refilled,
                    "misses": self.misses,
                    "refill_errors": self.refill_errors,
                    "depth": self.depth,
                    "pending": self._next - self._head}

    def close(self) -> None:
        """Stop the refill thread; a later ``take`` raises. Waits for a
        refill in progress to finish."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=60.0)
