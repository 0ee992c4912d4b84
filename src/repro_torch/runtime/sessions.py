"""Streaming per-token blinding slots for private decode.

Port of ``TokenSlotRing`` and ``SlotReuseError`` from
``repro/runtime/sessions.py``. A decode session consumes, at every
generated token, the (session, token, op) factor set of every offloaded op
of its scan segments: pads ``r``, factors ``u = r @ W_q`` and, under a
Freivalds policy, fold vectors. The ring keeps ``depth`` future tokens'
sets prefetched through ``BlindedLayerCache.session_factors(key,
step=token)`` — the token index rides the factor keying's ``step`` slot,
the stream a live decode step derives itself, so ring-fed and live steps
are bit-identical.

- **reuse guard**: ``take(token)`` remembers every token issued and raises
  SlotReuseError on a re-issue: pads are one-time per (session, token, op).
- **refill**: a daemon thread tops the ring up ahead of the consumer. On
  the card its field matmuls launch on the same default stream as the
  consumer's, so no event orders them. A consumer that asks for the token
  the thread is drawing waits for that draw; one that outruns the thread
  computes the slot synchronously (a counted miss), never an error.
- **fault containment**: a failing refill counts in ``refill_errors`` and
  the thread goes on; ``refill_fault`` (called with the token index) is a
  hook for scripting that failure.

``SessionPool`` (forward sessions for the serving engine) waits for the
engine slice (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Set


class SlotReuseError(RuntimeError):
    """A (session, token) factor slot was issued twice: the token's pads
    would blind two different activations."""


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
