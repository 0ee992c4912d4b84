"""Dishonest and unresponsive devices: fault injection under the device
matmul.

Port of ``repro/runtime/faults.py``. The untrusted accelerator is untrusted
for integrity as well as privacy. ``DishonestDevice`` sits at the device
boundary: core/slalom.py (and a slot of the offload plane) hands it the
device's field-domain result and it returns a possibly corrupted one, so
the enclave's Freivalds layer (core/integrity.py) sees what a byzantine
backend would feed it. Integrity fault classes (``FaultSpec.kind``):

- ``bit_flip``  one bit of one field element flips;
- ``row_swap``  two result rows are exchanged;
- ``stale``     a replayed result: a uniform field offset on every element;
- ``adaptive``  a bit flip only on ops that will NOT be verified (it knows
                the sampling schedule): defeats ``sampled``, never ``full``.

Every decision is a pure function of the per-(session, op, step) fault key
(threefry, core/prng.py), so the port corrupts exactly the elements the
reference corrupts, and a session replays identically.

``UnresponsiveDevice`` is the availability half: a device that returns no
result (``crash``, ``hang``, ``flaky``) or a late one (``brownout``). It
perturbs the offload plane's slot dispatch on the slot's worker thread.
Its decisions are pure functions of (seed, op, attempt).
"""
from __future__ import annotations

import random
import threading
import zlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import blinding as B
from repro_torch.core import prng
from repro_torch.kernels.limb_matmul.ref import P

KINDS = ("bit_flip", "row_swap", "stale", "adaptive")
LIVENESS_KINDS = ("crash", "hang", "flaky", "brownout")


class DeviceCrash(RuntimeError):
    """The untrusted device raised (or was abandoned) mid-dispatch."""


def stable_seed(*parts) -> int:
    """Process-independent integer seed from reprable parts (``hash`` of a
    tuple changes with PYTHONHASHSEED)."""
    return zlib.crc32(repr(parts).encode())


@dataclass(frozen=True)
class LivenessSpec:
    """Liveness-corruption plan for one device. ``prob``: per-attempt
    trigger probability; ``decay``: ``flaky`` multiplies it by this per
    attempt on the same op; ``delay_s``: ``brownout`` latency; ``ops``:
    targeted op indices (None = every op)."""
    kind: str
    prob: float = 1.0
    decay: float = 0.5
    delay_s: float = 0.05
    ops: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        assert self.kind in LIVENESS_KINDS, self.kind
        assert 0.0 < self.prob <= 1.0, self.prob
        assert 0.0 <= self.decay <= 1.0, self.decay
        assert self.delay_s >= 0.0, self.delay_s


class UnresponsiveDevice:
    """Host-side liveness injector; ``perturb`` runs on the slot's worker
    thread before its compute."""

    def __init__(self, spec: LivenessSpec, seed: int = 0):
        self.spec = spec
        self.seed = seed
        self.fired = 0                     # perturbations that triggered
        self._attempts: Dict[int, int] = {}
        self._lock = threading.Lock()

    def _attempt(self, op_index: int) -> int:
        with self._lock:
            k = self._attempts.get(op_index, 0)
            self._attempts[op_index] = k + 1
        return k

    def _gate(self, op_index: int, attempt: int, prob: float) -> bool:
        if prob >= 1.0:
            return True
        u = random.Random(stable_seed(self.seed, self.spec.kind, op_index,
                                      attempt)).random()
        return u < prob

    def perturb(self, *, op_index: int, cancel: threading.Event) -> None:
        """Crash, park, delay, or pass through. An injected hang parks on
        ``cancel`` (the slot's abandon/shutdown event), so a timed-out
        dispatch or a draining close always reclaims the worker."""
        spec = self.spec
        if spec.ops is not None and op_index not in spec.ops:
            return
        attempt = self._attempt(op_index)
        if spec.kind == "brownout":
            if self._gate(op_index, attempt, spec.prob):
                self.fired += 1
                cancel.wait(timeout=spec.delay_s)
            return
        prob = spec.prob
        if spec.kind == "flaky":
            prob = spec.prob * (spec.decay ** attempt)
        if not self._gate(op_index, attempt, prob):
            return
        self.fired += 1
        if spec.kind == "hang":
            cancel.wait()                  # parked until abandon/close
        raise DeviceCrash(f"{spec.kind} (op {op_index}, "
                          f"attempt {attempt})")


# fold_in sub-domains of the per-op fault key
_SUB_GATE = 0
_SUB_PICK = 1
_SUB_STALE = 2


@dataclass(frozen=True)
class FaultSpec:
    """Corruption plan. ``ops``: targeted blinded-op indices (None =
    every op); ``prob``: per-(op, session) corruption probability (1.0 is
    a persistent adversary, < 1 a flaky part)."""
    kind: str
    prob: float = 1.0
    ops: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        assert self.kind in KINDS, self.kind
        assert 0.0 < self.prob <= 1.0, self.prob


def _draw(key, lo: int, hi: int) -> int:
    return int(prng.randint(key, (), lo, hi))


class DishonestDevice:
    """Corrupts field-domain matmul results."""

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self.targeted_ops = 0
        self._lock = threading.Lock()

    def _bit_flip(self, y: torch.Tensor, key) -> torch.Tensor:
        t, d = y.shape
        ki, kj, kb = prng.split(prng.fold_in(key, _SUB_PICK), 3)
        i, j, b = _draw(ki, 0, t), _draw(kj, 0, d), _draw(kb, 0, 23)
        out = y.clone()
        out[i, j] = torch.remainder(y[i, j] ^ (1 << b), P)
        return out

    def _row_swap(self, y: torch.Tensor, key) -> torch.Tensor:
        t = y.shape[0]
        if t < 2:
            return y
        ka, ko = prng.split(prng.fold_in(key, _SUB_PICK))
        a = _draw(ka, 0, t)
        bb = (a + _draw(ko, 1, t)) % t
        idx = torch.arange(t, device=y.device)
        idx[a], idx[bb] = bb, a
        return y.index_select(0, idx)

    def _stale(self, y: torch.Tensor, key) -> torch.Tensor:
        off = B.blinding_stream(prng.fold_in(key, _SUB_STALE),
                                tuple(y.shape), device=y.device)
        return torch.remainder(y + off, P)

    def corrupt(self, y_field: torch.Tensor, *, op_index: int, key,
                will_verify: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """Possibly corrupt one device result.

        y_field: (t, d_out) int32 in [0, p); key: the per-(session, op,
        step) fault key; will_verify: the integrity layer's check/skip
        decision for this op (only ``adaptive`` reads it). Returns
        ``(y', changed)``, ``changed`` a 0-d bool tensor: the ground truth
        the IntegrityReport exposes."""
        spec = self.spec
        if spec.ops is not None and op_index not in spec.ops:
            return y_field, torch.zeros((), dtype=torch.bool,
                                        device=y_field.device)
        with self._lock:                   # slots corrupt from worker threads
            self.targeted_ops += 1
        gate = True
        if spec.prob < 1.0:
            gate = bool(prng.uniform(prng.fold_in(key, _SUB_GATE))
                        < np.float32(spec.prob))
        if spec.kind == "adaptive":
            gate = gate and not will_verify
        y_out = y_field
        if gate:
            if spec.kind in ("bit_flip", "adaptive"):
                y_out = self._bit_flip(y_field, key)
            elif spec.kind == "row_swap":
                y_out = self._row_swap(y_field, key)
            else:
                y_out = self._stale(y_field, key)
        return y_out, (y_out != y_field).any()
