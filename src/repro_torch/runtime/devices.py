"""Multi-device offload pool: per-device health for the blinded plane.

Port of ``repro/runtime/devices.py``. ``DevicePool`` is the health half of
the multi-device offload plane (parallel/offload_sharding.py is the
dispatch half):

- **slots**: one per untrusted accelerator: real CUDA cards
  (``DevicePool.from_torch()``), or ``n`` simulated slots whose compute
  lands on the operands' own device (one card, or the CPU in the tests).
  Each slot keeps its own worker thread, fault injector, liveness
  injector, latency model and health state, which is what the
  dishonest-device drills exercise on a host with one card.
- **per-device telemetry**: a latency EWMA per slot (placement prefers
  fast devices) and Freivalds-failure counters fed by the shard checks.
- **per-device quarantine/probation** (integrity): ``quarantine_after``
  consecutive failed shard checks quarantine that slot only; after
  ``probation_after`` further pool dispatches it gets one verified probe
  shard: a clean check restores it, a failed one re-benches it.
- **per-device circuit breaker** (liveness): ``breaker_after``
  consecutive crashes or hard timeouts open the breaker; after a cooldown
  it half-opens for one probe shard, which closes it on a verified
  success and re-opens it, with a doubled cooldown, on a failure.

Each slot owns a single-worker thread (its dispatch queue): work for one
device serializes like a command queue, and shards to distinct slots
overlap. Streams: a worker launches on its thread's current stream, which
is the card's default stream, so the slots' kernels are ordered on the
card and their concurrency is on the host (no operand crosses streams, so
no event waits or ``record_stream`` are needed). A queue wedged by a hung
dispatch is ``abandon()``-ed: its cancel event is released, its pending
work cancelled, and a fresh queue takes its place.
"""
from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

import torch

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"


@dataclasses.dataclass
class DeviceHealthConfig:
    quarantine_after: int = 2       # consecutive failed shard checks
    probation_after: int = 4        # pool dispatches before a re-probe
    ewma_alpha: float = 0.25        # latency EWMA smoothing
    # liveness circuit breaker (independent of the integrity quarantine)
    breaker_after: int = 2          # consecutive liveness failures -> open
    breaker_cooldown: int = 4       # pool dispatches until half-open
    breaker_backoff: float = 2.0    # cooldown multiplier per failed probe
    breaker_max_cooldown: int = 64  # cooldown growth cap


class DeviceSlot:
    """One untrusted accelerator: identity, health, queue, telemetry."""

    def __init__(self, index: int, *, device=None, fault=None,
                 liveness=None, sim_delay_s: float = 0.0):
        self.index = index
        # real device, or None (simulated: compute on the operand's device)
        self.device = torch.device(device) if device is not None else None
        self.fault = fault                      # integrity injector
        self.liveness = liveness                # liveness injector
        self.sim_delay_s = sim_delay_s          # fixed per-dispatch latency
        self.name = (str(self.device) if self.device is not None
                     else f"sim:{index}")
        # health state (guarded by the pool lock)
        self.quarantined = False
        self.probation = False                  # probe-eligible
        self._cooldown = 0                      # dispatches until probation
        self.consec_failures = 0
        # liveness circuit breaker (guarded by the pool lock)
        self.breaker = BREAKER_CLOSED
        self.consec_liveness = 0
        self._breaker_cooldown = 0              # dispatches until half-open
        self._breaker_wait = 0                  # current cooldown length
        # telemetry
        self.dispatches = 0
        self.verify_failures = 0
        self.quarantines = 0
        self.probes = 0
        self.restores = 0
        self.liveness_failures = 0
        self.breaker_opens = 0
        self.breaker_probes = 0
        self.breaker_closes = 0
        self.abandons = 0
        self.ewma_latency_s: Optional[float] = None
        # the cancel event is handed to in-flight dispatches: an injected
        # hang parks on it, and abandon()/close() set it so the parked
        # worker is always reclaimable
        self.cancel = threading.Event()
        self._queue = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"offload-dev{index}")

    @property
    def available(self) -> bool:
        """Serving-eligible: neither indicted for integrity (quarantine)
        nor for liveness (open/half-open breaker — half-open only takes
        the explicit probe the plane routes it)."""
        return not self.quarantined and self.breaker == BREAKER_CLOSED

    def submit(self, fn: Callable, *args) -> Future:
        """Enqueue ``fn(self, *args)`` on this device's serial queue."""
        return self._queue.submit(fn, self, *args)

    def abandon(self) -> None:
        """Cut a wedged queue loose after a hard dispatch timeout: release
        anything parked on the cancel event, cancel queued-but-unstarted
        work, and swap in a fresh queue + event so subsequent probes do
        not line up behind the hung dispatch."""
        old_queue, old_cancel = self._queue, self.cancel
        self.cancel = threading.Event()
        self._queue = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"offload-dev{self.index}")
        self.abandons += 1
        old_cancel.set()
        old_queue.shutdown(wait=False, cancel_futures=True)

    def snapshot(self) -> Dict[str, object]:
        return {"name": self.name, "quarantined": self.quarantined,
                "probation": self.probation,
                "breaker": self.breaker, "available": self.available,
                "dispatches": self.dispatches,
                "verify_failures": self.verify_failures,
                "consec_failures": self.consec_failures,
                "liveness_failures": self.liveness_failures,
                "breaker_opens": self.breaker_opens,
                "breaker_probes": self.breaker_probes,
                "breaker_closes": self.breaker_closes,
                "abandons": self.abandons,
                "quarantines": self.quarantines, "probes": self.probes,
                "restores": self.restores,
                "ewma_latency_s": self.ewma_latency_s}

    def close(self, drain: bool = True) -> None:
        """Stop the dispatch queue. ``drain=True`` (the default) lets
        already-submitted work finish instead of orphaning it; the cancel
        event is set first so an injected hang cannot stall the drain."""
        self.cancel.set()
        self._queue.shutdown(wait=drain, cancel_futures=not drain)


class DevicePool:
    """Health-tracked device set the sharded offload plane dispatches to.

    ``n``: simulated slot count; ``devices``: explicit torch devices
    (``DevicePool.from_torch()`` wraps the host's CUDA cards).
    ``faults``: {slot index: DishonestDevice} — per-device injectors, the
    "one dishonest device in the fleet" drill the tier-1 smoke runs.
    """

    def __init__(self, n: Optional[int] = None, *,
                 devices: Optional[Sequence] = None,
                 faults: Optional[Dict[int, object]] = None,
                 liveness: Optional[Dict[int, object]] = None,
                 sim_delay_s: Optional[Dict[int, float]] = None,
                 health: Optional[DeviceHealthConfig] = None):
        assert (n is None) != (devices is None), "pass n= XOR devices="
        faults = faults or {}
        livefaults = liveness or {}
        delays = sim_delay_s or {}
        self.health = health or DeviceHealthConfig()
        self._lock = threading.Lock()
        if devices is not None:
            self.slots = [DeviceSlot(i, device=d, fault=faults.get(i),
                                     liveness=livefaults.get(i),
                                     sim_delay_s=delays.get(i, 0.0))
                          for i, d in enumerate(devices)]
        else:
            assert n >= 1, n
            self.slots = [DeviceSlot(i, fault=faults.get(i),
                                     liveness=livefaults.get(i),
                                     sim_delay_s=delays.get(i, 0.0))
                          for i in range(n)]
        self.dispatches = 0                 # plane-level matmul dispatches

    @classmethod
    def from_torch(cls, **kw) -> "DevicePool":
        """One slot per CUDA card of this host (raises without one)."""
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("DevicePool.from_torch: no CUDA device")
        return cls(devices=[torch.device("cuda", i) for i in range(n)], **kw)

    @property
    def size(self) -> int:
        return len(self.slots)

    # -- health ------------------------------------------------------------
    def n_healthy(self) -> int:
        """Integrity-healthy (non-quarantined) slots — liveness aside."""
        with self._lock:
            return sum(not s.quarantined for s in self.slots)

    def n_available(self) -> int:
        """Serving-eligible slots: neither quarantined nor breaker-open.
        Zero means only the enclave can compute."""
        with self._lock:
            return sum(s.available for s in self.slots)

    def healthy(self, group: Optional[Sequence[int]] = None
                ) -> List[DeviceSlot]:
        """Serving-eligible slots (not quarantined, breaker closed;
        optionally restricted to a device group), fastest EWMA first —
        placement prefers proven-fast parts; never-measured slots sort
        first so every device gets warmed."""
        with self._lock:
            out = [s for s in self.slots if s.available
                   and (group is None or s.index in group)]
        return sorted(out, key=lambda s: (s.ewma_latency_s is not None,
                                          s.ewma_latency_s or 0.0, s.index))

    def probe_candidate(self, group: Optional[Sequence[int]] = None
                        ) -> Optional[DeviceSlot]:
        """One probe-eligible quarantined slot (probation reached), if any.
        A slot whose breaker is also non-closed is skipped — liveness must
        be re-proven first (the breaker probe path)."""
        with self._lock:
            for s in self.slots:
                if (s.quarantined and s.probation
                        and s.breaker == BREAKER_CLOSED
                        and (group is None or s.index in group)):
                    return s
        return None

    def breaker_candidate(self, group: Optional[Sequence[int]] = None
                          ) -> Optional[DeviceSlot]:
        """One half-open slot awaiting its liveness probe, if any."""
        with self._lock:
            for s in self.slots:
                if (s.breaker == BREAKER_HALF_OPEN and not s.quarantined
                        and (group is None or s.index in group)):
                    return s
        return None

    def begin_dispatch(self) -> None:
        """One plane-level matmul dispatch: age quarantine and breaker
        cooldowns so benched devices eventually reach their probe state.
        """
        with self._lock:
            self.dispatches += 1
            for s in self.slots:
                if s.quarantined and not s.probation:
                    s._cooldown -= 1
                    if s._cooldown <= 0:
                        s.probation = True
                if s.breaker == BREAKER_OPEN:
                    s._breaker_cooldown -= 1
                    if s._breaker_cooldown <= 0:
                        s.breaker = BREAKER_HALF_OPEN

    def record_success(self, slot: DeviceSlot, latency_s: float) -> None:
        """A shard this slot computed passed its Freivalds check."""
        a = self.health.ewma_alpha
        with self._lock:
            slot.dispatches += 1
            slot.ewma_latency_s = (
                latency_s if slot.ewma_latency_s is None
                else (1 - a) * slot.ewma_latency_s + a * latency_s)
            slot.consec_failures = 0
            slot.consec_liveness = 0
            if slot.breaker == BREAKER_HALF_OPEN:
                # the liveness probe came back verified: close the breaker
                # and reset the cooldown backoff
                slot.breaker = BREAKER_CLOSED
                slot._breaker_wait = 0
                slot.breaker_closes += 1
            if slot.quarantined and slot.probation:
                # restored ONLY via the probation probe — a clean result
                # reaching a quarantined slot any other way (a spares list
                # captured before a mid-op quarantine) must not shortcut
                # the probation wait, or a probabilistic corruptor could
                # un-bench itself immediately
                slot.quarantined = False
                slot.probation = False
                slot.restores += 1

    def record_latency(self, slot: DeviceSlot, latency_s: float) -> None:
        """EWMA-only update — a hedge loser's wall time teaches placement
        to avoid a chronic straggler without touching its health state
        (its Freivalds check never ran)."""
        a = self.health.ewma_alpha
        with self._lock:
            slot.ewma_latency_s = (
                latency_s if slot.ewma_latency_s is None
                else (1 - a) * slot.ewma_latency_s + a * latency_s)

    def record_probe(self, slot: DeviceSlot) -> None:
        """The plane routed a probe shard to a quarantined slot."""
        with self._lock:
            slot.probes += 1

    def record_breaker_probe(self, slot: DeviceSlot) -> None:
        """The plane routed a liveness probe to a half-open slot."""
        with self._lock:
            slot.breaker_probes += 1

    def record_liveness_failure(self, slot: DeviceSlot) -> None:
        """A dispatch to this slot crashed or exceeded the hard timeout.

        Liveness failures feed the circuit breaker, NOT the integrity
        quarantine — a crashing device never returned a wrong result, so
        conflating the two would let an attacker convert cheap crashes
        into integrity convictions (and vice versa would let a corruptor
        hide behind breaker half-open resets)."""
        with self._lock:
            slot.dispatches += 1
            slot.liveness_failures += 1
            slot.consec_liveness += 1
            if slot.breaker == BREAKER_HALF_OPEN:
                # failed probe: re-open with a longer cooldown (capped)
                slot.breaker = BREAKER_OPEN
                slot._breaker_wait = min(
                    max(int(slot._breaker_wait
                            * self.health.breaker_backoff), 1),
                    self.health.breaker_max_cooldown)
                slot._breaker_cooldown = slot._breaker_wait
            elif (slot.breaker == BREAKER_CLOSED
                  and slot.consec_liveness >= self.health.breaker_after):
                slot.breaker = BREAKER_OPEN
                slot._breaker_wait = self.health.breaker_cooldown
                slot._breaker_cooldown = slot._breaker_wait
                slot.breaker_opens += 1

    def record_failure(self, slot: DeviceSlot) -> None:
        """A shard this slot computed FAILED its Freivalds check."""
        with self._lock:
            slot.dispatches += 1
            slot.verify_failures += 1
            slot.consec_failures += 1
            if slot.quarantined:                # failed probe: re-bench
                slot.probation = False
                slot._cooldown = self.health.probation_after
            elif slot.consec_failures >= self.health.quarantine_after:
                slot.quarantined = True
                slot.probation = False
                slot._cooldown = self.health.probation_after
                slot.quarantines += 1

    def snapshot(self) -> Dict[str, object]:
        return {"size": self.size, "healthy": self.n_healthy(),
                "available": self.n_available(),
                "dispatches": self.dispatches,
                "slots": [s.snapshot() for s in self.slots]}

    def close(self, drain: bool = True) -> None:
        for s in self.slots:
            s.close(drain=drain)
