"""Deterministic chaos harness: scripted faults across serving layers.

Port of ``repro/runtime/chaos.py``.

The integrity and liveness ladders (DESIGN.md §9/§11/§12) are recovery
machinery; this module is the *drill sergeant* that proves they work as a
system. A ``ChaosSchedule`` arms and disarms faults at scripted batch
indices across three layers:

- **device** (``dev{i}.{kind}@a-b``): installs a runtime/faults
  ``UnresponsiveDevice`` of the given liveness kind (``crash`` / ``hang``
  / ``flaky`` / ``brownout``) on DevicePool slot ``i`` for batches a..b
  inclusive, then removes it — the breaker/timeout/backoff ladder must
  absorb the window and re-admit the device afterwards;
- **session-refill** (``refill@a-b``): the SessionPool's prefetch raises
  for those batches (``refill_fault`` hook) — factor generation falls
  back to the request path, ``refill_errors`` must count it, serving must
  not stop;
- **sealing** (``seal@a-b``): every request dispatched in those batches
  gets its MAC flipped in flight — the enclave must reject exactly those
  requests (``mac_failed``) without disturbing the rest of the batch.

Everything is deterministic: the schedule is a pure function of batch
index, and the device injectors draw per-(seed, op, attempt) decisions —
the same schedule replays the same run (runtime/faults.py). The engine
advances the clock (``ChaosController.on_batch``) once per dispatched
batch of the chaotic model; ``launch/serve.py --chaos`` drives the drill.

The chaos invariant the drills assert: under any schedule, every
submitted future resolves (ok, flagged-recovered, or an explicit error),
the engine never stops serving, and recovered outputs are bit-exact
against a healthy oracle. A ``SealedBox`` MAC is a Python int here, so
the seal window flips its low bit as ``(mac ^ 1) & 0xFFFFFFFF``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

from repro_torch.runtime.faults import (LIVENESS_KINDS, LivenessSpec,
                                        UnresponsiveDevice)

LAYERS = ("device", "refill", "seal")


class RefillChaos(RuntimeError):
    """Injected session-refill failure (scripted, not a real fault)."""


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One armed window: ``layer`` fault active for batches
    [start, stop], both inclusive (batch indices are per-model dispatch
    counts, the engine's drill clock)."""
    layer: str
    start: int
    stop: int
    device: Optional[int] = None    # device layer only
    kind: Optional[str] = None      # liveness kind (device layer only)
    prob: float = 1.0
    delay_s: float = 0.05           # brownout inflation

    def __post_init__(self):
        assert self.layer in LAYERS, self.layer
        assert 0 <= self.start <= self.stop, (self.start, self.stop)
        if self.layer == "device":
            assert self.device is not None and self.device >= 0
            assert self.kind in LIVENESS_KINDS, self.kind

    def active(self, batch: int) -> bool:
        return self.start <= batch <= self.stop

    @property
    def label(self) -> str:
        span = (f"@{self.start}" if self.start == self.stop
                else f"@{self.start}-{self.stop}")
        if self.layer == "device":
            return f"dev{self.device}.{self.kind}{span}"
        return f"{self.layer}{span}"


_EVENT_RE = re.compile(
    r"^(?:dev(?P<dev>\d+)\.(?P<kind>[a-z_]+)|(?P<layer>refill|seal))"
    r"@(?P<start>\d+)(?:-(?P<stop>\d+))?$")


@dataclasses.dataclass
class ChaosSchedule:
    """An ordered list of ChaosEvents (order is cosmetic — activation is
    purely by batch index, so overlapping windows compose)."""
    events: List[ChaosEvent]

    @classmethod
    def parse(cls, text: str) -> "ChaosSchedule":
        """Mini-language: comma-separated ``dev{i}.{kind}@a[-b]``,
        ``refill@a[-b]``, ``seal@a[-b]`` — e.g. the drill
        ``dev0.crash@1-2,dev1.hang@1-2,refill@4-5,seal@6``."""
        events: List[ChaosEvent] = []
        for part in filter(None, (p.strip() for p in text.split(","))):
            m = _EVENT_RE.match(part)
            if m is None:
                raise ValueError(
                    f"bad chaos event {part!r} (want dev<i>.<kind>@a[-b], "
                    f"refill@a[-b] or seal@a[-b])")
            start = int(m["start"])
            stop = int(m["stop"]) if m["stop"] is not None else start
            if m["dev"] is not None:
                if m["kind"] not in LIVENESS_KINDS:
                    raise ValueError(
                        f"bad liveness kind {m['kind']!r} in {part!r} "
                        f"(want one of {LIVENESS_KINDS})")
                events.append(ChaosEvent("device", start, stop,
                                         device=int(m["dev"]),
                                         kind=m["kind"]))
            else:
                events.append(ChaosEvent(m["layer"], start, stop))
        if not events:
            raise ValueError(f"empty chaos schedule {text!r}")
        return cls(events)

    @property
    def horizon(self) -> int:
        """First batch index past every window (all faults disarmed)."""
        return max(ev.stop for ev in self.events) + 1

    def __str__(self) -> str:
        return ",".join(ev.label for ev in self.events)


class ChaosController:
    """Binds a schedule to a live engine's fault surfaces and advances it.

    ``on_batch(idx)`` is called by the engine once per dispatched batch
    (runtime/engine.py ``_dispatch``): events entering their window arm
    (device injector installed / refill hook set / request MACs flipped),
    events leaving it disarm. The arm/disarm ``log`` plus the per-layer
    counters are what the drills and the bench assert against.
    """

    def __init__(self, schedule: ChaosSchedule, *, pool=None,
                 sessions=None, seed: int = 0):
        self.schedule = schedule
        self.pool = pool                # runtime/devices.DevicePool
        self.sessions = sessions        # runtime/sessions.SessionPool
        self.seed = seed
        self.batch = -1                 # last batch index seen
        self.log: List[Tuple[int, str, str]] = []   # (batch, label, action)
        self.seal_corruptions = 0
        self.refill_faults = 0          # injected refill raises
        self._armed: Dict[int, object] = {}         # event idx -> injector

    def bind(self, *, pool=None, sessions=None) -> None:
        """Late-bind the fault surfaces (the engine owns their lifetimes:
        register_executor calls this once the pools exist)."""
        if pool is not None:
            self.pool = pool
        if sessions is not None:
            self.sessions = sessions

    # -- arming ------------------------------------------------------------
    def _arm(self, i: int, ev: ChaosEvent, batch: int) -> None:
        if ev.layer == "device":
            assert self.pool is not None, "device chaos needs a DevicePool"
            spec = LivenessSpec(kind=ev.kind, prob=ev.prob,
                                delay_s=ev.delay_s)
            injector = UnresponsiveDevice(spec, seed=(self.seed, i))
            self.pool.slots[ev.device].liveness = injector
            self._armed[i] = injector
        elif ev.layer == "refill":
            assert self.sessions is not None, "refill chaos needs a pool"

            def fail(counter: int, _ev=ev) -> None:
                self.refill_faults += 1
                raise RefillChaos(f"scripted refill fault ({_ev.label})")

            self.sessions.refill_fault = fail
            self._armed[i] = fail
        else:                           # seal: applied per batch in on_batch
            self._armed[i] = True
        self.log.append((batch, ev.label, "arm"))

    def _disarm(self, i: int, ev: ChaosEvent, batch: int) -> None:
        injector = self._armed.pop(i)
        if ev.layer == "device":
            slot = self.pool.slots[ev.device]
            if slot.liveness is injector:   # overlapping windows: last wins
                slot.liveness = None
        elif ev.layer == "refill":
            if self.sessions.refill_fault is injector:
                self.sessions.refill_fault = None
        self.log.append((batch, ev.label, "disarm"))

    # -- the drill clock ----------------------------------------------------
    def on_batch(self, batch: int, requests=None) -> None:
        """Advance to batch ``batch``: arm/disarm every event whose window
        boundary was crossed, then corrupt this batch's request MACs if a
        seal window is active. Idempotent per index and tolerant of
        skipped indices (activation is absolute, not incremental)."""
        self.batch = batch
        seal_active = False
        for i, ev in enumerate(self.schedule.events):
            armed = i in self._armed
            if ev.active(batch) and not armed:
                self._arm(i, ev, batch)
            elif not ev.active(batch) and armed:
                self._disarm(i, ev, batch)
            if ev.layer == "seal" and ev.active(batch):
                seal_active = True
        if seal_active and requests:
            for r in requests:
                # flip one MAC bit in flight: the enclave's unseal must
                # reject exactly this request (mac_failed), nothing else
                r.box = r.box._replace(mac=(r.box.mac ^ 1) & 0xFFFFFFFF)
                self.seal_corruptions += 1

    def quiesce(self, batch: Optional[int] = None) -> None:
        """Force-disarm everything (end of drill / engine close)."""
        b = batch if batch is not None else self.batch
        for i, ev in enumerate(self.schedule.events):
            if i in self._armed:
                self._disarm(i, ev, b)

    def snapshot(self) -> Dict[str, object]:
        return {"schedule": str(self.schedule), "batch": self.batch,
                "armed": sorted(self.schedule.events[i].label
                                for i in self._armed),
                "seal_corruptions": self.seal_corruptions,
                "refill_faults": self.refill_faults,
                "log": list(self.log)}
