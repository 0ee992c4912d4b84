"""Sharded blinded offload: one field matmul across many untrusted devices.

Port of ``repro/parallel/offload_sharding.py``.
The Slalom protocol offloads ``y_b = (x_b @ W_q) mod p`` to one untrusted
accelerator; this module shards each blinded matmul across a
``runtime/devices.DevicePool``, the health half of the plane. Two shard
geometries (``core/plan.ShardPolicy``):

- **rows**: shard j is rows [lo_j, hi_j) of ``x_b`` (a slice of a pad is
  a pad); the results concatenate;
- **shares**: additive secret sharing, ``x_b = (sum_j x_j) mod p`` with
  every proper subset of shares uniform, so no single device ever holds
  the full blinded tensor; each device multiplies its full-shape share and
  the results sum mod p. A share never visits a second device.

Both geometries are linear in ``x``, so the assembled result is bit-equal
to the single-device matmul.

**Shard-local Freivalds.** Every shard is checked with its own fold
vectors ``(s_j, ws_j = W_q @ s_j)`` (core/integrity.py
``shard_fold_stream``, prefetched by core/precompute.py). A corrupt result
indicts a device, not the op: only that shard is re-dispatched to another
healthy device, the pool records the failure against the slot
(quarantine/probation), and only when every device is exhausted does the
enclave compute the shard itself. Shards are always checked, so the
adaptive adversary of runtime/faults.py finds no unchecked op.

**Straggler hedging.** Shard wall times feed a ``runtime/straggler.py``
``StepWatchdog``; once warm, a shard past ``deadline_factor`` x the P50 is
duplicated onto the fastest spare healthy device and the first verified
result wins. The loser's latency still feeds its EWMA.

**Liveness ladder.** A dispatch that raises is contained as a liveness
failure of that device and only that shard re-dispatches; a dispatch past
the hard timeout (``timeout_factor`` x the same P50, floored, or
``cold_timeout_s`` before warm-up) is abandoned (``DeviceSlot.abandon``)
and re-dispatched; re-dispatches back off exponentially with
deterministic jitter; ``breaker_after`` consecutive liveness failures open
the slot's circuit breaker (runtime/devices.py). Every submitted matmul
resolves, and the result stays bit-equal.

On the card a slot's worker launches the port's kernels on its thread's
current stream (the default stream) and synchronizes it before it reports
its wall time, so the latency EWMA measures the compute and not the
launch; a slot on another card gets its operands with ``.to(device)``.

**Tracing.** One ``shard.matmul`` span per sharded op, a ``shard.dispatch``
child per dispatch (closed with its ``outcome``) and a ``shard.enclave``
child where the enclave computes a shard; every span opens on the thread
that runs the op, so the ambient parent is always right. A bad outcome
(timeout, crash, failed check) is also logged to ``recorder``, a
runtime/profiling.FlightRecorder, when one is attached.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
from concurrent.futures import FIRST_COMPLETED, wait
from contextlib import nullcontext
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import blinding as B
from repro_torch.core import integrity as IG
from repro_torch.core import prng
from repro_torch.core import tracing
from repro_torch.core.plan import SHARD_MODES
from repro_torch.kernels.limb_matmul.ops import field_matmul
from repro_torch.kernels.limb_matmul.ref import P
from repro_torch.runtime import faults as FT
from repro_torch.runtime.devices import DevicePool, DeviceSlot
from repro_torch.runtime.straggler import StepWatchdog, WatchdogConfig

# fold_in domains: additive-share masks and per-shard fault keys live in
# their own sub-spaces, disjoint from blinding/verify/fault streams
SHARE_DOMAIN = 0x5A8E
_SHARD_FAULT = 0x51


@dataclasses.dataclass
class LivenessConfig:
    """Liveness-ladder knobs. The hard timeout is ``timeout_factor`` x the
    watchdog P50 once warm (at least ``timeout_floor_s``), else
    ``cold_timeout_s``. Backoff sleeps ``base * factor^attempt * (1 +
    jitter * u)`` (at most ``backoff_max_s`` before the jitter) between
    liveness re-dispatches of one shard, u deterministic in (op, shard,
    attempt)."""
    timeout_factor: float = 8.0
    timeout_floor_s: float = 0.25
    cold_timeout_s: float = 10.0
    backoff_base_s: float = 0.005
    backoff_factor: float = 2.0
    backoff_max_s: float = 0.25
    backoff_jitter: float = 0.5


@dataclasses.dataclass
class ShardReport:
    """Per-infer outcome of the sharded plane (host-side counters)."""
    ops: int = 0                    # sharded matmuls dispatched
    dispatches: int = 0             # shard -> device submissions (all)
    checks: int = 0                 # shard-local Freivalds checks run
    failures: int = 0               # checks that mismatched
    retries: int = 0                # single-shard re-dispatches
    hedges: int = 0                 # straggler duplicates launched
    enclave_shards: int = 0         # shards the enclave computed itself
    probes: int = 0                 # probation probes routed
    crashes: int = 0                # dispatches that raised (contained)
    timeouts: int = 0               # dispatches abandoned past the deadline
    backoffs: int = 0               # backoff sleeps between re-dispatches
    breaker_probes: int = 0         # half-open liveness probes routed

    @property
    def flagged(self) -> bool:
        """A device misbehaved (even though every shard was recovered)."""
        return self.failures > 0

    def add(self, other: "ShardReport") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))


def row_spans(t: int, n: int) -> List[Tuple[int, int]]:
    """Balanced contiguous row ranges: shard j owns [lo_j, hi_j). Static in
    (t, n), so the split never depends on device health."""
    base, extra = divmod(t, n)
    spans, lo = [], 0
    for j in range(n):
        hi = lo + base + (1 if j < extra else 0)
        spans.append((lo, hi))
        lo = hi
    return spans


def additive_shares(x_field: torch.Tensor, session_key: np.ndarray,
                    op_index: int, step: int, n: int) -> List[torch.Tensor]:
    """Split ``x_field`` into n additive shares over Z_p: shares 0..n-2 are
    uniform masks from the SHARE_DOMAIN stream of (session, op, step), the
    last is the residual. Any proper subset is jointly uniform."""
    root = B.stream_key(prng.fold_in(session_key, SHARE_DOMAIN),
                        op_index, step)
    shares, acc = [], None
    for j in range(n - 1):
        m = B.blinding_stream(prng.fold_in(root, j), tuple(x_field.shape),
                              device=x_field.device)
        shares.append(m)
        acc = m if acc is None else torch.remainder(acc + m, P)
    resid = (x_field if acc is None
             else torch.remainder(x_field - acc + P, P))
    shares.append(resid)
    return shares


@dataclasses.dataclass
class _ShardTask:
    index: int                      # shard id (static)
    op_index: int                   # the blinded op this shard belongs to
    x: torch.Tensor                 # the operand this shard's device gets
    s: torch.Tensor                 # fold vectors (d_out, k)
    ws: torch.Tensor                # (d_in, k) = W_q @ s mod p
    fault_key: np.ndarray


class OffloadPlane:
    """Dispatches blinded field matmuls across a DevicePool."""

    def __init__(self, pool: DevicePool, *, mode: str = "rows",
                 hedging: bool = True,
                 watchdog: Optional[StepWatchdog] = None,
                 liveness: Optional[LivenessConfig] = None):
        assert mode in SHARD_MODES, mode
        self.pool = pool
        self.mode = mode
        self.hedging = hedging
        self.liveness = liveness or LivenessConfig()
        # shard wall times feed the watchdog; its P50 sets the hedge
        # deadline (deadline_factor x P50 after warmup)
        self.watchdog = watchdog or StepWatchdog(WatchdogConfig(
            deadline_factor=3.0, warmup_steps=4, window=64))
        self.report = ShardReport()         # current-infer counters
        self.totals = ShardReport()         # lifetime counters
        # optional runtime/profiling.FlightRecorder: bad shard outcomes land
        # in the post-mortem ring even though the plane recovers them
        self.recorder = None
        self._lock = threading.Lock()

    @property
    def n_shards(self) -> int:
        return self.pool.size

    def begin_infer(self) -> None:
        """Reset the per-infer report (the executor calls this per run)."""
        self.report = ShardReport()

    # -- internals ---------------------------------------------------------
    def _record(self, **deltas: int) -> None:
        with self._lock:
            for k, v in deltas.items():
                setattr(self.report, k, getattr(self.report, k) + v)
                setattr(self.totals, k, getattr(self.totals, k) + v)

    def _span_start(self, name: str, **attrs):
        """Open a child span of the ambient parent (the op's
        ``shard.matmul``; submission and resolution both run on the op's
        thread). None when no tracer is active."""
        tr = tracing.current_tracer()
        if tr is None:
            return None
        return tr.start_span(name, "shard", **attrs)

    def _span_end(self, span, **attrs) -> None:
        if span is None:
            return
        tr = tracing.current_tracer()
        if tr is not None:
            tr.end(span, **attrs)

    def _rec_event(self, outcome: str, slot: DeviceSlot) -> None:
        """Log a bad shard outcome to the attached flight recorder."""
        if self.recorder is not None:
            self.recorder.event("shard_" + outcome, device=slot.name)

    def _observe_latency(self, dt: float) -> None:
        with self._lock:
            self.watchdog.start_step(now=0.0)
            self.watchdog.end_step(now=dt)

    def _hedge_deadline(self) -> Optional[float]:
        with self._lock:
            return self.watchdog.deadline(floor=1e-4)

    def _dispatch_timeout(self) -> float:
        """Hard liveness deadline for one shard dispatch: the hedge's
        watchdog baseline with a larger factor and a floor."""
        lv = self.liveness
        with self._lock:
            return self.watchdog.deadline(factor=lv.timeout_factor,
                                          floor=lv.timeout_floor_s,
                                          cold=lv.cold_timeout_s)

    def _backoff(self, task: _ShardTask, attempt: int) -> None:
        """Sleep before liveness re-dispatch ``attempt`` of one shard:
        exponential, with jitter deterministic in (op, shard, attempt)."""
        lv = self.liveness
        u = random.Random(FT.stable_seed(task.op_index, task.index,
                                         attempt)).random()
        dt = min(lv.backoff_base_s * (lv.backoff_factor ** attempt),
                 lv.backoff_max_s) * (1.0 + lv.backoff_jitter * u)
        self._record(backoffs=1)
        time.sleep(dt)

    def _device_run(self, slot: DeviceSlot, task: _ShardTask,
                    w_q: torch.Tensor):
        """Runs on the slot's worker thread: the untrusted device's half.

        Returns (y_field, wall_s). The slot's fault injector corrupts the
        result where a byzantine accelerator would; the liveness injector
        crashes, parks or delays the dispatch where a dead or slow device
        would; the latency model (sim_delay_s) sleeps out a fixed
        per-dispatch delay."""
        t0 = time.perf_counter()
        if slot.liveness is not None:
            slot.liveness.perturb(op_index=task.op_index,
                                  cancel=slot.cancel)
        x, w = task.x, w_q
        if slot.device is not None:
            x, w = x.to(slot.device), w.to(slot.device)
        with (torch.cuda.device(x.device) if x.is_cuda else nullcontext()):
            y = field_matmul(x, w)
            if slot.fault is not None:
                y, _ = slot.fault.corrupt(y, op_index=task.op_index,
                                          key=task.fault_key,
                                          will_verify=True)
            if y.is_cuda:
                torch.cuda.current_stream(y.device).synchronize()
        if slot.sim_delay_s:
            time.sleep(slot.sim_delay_s)
        return y.to(task.x.device), time.perf_counter() - t0

    @staticmethod
    def _shard_ok(y: torch.Tensor, task: _ShardTask) -> bool:
        return bool(IG.fold_check(y, task.x, task.s, task.ws))

    def _enclave_shard(self, task: _ShardTask,
                       w_q: torch.Tensor) -> torch.Tensor:
        """The enclave computes this shard itself (last resort), traced as
        its own span."""
        self._record(enclave_shards=1)
        with tracing.maybe_span("shard.enclave", "shard",
                                shard=task.index, op_index=task.op_index):
            return field_matmul(task.x, w_q)

    def _resolve_shard(self, task: _ShardTask, w_q: torch.Tensor,
                       primary: DeviceSlot, fut,
                       spares: Sequence[DeviceSlot],
                       span=None) -> torch.Tensor:
        """One shard, from its submitted ``fut`` to a verified result: hedge
        onto the first spare past the straggler deadline, contain crashes,
        abandon dispatches past the hard timeout, retry failures down the
        spare list, enclave-compute as the last resort. ``span``: the
        primary dispatch's open span; every re-dispatch and hedge opens its
        own, and each closes with an ``outcome`` when its future resolves."""
        futures: Dict[object, Tuple[DeviceSlot, float, object]] = {
            fut: (primary, time.perf_counter(), span)}
        spares = list(spares)
        hedged = False
        attempt = 0                    # liveness re-dispatches of this shard
        hedge_deadline = self._hedge_deadline()

        def next_spare() -> Optional[DeviceSlot]:
            # re-check health at use time: an earlier shard of this op may
            # have indicted a spare since the list was captured
            busy = {v[0] for v in futures.values()}
            return next((s for s in spares
                         if s.available and s not in busy), None)

        def submit_to(slot: DeviceSlot, why: str) -> None:
            futures[slot.submit(self._device_run, task, w_q)] = (
                slot, time.perf_counter(),
                self._span_start("shard.dispatch", shard=task.index,
                                 op_index=task.op_index, device=slot.name,
                                 attempt=why))

        def redispatch() -> bool:
            """Backoff, then re-submit this shard to the next spare."""
            nonlocal attempt
            retry = next_spare()
            if retry is None:
                return False
            spares.remove(retry)
            attempt += 1
            self._backoff(task, attempt)
            submit_to(retry, "retry")
            self._record(dispatches=1, retries=1)
            return True

        while futures:
            hard = self._dispatch_timeout()
            now = time.perf_counter()
            wait_t = min(max(v[1] + hard - now, 0.0)
                         for v in futures.values())
            if not hedged and hedge_deadline is not None:
                wait_t = min(wait_t, hedge_deadline)
            done, _ = wait(list(futures), timeout=wait_t,
                           return_when=FIRST_COMPLETED)
            if not done:
                now = time.perf_counter()
                expired = [f for f, v in futures.items()
                           if now - v[1] >= hard]
                if expired:
                    # hard liveness timeout: indict the device, cut its
                    # wedged queue loose, re-dispatch elsewhere
                    for f in expired:
                        slot, _, sp = futures.pop(f)
                        self._span_end(sp, outcome="timeout")
                        self._record(timeouts=1)
                        self._rec_event("timeout", slot)
                        self.pool.record_liveness_failure(slot)
                        slot.abandon()
                    if not futures and not redispatch():
                        return self._enclave_shard(task, w_q)
                    continue
                # straggler (still inside the hard deadline): hedge once
                spare = next_spare()
                if self.hedging and not hedged and spare is not None:
                    hedged = True
                    spares.remove(spare)
                    submit_to(spare, "hedge")
                    self._record(dispatches=1, hedges=1)
                hedge_deadline = None  # hard expiries drive the waits now
                continue
            fut = next(iter(done))
            slot, _, sp = futures.pop(fut)
            try:
                y, dt = fut.result()
            except Exception:  # noqa: BLE001 — crash containment
                # the dispatch raised (injected crash, CUDA error,
                # abandoned-queue cancellation): a liveness failure of the
                # device, contained here
                self._span_end(sp, outcome="crash")
                self._record(crashes=1)
                self._rec_event("crash", slot)
                self.pool.record_liveness_failure(slot)
                if not futures and not redispatch():
                    return self._enclave_shard(task, w_q)
                continue
            self._observe_latency(dt)
            self._record(checks=1)
            if self._shard_ok(y, task):
                self._span_end(sp, outcome="verified", device_wall_s=dt)
                self.pool.record_success(slot, dt)
                # a hedge loser still teaches the EWMA its wall time
                for f, v in futures.items():
                    self._span_end(v[2], outcome="superseded")
                    f.add_done_callback(
                        lambda f_, s_=v[0]: self._late_latency(f_, s_))
                return y
            self._span_end(sp, outcome="verify_failed", device_wall_s=dt)
            self._record(failures=1)
            self._rec_event("verify_failed", slot)
            self.pool.record_failure(slot)
            if not futures:                    # re-dispatch this shard only
                retry = next_spare()
                if retry is None:
                    return self._enclave_shard(task, w_q)
                spares.remove(retry)
                submit_to(retry, "retry")
                self._record(dispatches=1, retries=1)
        raise AssertionError("unreachable: shard loop exited without result")

    def _late_latency(self, fut, slot: DeviceSlot) -> None:
        try:
            _, dt = fut.result()
        except Exception:  # noqa: BLE001 — a dead hedge loser is ignorable
            return
        self._observe_latency(dt)
        self.pool.record_latency(slot, dt)

    # -- public API --------------------------------------------------------
    def matmul(self, x_field: torch.Tensor, w_q: torch.Tensor, *,
               session_key: np.ndarray, op_index: int, step: int = 0,
               k: int = 1,
               folds: Optional[Sequence[Tuple[torch.Tensor,
                                              torch.Tensor]]] = None,
               mode: Optional[str] = None,
               group: Optional[Sequence[int]] = None) -> torch.Tensor:
        """``(x_field @ w_q) mod p`` sharded across the pool.

        ``folds``: per-shard (s_j, ws_j) from the precompute cache (derived
        live from the same streams when absent). ``mode``/``group``:
        per-step ShardPolicy overrides. Bit-equal to ``field_matmul(x_field,
        w_q)`` for any device behaviour the checks and retries recover."""
        mode = mode or self.mode
        assert mode in SHARD_MODES, mode
        # one "shard.matmul" span per sharded op; every dispatch, retry,
        # hedge and enclave child parents to it (all opened on this thread)
        with tracing.maybe_span("shard.matmul", "shard", op_index=op_index,
                                step=step, mode=mode,
                                n_shards=self.n_shards,
                                t=int(x_field.shape[0]),
                                d_in=int(x_field.shape[1]),
                                d_out=int(w_q.shape[1])):
            return self._sharded_matmul(x_field, w_q,
                                        session_key=session_key,
                                        op_index=op_index, step=step, k=k,
                                        folds=folds, mode=mode, group=group)

    def _sharded_matmul(self, x_field: torch.Tensor, w_q: torch.Tensor, *,
                        session_key: np.ndarray, op_index: int, step: int,
                        k: int,
                        folds: Optional[Sequence[Tuple[torch.Tensor,
                                                       torch.Tensor]]],
                        mode: str,
                        group: Optional[Sequence[int]]) -> torch.Tensor:
        n = self.n_shards
        t, _ = x_field.shape
        d_out = w_q.shape[1]
        self.pool.begin_dispatch()
        self._record(ops=1)

        if mode == "rows":
            operands = [x_field[lo:hi] for lo, hi in row_spans(t, n)]
        else:
            operands = additive_shares(x_field, session_key, op_index,
                                       step, n)

        tasks: List[Optional[_ShardTask]] = []
        fault_root = B.stream_key(prng.fold_in(session_key, _SHARD_FAULT),
                                  op_index, step)
        for j, xj in enumerate(operands):
            if xj.shape[0] == 0:               # t < n: nothing to compute
                tasks.append(None)
                continue
            if folds is not None:
                s, ws = folds[j]
            else:
                s = IG.shard_fold_stream(session_key, op_index, step, j,
                                         d_out, k, device=x_field.device)
                ws = field_matmul(w_q, s)
            tasks.append(_ShardTask(j, op_index, xj, s, ws,
                                    prng.fold_in(fault_root, j)))

        healthy = self.pool.healthy(group)
        probe = self.pool.probe_candidate(group)
        bprobe = self.pool.breaker_candidate(group)
        probe_j = max((j for j, tk in enumerate(tasks) if tk is not None),
                      default=None)
        # the liveness probe rides the lowest shard so the two probe kinds
        # never collide; with a single shard the integrity probe wins
        bprobe_j = min((j for j, tk in enumerate(tasks) if tk is not None),
                       default=None)
        if probe is not None and bprobe_j == probe_j:
            bprobe = None
        results: List[Optional[torch.Tensor]] = [None] * n
        # submit every shard's primary before resolving any, so shards on
        # distinct devices overlap
        pending = []
        for j, task in enumerate(tasks):
            if task is None:
                results[j] = torch.zeros((0, d_out), dtype=x_field.dtype,
                                         device=x_field.device)
                continue
            if probe is not None and j == probe_j:
                # the probation probe: one verified shard on the benched
                # device; a failure re-benches it and the shard retries
                primary, spares = probe, list(healthy)
            elif bprobe is not None and j == bprobe_j:
                # the breaker probe: one shard on the half-open device
                primary, spares = bprobe, list(healthy)
            elif healthy:
                if mode == "shares":
                    # a device may hold at most one share of an op: two
                    # shares could reconstruct the full blinded tensor
                    primary = healthy[j] if j < len(healthy) else None
                else:
                    primary = healthy[j % len(healthy)]
                spares = [s for s in healthy if s is not primary]
            else:
                primary, spares = None, []
            if mode == "shares":
                spares = []                # one device per share, ever
            if primary is None:
                # no device this shard may visit: the enclave computes it
                results[j] = self._enclave_shard(task, w_q)
                continue
            why = "primary"
            if primary is probe:
                self.pool.record_probe(primary)
                self._record(probes=1)
                why = "probe"
            elif primary is bprobe:
                self.pool.record_breaker_probe(primary)
                self._record(breaker_probes=1)
                why = "breaker_probe"
            span = self._span_start("shard.dispatch", shard=j,
                                    op_index=op_index, device=primary.name,
                                    attempt=why)
            fut = primary.submit(self._device_run, task, w_q)
            self._record(dispatches=1)
            pending.append((j, task, primary, fut, spares, span))
        for j, task, primary, fut, spares, span in pending:
            results[j] = self._resolve_shard(task, w_q, primary, fut,
                                             spares, span=span)

        if mode == "rows":
            return torch.cat(results, dim=0)
        out = results[0]
        for y in results[1:]:
            if y.shape[0]:
                out = torch.remainder(out + y, P)
        return out

    def snapshot(self) -> Dict[str, object]:
        lv = self.liveness
        with self._lock:
            totals = dataclasses.asdict(self.totals)
            watchdog = {
                "p50_s": self.watchdog.p50,
                "samples": len(self.watchdog.history),
                "flagged_steps": self.watchdog.flagged_steps,
                "hedge_deadline_s": self.watchdog.deadline(floor=1e-4),
                "dispatch_timeout_s": self.watchdog.deadline(
                    factor=lv.timeout_factor, floor=lv.timeout_floor_s,
                    cold=lv.cold_timeout_s),
            }
        return {"mode": self.mode, "hedging": self.hedging,
                "totals": totals, "watchdog": watchdog,
                "pool": self.pool.snapshot()}
