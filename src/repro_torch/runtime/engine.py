"""Continuous micro-batching serving engine over a registry of enclaves.

Port of ``repro/runtime/engine.py``. ``ServingEngine`` is the serving layer
in front of the Origami executors:

- **request queue with admission control**: ``submit`` returns a future
  at once; past ``max_queue`` in-flight requests the engine sheds load
  (``Response.ok=False``, ``error="rejected"``), and a per-request
  deadline drops work that can no longer be served in time before it
  costs an unseal or an inference slot;
- **continuous micro-batcher**: requests bucket by (model, input shape); a
  bucket dispatches as soon as it holds ``max_batch`` requests or its
  oldest request has waited ``max_wait_ms``, and is padded to the
  smallest power-of-two shape bucket (runtime/aot.py ``bucket_for``);
- **out-of-order completion**: responses resolve per-request futures keyed
  by (model, rid), so a later model's full bucket completes before an
  earlier partial bucket flushes on its timer;
- **per-model registry**: one engine serves several models (VGG-16 and
  VGG-19 at once), each with its own OrigamiExecutor, attestation quote,
  blinding ``SessionPool`` (runtime/sessions.py) and partition plan from
  core/planner.py;
- **integrity and liveness**: a model whose Freivalds checks keep failing
  is quarantined (its batches run trusted, in the enclave) and earns a
  verified probe after ``probation_after`` trusted batches; a model with
  a DevicePool whose every slot is benched degrades to verified
  enclave-only dispatch and recovers when a slot becomes a probe
  candidate again;
- **compile-once serving**: every executor attaches the engine's shared
  ``CompileCache``. On the card an executable is a CUDA graph of the eager
  step; ``aot_warm`` captures every (trace kind, shape bucket) at
  registration, so the first request pays no capture. The cache is
  memory only: a CUDA graph cannot be serialized, and
  ``EngineConfig(compile_cache_dir=...)`` raises;
- **two-stage pipeline**: the enclave stage (unseal -> MAC filter ->
  bucket pad) runs on the batcher thread, the device stage (blinded infer
  -> verify -> recovery -> seal) on a worker thread, joined by a bounded
  handoff queue, so batch N+1's unseal overlaps batch N's device work.
  ``pipeline=False`` runs both stages on the batcher thread,
  bit-identically;
- **draining shutdown**: ``close()`` stops admission, flushes what is
  queued, drains the device stage, resolves anything left with
  ``error="shutdown"``, then stops the session pools and device queues.

Every batch completes on the single device-stage thread in handoff order
(a chaos-bound model defers even its unseal there, so that scripted
sealed-box corruption lands before the MAC check), so the per-model
state, the watchdog and the quarantine and degradation machines need no
lock.

Threads on the card: the batcher (unseal, on the CPU for client-sealed
requests; the stacked batch moves to the card in the executor), the
device-stage worker (infer, verify, recovery, seal; it replays CUDA graphs
captured on the registering thread), the session pools' refill threads
and the DevicePool slot workers all launch on the card's default stream,
so no operand crosses streams.
"""
from __future__ import annotations

import dataclasses
import queue as queue_mod
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tracing
from repro_torch.core.attestation import Quote, measure_enclave
from repro_torch.core.origami import OrigamiExecutor
from repro_torch.core.plan import PlacementPlan
from repro_torch.core.planner import PartitionPlan, PartitionPlanner
from repro_torch.core.sealing import seal, unseal
from repro_torch.runtime.aot import CompileCache, bucket_ladder
from repro_torch.runtime.devices import DevicePool
from repro_torch.runtime.observability import MetricsRegistry, sync_struct
from repro_torch.runtime.profiling import CriticalPathProfiler, FlightRecorder
from repro_torch.models.model import torch_dtype
from repro_torch.runtime.serving import (Request, Response,
                                         complete_prepared_batch,
                                         prepare_sealed_batch,
                                         request_nonce, response_nonce)
from repro_torch.runtime.sessions import SessionPool
from repro_torch.runtime.straggler import StepWatchdog


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    max_wait_ms: float = 5.0            # bucket age that forces a flush
    max_queue: int = 256                # admission-control bound (in-flight)
    default_deadline_s: Optional[float] = None
    session_pool_depth: int = 4
    # integrity (DESIGN.md §9): grant one fresh-session device retry after
    # a failed Freivalds check before the enclave recomputes, and after
    # ``quarantine_after`` consecutive failing batches stop offloading to
    # that model's backend at all (every dispatch runs trusted). After
    # ``probation_after`` trusted batches the backend earns one probation
    # probe: a verified offload dispatch — a clean probe restores offload
    # (a transient fault heals), a dirty one re-benches it. Models
    # registered with a DevicePool skip this path entirely — their
    # quarantine/probation is per-DEVICE (runtime/devices.py), so one bad
    # part never benches the whole model.
    integrity_retry: bool = True
    quarantine_after: int = 3
    probation_after: int = 8
    # compile-once serving: ``aot_warm`` captures every (trace kind, shape
    # bucket) executable at register time (and runs one seal/unseal round
    # at the request and response shapes), so the first request pays no
    # capture. Warm is opt-in because it builds the whole bucket ladder up
    # front, which a short-lived engine hitting one shape never amortizes.
    # ``compile_cache_dir`` is kept for the reference's signature and
    # raises: a CUDA graph cannot be serialized (runtime/aot.py).
    compile_cache_dir: Optional[str] = None
    aot_warm: bool = False
    # two-stage enclave/device pipeline: ``pipeline_depth`` bounds the
    # prepared-batch handoff queue (the batcher blocks past it — natural
    # backpressure); ``pipeline=False`` collapses both stages onto the
    # batcher thread (the serial dispatch, bit-identical)
    pipeline: bool = True
    pipeline_depth: int = 2


@dataclasses.dataclass
class _Pending:
    model: str
    req: Request
    future: Future
    submit_t: float
    deadline_s: Optional[float]
    # trace plane (core/tracing.py): the per-request root span and its
    # open "queue" child, both None when the engine has no tracer
    span: Optional[object] = None
    queue_span: Optional[object] = None


@dataclasses.dataclass
class _ModelEntry:
    name: str
    cfg: ModelConfig
    executor: OrigamiExecutor
    quote: Quote
    pool: SessionPool
    plan: PartitionPlan                  # prefix-decision provenance
    placement: PlacementPlan = None      # the per-layer IR actually executed
    input_key: str = "images"
    input_dtype: object = None           # cast unsealed floats (LM tokens)
    # integrity bookkeeping (batcher thread only — no locking needed)
    integrity_failures: int = 0          # total failed-check batches
    consec_failures: int = 0             # consecutive (resets on clean)
    quarantined: bool = False            # offload disabled, enclave serves
    trusted_streak: int = 0              # trusted batches since quarantine
    probations: int = 0                  # probe dispatches attempted
    restores: int = 0                    # probes that re-admitted offload
    # liveness / degradation bookkeeping (batcher thread only, §12)
    batches: int = 0                     # dispatches (the chaos clock)
    degraded: bool = False               # pool empty: enclave-only serving
    degradations: int = 0                # healthy -> degraded transitions
    recoveries: int = 0                  # degraded -> healthy transitions
    degraded_batches: int = 0            # batches served enclave-only
    chaos: Optional[object] = None       # runtime/chaos.ChaosController
    # flight-recorder trigger edges (batcher thread only): per-device
    # breaker/quarantine transitions are detected as counter increases
    # across dispatches, since the transitions happen inside the plane
    breaker_opens_seen: int = 0
    dev_quarantines_seen: int = 0


@dataclasses.dataclass
class _BatchWork:
    """Handoff unit between the enclave stage and the device stage.

    ``prep`` is the enclave stage's product (serving.PreparedBatch); None
    means the enclave stage was deferred into the completion stage (serial
    ``pipeline=False`` dispatch, or a chaos-bound model whose drill must
    corrupt sealed boxes before the MAC check)."""
    entry: _ModelEntry
    batch: List[_Pending]
    batch_span: Optional[object]
    prep: Optional[object]


class EngineStats:
    """Aggregate serving telemetry — a facade over ``MetricsRegistry``.

    Counters used to live as bare ints bumped with ``+=`` from the
    submit path, the batcher thread and (via snapshot reads) any caller
    thread — unsynchronized read-modify-write. Every counter now lives in
    the registry under its DESIGN.md §13 name; attribute access keeps
    working (``stats.batches`` reads the registry) so existing tests and
    benches hold, but *mutation* should go through ``inc``/``inc_many``,
    which are atomic under the registry's lock. ``stats.lock`` aliases
    that (re-entrant) lock, so legacy ``with stats.lock: stats.x += 1``
    blocks remain correct rather than deadlocking.
    """

    LAT_WINDOW = 4096
    LATENCY_HIST = "engine.latency_s"

    # attribute -> registry counter name (the §13 naming scheme: one
    # dotted namespace per stat surface)
    COUNTERS = {
        "submitted": "engine.submitted",
        "completed": "engine.completed",
        "rejected": "engine.rejected",           # admission control
        "expired": "engine.expired",             # deadline before dispatch
        "mac_failures": "engine.mac_failures",
        "batches": "engine.batches",
        "padded_slots": "engine.padded_slots",
        "batched_requests": "engine.batched_requests",
        # integrity counters (DESIGN.md §9)
        "verify_checks": "integrity.verify_checks",
        "verify_failures": "integrity.verify_failures",
        "device_retries": "integrity.device_retries",
        "recomputes": "integrity.recomputes",
        "trusted_batches": "integrity.trusted_batches",
        "quarantines": "integrity.quarantines",
        "probations": "integrity.probations",
        "probation_restores": "integrity.probation_restores",
        # multi-device plane counters (DESIGN.md §11)
        "shard_checks": "shard.checks",
        "shard_failures": "shard.failures",
        "shard_retries": "shard.retries",
        "shard_hedges": "shard.hedges",
        "shard_enclave": "shard.enclave",
        # liveness plane counters (DESIGN.md §12)
        "shard_crashes": "liveness.shard_crashes",
        "shard_timeouts": "liveness.shard_timeouts",
        "degradations": "liveness.degradations",
        "recoveries": "liveness.recoveries",
        "degraded_batches": "liveness.degraded_batches",
        "shutdown_drops": "liveness.shutdown_drops",
    }

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        self.registry = registry if registry is not None else MetricsRegistry()
        self.lock = self.registry.lock
        for metric in self.COUNTERS.values():
            self.registry.set_counter(metric, 0)
        self.start_t = time.monotonic()
        self.first_batch_t: Optional[float] = None
        self.first_submit_t: Optional[float] = None
        # request-path compile seconds accrued by the time the first batch
        # completed (CompileCache.request_compile_seconds) — what separates
        # ttfb_cold_s from ttfb_warm_s
        self.first_batch_compile_s: float = 0.0

    # -- recording ---------------------------------------------------------
    def inc(self, attr: str, n: int = 1) -> None:
        """Atomically bump one counter by its legacy attribute name."""
        self.registry.inc(self.COUNTERS[attr], n)

    def inc_many(self, **deltas: int) -> None:
        """Atomically bump several counters (one lock acquisition)."""
        self.registry.inc_many(
            **{self.COUNTERS[a]: n for a, n in deltas.items()})

    def record_submit(self) -> None:
        with self.lock:
            if self.first_submit_t is None:
                self.first_submit_t = time.monotonic()
            self.inc("submitted")

    def record_batch(self, n_valid: int, pad: int,
                     request_compile_s: Optional[float] = None) -> None:
        with self.lock:
            if self.first_batch_t is None:
                self.first_batch_t = time.monotonic()
                self.first_batch_compile_s = float(request_compile_s or 0.0)
            self.inc_many(batches=1, batched_requests=n_valid,
                          padded_slots=pad)

    def record_done(self, latency_s: float) -> None:
        with self.lock:
            self.inc("completed")
            self.registry.observe(self.LATENCY_HIST, latency_s)

    # -- derived -----------------------------------------------------------
    @property
    def latencies(self) -> List[float]:
        return self.registry.hist_values(self.LATENCY_HIST)

    @property
    def time_to_first_batch_s(self) -> Optional[float]:
        if self.first_batch_t is None:
            return None
        return self.first_batch_t - self.start_t

    @property
    def ttfb_cold_s(self) -> Optional[float]:
        """First submit -> first completed batch, compile included."""
        if self.first_batch_t is None or self.first_submit_t is None:
            return None
        return self.first_batch_t - self.first_submit_t

    @property
    def ttfb_warm_s(self) -> Optional[float]:
        """``ttfb_cold_s`` minus the request-path capture seconds measured
        by the CompileCache up to the first batch — what a warmed engine
        delivers.
        Equals ``ttfb_cold_s`` when registration pre-compiled everything
        (there was no request-path compile left to subtract)."""
        cold = self.ttfb_cold_s
        if cold is None:
            return None
        return max(0.0, cold - self.first_batch_compile_s)

    def _quantile(self, q: float) -> Optional[float]:
        lat = sorted(self.latencies)
        if not lat:
            return None
        return lat[min(len(lat) - 1, int(q * len(lat)))]

    def p50_latency_s(self) -> Optional[float]:
        return self._quantile(0.50)

    def p95_latency_s(self) -> Optional[float]:
        return self._quantile(0.95)

    def snapshot(self, engine: "ServingEngine") -> Dict[str, object]:
        c = {attr: self.registry.get(m) for attr, m in self.COUNTERS.items()}
        out: Dict[str, object] = {
            "submitted": c["submitted"], "completed": c["completed"],
            "rejected": c["rejected"], "expired": c["expired"],
            "mac_failures": c["mac_failures"], "batches": c["batches"],
            "padded_slots": c["padded_slots"],
            "batched_requests": c["batched_requests"],
        }
        out["queue_depth"] = engine.queue_depth()
        out["time_to_first_batch_s"] = self.time_to_first_batch_s
        out["ttfb_cold_s"] = self.ttfb_cold_s
        out["ttfb_warm_s"] = self.ttfb_warm_s
        out["p50_latency_s"] = self.p50_latency_s()
        out["p95_latency_s"] = self.p95_latency_s()
        out["aot"] = engine.aot.stats()
        out["integrity"] = {
            k: c[k] for k in (
                "verify_checks", "verify_failures", "device_retries",
                "recomputes", "trusted_batches", "quarantines",
                "probations", "probation_restores", "shard_checks",
                "shard_failures", "shard_retries", "shard_hedges",
                "shard_enclave")}
        out["liveness"] = {
            k: c[k] for k in (
                "shard_crashes", "shard_timeouts", "degradations",
                "recoveries", "degraded_batches", "shutdown_drops")}
        # per-device health of every model running a sharded offload plane
        # (quarantine is per-DEVICE there, not per-model)
        out["devices"] = {
            name: e.executor.plane.snapshot()
            for name, e in engine.models.items()
            if e.executor.plane is not None}
        out["sessions"] = {name: e.pool.stats()
                           for name, e in engine.models.items()}
        # a persistently failing refill thread silently puts every factor
        # matmul back on the hot path — surface it at the top level too,
        # not just per-model under "sessions"
        out["refill_errors"] = sum(s["refill_errors"]
                                   for s in out["sessions"].values())
        # offload counters read the *blinded*-trace snapshot so a recovery
        # (trusted) trace can never pollute them; trusted_matmuls reads the
        # trusted-trace snapshot for the same reason
        out["matmuls"] = {
            name: {"mode": e.executor.plan.mode_label,
                   "plan": e.executor.plan.digest[:12],
                   "device": e.executor.telemetry_blinded.device_matmuls,
                   "enclave": e.executor.telemetry_blinded.enclave_matmuls}
            for name, e in engine.models.items()}
        # the effective policy is the executor-wide one OR the plan's
        # per-step policies (a vopen plan verifies with integrity=None —
        # reporting "off" for it would contradict the nonzero
        # verify_checks above)
        out["models"] = {
            name: {"policy": (e.executor.integrity.mode
                              if e.executor.integrity.enabled else
                              "per-step" if e.executor.plan.has_step_policies
                              else "off"),
                   "plan": e.executor.plan.digest[:12],
                   "placements": e.executor.plan.placement_string,
                   "verify_ops": e.executor.telemetry_blinded.verify_ops,
                   "verify_flops": e.executor.telemetry_blinded.verify_flops,
                   "fold_matmuls": e.executor.telemetry_blinded.fold_matmuls,
                   "trusted_matmuls":
                       e.executor.telemetry_trusted.trusted_matmuls,
                   "integrity_failures": e.integrity_failures,
                   "quarantined": e.quarantined,
                   "probations": e.probations, "restores": e.restores,
                   "degraded": e.degraded,
                   "degradations": e.degradations,
                   "recoveries": e.recoveries,
                   "degraded_batches": e.degraded_batches}
            for name, e in engine.models.items()}
        # unified registry view: publish the per-model/per-device feeder
        # surfaces (Telemetry, ShardReport, session stats, watchdog EWMAs,
        # breaker/quarantine state) as gauges, then export one consistent
        # cut — the same names the benches and DESIGN.md §13 use
        engine.sync_registry(out)
        # performance-attribution plane (§14): fold any newly completed
        # request trees and export the phase decomposition alongside the
        # metrics cut it explains
        out["phases"] = engine.profile_phases()
        out["flight_recorder"] = engine.recorder.snapshot()
        out["metrics"] = self.registry.snapshot()
        # per-bucket occupancy view of the §15 shape ladder, derived from
        # the engine.bucket.<b>.* counters the device stage bumps
        buckets: Dict[int, Dict[str, int]] = {}
        for mname, v in out["metrics"]["counters"].items():
            if mname.startswith("engine.bucket."):
                _, _, b, fld = mname.split(".")
                buckets.setdefault(int(b), {})[fld] = v
        out["buckets"] = buckets
        return out


def _counter_property(metric: str) -> property:
    def fget(self: EngineStats) -> int:
        return self.registry.get(metric)

    def fset(self: EngineStats, value: int) -> None:
        self.registry.set_counter(metric, value)

    return property(fget, fset)


for _attr, _metric in EngineStats.COUNTERS.items():
    setattr(EngineStats, _attr, _counter_property(_metric))


class ServingEngine:
    """Continuous micro-batching engine over a registry of enclaves."""

    def __init__(self, cfg: Optional[EngineConfig] = None,
                 tracer: Optional[tracing.Tracer] = None,
                 registry: Optional[MetricsRegistry] = None,
                 recorder: Optional[FlightRecorder] = None, **kw):
        self.cfg = cfg or EngineConfig(**kw)
        self.models: Dict[str, _ModelEntry] = {}
        self.tracer = tracer
        self.stats = EngineStats(registry)
        self.registry = self.stats.registry
        # performance-attribution plane: folds completed request trees into
        # the §14 phase taxonomy; always constructed (ingest is a no-op
        # without a tracer) so snapshot()["phases"] is a stable surface
        self.profiler = CriticalPathProfiler()
        # always-on post-mortem ring; callers pass a FlightRecorder with an
        # out_dir to get on-disk bundles (serve.py --postmortem-dir)
        self.recorder = recorder if recorder is not None else FlightRecorder()
        self.watchdog = StepWatchdog()
        # the shared compile-once cache (§15): attached to every registered
        # executor; counters land in this engine's registry
        self.aot = CompileCache(self.cfg.compile_cache_dir,
                                registry=self.registry)
        self._buckets: Dict[Tuple[str, Tuple[int, ...]],
                            Deque[_Pending]] = OrderedDict()
        self._futures: Dict[Tuple[str, int], Future] = {}   # (model, rid)
        self._in_flight = 0
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._flush_t = -1.0              # see flush()
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        # two-stage pipeline: bounded handoff of prepared batches from the
        # batcher (enclave stage) to the device-stage worker
        self._pipe: "queue_mod.Queue" = queue_mod.Queue(
            maxsize=max(1, self.cfg.pipeline_depth))
        self._pipe_inflight = 0           # handed off, not yet completed
        self._device_thread: Optional[threading.Thread] = None
        # (model, rid) completion log, bounded like EngineStats.latencies —
        # an unbounded list would leak one tuple per request forever
        self.completion_order: Deque[Tuple[str, int]] = deque(
            maxlen=EngineStats.LAT_WINDOW)

    # -- registry ----------------------------------------------------------
    def register_model(self, name: str, cfg: ModelConfig, params, *,
                       mode: str = "origami", impl: str = "fused",
                       precompute: bool = True, input_key: str = "images",
                       input_dtype=None,
                       partition: Optional[int] = None,
                       privacy_floor: Optional[float] = None,
                       planner: Optional[PartitionPlanner] = None,
                       leakage: Optional[Dict[int, float]] = None,
                       integrity=None, fault=None,
                       placement: Optional[PlacementPlan] = None,
                       devices=None, shard: str = "rows",
                       hedging: bool = True, liveness=None,
                       chaos=None, device="cuda") -> _ModelEntry:
        """Build an executor for ``name`` and admit it to the registry.

        ``placement``: an explicit per-layer PlacementPlan (core/plan.py)
        — overrides the mode/partition path entirely. Otherwise the
        partition point comes from, in order: the explicit ``partition``
        argument, the cost-model planner (when ``privacy_floor`` or
        ``planner`` is given), or the config's declared
        ``origami.tier1_layers``, and is compiled to a prefix plan.
        ``integrity``/``fault``: Freivalds verification policy and (for
        tests/chaos drills) a dishonest-device injector, forwarded to the
        executor (core/integrity.py, runtime/faults.py).
        ``device``: where the executor runs (``"cuda"`` unless the caller
        asks for the CPU). ``devices``: a runtime/devices.DevicePool or a
        simulated slot count — attaches the sharded multi-device offload
        plane (parallel/offload_sharding.py) with default shard geometry
        ``shard`` and straggler ``hedging``; quarantine then becomes
        per-device (the pool's) instead of per-model. ``liveness``: a
        parallel/offload_sharding.LivenessConfig for the plane's
        timeout/backoff/breaker ladder. ``chaos``: a runtime/chaos
        ChaosController — its schedule is advanced once per dispatched
        batch of this model (the drill clock).
        """
        if isinstance(devices, int):
            devices = DevicePool(devices)
        if placement is not None:
            plan = PartitionPlan(cfg.name, placement.mode_label,
                                 placement.boundary, "explicit",
                                 None, {}, {}, ())
            executor = OrigamiExecutor(cfg, params, impl=impl,
                                       precompute=precompute,
                                       integrity=integrity, fault=fault,
                                       plan=placement, devices=devices,
                                       shard=shard, hedging=hedging,
                                       liveness=liveness, device=device)
            return self.register_executor(name, executor,
                                          input_key=input_key,
                                          input_dtype=input_dtype, plan=plan,
                                          chaos=chaos)
        if planner is None and privacy_floor is not None:
            planner = PartitionPlanner(privacy_floor=privacy_floor)
        if planner is not None or partition is not None:
            planner = planner or PartitionPlanner()
            plan = planner.plan(cfg, params, mode=mode, partition=partition,
                                leakage=leakage)
        else:
            plan = PartitionPlan(cfg.name, mode, cfg.origami.tier1_layers,
                                 "config", None, {}, {}, ())
        executor = OrigamiExecutor(cfg, params, mode=mode,
                                   partition=plan.partition, impl=impl,
                                   precompute=precompute,
                                   integrity=integrity, fault=fault,
                                   devices=devices, shard=shard,
                                   hedging=hedging, liveness=liveness,
                                   device=device)
        return self.register_executor(name, executor, input_key=input_key,
                                      input_dtype=input_dtype, plan=plan,
                                      chaos=chaos)

    def register_executor(self, name: str, executor: OrigamiExecutor, *,
                          input_key: str = "images",
                          input_dtype=None,
                          plan: Optional[PartitionPlan] = None,
                          pool: Optional[SessionPool] = None,
                          chaos=None) -> _ModelEntry:
        """Admit a pre-built executor (the legacy server's compat path)."""
        assert name not in self.models, f"model {name!r} already registered"
        plan = plan or PartitionPlan(executor.cfg.name,
                                     executor.plan.mode_label,
                                     executor.partition, "explicit",
                                     None, {}, {}, ())
        entry = _ModelEntry(
            name=name, cfg=executor.cfg, executor=executor,
            # a generate executor attests its decode plan's digest (it
            # covers the scan structure too, core/plan.py)
            quote=measure_enclave(executor.cfg, executor.params,
                                  executor.partition,
                                  plan_digest=getattr(
                                      executor, "attested_digest",
                                      executor.plan.digest)),
            pool=pool or SessionPool(executor,
                                     depth=self.cfg.session_pool_depth),
            plan=plan, placement=executor.plan,
            input_key=input_key, input_dtype=input_dtype)
        entry.chaos = chaos
        if executor.plane is not None:
            # bad shard outcomes (verify-fail/crash/timeout) land in the
            # post-mortem ring even though the plane recovers them itself
            executor.plane.recorder = self.recorder
        if chaos is not None:
            chaos.bind(
                pool=(executor.plane.pool if executor.plane is not None
                      else None),
                sessions=entry.pool)
        executor.attach_aot(self.aot)
        if self.cfg.aot_warm:
            self.warm(entry)
        with self._lock:
            self.models[name] = entry
        return entry

    def warm(self, entry: _ModelEntry,
             warm_shape: Optional[Tuple[int, ...]] = None) -> int:
        """Build the model's serving surface before its first request:
        every (trace kind, shape bucket) executable of the ladder (on the
        card one CUDA-graph capture each), which also builds the
        per-bucket factor caches the SessionPool prefetches into; then one
        plain seal/unseal round at the request and response shapes, so
        that first-use allocations leave the first request (the sealing is
        eager torch: there is nothing to compile). ``warm_shape``
        overrides the per-request input shape; by default an executor
        that declares ``request_shape`` (a generate executor: the prompt
        length) gives it, CNN configs derive it (image HWC) and other
        models are skipped. The response is ``response_elems`` long when
        the executor declares it, else ``num_classes``. Returns the
        executables ensured."""
        cfg = entry.cfg
        shape = warm_shape
        if shape is None:
            shape = getattr(entry.executor, "request_shape", None)
        if shape is None and cfg.family == "cnn":
            shape = (cfg.image_size, cfg.image_size, cfg.image_channels)
        if shape is None:
            return 0
        n = entry.executor.warm_aot(
            entry.input_key, shape, bucket_ladder(self.cfg.max_batch),
            dtype=(None if entry.input_dtype is None
                   else torch_dtype(entry.input_dtype)))
        key = np.zeros(2, np.uint32)
        box = seal(key, torch.zeros(shape), request_nonce(0))
        unseal(key, box, shape)
        n_out = (getattr(entry.executor, "response_elems", None)
                 or cfg.num_classes)
        if n_out:
            seal(key, torch.zeros(int(n_out)), response_nonce(0))
        return n

    def attest(self, name: str) -> Quote:
        return self.models[name].quote

    # -- submission --------------------------------------------------------
    def submit(self, model: str, req: Request,
               deadline_s: Optional[float] = None) -> Future:
        """Queue one sealed request; resolves to a ``Response``.

        Rejected (queue full / unknown model / duplicate in-flight rid)
        requests resolve immediately with ``ok=False`` — admission control
        is part of the response contract, not an exception path.
        """
        fut: Future = Future()
        now = time.monotonic()
        deadline = (deadline_s if deadline_s is not None
                    else self.cfg.default_deadline_s)
        with self._cv:
            self.stats.record_submit()
            entry = self.models.get(model)
            if entry is None or self._closed:
                self.stats.inc("rejected")
                fut.set_result(Response(
                    req.rid, None, False, 0.0,
                    error="shutdown" if self._closed else "rejected"))
                return fut
            if (self._in_flight >= self.cfg.max_queue
                    or (model, req.rid) in self._futures):
                self.stats.inc("rejected")
                fut.set_result(Response(req.rid, None, False, 0.0,
                                        error="rejected"))
                return fut
            self._futures[(model, req.rid)] = fut
            p = _Pending(model, req, fut, now, deadline)
            if self.tracer is not None and self.tracer.enabled:
                # admitted requests only: a shed request never cost a stage
                p.span = self.tracer.start_span(
                    "request", "request", parent=None, rid=req.rid,
                    model=model, shape=list(req.shape))
                p.queue_span = self.tracer.start_span(
                    "queue", "queue", parent=p.span)
            bucket_key = (model, tuple(req.shape))
            bucket = self._buckets.setdefault(bucket_key, deque())
            bucket.append(p)
            self._in_flight += 1
            self._ensure_thread()
            self._cv.notify_all()
        return fut

    def submit_many(self, model: str, reqs: List[Request],
                    deadline_s: Optional[float] = None) -> List[Future]:
        return [self.submit(model, r, deadline_s) for r in reqs]

    def future_for(self, model: str, rid: int) -> Optional[Future]:
        """The in-flight future for (model, rid), if any."""
        with self._lock:
            return self._futures.get((model, rid))

    def flush(self) -> None:
        """Dispatch everything already queued without waiting for
        max_batch or the max_wait timer — for callers that know their
        request list is complete (e.g. the synchronous serve() wrapper,
        whose tail batch would otherwise idle out the timer). Requests
        submitted after the flush batch up normally."""
        with self._cv:
            self._flush_t = time.monotonic()
            self._cv.notify_all()

    def queue_depth(self) -> int:
        """Requests not yet resolved: queued in buckets plus handed off to
        (or executing on) the device stage — so ``drain()`` waits for the
        pipeline's tail, not just for empty buckets."""
        with self._lock:
            return self._in_flight + self._pipe_inflight

    # -- batcher -----------------------------------------------------------
    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._batch_loop,
                                            name="serving-engine-batcher",
                                            daemon=True)
            self._thread.start()

    def _ensure_device_thread(self) -> None:
        if self._device_thread is None or not self._device_thread.is_alive():
            self._device_thread = threading.Thread(
                target=self._device_loop, name="serving-engine-device",
                daemon=True)
            self._device_thread.start()

    def _ready_bucket(self, now: float):
        """The ready bucket (full or past max_wait) whose head request has
        waited longest — head age, not registry order, breaks ties so a
        persistently full hot bucket cannot starve a timer-expired trickle
        bucket. Also returns the earliest upcoming flush time across
        non-ready buckets (the cv wait timeout when nothing is ready)."""
        max_wait = self.cfg.max_wait_ms / 1e3
        best_key = best_head_t = None
        next_deadline = None
        for key, bucket in self._buckets.items():
            if not bucket:
                continue
            head_t = bucket[0].submit_t
            if (len(bucket) >= self.cfg.max_batch
                    or head_t + max_wait <= now
                    or head_t <= self._flush_t):
                if best_head_t is None or head_t < best_head_t:
                    best_key, best_head_t = key, head_t
            else:
                flush_at = head_t + max_wait
                next_deadline = (flush_at if next_deadline is None
                                 else min(next_deadline, flush_at))
        return best_key, next_deadline

    def _batch_loop(self) -> None:
        while True:
            with self._cv:
                while True:
                    if self._closed and self._in_flight == 0:
                        return
                    now = time.monotonic()
                    key, next_flush = self._ready_bucket(now)
                    if key is not None:
                        break
                    timeout = (None if next_flush is None
                               else max(1e-4, next_flush - now))
                    self._cv.wait(timeout=timeout)
                bucket = self._buckets[key]
                batch: List[_Pending] = []
                expired: List[_Pending] = []
                while bucket and len(batch) < self.cfg.max_batch:
                    p = bucket.popleft()
                    if (p.deadline_s is not None
                            and now - p.submit_t > p.deadline_s):
                        expired.append(p)
                    else:
                        batch.append(p)
                self._in_flight -= len(batch) + len(expired)
                if not bucket:
                    self._buckets.pop(key, None)
            for p in expired:
                self.stats.inc("expired")
                self._end_queue_span(p, expired=True)
                self._finish(p, Response(p.req.rid, None, False,
                                         time.monotonic() - p.submit_t,
                                         error="deadline_exceeded"))
            if batch:
                entry = self.models[batch[0].model]
                try:
                    if self.cfg.pipeline:
                        # enclave stage here; completion on the device
                        # thread. Chaos-bound models defer the unseal too
                        # (their drill may corrupt sealed boxes, which must
                        # land before the MAC check) — their work item just
                        # rides the same FIFO with the enclave stage folded
                        # into the completion stage.
                        work = self._stage_prepare(
                            entry, batch, unseal_now=entry.chaos is None)
                        if work is not None:
                            self._ensure_device_thread()
                            with self._lock:
                                self._pipe_inflight += len(work.batch)
                            self._pipe.put(work)   # blocks at depth: the
                            # batcher back-pressures instead of out-running
                            # the device stage without bound
                    else:
                        self._dispatch(entry, batch)
                except Exception as exc:  # noqa: BLE001 — fail the batch,
                    for p in batch:       # not the engine
                        with self._lock:
                            self._futures.pop((p.model, p.req.rid), None)
                        if not p.future.done():
                            p.future.set_exception(exc)

    def _device_loop(self) -> None:
        """Device-stage worker: completes prepared batches in handoff
        order. ALL post-dispatch bookkeeping (watchdog, integrity/
        degradation state machines, stats, flight-recorder dumps, future
        resolution) runs here and only here — the single-thread ownership
        the pre-pipeline batcher had, preserved by construction."""
        while True:
            work = self._pipe.get()
            if work is None:           # close() sentinel
                return
            try:
                self._stage_complete(work)
            except Exception as exc:   # noqa: BLE001 — fail the batch,
                for p in work.batch:   # not the pipeline
                    with self._lock:
                        self._futures.pop((p.model, p.req.rid), None)
                    if not p.future.done():
                        p.future.set_exception(exc)
            finally:
                with self._lock:
                    self._pipe_inflight -= len(work.batch)

    def _dispatch(self, entry: _ModelEntry, batch: List[_Pending]) -> None:
        """One serial enclave dispatch (``pipeline=False`` and direct
        callers): both stages back-to-back on the calling thread — the
        legacy single-threaded order, which is also why the unseal is
        deferred into the completion stage here."""
        work = self._stage_prepare(entry, batch, unseal_now=False)
        if work is not None:
            self._stage_complete(work)

    def _stage_prepare(self, entry: _ModelEntry, batch: List[_Pending],
                       unseal_now: bool) -> Optional["_BatchWork"]:
        """Enclave stage: deadline re-check, span bookkeeping and (when
        ``unseal_now``) the unseal -> MAC-filter -> bucket-pad half of the
        sealed-batch primitive. Touches no per-model mutable state — that
        all belongs to the completion stage."""
        # deadline re-check at dispatch time (DESIGN.md §12): formation and
        # dispatch are back-to-back on the batcher thread, but a slow
        # previous batch can age this one past its deadline — don't burn
        # device compute on work nobody can use, and tell the caller why
        now = time.monotonic()
        live: List[_Pending] = []
        for p in batch:
            if p.deadline_s is not None and now - p.submit_t > p.deadline_s:
                self.stats.inc("expired")
                self._end_queue_span(p, expired=True)
                self._finish(p, Response(p.req.rid, None, False,
                                         now - p.submit_t,
                                         error="deadline_exceeded"))
            else:
                live.append(p)
        batch = live
        if not batch:
            return None
        # trace plane: close every member's queue span, open one "batch"
        # span parented at the OLDEST request's root (the request whose
        # wait formed the batch); other members' roots carry the batch
        # span id as an attribute so their trees remain navigable
        batch_span = None
        if self.tracer is not None and self.tracer.enabled:
            for p in batch:
                self._end_queue_span(p)
            anchor = min(batch, key=lambda p: p.submit_t)
            batch_span = self.tracer.start_span(
                "batch", "batch", parent=anchor.span, model=entry.name,
                n_requests=len(batch),
                plan=entry.executor.plan.digest[:12],
                rids=[p.req.rid for p in batch[:32]])
            for p in batch:
                if p.span is not None:
                    # every member root gets the plan digest (the profiler
                    # keys on it; only the anchor has the batch child)
                    self.tracer.annotate(
                        p.span, plan=entry.executor.plan.digest[:12])
                    if p is not anchor:
                        self.tracer.annotate(
                            p.span, batch_span_id=batch_span.span_id)
        prep = None
        if unseal_now:
            try:
                with tracing.activate(self.tracer, batch_span):
                    prep = prepare_sealed_batch(
                        [p.req for p in batch],
                        max_batch=self.cfg.max_batch,
                        input_dtype=entry.input_dtype)
            except Exception:
                if batch_span is not None and self.tracer is not None:
                    self.tracer.end(batch_span)
                raise
        return _BatchWork(entry=entry, batch=batch, batch_span=batch_span,
                          prep=prep)

    def _stage_complete(self, work: "_BatchWork") -> None:
        """Device stage: infer -> verify -> §9/§12 recovery -> seal, plus
        every piece of post-dispatch bookkeeping. Single-threaded (the
        device worker, or the caller when ``pipeline=False``)."""
        entry, batch, batch_span = work.entry, work.batch, work.batch_span
        entry.batches += 1
        if entry.chaos is not None:
            # the drill clock: arm/disarm scripted faults for this batch
            # index (device injectors, refill faults, sealed-box corruption)
            entry.chaos.on_batch(entry.batches - 1,
                                 requests=[p.req for p in batch])
        self.watchdog.start_step()
        # probation (poolless models): a quarantined backend that has
        # served ``probation_after`` trusted batches earns ONE verified
        # offload probe — clean restores offload, dirty re-benches it.
        # The probe routes REAL client traffic back to a convicted
        # backend, so it is only safe when every offloaded op is checked
        # (the retry/recompute path then recovers any corruption before
        # sealing): a "sampled" policy would let unchecked ops carry
        # corrupt logits to clients AND could restore the backend off a
        # lucky probe, so such models stay benched (the pre-probation
        # behavior). Models with a DevicePool never take this path:
        # their quarantine/probation is per-device, and shards are
        # always checked.
        per_device = entry.executor.plane is not None
        probe = (entry.quarantined and not per_device
                 and entry.executor.integrity.mode == "full"
                 and entry.trusted_streak >= self.cfg.probation_after)
        if probe:
            entry.probations += 1
            self.stats.inc("probations")
        # graceful degradation (DESIGN.md §12): zero serving-eligible
        # devices (every slot quarantined or breaker-open) means a blinded
        # dispatch has nowhere to go — serve this batch verified
        # enclave-only instead. The moment the pool has a probe candidate
        # (half-open breaker or probation-ripe quarantine) the blinded
        # path runs again so the plane can route the probe: shards are
        # always verified, so a recovery attempt is safe with real traffic
        # (un-routable shards fall to the enclave inside the op).
        degrade_trusted = False
        if per_device:
            dpool = entry.executor.plane.pool
            can_probe = (dpool.breaker_candidate() is not None
                         or dpool.probe_candidate() is not None)
            if dpool.n_available() == 0 and not can_probe:
                degrade_trusted = True
                entry.degraded_batches += 1
                self.stats.inc("degraded_batches")
                # enclave-only batches still age the pool's cooldowns —
                # otherwise a fully-benched pool could never reach its
                # half-open / probation probe state and the degradation
                # would be permanent
                dpool.begin_dispatch()
        try:
            with tracing.activate(self.tracer, batch_span):
                prep = work.prep
                if prep is None:      # serial path / chaos: enclave stage
                    prep = prepare_sealed_batch(        # runs here instead
                        [p.req for p in batch],
                        max_batch=self.cfg.max_batch,
                        input_dtype=entry.input_dtype)
                if prep.x is None:    # every MAC failed: nothing to infer
                    boxes, n_valid, pad, integ = (prep.boxes, 0, 0,
                                                  prep.integ)
                else:
                    boxes, n_valid, pad, integ = complete_prepared_batch(
                        entry.executor, prep, input_key=entry.input_key,
                        session_key=entry.pool.acquire,  # lazy: only
                        # consumed if a valid request infers
                        trusted=(entry.quarantined and not probe)
                        or degrade_trusted,
                        retry_device=self.cfg.integrity_retry)
        finally:
            if batch_span is not None and self.tracer is not None:
                self.tracer.end(batch_span)
        if batch_span is not None and self.tracer is not None:
            self.tracer.annotate(batch_span, n_valid=n_valid, pad=pad,
                                 bucket=prep.bucket,
                                 flagged=integ.flagged,
                                 trusted=integ.trusted > 0,
                                 degraded=degrade_trusted, probe=probe)
        if n_valid:
            self.stats.record_batch(
                n_valid, pad,
                request_compile_s=self.aot.request_compile_seconds)
            # per-bucket occupancy counters for the §15 shape ladder
            self.registry.inc_many(**{
                f"engine.bucket.{prep.bucket}.batches": 1,
                f"engine.bucket.{prep.bucket}.padded_slots": pad})
        self.stats.inc_many(
            mac_failures=sum(b is None for b in boxes),
            verify_checks=integ.checks,
            verify_failures=integ.failures,
            device_retries=integ.retried,
            recomputes=integ.recomputed,
            trusted_batches=integ.trusted,
            shard_checks=integ.shard_checks,
            shard_failures=integ.shard_failures,
            shard_retries=integ.shard_retries,
            shard_hedges=integ.shard_hedges,
            shard_enclave=integ.shard_enclave,
            shard_crashes=integ.shard_crashes,
            shard_timeouts=integ.shard_timeouts)
        if integ.flagged:
            # post-mortem trigger: a Freivalds failure this batch (whatever
            # recovered it) — the span tail shows which op/shard lied
            self.recorder.dump(
                "verify_failure", tracer=self.tracer,
                registry=self.registry, model=entry.name,
                checks=integ.checks, failures=integ.failures,
                shard_failures=integ.shard_failures,
                batch_index=entry.batches - 1)
        if n_valid and entry.quarantined and not per_device:
            if probe:
                if integ.checks and not integ.failures:
                    entry.quarantined = False
                    entry.consec_failures = 0
                    entry.restores += 1
                    self.stats.inc("probation_restores")
                entry.trusted_streak = 0     # clean: healthy again; dirty:
            else:                            # restart the probation clock
                entry.trusted_streak += 1
        elif n_valid and not entry.quarantined and not per_device:
            # quarantine bookkeeping (batcher thread owns entry state): a
            # backend that keeps failing its Freivalds checks stops being
            # offloaded to until probation re-admits it.
            if integ.flagged:
                entry.integrity_failures += 1
                entry.consec_failures += 1
                if entry.consec_failures >= self.cfg.quarantine_after:
                    entry.quarantined = True
                    entry.trusted_streak = 0
                    self.stats.inc("quarantines")
                    self.recorder.dump(
                        "quarantine", tracer=self.tracer,
                        registry=self.registry, model=entry.name,
                        consec_failures=entry.consec_failures,
                        batch_index=entry.batches - 1)
            elif integ.checks:
                entry.consec_failures = 0
        elif n_valid and per_device and integ.flagged:
            entry.integrity_failures += 1    # visibility only: recovery and
                                             # health are per-device (pool)
        if per_device:
            # degraded-mode state machine (§12): the flag tracks the pool's
            # serving-eligible count, transitions counted right after the
            # dispatch that caused them (a breaker opening mid-batch
            # degrades here; a successful half-open probe recovers here)
            dpool = entry.executor.plane.pool
            available = dpool.n_available() > 0
            if entry.degraded and available:
                entry.degraded = False
                entry.recoveries += 1
                self.stats.inc("recoveries")
                self.recorder.event("recovery", model=entry.name,
                                    batch_index=entry.batches - 1)
            elif not entry.degraded and not available:
                entry.degraded = True
                entry.degradations += 1
                self.stats.inc("degradations")
                self.recorder.dump(
                    "degradation", tracer=self.tracer,
                    registry=self.registry, model=entry.name,
                    batch_index=entry.batches - 1)
            # per-device transitions happen inside the plane — detect them
            # as counter edges so breaker-opens/device-quarantines dump too
            opens = sum(s.breaker_opens for s in dpool.slots)
            quars = sum(s.quarantines for s in dpool.slots)
            if opens > entry.breaker_opens_seen:
                self.recorder.dump(
                    "breaker_open", tracer=self.tracer,
                    registry=self.registry, model=entry.name,
                    new_opens=opens - entry.breaker_opens_seen,
                    batch_index=entry.batches - 1)
            if quars > entry.dev_quarantines_seen:
                self.recorder.dump(
                    "device_quarantine", tracer=self.tracer,
                    registry=self.registry, model=entry.name,
                    new_quarantines=quars - entry.dev_quarantines_seen,
                    batch_index=entry.batches - 1)
            entry.breaker_opens_seen = opens
            entry.dev_quarantines_seen = quars
        self.watchdog.end_step()
        for p, box in zip(batch, boxes):
            self._finish(p, Response(p.req.rid, box, box is not None,
                                     time.monotonic() - p.submit_t,
                                     flagged=integ.flagged
                                     and box is not None,
                                     error=None if box is not None
                                     else "mac_failed"))

    def _end_queue_span(self, p: _Pending, expired: bool = False) -> None:
        if p.queue_span is not None and self.tracer is not None:
            if p.queue_span.t1 is None:
                self.tracer.end(p.queue_span, expired=expired)
            p.queue_span = None

    def _finish(self, p: _Pending, resp) -> None:
        if resp.ok:
            self.stats.record_done(resp.latency_s)
        self._end_queue_span(p)
        if p.span is not None and self.tracer is not None:
            self.tracer.end(p.span, ok=resp.ok, error=resp.error,
                            flagged=resp.flagged)
            p.span = None
        with self._lock:
            self.completion_order.append((p.model, p.req.rid))
            self._futures.pop((p.model, p.req.rid), None)
        # done-guard: the forced shutdown sweep (close) may have resolved
        # this future already — set_result on a done future raises and
        # would kill the batcher thread
        if not p.future.done():
            p.future.set_result(resp)

    def snapshot(self) -> Dict[str, object]:
        """Aggregate serving telemetry (EngineStats.snapshot shorthand)."""
        return self.stats.snapshot(self)

    def profile_phases(self) -> Dict[str, object]:
        """Fold completed request spans into the §14 phase decomposition."""
        if self.tracer is not None:
            self.profiler.ingest(self.tracer)
            self.profiler.export_gauges(self.registry)
        return self.profiler.report()

    def sync_registry(self, legacy: Optional[Dict[str, object]] = None
                      ) -> MetricsRegistry:
        """Publish every feeder surface into the one registry as gauges.

        The producers (executor Telemetry, plane ShardReport, DeviceSlot
        breaker/quarantine state, StepWatchdog EWMAs, session pools) keep
        their own lightweight accounting on their own hot paths; this
        pulls a consistent cut of each into the registry under the §13
        names so ``snapshot()["metrics"]`` is the single queryable view.
        ``legacy``: the partially-built legacy snapshot dict (when called
        from EngineStats.snapshot) — reused to avoid re-walking planes.
        """
        reg = self.registry
        reg.gauges({"engine.queue_depth": self.queue_depth(),
                    "engine.watchdog.p50_s": self.watchdog.p50 or 0.0,
                    "engine.watchdog.flagged_steps":
                        self.watchdog.flagged_steps})
        for name, e in self.models.items():
            sync_struct(reg, f"model.{name}.telemetry",
                        e.executor.telemetry_blinded,
                        ("blinded_bytes", "returned_bytes",
                         "offloaded_flops", "enclave_flops",
                         "enclave_peak_feature_bytes", "calls",
                         "device_matmuls", "enclave_matmuls", "verify_ops",
                         "verify_flops", "fold_matmuls"))
            reg.gauge(f"model.{name}.telemetry.trusted_matmuls",
                      e.executor.telemetry_trusted.trusted_matmuls)
            for k, v in e.pool.stats().items():
                if isinstance(v, (int, float)):
                    reg.gauge(f"session.{name}.{k}", v)
            reg.gauges({f"model.{name}.quarantined": int(e.quarantined),
                        f"model.{name}.degraded": int(e.degraded)})
            plane = e.executor.plane
            if plane is None:
                continue
            sync_struct(reg, f"model.{name}.shard", plane.totals,
                        ("ops", "dispatches", "checks", "failures",
                         "retries", "hedges", "enclave_shards", "probes",
                         "crashes", "timeouts", "backoffs",
                         "breaker_probes"))
            psnap = plane.snapshot()
            wd = psnap.get("watchdog", {})
            for k, v in wd.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    reg.gauge(f"model.{name}.shard.watchdog.{k}", v)
            # per-device breaker/quarantine/EWMA gauges (satellite: chaos
            # drills and hedging decisions must be explainable post-hoc)
            for idx, slot in enumerate(psnap["pool"]["slots"]):
                pre = f"device.{name}.{idx}"
                for k, v in slot.items():
                    if isinstance(v, bool):
                        reg.gauge(f"{pre}.{k}", int(v))
                    elif isinstance(v, (int, float)):
                        reg.gauge(f"{pre}.{k}", v)
                    elif k == "breaker" and isinstance(v, str):
                        # encode breaker state as an ordinal gauge
                        # (closed=0, half_open=1, open=2) + keep the
                        # string in the legacy snapshot
                        order = {"closed": 0, "half_open": 1, "open": 2}
                        reg.gauge(f"{pre}.breaker_state",
                                  order.get(v, -1))
        return reg

    # -- lifecycle ---------------------------------------------------------
    def drain(self, timeout_s: float = 60.0) -> bool:
        """Block until the queue is empty (True) or timeout (False)."""
        end = time.monotonic() + timeout_s
        while time.monotonic() < end:
            if self.queue_depth() == 0:
                return True
            time.sleep(0.002)
        return self.queue_depth() == 0

    def close(self, drain_s: float = 30.0) -> None:
        """Graceful shutdown (DESIGN.md §12): stop admitting, let the
        batcher flush everything already queued (the plane's liveness
        timeouts bound how long a wedged device can stall that), drain the
        device stage behind it, then force-resolve anything still pending
        with an explicit ``shutdown`` error — **every submitted future
        resolves** — and only then stop the session pools and drain the
        device queues."""
        with self._cv:
            self._closed = True
            # the tail bucket must not idle out its max_wait timer while
            # the batcher is the only thing left running
            self._flush_t = time.monotonic()
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=drain_s)
        # the batcher has stopped enqueueing: sentinel the device stage so
        # it finishes everything already handed off, then exits
        if (self._device_thread is not None
                and self._device_thread.is_alive()):
            self._pipe.put(None)
            self._device_thread.join(timeout=drain_s)
        # forced resolution: anything the batcher or device stage left
        # behind (a thread died, or the drain timed out) resolves NOW — a
        # shutdown may abandon work, never a caller
        leftovers: List[_Pending] = []
        while True:
            try:
                work = self._pipe.get_nowait()
            except queue_mod.Empty:
                break
            if work is not None:
                leftovers.extend(work.batch)
                with self._lock:
                    self._pipe_inflight -= len(work.batch)
        with self._cv:
            for bucket in self._buckets.values():
                leftovers.extend(bucket)
            self._buckets.clear()
            self._in_flight = 0
        for p in leftovers:
            self.stats.inc("shutdown_drops")
            self._finish(p, Response(p.req.rid, None, False,
                                     time.monotonic() - p.submit_t,
                                     error="shutdown"))
        for entry in self.models.values():
            entry.pool.close()
            if entry.executor.plane is not None:
                entry.executor.plane.pool.close(drain=True)
