"""Private-inference serving (the paper's deployment shape).

Port of ``repro/runtime/serving.py``. The client attests the enclave
(core/attestation), seals its input under its session key
(core/sealing); the enclave unseals, filters failed MACs, pads the batch
to a power-of-two bucket, runs the OrigamiExecutor (tier-1 blinded and
Freivalds-verified, tier-2 open) and seals each result back. A batch
whose check fails drains through the recovery ladder: one device retry
under a fresh blinding session, then the enclave recomputes it; either
way the response is bit-identical to an honest device's.

``PrivateInferenceServer.serve_batch`` is the one-dispatch primitive;
``serve`` drives the continuous micro-batching ``ServingEngine``
(runtime/engine.py) over the same executor and returns the responses in
request order.

Nonces: requests seal under the 64-bit rid split ``[lo, hi]``, responses
under ``[lo, hi, DIRECTION_RESPONSE]``, so no (key, nonce) pair repeats
between the two directions.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng, tracing
from repro_torch.core.attestation import Quote, measure_enclave
from repro_torch.core.origami import OrigamiExecutor
from repro_torch.core.sealing import SealedBox, seal, unseal
from repro_torch.models.model import torch_dtype
from repro_torch.runtime.aot import bucket_for

DIRECTION_RESPONSE = 0xEE

# fold_in tag of a fresh blinding session for an integrity retry when the
# caller gave a fixed key (a re-run must never reuse one-time pads)
_RETRY_DOMAIN = 0x0E7B1


def request_nonce(rid: int) -> np.ndarray:
    return np.asarray([rid & 0xFFFFFFFF, (rid >> 32) & 0xFFFFFFFF],
                      np.uint32)


def response_nonce(rid: int) -> np.ndarray:
    return np.asarray([rid & 0xFFFFFFFF, (rid >> 32) & 0xFFFFFFFF,
                       DIRECTION_RESPONSE], np.uint32)


@dataclasses.dataclass
class Request:
    rid: int
    box: SealedBox
    shape: Tuple[int, ...]
    session_key: np.ndarray          # client's symmetric key material


@dataclasses.dataclass
class Response:
    rid: int
    box: Optional[SealedBox]
    ok: bool
    latency_s: float
    # True when a Freivalds check failed on this request's batch and the
    # logits were recovered (device retry or enclave recompute)
    flagged: bool = False
    # why ok=False: "mac_failed" (never reached the executor),
    # "deadline_exceeded", "shutdown" or "rejected" (engine admission)
    error: Optional[str] = None


@dataclasses.dataclass
class BatchIntegrity:
    """Verification outcome of one sealed-batch dispatch (the requests of
    a batch share one run, so detection and recovery are per batch)."""
    checks: int = 0              # Freivalds checks that ran (all attempts)
    failures: int = 0            # checks that mismatched
    corrupted: int = 0           # injector ground truth
    retried: bool = False        # one fresh-session device retry happened
    recomputed: bool = False     # enclave recompute produced the response
    trusted: bool = False        # dispatched straight to the enclave
    # offload-plane counters (parallel/offload_sharding.py): shard failures
    # are detected and recovered inside the op, so they never trigger the
    # batch-level retry, but they still flag the response
    shard_checks: int = 0        # shard-local Freivalds checks run
    shard_failures: int = 0      # shard checks that mismatched
    shard_retries: int = 0       # single-shard re-dispatches
    shard_hedges: int = 0        # straggler duplicates launched
    shard_enclave: int = 0       # shards the enclave computed itself
    shard_crashes: int = 0       # dispatches that raised (contained)
    shard_timeouts: int = 0      # dispatches abandoned past the deadline

    @property
    def flagged(self) -> bool:
        return self.failures > 0 or self.shard_failures > 0


@dataclasses.dataclass
class IntegrityTotals:
    """Running sums over many dispatches (per-batch flags become counts)."""
    checks: int = 0
    failures: int = 0
    corrupted: int = 0
    retries: int = 0
    recomputes: int = 0
    trusted_batches: int = 0
    shard_checks: int = 0
    shard_failures: int = 0
    shard_retries: int = 0
    shard_hedges: int = 0
    shard_enclave: int = 0
    shard_crashes: int = 0
    shard_timeouts: int = 0

    def add(self, integ: BatchIntegrity) -> None:
        self.checks += integ.checks
        self.failures += integ.failures
        self.corrupted += integ.corrupted
        self.retries += integ.retried
        self.recomputes += integ.recomputed
        self.trusted_batches += integ.trusted
        self.shard_checks += integ.shard_checks
        self.shard_failures += integ.shard_failures
        self.shard_retries += integ.shard_retries
        self.shard_hedges += integ.shard_hedges
        self.shard_enclave += integ.shard_enclave
        self.shard_crashes += integ.shard_crashes
        self.shard_timeouts += integ.shard_timeouts


def _fresh_session(session_key, used: np.ndarray) -> np.ndarray:
    """A never-used blinding session for a device retry: the next key of
    a zero-argument callable, else a tagged derivation of the used key
    (one-time pads must not repeat across attempts)."""
    if callable(session_key):
        return session_key()
    return prng.fold_in(used, _RETRY_DOMAIN)


def _trusted_key() -> np.ndarray:
    """The enclave-recompute run draws no pads or fold vectors."""
    return prng.PRNGKey(0)


@dataclasses.dataclass
class PreparedBatch:
    """Product of the enclave stage: requests unsealed, failed MACs
    filtered, survivors stacked and zero-padded to a bucket."""
    requests: List[Request]
    boxes: List[Optional[SealedBox]]     # positional; None = MAC failed
    valid_idx: List[int]
    x: Optional[torch.Tensor]            # bucket-padded input, None if empty
    pad: int
    bucket: int
    integ: BatchIntegrity
    # wall seconds of the stages: "unseal" here, "infer" (until the logits
    # reach the host) and "seal" in complete_prepared_batch
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def n_valid(self) -> int:
        return len(self.valid_idx)


def prepare_sealed_batch(requests: List[Request], *, max_batch: int,
                         input_dtype=None) -> PreparedBatch:
    """Enclave stage: unseal -> filter failed MACs -> bucket-pad. Zero pad
    rows never raise the activation absmax, so they leave every data row's
    result unchanged. ``input_dtype`` (a torch dtype or its name) casts
    the unsealed float payloads, as LM tokens ride sealed as floats."""
    t0 = time.perf_counter()
    valid_idx: List[int] = []
    inputs: List[torch.Tensor] = []
    with tracing.maybe_span("unseal", "crypto",
                            n_requests=len(requests)) as usp:
        for i, r in enumerate(requests):
            pt, ok = unseal(r.session_key, r.box, r.shape)
            if ok:
                valid_idx.append(i)
                inputs.append(pt)
        tracing.annotate(usp, n_valid=len(inputs))
    boxes: List[Optional[SealedBox]] = [None] * len(requests)
    integ = BatchIntegrity()
    if not inputs:
        return PreparedBatch(requests, boxes, valid_idx, None, 0, 0, integ,
                             {"unseal": time.perf_counter() - t0})
    bucket = bucket_for(len(inputs), max_batch)
    pad = bucket - len(inputs)
    x = torch.stack(inputs + [torch.zeros_like(inputs[0])] * pad)
    if input_dtype is not None:
        x = x.to(torch_dtype(input_dtype))
    return PreparedBatch(requests, boxes, valid_idx, x, pad, bucket, integ,
                         {"unseal": time.perf_counter() - t0})


def complete_prepared_batch(executor: OrigamiExecutor, prep: PreparedBatch,
                            *, session_key, input_key: str = "images",
                            trusted: bool = False,
                            retry_device: bool = True
                            ) -> Tuple[List[Optional[SealedBox]], int, int,
                                       BatchIntegrity]:
    """Device stage: blinded infer -> verify -> recovery -> seal.

    ``session_key`` is a key or a zero-argument callable returning a fresh
    one. A failed Freivalds check discards the device's answer;
    ``retry_device`` grants one re-offload under a fresh blinding session
    (a one-time pad is never reused), after which the enclave recomputes
    the batch itself; ``trusted=True`` skips the device entirely. Every
    recovery path is bit-identical to an honest device's answer."""
    requests, boxes, integ = prep.requests, prep.boxes, prep.integ
    batch = {input_key: prep.x}
    t0 = time.perf_counter()
    if trusted:
        # the enclave run draws no pads, so it takes no session key
        integ.trusted = True
        with tracing.maybe_span("infer", "infer", attempt="trusted",
                                trusted=True):
            result = executor.infer(batch, session_key=_trusted_key(),
                                    trusted=True)
    else:
        with tracing.maybe_span("session.acquire", "session",
                                pooled=callable(session_key)):
            sk = session_key() if callable(session_key) else session_key
        result = _attempt(executor, batch, sk, "blinded")
        _absorb(integ, result)
        if not result.integrity.ok and retry_device:
            with tracing.maybe_span("session.acquire", "session",
                                    pooled=callable(session_key),
                                    retry=True):
                sk = _fresh_session(session_key, sk)
            result = _attempt(executor, batch, sk, "retry")
            integ.retried = True
            _absorb(integ, result)
        if not result.integrity.ok:
            with tracing.maybe_span("infer", "infer", attempt="recompute",
                                    trusted=True):
                result = executor.infer(batch, session_key=_trusted_key(),
                                        trusted=True)
            integ.recomputed = True
        # the batch's verification outcome as one span, so the tree reads
        # ... -> infer -> verify -> seal although the checks ran inside
        # the infer attempts
        with tracing.maybe_span("verify", "verify", checks=integ.checks,
                                failures=integ.failures,
                                shard_checks=integ.shard_checks,
                                shard_failures=integ.shard_failures,
                                retried=integ.retried,
                                recomputed=integ.recomputed):
            pass
    with tracing.maybe_span("seal", "crypto", n_responses=prep.n_valid,
                            pad=prep.pad):
        logits = result.logits.to(torch.float32).cpu()[:prep.n_valid]
        t1 = time.perf_counter()
        for row, i in enumerate(prep.valid_idx):
            r = requests[i]
            boxes[i] = seal(r.session_key, logits[row],
                            response_nonce(r.rid))
    prep.phases.update(infer=t1 - t0, seal=time.perf_counter() - t1)
    return boxes, prep.n_valid, prep.pad, integ


def _attempt(executor: OrigamiExecutor, batch, sk, attempt: str):
    """One untrusted infer under its ``infer`` span."""
    with tracing.maybe_span("infer", "infer", attempt=attempt) as isp:
        result = executor.infer(batch, session_key=sk)
        tracing.annotate(isp, checks=result.integrity.n_checked,
                         failures=result.integrity.n_failed)
    return result


def _absorb(integ: BatchIntegrity, result) -> None:
    """Add one untrusted attempt's verification and shard counters."""
    integ.checks += result.integrity.n_checked
    integ.failures += result.integrity.n_failed
    integ.corrupted += result.integrity.n_corrupted
    sh = result.sharding
    if sh is not None:
        integ.shard_checks += sh.checks
        integ.shard_failures += sh.failures
        integ.shard_retries += sh.retries
        integ.shard_hedges += sh.hedges
        integ.shard_enclave += sh.enclave_shards
        integ.shard_crashes += sh.crashes
        integ.shard_timeouts += sh.timeouts


def execute_sealed_batch(executor: OrigamiExecutor, requests: List[Request],
                         *, max_batch: int, session_key,
                         trusted: bool = False, retry_device: bool = True
                         ) -> Tuple[List[Optional[SealedBox]], int, int,
                                    BatchIntegrity]:
    """unseal -> filter failed MACs -> bucket-pad -> verified blinded
    infer -> recover on failure -> seal. Returns ``(boxes, n_valid, pad,
    integrity)``; ``boxes[i] is None`` iff request i failed its MAC (it
    never reached the executor). A callable ``session_key`` is called only
    once a valid request will reach the executor."""
    prep = prepare_sealed_batch(requests, max_batch=max_batch)
    if prep.x is None:
        return prep.boxes, 0, 0, prep.integ
    return complete_prepared_batch(executor, prep, session_key=session_key,
                                   trusted=trusted,
                                   retry_device=retry_device)


class PrivateInferenceServer:
    """Batched Origami serving of a VGG model on one device."""

    def __init__(self, cfg: ModelConfig, params, *, mode: str = "origami",
                 max_batch: int = 8, input_key: str = "images",
                 impl: str = "fused", precompute: bool = True,
                 integrity=None, fault=None, plan=None, device="cuda"):
        self.cfg = cfg
        self.executor = OrigamiExecutor(cfg, params, mode=mode, impl=impl,
                                        precompute=precompute,
                                        integrity=integrity, fault=fault,
                                        plan=plan, device=device)
        self.quote = measure_enclave(cfg, self.executor.params,
                                     self.executor.partition,
                                     plan_digest=self.executor.plan.digest)
        self.max_batch = max_batch
        self.input_key = input_key
        self.processed = 0
        self.batches = 0
        self.integrity_totals = IntegrityTotals()  # running serve_batch sums
        self.last_phases: Dict[str, float] = {}   # stage seconds, last batch
        self._engine = None              # lazy ServingEngine (serve())
        # server-side root of the per-batch blinding sessions: batch k runs
        # under fold_in(root, k). Fresh entropy per instance, so one-time
        # pads never repeat across restarts or replicas.
        w0, w1 = np.frombuffer(os.urandom(8), np.uint32)
        self._blind_root = prng.fold_in(prng.PRNGKey(int(w0)), int(w1))

    def _blind_session(self, batch_idx: int) -> np.ndarray:
        return prng.fold_in(self._blind_root, batch_idx)

    # -- client side helpers ---------------------------------------------
    def attest(self) -> Quote:
        return self.quote

    @staticmethod
    def client_seal(key: np.ndarray, x, rid: int) -> SealedBox:
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.array(x, np.float32))
        return seal(key, x, request_nonce(rid))

    @staticmethod
    def client_open(key: np.ndarray, box: SealedBox,
                    shape: Tuple[int, ...]) -> np.ndarray:
        pt, ok = unseal(key, box, shape)
        if not ok:
            raise ValueError("response MAC failed")
        return pt.cpu().numpy()

    # -- server side -------------------------------------------------------
    def serve_batch(self, requests: List[Request]) -> List[Response]:
        """One enclave dispatch of at most ``max_batch`` requests."""
        if len(requests) > self.max_batch:
            raise ValueError(
                f"serve_batch got {len(requests)} requests for max_batch="
                f"{self.max_batch}")
        t0 = time.monotonic()
        prep = prepare_sealed_batch(requests, max_batch=self.max_batch)
        boxes, n_valid, integ = prep.boxes, 0, prep.integ
        if prep.x is not None:
            boxes, n_valid, _, integ = complete_prepared_batch(
                self.executor, prep, input_key=self.input_key,
                session_key=self._blind_session(self.batches))
        self.integrity_totals.add(integ)
        self.last_phases = prep.phases
        if n_valid:
            self.batches += 1
            # compute the next session's factors now, off its request path
            self.executor.prepare_session(self._blind_session(self.batches))
            self.processed += n_valid
        dt = time.monotonic() - t0
        return [Response(r.rid, box, box is not None, dt,
                         flagged=integ.flagged and box is not None,
                         error=None if box is not None else "mac_failed")
                for r, box in zip(requests, boxes)]

    def serve(self, requests: List[Request]) -> List[Response]:
        """Serve any number of requests through the engine and return the
        responses in request order (the engine completes out of order).
        The engine rejects a rid already in flight, so duplicate rids go
        in waves, each waiting for the previous occurrence to finish."""
        responses: List[Optional[Response]] = [None] * len(requests)
        waves: List[List[int]] = []
        depth: Dict[int, int] = {}
        for i, r in enumerate(requests):
            d = depth.get(r.rid, 0)
            depth[r.rid] = d + 1
            while len(waves) <= d:
                waves.append([])
            waves[d].append(i)
        for wave in waves:
            futures = [(i, self.engine.submit("default", requests[i]))
                       for i in wave]
            # the list is complete: do not let the tail batch idle out
            # the max_wait timer
            self.engine.flush()
            for i, f in futures:
                responses[i] = f.result(timeout=300.0)
        return responses

    @property
    def engine(self):
        """A lazily built single-model ServingEngine over this server's
        executor (so ``serve`` and ``serve_batch`` share its caches).
        ``max_queue`` is effectively unbounded: ``serve`` is synchronous,
        and admission control would shed the tail of a long list."""
        if self._engine is None:
            from repro_torch.runtime.engine import EngineConfig, ServingEngine
            self._engine = ServingEngine(EngineConfig(
                max_batch=self.max_batch, max_wait_ms=25.0,
                max_queue=1_000_000_000))
            self._engine.register_executor("default", self.executor,
                                           input_key=self.input_key)
        return self._engine

    def close(self) -> None:
        """Stop the engine's batcher, device-stage and session-pool
        threads, if ``serve`` started them."""
        if self._engine is not None:
            self._engine.close()
            self._engine = None
