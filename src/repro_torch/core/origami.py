"""Origami executor: plan-driven trust-partitioned inference (the paper).

Port of ``repro/core/origami.py`` for CNN plans and dense-LM decode on one
device. The executor walks a ``PlacementPlan`` (core/plan.py) segment by
segment: plain segments run the float layers, blinded and verified
segments route every linear op through the Slalom protocol
(core/slalom.py) by installing it as the layer hook. The legacy mode
strings

    "open" | "enclave" | "split" | "slalom" | "origami"

compile to plans (``plan.compile_mode``). The port runs on ``device``
(``"cuda"`` by default; the CPU tests pass ``"cpu"``). On the card the
field ops and the prefill attention launch the port's CUDA kernels; on the
CPU they take the kernels' plain versions.

**Executables.** With a runtime/aot.CompileCache attached (``attach_aot``)
``infer`` runs each (trace kind, plan digest, batch shape) signature
through an executable: on the card a CUDA graph of the eager step,
captured once (``warm_aot`` captures every bucket ahead of the first
request) and replayed with the request's batch and session factors copied
into its static buffers; on the CPU the eager step itself. A captured step
must not depend on host-side values that change per request, so these
stay eager, as the reference keeps its plane executors eager: an executor
with an offload plane (host-side dispatch, retries, health) or an injected
fault (its decisions are drawn on the host), and a blinded step that
derives material from the session key on the host (no precompute cache,
or a "sampled" Freivalds policy, whose check decisions are host draws).
Without an attached cache ``infer`` runs eagerly.

For an LM (every LM family), ``infer`` on {"tokens": (B, S)} is the
forward over every position; Whisper's batch adds its "frames" (B, M, d)
and its plan ranges over the encoder blocks (the decoder runs in the
clear after the last segment), Llama-3.2-Vision's adds its "patches"
(B, M, d), which every segment's cross blocks attend to. A MoE
block's experts and router are not ``layers.dense`` calls: they run as
plain float ops in every segment (in tier-1 on the enclave's side, as in
the reference), and only its attention projections (and Arctic's
dense-residual FFN) are blinded; likewise a Mamba2, mLSTM or sLSTM
block blinds its projections and runs its convolution and recurrence in
the enclave. For the dense LM the executor also runs
private autoregressive decode (runtime/generate.py):
``attach_decode_plan`` adopts a DecodePlan,
``prefill_session`` walks the prompt through the base plan's segments
(every tier-1 op blinded with its own key, ``step`` 0) and
``decode_once`` walks one token through the scan segments (``step`` = the
token's position), its factors from a TokenSlotRing slot or derived live.
A MoE, recurrent, audio or VLM executor has no decode plan:
``attach_decode_plan`` raises plan.ScanExclusion with the reference's
reason.
With a CompileCache attached, the trusted prompt pass and the slot-fed
and trusted token steps replay CUDA graphs keyed on the decode plan's
digest (``warm_decode_aot`` captures them ahead of the first request).

**Where the port departs from the reference: the LM forward is per op.**
The reference walks an LM forward's blocks under ``lax.scan``, so each
projection of a blinded segment is traced once for all its layers: one
pad (key ``(session, op, 0)``, op 0..6) blinds that projection in every
layer, the segment's Freivalds policy is dropped and the counters count
one op per traced call. The port walks the blocks one by one, as the
reference's own prompt pass (``prefill_session``) does: every runtime op
draws its own key ``(session, op, 0)`` and binds its segment's policy and
fault injector, and the telemetry and ``IntegrityReport`` count every op.
The blinding cancels exactly, so the logits do not depend on the pads
(ROADMAP Queue 3).

``impl`` picks the fused or unfused Slalom data path, ``fault`` injects a
dishonest device under every untrusted run, and ``devices`` (a
runtime/devices.DevicePool) attaches a multi-device offload plane
(parallel/offload_sharding.py) that shards every blinded matmul of a CNN
plan; an LM executor keeps the pool with its plane idle, as in the
reference.
"""
from __future__ import annotations

import functools
from contextlib import ExitStack
from dataclasses import dataclass, field as dfield, replace as dreplace
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import integrity as IG
from repro_torch.core import plan as PL
from repro_torch.core import prng
from repro_torch.core import slalom as SL
from repro_torch.core import tracing
from repro_torch.core.blinding import BlindingSpec
from repro_torch.core.precompute import BlindedLayerCache
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import vgg as V
from repro_torch.runtime import aot as AOT

MODES = PL.LEGACY_MODES

# per-layer factor entries that are the cache's own weight material, the
# same tensors for every session (a captured step reads them in place)
_STATIC_FACTORS = ("w_q", "w_limbs", "w_scale")


@dataclass
class OrigamiResult:
    logits: torch.Tensor
    boundary: Optional[torch.Tensor]    # what the adversary observes
    telemetry: SL.Telemetry
    integrity: IG.IntegrityReport = dfield(
        default_factory=IG.IntegrityReport.empty)
    trusted: bool = False               # enclave-recompute run (no device)
    sharding: Optional[Any] = None      # offload_sharding.ShardReport


def resolve_device(device) -> torch.device:
    """The entry points' device; a CUDA request without a card raises
    (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           f"available; pass device='cpu' to run the plain "
                           f"versions of the kernels")
    return dev


def tokens_on(tokens, device: torch.device) -> torch.Tensor:
    """Token ids (a tensor or array-like) as a long tensor on ``device``."""
    t = (tokens if isinstance(tokens, torch.Tensor)
         else torch.from_numpy(np.asarray(tokens, np.int64)))
    return t.to(device, torch.long)


def params_to_device(params, device: torch.device):
    """A nested parameter dict on ``device`` (tensors already there are
    kept, not copied)."""
    if isinstance(params, dict):
        return {k: params_to_device(v, device) for k, v in params.items()}
    return torch.as_tensor(params).to(device)


class OrigamiExecutor:
    """Plan-interpreting private inference over a VGG model or a dense
    LM."""

    def __init__(self, cfg: ModelConfig, params, mode: str = "origami",
                 partition: Optional[int] = None,
                 spec: Optional[BlindingSpec] = None,
                 impl: str = "fused", precompute: bool = False,
                 integrity: Optional[IG.IntegrityPolicy] = None,
                 fault: Optional[Any] = None,
                 plan: Optional[PL.PlacementPlan] = None,
                 devices: Optional[Any] = None, shard: str = "rows",
                 hedging: bool = True, liveness: Optional[Any] = None,
                 device="cuda"):
        """``plan``: an explicit PlacementPlan; when omitted, ``mode`` and
        ``partition`` compile one. ``impl``: "fused" | "unfused" data
        path. ``integrity``: Freivalds policy of blinded steps without
        their own (default off). ``fault``: a runtime/faults.DishonestDevice
        under the device matmul (a pool carries per-slot injectors
        instead). ``precompute``: draw each session's factors through a
        BlindedLayerCache. ``devices``: a runtime/devices.DevicePool —
        attaches an offload plane with default shard mode ``shard``
        ("rows" | "shares"), straggler ``hedging`` and an
        offload_sharding.LivenessConfig ``liveness``."""
        assert impl in ("fused", "unfused"), impl
        if plan is None:
            plan = PL.compile_mode(cfg, mode, partition)
        assert plan.n_layers == PL.num_blocks(cfg), plan.n_layers
        self.device = resolve_device(device)
        L.set_exact_float(self.device)
        self.cfg = cfg
        self.params = params_to_device(params, self.device)
        self.plan = plan
        self.partition = plan.boundary
        self.spec = spec or BlindingSpec()
        self.impl = impl
        self.precompute = precompute
        self.integrity = integrity or IG.IntegrityPolicy.off()
        self.fault = fault
        self.plane = None
        self._plane_live = False
        if devices is not None:
            from repro_torch.parallel.offload_sharding import OffloadPlane
            self.plane = OffloadPlane(devices, mode=shard, hedging=hedging,
                                      liveness=liveness)
            # the plane only fires on offloaded steps of a family whose
            # plans address linear ops one by one (not the LMs, whose
            # plans the reference shares with its scanned forward): an LM
            # executor keeps the pool and leaves its plane idle
            self._plane_live = (PL.linear_layers(cfg) is not None
                                and plan.has_offload)
        self.cache: Optional[BlindedLayerCache] = None
        self._caches: Dict[Any, BlindedLayerCache] = {}
        self._cache_key = None
        self._program = PL.program_for(cfg)
        self._tele_last = SL.Telemetry()
        self._tele_blinded = SL.Telemetry()
        self._tele_trusted = SL.Telemetry()
        # executables (attach_aot): None keeps infer eager
        self._aot: Optional[AOT.CompileCache] = None
        self._executables: Dict[Any, Any] = {}   # sig -> executable (COW)
        # signatures already inferred: the first call of each pays the
        # capture (or the first eager run), and the profiler needs it named
        self._seen_sigs: set = set()
        # decode plane (attach_decode_plan): scan segments + token-slot
        # factor caches, one per batch size
        self.dplan: Optional[PL.DecodePlan] = None
        self._decode_caches: Dict[int, BlindedLayerCache] = {}

    # -- telemetry snapshots -------------------------------------------------
    @property
    def telemetry(self) -> SL.Telemetry:
        """Counters of the most recent run (blinded or trusted)."""
        return self._tele_last

    @property
    def telemetry_blinded(self) -> SL.Telemetry:
        return self._tele_blinded

    @property
    def telemetry_trusted(self) -> SL.Telemetry:
        return self._tele_trusted

    # -- the plan walk -------------------------------------------------------
    def _traced(self, batch, session_key, factors=None, trusted=False):
        tele = SL.Telemetry()
        ctx = SL.SlalomContext(
            session_key, self.spec, telemetry=tele, impl=self.impl,
            factors=factors, fault=None if trusted else self.fault,
            trusted=trusted,
            plane=self.plane if self._plane_live and not trusted else None)
        logits, boundary = self._run(batch, ctx)
        if ctx.integrity_log:
            rep = tuple(torch.stack([entry[i] for entry in ctx.integrity_log])
                        for i in range(3))
        else:
            z = torch.zeros((0,), dtype=torch.bool, device=self.device)
            rep = (z, z, z)
        if trusted:
            self._tele_trusted = tele
        else:
            self._tele_blinded = tele
        return logits, boundary, rep

    def _run(self, batch, ctx):
        """Walk the plan segments: one interpreter for every placement."""
        params, prog, plan = self.params, self._program, self.plan
        x, memory = prog.prologue(params, batch)
        boundary = x if plan.boundary == 0 else None
        for seg in plan.segments:
            with ExitStack() as stack:
                stack.enter_context(tracing.maybe_span(
                    "plan.segment", "step", lo=seg.lo, hi=seg.hi,
                    regime=seg.regime))
                if seg.regime != "plain":
                    policy = (seg.policy if seg.policy is not None
                              else self.integrity)
                    stack.enter_context(ctx.segment_overrides(
                        policy, unblinded=(seg.regime == "verified"),
                        shard=seg.shard))
                    stack.enter_context(L.dense_impl(
                        functools.partial(SL.blinded_dense, ctx)))
                    if prog.blind_convs:
                        stack.enter_context(L.conv_impl(
                            functools.partial(SL.blinded_conv2d, ctx)))
                x = prog.segment(params, x, seg.lo, seg.hi, memory)
            if seg.hi == plan.boundary:
                boundary = x
        return prog.epilogue(params, x, batch, memory), boundary

    # -- decode plans: scan segments + token slots ---------------------------
    def attach_decode_plan(self, dplan: Optional[PL.DecodePlan] = None, *,
                           max_steps: int = 256) -> PL.DecodePlan:
        """Adopt a DecodePlan (``plan.make_decode_plan``). When ``dplan`` is
        omitted one is compiled from this executor's plan, with the
        executor's Freivalds policy as the per-step policy of every
        offloaded scan segment. Raises plan.ScanExclusion outside
        plan.DECODE_FAMILIES."""
        if dplan is None:
            dplan = PL.make_decode_plan(
                self.cfg, self.plan, max_steps=max_steps,
                integrity=(self.integrity if self.integrity.enabled
                           else None))
        assert dplan.base.digest == self.plan.digest, \
            "decode plan extends a different base plan"
        self.dplan = dplan
        return dplan

    def decode_cache(self, batch_size: int) -> Optional[BlindedLayerCache]:
        """Quantize-once weight material and the per-(session, token, op)
        factor store of the decode walk, one per batch size. A
        TokenSlotRing (runtime/sessions.py) streams
        ``session_factors(key, step=token)`` out of it. None when the
        decode plan offloads nothing."""
        assert self.dplan is not None, "attach_decode_plan first"
        if not self.dplan.has_offload:
            return None
        cache = self._decode_caches.get(batch_size)
        if cache is None:
            with torch.no_grad():
                cache = BlindedLayerCache.from_records(
                    self._decode_records(batch_size), self.spec,
                    integrity=self.integrity)
            # copy-on-write rebind: read by a ring's refill thread
            self._decode_caches = {**self._decode_caches, batch_size: cache}
        return cache

    def _decode_records(self, batch_size: int):
        """Per-op descriptors of the decode walk, in call order: one token
        step run with a recording dense hook. Only offloaded segments
        record; plain segments touch no factor material."""
        cfg, params = self.cfg, self.params
        records = []

        def capture(p, xx):
            w = p["w"]
            t = 1
            for s_ in xx.shape[:-1]:
                t *= s_
            records.append({"kind": "dense", "w": w, "t": int(t),
                            "d_in": int(w.shape[0]),
                            "d_out": int(w.shape[1])})
            y = xx @ w.to(xx.dtype)
            if "b" in p:
                y = y + p["b"].to(xx.dtype)
            return y

        caches = M.init_caches(cfg, batch_size, 8, device=self.device)
        token = torch.zeros((batch_size, 1), dtype=torch.long,
                            device=self.device)
        x = M.embed_tokens_at(params, token, 0, cfg)
        for seg in self.dplan.scan:
            if seg.regime == "plain":
                x, caches = M.decode_range(params, x, caches, 0, cfg,
                                           seg.lo, seg.hi)
                continue
            pol = seg.policy if seg.policy is not None else self.integrity
            start = len(records)
            with L.dense_impl(capture):
                x, caches = M.decode_range_unrolled(params, x, caches, 0, cfg,
                                                    seg.lo, seg.hi)
            for rec in records[start:]:
                rec["unblinded"] = seg.regime == "verified"
                rec["policy"] = pol
        return records

    def _context(self, session_key, tele, step: int, factors=None,
                 trusted: bool = False) -> SL.SlalomContext:
        return SL.SlalomContext(
            session_key, self.spec, telemetry=tele, step=step,
            impl=self.impl, factors=factors,
            fault=None if trusted else self.fault, trusted=trusted)

    def _offloaded(self, ctx, seg):
        """Scope ``seg``'s policy and regime and install the Slalom hook."""
        stack = ExitStack()
        policy = seg.policy if seg.policy is not None else self.integrity
        stack.enter_context(ctx.segment_overrides(
            policy, unblinded=(seg.regime == "verified"), shard=seg.shard))
        stack.enter_context(L.dense_impl(
            functools.partial(SL.blinded_dense, ctx)))
        return stack

    def _traced_decode(self, token, caches, pos, session_key, factors=None,
                       step: int = 0, trusted: bool = False):
        """One token step under the decode plan's scan segments. ``pos`` is
        the token's position as a 0-dim long tensor (the model reads it
        there, so one CUDA graph serves every position) and ``step`` the
        same position as a host int: the key domain of live pads, folds
        and check decisions, so the ring's cached factors for ``step ==
        pos`` equal this step's live derivation. A captured step reads no
        ``step`` (``_graphable``: only slot-fed, unsampled or trusted steps
        are captured)."""
        tele = SL.Telemetry()
        ctx = self._context(session_key, tele, step, factors, trusted)
        params, cfg = self.params, self.cfg
        x = M.embed_tokens_at(params, token, pos, cfg)
        for seg in self.dplan.scan:
            if seg.regime == "plain":
                x, caches = M.decode_range(params, x, caches, pos, cfg,
                                           seg.lo, seg.hi)
                continue
            with self._offloaded(ctx, seg):
                x, caches = M.decode_range_unrolled(params, x, caches, pos,
                                                    cfg, seg.lo, seg.hi)
        logits = M.head(params, x, cfg)
        self._keep_telemetry(tele, trusted)
        return logits, caches, self._fold_log(ctx)

    def _traced_prefill(self, tokens, session_key, trusted: bool = False,
                        *, max_seq: int):
        """The prompt through the base plan's segments ->
        (last-position logits, decode caches, integrity log). Every prompt
        op of an offloaded segment draws its own key and fold at
        ``step`` 0; decode steps use their position (>= the prompt length
        >= 1), so the two key domains never meet."""
        tele = SL.Telemetry()
        ctx = self._context(session_key, tele, 0, None, trusted)
        params, cfg = self.params, self.cfg
        x = M.embed_tokens(params, tokens, cfg)
        parts = []
        for seg in self.plan.segments:
            if seg.regime == "plain":
                x, c = M.prefill_range(params, x, cfg, seg.lo, seg.hi)
            else:
                with self._offloaded(ctx, seg):
                    x, c = M.prefill_range_unrolled(params, x, cfg, seg.lo,
                                                    seg.hi)
            parts.append(c)
        caches = M.concat_layer_caches(parts, max_seq)
        logits = M.head(params, x[:, -1:], cfg)
        self._keep_telemetry(tele, trusted)
        return logits, caches, self._fold_log(ctx)

    def _keep_telemetry(self, tele: SL.Telemetry, trusted: bool) -> None:
        if trusted:
            self._tele_trusted = tele
        else:
            self._tele_blinded = tele
        self._tele_last = tele

    def _fold_log(self, ctx):
        if ctx.integrity_log:
            return tuple(torch.stack([e[i] for e in ctx.integrity_log])
                         for i in range(3))
        z = torch.zeros((0,), dtype=torch.bool, device=self.device)
        return (z, z, z)

    def prefill_session(self, tokens, session_key, *, max_seq: int,
                        trusted: bool = False, jit: bool = True):
        """The prompt pass: (logits at the last position (B, 1, V), decode
        caches padded to ``max_seq``, IntegrityReport of the prompt's
        offloaded ops). With a CompileCache attached and ``jit`` true a
        pass that draws nothing on the host (the trusted one, or a plan
        with no offload) replays its executable."""
        assert self.dplan is not None, "attach_decode_plan first"
        tokens = tokens_on(tokens, self.device)
        args = (tokens, session_key)
        sig, fn, kind = self._lm_step("prefill", trusted, tokens.shape,
                                      max_seq)
        with torch.no_grad():
            if jit and self._graphable(trusted, "prefill"):
                logits, caches, rep = self._run_executable(
                    sig, args, trusted, fn, self.dplan.digest, kind)
            else:
                logits, caches, rep = fn(*args)
        self._tele_last = (self._tele_trusted if trusted
                           else self._tele_blinded)
        return logits, caches, IG.IntegrityReport(*rep)

    def decode_once(self, token, caches, pos: int, session_key, factors=None,
                    *, trusted: bool = False, jit: bool = True):
        """One token step: (logits (B, 1, V), the caches with this token's
        K/V written (in place when eager; a replay returns a copy),
        IntegrityReport of this token's offloaded ops). ``factors`` is a
        TokenSlotRing slot (``take(pos)``) or None for the live and
        trusted derivations. With a CompileCache attached and ``jit``
        true a slot-fed or trusted step replays its executable, the
        session's caches copied into the graph's buffers and out again."""
        assert self.dplan is not None, "attach_decode_plan first"
        token = tokens_on(token, self.device)
        with torch.no_grad():
            args = (token, caches, A.position(int(pos), self.device),
                    session_key, factors, int(pos))
            sig, fn, kind = self._lm_step("decode", trusted, token.shape,
                                          caches.k.shape[2],
                                          factors is not None)
            if jit and self._graphable(trusted, "decode", factors):
                logits, caches, rep = self._run_executable(
                    sig, args, trusted, fn, self.dplan.digest, kind)
            else:
                logits, caches, rep = fn(*args)
        self._tele_last = (self._tele_trusted if trusted
                           else self._tele_blinded)
        return logits, caches, IG.IntegrityReport(*rep)

    def warm_decode_aot(self, batch: int, prompt_len: int, max_seq: int,
                        trusted_too: bool = True) -> int:
        """Build the prompt pass's and the token step's executables (and
        the trusted twins, ``trusted_too``) for one batch size ahead of the
        first request, and the batch size's token-slot cache: the decode
        counterpart of ``warm_aot``. Returns the number of signatures
        ensured; a pass that stays eager (``_graphable``: the blinded
        prompt pass draws live pads) is skipped."""
        assert self._aot is not None, "attach_aot first"
        assert self.dplan is not None, "attach_decode_plan first"
        key0 = prng.PRNGKey(0)
        tokens = torch.zeros((batch, int(prompt_len)), dtype=torch.long,
                             device=self.device)
        token = torch.zeros((batch, 1), dtype=torch.long, device=self.device)
        cache = self.decode_cache(batch)
        n = 0
        with self._aot.warmup_scope(), torch.no_grad():
            for trusted in ((False, True) if trusted_too else (False,)):
                if self._graphable(trusted, "prefill"):
                    sig, fn, kind = self._lm_step("prefill", trusted,
                                                  tokens.shape, max_seq)
                    self._ensure_executable(sig, (tokens, key0), trusted, fn,
                                            self.dplan.digest, kind)
                    n += 1
                factors = (None if trusted or cache is None
                           else cache.session_factors(key0, int(prompt_len)))
                if self._graphable(trusted, "decode", factors):
                    caches = M.init_caches(self.cfg, batch, int(max_seq),
                                           device=self.device)
                    args = (token, caches,
                            A.position(int(prompt_len), self.device), key0,
                            factors, int(prompt_len))
                    sig, fn, kind = self._lm_step("decode", trusted,
                                                  token.shape, max_seq,
                                                  factors is not None)
                    self._ensure_executable(sig, args, trusted, fn,
                                            self.dplan.digest, kind)
                    n += 1
        return n

    def _lm_step(self, kind: str, trusted: bool, shape, max_seq: int,
                 fed: bool = False):
        """(signature, eager step, executable kind) of the prompt pass
        (``kind`` "prefill") or the token step ("decode", ``fed`` by a
        ring slot): the one place the request path and
        ``warm_decode_aot`` take them from, so a warmed executable is the
        one a request looks up."""
        trusted, max_seq = bool(trusted), int(max_seq)
        suffix = "_trusted" if trusted else ""
        if kind == "prefill":
            return (("prefill", trusted, self.dplan.digest, tuple(shape),
                     max_seq),
                    functools.partial(self._traced_prefill, trusted=trusted,
                                      max_seq=max_seq),
                    f"prefill{max_seq}{suffix}")
        return (("decode", trusted, self.dplan.digest, tuple(shape), max_seq,
                 bool(fed)),
                functools.partial(self._traced_decode, trusted=trusted),
                f"decode{suffix}")

    # -- precompute pipeline -------------------------------------------------
    def _batch_key(self, batch):
        return self.plan.digest, self._shapes(batch)

    def build_cache(self, batch) -> Optional[BlindedLayerCache]:
        """Quantize and limb-encode every offloaded layer's weights once
        and set up the per-session factor store for this batch shape."""
        ops = self.plan.cache_ops
        if not ops:
            self.precompute = False
            self.cache = None
            return None
        batch_size = int(batch["images"].shape[0])
        records = V.blinded_op_records(self.params, self.cfg,
                                       [s.layer_id for s in ops], batch_size)
        for rec, step in zip(records, ops):
            rec["unblinded"] = step.verified_open
            rec["policy"] = (step.integrity if step.integrity is not None
                             else self.integrity)
        self.cache = BlindedLayerCache.from_records(records, self.spec,
                                                    integrity=self.integrity)
        if self._plane_live:
            # per-shard fold vectors ride the session factors
            self.cache.shards = self.plane.n_shards
        self._cache_key = self._batch_key(batch)
        # copy-on-write: a SessionPool's refill thread reads this dict
        self._caches = {**self._caches, self._cache_key: self.cache}
        return self.cache

    def prepare_session(self, session_key, step: int = 0) -> None:
        """Compute a future session's factors ahead of its request."""
        if self.cache is not None:
            self.cache.prefetch(session_key, step)

    def _session_factors(self, batch, session_key):
        if not (self.precompute and self.plan.has_offload):
            return None
        key = self._batch_key(batch)
        if self.cache is None or key != self._cache_key:
            if key in self._caches:
                self.cache = self._caches[key]
                self._cache_key = key
            else:
                self.build_cache(batch)
        if self.cache is None:
            return None
        return self.cache.take(session_key)

    # -- executables ---------------------------------------------------------
    def attach_aot(self, cache: AOT.CompileCache) -> None:
        """Adopt a (shared) CompileCache: ``infer`` then runs through
        executables, built exactly once per signature, and counted in the
        cache. Keeps the executables this executor already has."""
        self._aot = cache

    def _graphable(self, trusted: bool, kind: str = "infer",
                   factors=None) -> bool:
        """Can a captured step serve this trace for every session? ``kind``
        is "infer" (the base plan's forward), "prefill" (the prompt pass)
        or "decode" (the token step fed ``factors``). Not with a plane or
        an injected fault (host-side decisions); a trusted trace, or one
        with no offloaded op, always; a blinded one only when every
        per-session value it reads is a tensor of the session's factors: a
        forward with a precompute cache, a token step fed a ring slot, and
        no "sampled" policy. A blinded prompt pass, and a blinded LM
        forward (no cache slots), draw live pads and stay eager."""
        if self._aot is None or self._plane_live or self.fault is not None:
            return False
        plan = self.dplan if kind == "decode" else self.plan
        if trusted or not plan.has_offload:
            return True
        if kind == "infer":
            fed = self.precompute and bool(self.plan.cache_ops)
            policies = [s.integrity for s in self.plan.steps]
        elif kind == "decode":
            fed = factors is not None
            policies = [seg.policy for seg in self.dplan.scan]
        else:
            return False
        return fed and all(p.mode != "sampled" for p in
                           [self.integrity] + policies if p is not None)

    def _weights_id(self) -> str:
        """The executor's weight buffers: a captured step reads them in
        place, so two executors share a step only when they share them."""
        parts = []

        def walk(tree):
            if isinstance(tree, dict):
                for k in sorted(tree):
                    walk(tree[k])
            else:
                parts.append(f"{tree.data_ptr():x}")
        walk(self.params)
        return ",".join(parts)

    def _ensure_executable(self, sig, args, trusted: bool, fn, digest: str,
                           kind: str):
        """The one build path: the memo, else a timed capture of ``fn`` (the
        eager step) keyed on ``digest`` (the plan's, or the decode plan's
        for the prompt pass and the token step) and ``kind``."""
        ex = self._executables.get(sig)
        if ex is not None:
            return ex
        ck = self._aot.entry_key(f"{digest}@{self._weights_id()}", kind,
                                 args)

        def build():
            with tracing.maybe_span("compile.aot", "compile",
                                    trusted=int(trusted)):
                if self.device.type != "cuda":
                    return AOT.EagerStep(fn)
                with tracing.suspended():
                    static = AOT.clone_tree(args, keep=_STATIC_FACTORS)
                    ex = AOT.GraphStep(fn, static, self.device)
                # the telemetry of the captured trace, restored per replay
                ex.telemetry = (self._tele_trusted if trusted
                                else self._tele_blinded)
                return ex

        ex, _ = self._aot.compile_once(ck, build)
        # copy-on-write rebind: read by warm-up and serving threads
        self._executables = {**self._executables, sig: ex}
        return ex

    def _run_executable(self, sig, args, trusted: bool, fn, digest: str,
                        kind: str):
        """``fn(*args)`` through the signature's executable, built once; an
        executable that fails at call time is evicted and the eager step
        ``fn`` runs instead."""
        ex = self._ensure_executable(sig, args, trusted, fn, digest, kind)
        try:
            out = ex(*args)
        except Exception:  # noqa: BLE001 — evict, run the eager step
            self._aot.record_fallback()
            self._executables = {k: v for k, v in self._executables.items()
                                 if k != sig}
            return fn(*args)
        tele = getattr(ex, "telemetry", None)
        if tele is not None:
            if trusted:
                self._tele_trusted = dreplace(tele)
            else:
                self._tele_blinded = dreplace(tele)
        return out

    def warm_aot(self, input_key: str, request_shape, buckets,
                 dtype=None, trusted_too: bool = True) -> int:
        """Build every (trace kind, shape bucket) executable, and each
        bucket's factor cache, ahead of the first request; the trusted
        recovery trace too (``trusted_too``). Returns the number of
        signatures ensured; a trace that stays eager (``_graphable``: a
        plane or an injected fault stays eager in both kinds) is skipped."""
        assert self._aot is not None, "attach_aot first"
        key0 = prng.PRNGKey(0)
        n = 0
        with self._aot.warmup_scope(), torch.no_grad():
            for b in buckets:
                x = torch.zeros((int(b),) + tuple(request_shape),
                                dtype=dtype or torch.float32,
                                device=self.device)
                batch = {input_key: x}
                shapes = self._shapes(batch)
                for trusted in ((False, True) if trusted_too else (False,)):
                    if not self._graphable(trusted):
                        continue
                    sig = (trusted, self.plan.digest, shapes)
                    factors = (None if trusted
                               else self._session_factors(batch, key0))
                    self._ensure_executable(
                        sig, (batch, key0, factors), trusted,
                        functools.partial(self._traced, trusted=trusted),
                        self.plan.digest,
                        "trusted" if trusted else "blinded")
                    self._seen_sigs.add(sig)
                    n += 1
        return n

    # -- public API ----------------------------------------------------------
    def _on_device(self, batch) -> Dict[str, torch.Tensor]:
        """The batch on the executor's device: an LM's token ids as long,
        every other entry (a CNN's images, Whisper's frames, a VLM's
        patches) as float32; the model casts the memory as the reference
        does (Whisper's prologue to the model dtype, a VLM's forward not
        at all)."""
        return {k: (v if isinstance(v, torch.Tensor)
                    else torch.from_numpy(np.asarray(v))).to(
                        self.device,
                        torch.long if k == "tokens" else torch.float32)
                for k, v in batch.items()}

    @staticmethod
    def _shapes(batch):
        return tuple(sorted((k, tuple(v.shape)) for k, v in batch.items()))

    def infer(self, batch, session_key=None, trusted: bool = False,
              jit: bool = True) -> OrigamiResult:
        """Run the plan on ``batch`` ({"images": (B, H, W, C)} or, for an
        LM, {"tokens": (B, S)} and a cross-attention model's "frames" or
        "patches": logits at every position) under the
        blinding session ``session_key`` (a (2,) uint32 key; PRNGKey(0)
        when omitted). ``trusted=True`` runs the enclave-recompute path:
        no device, no blinding, no verification, bit-identical logits.
        With a CompileCache attached the run goes through the signature's
        executable unless ``jit=False`` (the eager step, bit-equal)."""
        batch = self._on_device(batch)
        key = session_key if session_key is not None else prng.PRNGKey(0)
        sig = (bool(trusted), self.plan.digest, self._shapes(batch))
        first_call = sig not in self._seen_sigs
        self._seen_sigs.add(sig)
        shard_report = None
        with torch.no_grad():
            factors = None if trusted else self._session_factors(batch, key)
            args = (batch, key, factors)
            if self._plane_live and not trusted:
                self.plane.begin_infer()
                logits, boundary, rep = self._traced(*args)
                shard_report = self.plane.report
            elif jit and self._graphable(trusted):
                logits, boundary, rep = self._run_executable(
                    sig, args, trusted,
                    functools.partial(self._traced, trusted=trusted),
                    self.plan.digest, "trusted" if trusted else "blinded")
            else:
                logits, boundary, rep = self._traced(*args, trusted=trusted)
        self._tele_last = (self._tele_trusted if trusted
                           else self._tele_blinded)
        # stamp the ambient infer span (runtime/serving.py opens it) with
        # compile provenance and the cost-model quantities this run moved
        sp = tracing.current_span()
        if sp is not None:
            tele = self._tele_last
            tracing.annotate(
                sp, first_call=first_call,
                device_flops=int(tele.offloaded_flops),
                enclave_flops=int(tele.enclave_flops),
                blind_bytes=int(tele.blinded_bytes),
                unblind_bytes=int(tele.returned_bytes),
                device_matmuls=int(tele.device_matmuls))
        return OrigamiResult(logits=logits, boundary=boundary,
                             telemetry=self.telemetry,
                             integrity=IG.IntegrityReport(*rep),
                             trusted=trusted, sharding=shard_report)

    def reference(self, batch) -> torch.Tensor:
        """Plain float forward — the correctness oracle for all plans."""
        with torch.no_grad():
            batch = self._on_device(batch)
            if self.cfg.family != "cnn":
                return M.forward(self.params, batch, self.cfg).logits
            return V.vgg_forward(self.params, batch["images"], self.cfg)
