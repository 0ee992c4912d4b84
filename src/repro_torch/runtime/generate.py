"""Autoregressive generation: the open float path and private decode under
the Origami two-tier protocol.

Port of ``repro/runtime/generate.py`` for the dense, mixture-of-experts,
hybrid and SSM families: ``generate`` takes all four and
``generate_origami`` the dense and MoE families, as the reference's do;
``private_generate`` and ``GenerateExecutor`` need a decode plan, which
refuses MoE, hybrid, SSM, audio and VLM (plan.ScanExclusion, the
reference's reasons), so they run the dense family only, as in the
reference. ``generate`` refuses the cross-attention families (audio,
vlm): the reference's passes the prompt pass only the tokens and raises
``KeyError`` on the missing frames or patches. For
the recurrent families (hybrid Zamba2, SSM xLSTM) ``generate`` has no
prefill: it builds the state by stepping ``decode_step`` through the
prompt (``prefill_recurrent``), where the reference runs one jitted
``fori_loop``. Its counterpart of "compiles once" is ``RecurrentStep``:
on the card one CUDA graph of the step, captured once and replayed for
every prompt position and every new token.
``private_generate`` prefills the prompt through the base plan's segments
(tier-1 blinded op by op and Freivalds-checked, tier-2 open), then walks
each token through the decode plan's scan segments, its tier-1 pads and
fold vectors streamed by a TokenSlotRing. ``trusted=True`` is the
recovery oracle: the same quantized arithmetic entirely in the enclave,
bit-identical logits and tokens. The tier-1 KV cache rows (layers < p)
belong to the trusted domain; ``tier1_cache_bytes`` prices them.
``generate_origami`` is the reference's simpler per-step protocol: the
prompt and every new token stepped one by one, tier-1 blinded (its ops
numbered over the whole stream, a fresh pad each), tier-2 open.
``GenerateExecutor`` serves sealed prompts as token streams through the
engine (runtime/engine.py).

Sampling follows the reference: greedy at ``temperature == 0``, else
``categorical`` (core/prng.py, jax's Gumbel-max draw) of ``logits /
temperature``, with ``key, k = split(key)`` before every draw from the
sampling key (``PRNGKey(0)`` when omitted).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import integrity as IG
from repro_torch.core import origami as OG
from repro_torch.core import prng
from repro_torch.core import slalom as SL
from repro_torch.core.blinding import BlindingSpec
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.model import MEMORY_KEYS
from repro_torch.runtime import aot as AOT
from repro_torch.runtime.sessions import TokenSlotRing


@dataclass
class GenerationResult:
    tokens: torch.Tensor            # (B, prompt + new)
    telemetry: Optional[SL.Telemetry]


def _sample(logits: torch.Tensor, key, temperature: float,
            vocab_size: int) -> torch.Tensor:
    """The next token from the logits of the real vocab entries: the first
    index of the largest at ``temperature <= 0`` (torch.argmax and
    jnp.argmax both take the first), else a categorical draw from
    ``logits / temperature`` under ``key``."""
    logits = logits[..., :vocab_size].to(torch.float32)
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    # a full divisor: torch may turn a division by a scalar into a
    # multiplication by its reciprocal, which jax does not
    return prng.categorical(key, logits / torch.full_like(logits,
                                                          temperature))


# the families the reference's generate and generate_origami run (its
# generate fails for audio and vlm: MEMORY_KEYS)
FAMILIES = ("dense", "moe", "hybrid", "ssm")
ORIGAMI_FAMILIES = ("dense", "moe")         # generate_origami's
# the families whose state is built by stepping through the prompt
RECURRENT = ("hybrid", "ssm")


def _family_in(cfg: ModelConfig, families) -> None:
    if cfg.family in MEMORY_KEYS:
        raise NotImplementedError(
            f"{cfg.family}: open generate is refused, as the reference "
            f"cannot run it: its generate passes only the prompt's tokens "
            f"to the prompt pass, which raises KeyError on "
            f"{MEMORY_KEYS[cfg.family]!r}; run prefill"
            f"{'_vlm' if cfg.family == 'vlm' else ''} and decode_step "
            f"(models/model.py)")
    if cfg.family not in families:
        raise NotImplementedError(f"{cfg.family}: the port generates for "
                                  f"{families}")


def _zero_state(tree) -> None:
    if isinstance(tree, torch.Tensor):
        tree.zero_()
    elif isinstance(tree, dict):
        for v in tree.values():
            _zero_state(v)
    else:
        for v in tree:
            _zero_state(v)


class RecurrentStep:
    """``decode_step`` of a recurrent model with its state ``caches``
    bound: ``step(token (B, 1), pos) -> logits (B, 1, V)``, the state
    updated in place. On the card it is one CUDA graph (runtime/aot.py
    ``GraphStep``) captured once and replayed for every position: the
    token and the position (a 0-dim tensor) are its static inputs, the
    state its static buffers. The capture's warm-up runs one step into
    the state, so the state is zeroed after it. On the CPU it is the eager
    step."""

    def __init__(self, params, caches, cfg: ModelConfig, batch: int,
                 device: torch.device):
        def step(token, pos):
            return M.decode_step(params, token, caches, pos, cfg)[0]

        self.step = step
        if device.type == "cuda":
            args = (torch.zeros((batch, 1), dtype=torch.long, device=device),
                    torch.zeros((), dtype=torch.long, device=device))
            self.step = AOT.GraphStep(step, args, device)
            _zero_state(caches)

    def __call__(self, token: torch.Tensor, pos) -> torch.Tensor:
        return self.step(token, A.position(pos, token.device))


def prefill_recurrent(params, prompt: torch.Tensor, caches,
                      cfg: ModelConfig, step: Optional[RecurrentStep] = None):
    """A recurrent model's prompt pass: ``decode_step`` at positions 0 ..
    S0 - 1, each prompt token into the state (``caches``, updated in
    place), eagerly or through ``step`` (a ``RecurrentStep`` bound to
    ``caches``). -> (the last position's logits (B, 1, V), caches)."""
    logits = None
    for t in range(prompt.shape[1]):
        tok = prompt[:, t:t + 1]
        if step is None:
            logits, caches = M.decode_step(params, tok, caches, t, cfg)
        else:
            logits = step(tok, t)
    return logits, caches


def generate(params, prompt, cfg: ModelConfig, *, max_new_tokens: int,
             temperature: float = 0.0, key=None,
             device="cuda") -> GenerationResult:
    """Open (non-private) generation: the prompt pass (``prefill``, or for
    a recurrent model ``prefill_recurrent`` through a ``RecurrentStep``,
    which also takes the new tokens), then one decode step per new token,
    all in the clear on ``device``."""
    _family_in(cfg, FAMILIES)
    dev = OG.resolve_device(device)
    key = key if key is not None else prng.PRNGKey(0)
    params = OG.params_to_device(params, dev)
    tokens = OG.tokens_on(prompt, dev)
    B, S0 = tokens.shape
    total = S0 + max_new_tokens
    step = None
    with torch.no_grad():
        if cfg.family in RECURRENT:
            caches = M.init_caches(cfg, B, total, device=dev)
            step = RecurrentStep(params, caches, cfg, B, dev)
            logits, caches = prefill_recurrent(params, tokens, caches, cfg,
                                               step)
        else:
            logits, caches = M.prefill(params, {"tokens": tokens}, cfg,
                                       max_seq=total)
        key, k = prng.split(key)
        nxt = _sample(logits[:, -1], k, temperature, cfg.vocab_size)
        tokens = torch.cat([tokens, nxt[:, None]], dim=1)
        for t in range(S0, total - 1):
            if step is not None:
                logits = step(tokens[:, -1:], t)
            else:
                logits, caches = M.decode_step(params, tokens[:, -1:],
                                               caches, t, cfg)
            key, k = prng.split(key)
            nxt = _sample(logits[:, 0], k, temperature, cfg.vocab_size)
            tokens = torch.cat([tokens, nxt[:, None]], dim=1)
    return GenerationResult(tokens=tokens, telemetry=None)


def generate_origami(params, prompt, cfg: ModelConfig, *,
                     max_new_tokens: int, partition: Optional[int] = None,
                     temperature: float = 0.0, session_key=None, key=None,
                     device="cuda") -> GenerationResult:
    """Two-tier private generation, step by step: every position of the
    prompt and of the stream runs one decode step, blocks [0, p) under
    the blinded-dense context and [p, L) open, the per-step form of the
    paper's Fig. 3a flow. One SlalomContext at ``step`` 0 numbers the
    tier-1 ops in call order over the whole stream, so each runtime op
    draws its own pad (the reference's scanned step shares one pad among
    a step's layers, ROADMAP Queue 3); no policy verifies them, as in the
    reference. ``telemetry`` counts every op. The dense and MoE families
    only, as the reference asserts."""
    assert cfg.family in ORIGAMI_FAMILIES, cfg.family
    dev = OG.resolve_device(device)
    p = partition if partition is not None else cfg.origami.tier1_layers
    key = key if key is not None else prng.PRNGKey(0)
    session_key = (session_key if session_key is not None
                   else prng.PRNGKey(7))
    params = OG.params_to_device(params, dev)
    tokens = OG.tokens_on(prompt, dev)
    ctx = SL.SlalomContext(session_key, BlindingSpec())
    B, S0 = tokens.shape
    total = S0 + max_new_tokens
    caches = M.init_caches(cfg, B, total, device=dev)
    with torch.no_grad():
        for t in range(total - 1):
            feed = tokens[:, t:t + 1] if t < S0 else tokens[:, -1:]
            key, k = prng.split(key)
            logits, caches = tiered_decode_step(params, feed, caches, t, cfg,
                                                ctx, p)
            nxt = _sample(logits[:, 0], k, temperature, cfg.vocab_size)
            if t >= S0 - 1:
                tokens = torch.cat([tokens, nxt[:, None]], dim=1)
    return GenerationResult(tokens=tokens, telemetry=ctx.telemetry)


def tiered_decode_step(params, token: torch.Tensor, caches, pos,
                       cfg: ModelConfig, ctx: SL.SlalomContext,
                       partition: int):
    """One step of ``generate_origami``: the embedding in the enclave,
    blocks [0, partition) blinded op by op under ``ctx``, the rest and the
    head open. -> (logits (B, 1, V), caches)."""
    x = M.embed_tokens_at(params, token, pos, cfg)
    with L.dense_impl(functools.partial(SL.blinded_dense, ctx)):
        x, caches = M.decode_range_unrolled(params, x, caches, pos, cfg, 0,
                                            partition)
    x, caches = M.decode_range(params, x, caches, pos, cfg, partition,
                               cfg.num_layers)
    return M.head(params, x, cfg), caches


@dataclass
class PrivateGenerationResult:
    """Outcome of one ``private_generate`` stream.

    ``logits``: (B, max_new_tokens, vocab), the logits each sampled token
    was drawn from: the surface the ``trusted=True`` oracle is held to
    bit for bit. ``telemetry`` is the last step's (prefill's when no
    decode step ran); ``integrity`` concatenates the per-op outcomes of
    the prefill and of every decode step, in call order."""
    tokens: torch.Tensor                 # (B, prompt + new)
    logits: torch.Tensor                 # (B, new, vocab)
    telemetry: Optional[SL.Telemetry]
    integrity: IG.IntegrityReport
    ring: Optional[Dict[str, int]]       # TokenSlotRing.stats(); None when
    trusted: bool                        # nothing was blinded or trusted
    plan_digest: str                     # DecodePlan digest (attestation)
    decode_steps: int


def _concat_reports(reps) -> IG.IntegrityReport:
    def cat(xs):
        return torch.cat(xs) if xs else torch.zeros((0,), dtype=torch.bool)
    return IG.IntegrityReport(
        checked=cat([r.checked for r in reps if r.n_ops]),
        failed=cat([r.failed for r in reps if r.n_ops]),
        corrupted=cat([r.corrupted for r in reps if r.n_ops]))


def private_generate(params, prompt, cfg: ModelConfig, *,
                     max_new_tokens: int, partition: Optional[int] = None,
                     integrity: Optional[IG.IntegrityPolicy] = None,
                     temperature: float = 0.0, session_key=None, key=None,
                     trusted: bool = False, ring_depth: int = 8,
                     executor: Optional[OG.OrigamiExecutor] = None,
                     jit: bool = True, device="cuda"
                     ) -> PrivateGenerationResult:
    """Private autoregressive generation under a DecodePlan.

    ``prompt``: (B, S0) token ids. ``session_key``: the blinding session
    (a (2,) uint32 key; PRNGKey(7) when omitted); ``key``: the sampling
    key (PRNGKey(0)). ``executor``: a prepared OrigamiExecutor (its
    decode plan is attached on first use); otherwise one is built on
    ``device`` from ``partition`` and ``integrity``. ``trusted=True``
    runs the enclave oracle: no device, no blinding, no ring. ``jit``:
    with a CompileCache attached to the executor, the steps that can
    replay an executable do (``OrigamiExecutor._graphable``)."""
    key = key if key is not None else prng.PRNGKey(0)
    session_key = (session_key if session_key is not None
                   else prng.PRNGKey(7))
    if executor is None:
        executor = OG.OrigamiExecutor(cfg, params, "origami", partition,
                                      integrity=integrity, device=device)
    if executor.dplan is None:
        executor.attach_decode_plan(max_steps=max_new_tokens)
    prompt = OG.tokens_on(prompt, executor.device)
    B, S0 = prompt.shape
    total = S0 + max_new_tokens
    ring = None
    if not trusted:
        cache = executor.decode_cache(B)
        if cache is not None:
            # decode positions start at S0 >= 1 and prompt ops use step 0:
            # the ring's slots never meet the prompt's
            ring = TokenSlotRing(cache, session_key, lo=S0, depth=ring_depth)
    try:
        logits, caches, rep = executor.prefill_session(
            prompt, session_key, max_seq=total, trusted=trusted, jit=jit)
        reps = [rep]
        key, k = prng.split(key)
        nxt = _sample(logits[:, -1], k, temperature, cfg.vocab_size)
        tokens = torch.cat([prompt, nxt[:, None]], dim=1)
        step_logits = [logits[:, -1]]
        for t in range(S0, total - 1):
            factors = ring.take(t) if ring is not None else None
            logits, caches, rep = executor.decode_once(
                tokens[:, -1:], caches, t, session_key, factors,
                trusted=trusted, jit=jit)
            reps.append(rep)
            key, k = prng.split(key)
            nxt = _sample(logits[:, 0], k, temperature, cfg.vocab_size)
            tokens = torch.cat([tokens, nxt[:, None]], dim=1)
            step_logits.append(logits[:, 0])
    finally:
        if ring is not None:
            ring.close()
    return PrivateGenerationResult(
        tokens=tokens, logits=torch.stack(step_logits, dim=1),
        telemetry=executor.telemetry, integrity=_concat_reports(reps),
        ring=ring.stats() if ring is not None else None, trusted=trusted,
        plan_digest=executor.dplan.digest,
        decode_steps=max(0, max_new_tokens - 1))


class GenerateExecutor(OG.OrigamiExecutor):
    """Engine adapter: private token streams through the sealed batcher
    (runtime/engine.py).

    A request's payload is the prompt, ``prompt_len`` token ids riding the
    float32 sealing channel; the response is the whole generated sequence
    as float32 (exact for every vocab below 2^24). ``infer`` runs the
    prompt pass and the token loop for the batch with a fixed sampling key
    (``PRNGKey(0)``), so the trusted recompute of the recovery ladder
    replays the stream bit for bit. The attested digest is the decode
    plan's (it covers the scan structure, not only the base plan).
    ``request_shape`` and ``response_elems`` tell the engine's warm-up
    the shapes, and ``warm_aot`` captures each bucket's prompt pass and
    token steps (``warm_decode_aot``) and builds its token-slot cache."""

    def __init__(self, cfg: ModelConfig, params, *, prompt_len: int,
                 max_new_tokens: int, mode: str = "origami",
                 partition: Optional[int] = None,
                 integrity: Optional[IG.IntegrityPolicy] = None,
                 ring_depth: int = 8, temperature: float = 0.0, **kw):
        super().__init__(cfg, params, mode, partition, integrity=integrity,
                         **kw)
        self.prompt_len = int(prompt_len)
        self.max_new_tokens = int(max_new_tokens)
        self.ring_depth = int(ring_depth)
        self.temperature = float(temperature)
        self.attach_decode_plan(max_steps=self.max_new_tokens)
        self.request_shape: Tuple[int, ...] = (self.prompt_len,)
        self.response_elems: int = self.prompt_len + self.max_new_tokens

    @property
    def attested_digest(self) -> str:
        return self.dplan.digest

    def infer(self, batch, session_key=None, trusted: bool = False,
              jit: bool = True) -> OG.OrigamiResult:
        (prompt,) = batch.values()
        prompt = OG.tokens_on(prompt, self.device)
        assert prompt.shape[1] == self.prompt_len, prompt.shape
        key = session_key if session_key is not None else prng.PRNGKey(0)
        res = private_generate(
            self.params, prompt, self.cfg,
            max_new_tokens=self.max_new_tokens,
            temperature=self.temperature, session_key=key,
            key=prng.PRNGKey(0), trusted=trusted,
            ring_depth=self.ring_depth, executor=self, jit=jit)
        self._tele_last = (self._tele_trusted if trusted
                           else self._tele_blinded)
        return OG.OrigamiResult(
            logits=res.tokens.to(torch.float32), boundary=None,
            telemetry=self.telemetry, integrity=res.integrity,
            trusted=trusted, sharding=None)

    def warm_aot(self, input_key: str, request_shape, buckets,
                 dtype=None, trusted_too: bool = True) -> int:
        return sum(self.warm_decode_aot(
            int(b), self.prompt_len, self.prompt_len + self.max_new_tokens,
            trusted_too=trusted_too) for b in buckets)


def tier1_cache_bytes(cfg: ModelConfig, batch: int, max_seq: int,
                      partition: Optional[int] = None) -> int:
    """KV-cache bytes that must stay in the trusted domain (layers < p)."""
    p = partition if partition is not None else cfg.origami.tier1_layers
    hd = cfg.resolved_head_dim
    if cfg.attention == "mla":
        width = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        return p * batch * max_seq * width * 2
    return p * batch * max_seq * cfg.num_kv_heads * hd * 2 * 2
