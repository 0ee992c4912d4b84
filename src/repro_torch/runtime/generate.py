"""Autoregressive generation: the open float path and private decode under
the Origami two-tier protocol.

Port of ``repro/runtime/generate.py`` for the dense family.
``private_generate`` prefills the prompt through the base plan's segments
(tier-1 blinded op by op and Freivalds-checked, tier-2 open), then walks
each token through the decode plan's scan segments, its tier-1 pads and
fold vectors streamed by a TokenSlotRing. ``trusted=True`` is the
recovery oracle: the same quantized arithmetic entirely in the enclave,
bit-identical logits and tokens. The tier-1 KV cache rows (layers < p)
belong to the trusted domain; ``tier1_cache_bytes`` prices them.

Only greedy sampling (``temperature == 0``) is ported: the reference draws
with ``jax.random.categorical``, which has no bit-equal counterpart in
core/prng.py yet (ROADMAP Queue 1 item 11). ``generate_origami`` and the
engine adapter ``GenerateExecutor`` wait for the same item.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import integrity as IG
from repro_torch.core import origami as OG
from repro_torch.core import prng
from repro_torch.core import slalom as SL
from repro_torch.models import model as M
from repro_torch.runtime.sessions import TokenSlotRing


@dataclass
class GenerationResult:
    tokens: torch.Tensor            # (B, prompt + new)
    telemetry: Optional[SL.Telemetry]


def _greedy_only(temperature: float) -> None:
    if temperature > 0:
        raise NotImplementedError(
            "sampling at temperature > 0 needs a bit-equal port of "
            "jax.random.categorical (ROADMAP Queue 1 item 11)")


def _sample(logits: torch.Tensor, key, temperature: float,
            vocab_size: int) -> torch.Tensor:
    """Greedy: the first index of the largest logit among the real vocab
    entries (torch.argmax and jnp.argmax both take the first)."""
    _greedy_only(temperature)
    return torch.argmax(logits[..., :vocab_size].to(torch.float32), dim=-1)


def generate(params, prompt, cfg: ModelConfig, *, max_new_tokens: int,
             temperature: float = 0.0, key=None,
             device="cuda") -> GenerationResult:
    """Open (non-private) generation: prefill, then one decode step per
    new token, all in the clear on ``device``."""
    _greedy_only(temperature)
    dev = OG.resolve_device(device)
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.family}: the port generates for "
                                  f"the dense family (ROADMAP Queue 1 "
                                  f"items 11-12)")
    params = OG.params_to_device(params, dev)
    tokens = OG.tokens_on(prompt, dev)
    S0 = tokens.shape[1]
    total = S0 + max_new_tokens
    with torch.no_grad():
        logits, caches = M.prefill(params, {"tokens": tokens}, cfg,
                                   max_seq=total)
        nxt = _sample(logits[:, -1], key, temperature, cfg.vocab_size)
        tokens = torch.cat([tokens, nxt[:, None]], dim=1)
        for t in range(S0, total - 1):
            logits, caches = M.decode_step(params, tokens[:, -1:], caches, t,
                                           cfg)
            nxt = _sample(logits[:, 0], key, temperature, cfg.vocab_size)
            tokens = torch.cat([tokens, nxt[:, None]], dim=1)
    return GenerationResult(tokens=tokens, telemetry=None)


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
                     device="cuda") -> PrivateGenerationResult:
    """Private autoregressive generation under a DecodePlan.

    ``prompt``: (B, S0) token ids. ``session_key``: the blinding session
    (a (2,) uint32 key; PRNGKey(7) when omitted). ``executor``: a prepared
    OrigamiExecutor (its decode plan is attached on first use); otherwise
    one is built on ``device`` from ``partition`` and ``integrity``.
    ``trusted=True`` runs the enclave oracle: no device, no blinding, no
    ring."""
    _greedy_only(temperature)
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
            prompt, session_key, max_seq=total, trusted=trusted)
        reps = [rep]
        nxt = _sample(logits[:, -1], key, temperature, cfg.vocab_size)
        tokens = torch.cat([prompt, nxt[:, None]], dim=1)
        step_logits = [logits[:, -1]]
        for t in range(S0, total - 1):
            factors = ring.take(t) if ring is not None else None
            logits, caches, rep = executor.decode_once(
                tokens[:, -1:], caches, t, session_key, factors,
                trusted=trusted)
            reps.append(rep)
            nxt = _sample(logits[:, 0], key, temperature, cfg.vocab_size)
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


def tier1_cache_bytes(cfg: ModelConfig, batch: int, max_seq: int,
                      partition: Optional[int] = None) -> int:
    """KV-cache bytes that must stay in the trusted domain (layers < p)."""
    p = partition if partition is not None else cfg.origami.tier1_layers
    hd = cfg.resolved_head_dim
    if cfg.attention == "mla":
        width = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        return p * batch * max_seq * width * 2
    return p * batch * max_seq * cfg.num_kv_heads * hd * 2 * 2
