"""Attention of the LMs: GQA with RoPE, Multi-head Latent Attention (MLA)
and cross-attention (Whisper's decoder, Llama-3.2-Vision's image blocks),
prefill and decode paths.

Port of ``repro/models/attention.py`` but its windowed attention.
Projections work on the flat ``(..., n_heads * head_dim)`` layout and go
through ``layers.dense``, so the Origami executor's hook routes them into
the Slalom protocol in tier-1. Layouts are the reference's: q (B, S, H, D),
k and v (B, S, KH, D), a GQA layer's ``KVCache`` (B, max_seq, KH, D); an
MLA layer's cache is the latent and the shared rope key, (B, max_seq,
kv_lora_rank + qk_rope_head_dim), with no ``v``.

``sdpa`` is the prompt-side attention. The reference serves it with a
plain or a chunked online-softmax core in jnp; both compute the function
of the flash-attention kernel, so here every call goes to
``flash_attention_fwd``: on a CUDA tensor the hand-written kernel (head
widths 32 and 64 of SmolLM and Whisper, 128 of Yi, Qwen2.5, Qwen3-MoE,
Arctic and Llama-3.2-Vision, and MLA's q/k 96 against v 64, 48 against 32
at the smoke widths), on a CPU tensor its plain version. The reference
pads an irregular key length to a tile multiple and masks the padded keys
(vision's 1601 patches); the kernel masks a ragged length itself, so such
calls go to it unpadded. Like the reference's, ``sdpa`` takes keys and
values of another dtype than the queries (Llama-3.2-Vision's float32
patches projected into float32 k and v against bf16 queries): it promotes
the three to one dtype, runs the kernel of that dtype and casts the
output to q's. Sliding windows and query offsets are not ported.
When grad is enabled and an input requires it (training), ``sdpa`` goes
through ``FlashAttention``, a ``torch.autograd.Function``: its forward is
the same kernel, which also saves each row's log-sum-exp, and its
backward is ``flash_attention_bwd`` (the kernel on the card, its plain
version on the CPU), the port of the reference's custom VJP. Every
inference path calls the forward kernel alone, as before.
On a device mesh (q, k and v DTensors, launch/train.py's ``mesh=``)
``sdpa`` pins them at the reference's points (``act_sharding.constrain``)
and runs ``_flash`` through ``local_map``: batch over the active rules'
batch axes and the KV heads over "model" when it divides them (replicated
there otherwise), so the kernel and ``FlashAttention``'s backward kernel
run on each rank's local q, k and v and never see a DTensor. The query
is pinned to the batch axes only: the reference's context-parallel
layout ("flash_seq", the query sequence over "model") needs a query
offset that the kernel does not take, and pinning it there only to
gather it back left the backward's gradients sequence-sharded, which
DTensor's matmul propagation rejects under fake tensors.
``decode_sdpa`` (one query against the cache) has no kernel in the
reference and stays plain PyTorch, as do MLA's absorbed decode einsums,
which read ``wkv_b``'s weight directly (not through ``layers.dense``): in
tier-1 they run in float32 in the enclave, as in the reference.

Cross-attention projects its keys and values from a memory (Whisper's
encoder output, Llama-3.2-Vision's patches) and attends without a causal
mask; a decode step attends to the memory's K/V, precomputed once
(``cross_kv``), through ``sdpa`` at one query, as the reference does.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_bwd, flash_attention_fwd)
from repro_torch.models import layers as L
from repro_torch.parallel import act_sharding as ash
from repro_torch.parallel.hlo_analysis import flash_region

_ROADMAP = "ROADMAP Queue 1"


class KVCache(NamedTuple):
    """A layer's cache: k and v (B, max_seq, KH, D), or for MLA k the
    latent and rope key (B, max_seq, latent + rope) and v None; a stacked
    cache leads with a layer dim."""
    k: torch.Tensor
    v: Optional[torch.Tensor]


def gqa_defs(cfg: ModelConfig) -> Dict[str, object]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": L.dense_def(d, cfg.num_heads * hd, ("embed", "heads_flat"),
                          bias=cfg.qkv_bias),
        "wk": L.dense_def(d, cfg.num_kv_heads * hd, ("embed", "kv_flat"),
                          bias=cfg.qkv_bias),
        "wv": L.dense_def(d, cfg.num_kv_heads * hd, ("embed", "kv_flat"),
                          bias=cfg.qkv_bias),
        "wo": L.dense_def(cfg.num_heads * hd, d, ("heads_flat", "embed")),
    }


def mla_defs(cfg: ModelConfig) -> Dict[str, object]:
    m, d, h = cfg.mla, cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": L.dense_def(d, m.q_lora_rank, ("embed", "lora")),
        "q_norm": L.norm_def(m.q_lora_rank, "rmsnorm"),
        "wq_b": L.dense_def(m.q_lora_rank, h * qk, ("lora", "heads_flat")),
        "wkv_a": L.dense_def(d, m.kv_lora_rank + m.qk_rope_head_dim,
                             ("embed", "lora")),
        "kv_norm": L.norm_def(m.kv_lora_rank, "rmsnorm"),
        "wkv_b": L.dense_def(m.kv_lora_rank,
                             h * (m.qk_nope_head_dim + m.v_head_dim),
                             ("lora", "heads_flat")),
        "wo": L.dense_def(h * m.v_head_dim, d, ("heads_flat", "embed")),
    }


class FlashAttention(torch.autograd.Function):
    """Flash attention with the flash backward: the forward kernel keeps
    q, k, v, its output and lse; the backward recomputes the
    probabilities from them (reference: ``_make_flash``'s fwd and bwd)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=ctx.causal)
        return dq, dk, dv, None


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> torch.Tensor:
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal)
    return flash_attention_fwd(q, k, v, causal=causal)


def _local_flash(q, k, v, causal):
    with flash_region():
        if k.dtype == q.dtype and v.dtype == q.dtype:
            return _flash(q, k, v, causal)
        # mixed dtypes: the kernel of the promoted dtype, the output in q's
        dt = torch.promote_types(q.dtype,
                                 torch.promote_types(k.dtype, v.dtype))
        return _flash(q.to(dt), k.to(dt), v.to(dt), causal).to(q.dtype)


def _sharded_flash(q, k, v, causal: bool):
    """``sdpa`` of DTensors q (B,Sq,H,D), k, v (B,Skv,KH,*): each rank's
    batch rows (the rules' batch axes) and, when "model" divides KH, its
    KV heads with their query heads, through ``_flash`` on local tensors."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    q = ash.constrain(q, "batch", None, None, None)
    k = ash.constrain(k, "batch", None, None, None)
    v = ash.constrain(v, "batch", None, None, None)
    mesh = q.device_mesh
    rules = ash.current_rules() or {}
    batch = L._mesh_axes(rules.get("batch"))
    names = mesh.mesh_dim_names
    heads = ("model" in names
             and k.shape[2] % mesh.shape[names.index("model")] == 0)
    place = tuple(Shard(0) if n in batch else
                  Shard(2) if n == "model" and heads else Replicate()
                  for n in names)
    return local_map(_local_flash, out_placements=(place,),
                     in_placements=(place, place, place, None),
                     device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v, causal)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal=True,
         q_offset=0, window=0) -> torch.Tensor:
    """q: (B,Sq,H,D); k: (B,Skv,KH,D); v: (B,Skv,KH,Dv) -> (B,Sq,H,Dv) in
    q's dtype, the scores scaled by 1/sqrt(D); k and v may be of another
    dtype than q (computed in the promoted dtype).

    A sliding window or a query offset has no kernel and no caller in the
    port and raises."""
    if window or q_offset:
        raise NotImplementedError(
            f"sdpa with window={window}, q_offset={q_offset} is not ported "
            f"({_ROADMAP})")
    if ash.is_dtensor(q):
        return _sharded_flash(q, k, v, causal)
    return _local_flash(q, k, v, causal)


def position(pos, device) -> torch.Tensor:
    """A decode step's position as a 0-dim long tensor on ``device``: a
    Python int is filled in there (a fill kernel, no host-to-device copy),
    a tensor is taken as it is. A step that reads its position from a
    tensor serves every position from one CUDA graph."""
    if isinstance(pos, torch.Tensor):
        return pos
    return torch.full((), int(pos), dtype=torch.long, device=device)


def decode_sdpa(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                pos, *, window=0) -> torch.Tensor:
    """One-step decode. q: (B,1,H,D); cache_k: (B,S,KH,D); cache_v:
    (B,S,KH,Dv) -> (B,1,H,Dv); keys at positions <= ``pos`` (an int or a
    0-dim tensor; and inside the window) are seen."""
    B, _, H, D = q.shape
    S, KH = cache_k.shape[1], cache_k.shape[2]
    # on a mesh the cache's sequence takes "model": the query's heads are
    # gathered there before they split into KV heads and groups
    q = ash.constrain(q, "batch", None, None, None)
    qr = q.reshape(B, KH, H // KH, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qr.to(torch.float32),
                     cache_k.to(torch.float32)) / math.sqrt(D)
    kpos = torch.arange(S, device=q.device)
    mask = kpos <= pos
    if window > 0:
        mask &= (pos - kpos) < window
    s = s.masked_fill(~mask[None, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, cache_v.to(torch.float32))
    # on a mesh: summed over the sequence shards and laid out by batch
    # alone before the heads merge (a view cannot merge split head shards)
    out = ash.constrain(out, "batch", None, None, None)
    return out.reshape(B, 1, H, out.shape[-1]).to(q.dtype)


def _split_heads(t: torch.Tensor, B: int, S: int, H: int) -> torch.Tensor:
    """(B, S, H * D) -> (B, S, H, D). A DTensor whose flat dim is sharded
    over mesh dims that do not divide H (SmolLM's 3 KV heads over 2 ranks)
    is first replicated over them: a view cannot split a shard."""
    if ash.is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard
        last = t.dim() - 1
        mesh = t.device_mesh
        over = [i for i, pl in enumerate(t.placements) if pl == Shard(last)]
        n = 1
        for i in over:
            n *= mesh.shape[i]
        if H % n:
            t = t.redistribute(mesh, [Replicate() if i in over else pl
                                      for i, pl in enumerate(t.placements)])
    return t.reshape(B, S, H, -1)


def gqa_project_qkv(p, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor):
    B, S, _ = x.shape
    q = _split_heads(L.dense(p["wq"], x), B, S, cfg.num_heads)
    k = _split_heads(L.dense(p["wk"], x), B, S, cfg.num_kv_heads)
    v = _split_heads(L.dense(p["wv"], x), B, S, cfg.num_kv_heads)
    if cfg.rope_theta > 0:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_forward(p, x: torch.Tensor, cfg: ModelConfig, *, positions=None,
                causal=True) -> torch.Tensor:
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = gqa_project_qkv(p, x, cfg, positions)
    out = sdpa(q, k, v, causal=causal)
    return L.dense(p["wo"], out.reshape(B, S, -1))


def gqa_prefill(p, x: torch.Tensor, cfg: ModelConfig):
    """Forward + this layer's KV cache content (B, S, KH, D)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = gqa_project_qkv(p, x, cfg, positions)
    out = sdpa(q, k, v, causal=True)
    return L.dense(p["wo"], out.reshape(B, S, -1)), KVCache(k, v)


def gqa_decode(p, x: torch.Tensor, cache: KVCache, pos, cfg: ModelConfig):
    """x: (B,1,d); ``pos``: an int or a 0-dim long tensor (``position``).
    Writes this token's k and v into ``cache`` at ``pos`` in place (the
    reference updates a copy; the port saves the copy of every layer's
    cache at every token) and returns the same cache. The position is
    read from a tensor everywhere (RoPE, the cache write, the mask), so
    the eager step and a CUDA graph of it run the same code."""
    B = x.shape[0]
    pos = position(pos, x.device)
    q, k, v = gqa_project_qkv(p, x, cfg, pos.reshape(1, 1).expand(B, 1))
    at = pos.reshape(1)
    cache.k.index_copy_(1, at, k.to(cache.k.dtype))
    cache.v.index_copy_(1, at, v.to(cache.v.dtype))
    out = decode_sdpa(q, cache.k, cache.v, pos)
    return L.dense(p["wo"], out.reshape(B, 1, -1)), cache


def _mla_qkv(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """-> q_nope (B,S,H,nope), q_rope (B,S,H,rope), the normed latent
    (B,S,rank) and the rope key shared by every head (B,S,rope)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    q = L.dense(p["wq_b"], L.apply_norm(p["q_norm"], L.dense(p["wq_a"], x),
                                        "rmsnorm"))
    q = q.reshape(B, S, H, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = torch.split(
        q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)
    kv_a = L.dense(p["wkv_a"], x)
    latent, k_rope = torch.split(
        kv_a, [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    latent = L.apply_norm(p["kv_norm"], latent, "rmsnorm")
    k_rope = L.apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return q_nope, q_rope, latent, k_rope[:, :, 0, :]


def _mla_expand_kv(p, latent: torch.Tensor, k_rope: torch.Tensor,
                   cfg: ModelConfig):
    """The latent through ``wkv_b`` -> k (B,S,H,nope+rope), the rope key
    broadcast to every head, and v (B,S,H,v): a view of the projection."""
    m = cfg.mla
    B, S = latent.shape[:2]
    H = cfg.num_heads
    kv = L.dense(p["wkv_b"], latent).reshape(
        B, S, H, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = torch.split(kv, [m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k_rope_b = k_rope[:, :, None, :].expand(B, S, H, m.qk_rope_head_dim)
    return torch.cat([k_nope, k_rope_b], dim=-1), v


def _mla_attend(p, x: torch.Tensor, cfg: ModelConfig, positions):
    """(the attention's output projected by ``wo``, latent, rope key)."""
    B, S, _ = x.shape
    q_nope, q_rope, latent, k_rope = _mla_qkv(p, x, cfg, positions)
    k, v = _mla_expand_kv(p, latent, k_rope, cfg)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = sdpa(q, k, v, causal=True)
    return L.dense(p["wo"], out.reshape(B, S, -1)), latent, k_rope


def mla_forward(p, x: torch.Tensor, cfg: ModelConfig, *,
                positions=None) -> torch.Tensor:
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    return _mla_attend(p, x, cfg, positions)[0]


def mla_prefill(p, x: torch.Tensor, cfg: ModelConfig):
    """Forward + this layer's cache content: the latent and the rope key,
    (B, S, kv_lora_rank + qk_rope_head_dim), and no ``v``."""
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    y, latent, k_rope = _mla_attend(p, x, cfg, positions)
    return y, KVCache(torch.cat([latent, k_rope], dim=-1), None)


def mla_absorbed_attend(q_nope: torch.Tensor, q_rope: torch.Tensor,
                        latents: torch.Tensor, k_ropes: torch.Tensor,
                        w_kv_b: torch.Tensor, pos: torch.Tensor,
                        cfg: ModelConfig) -> torch.Tensor:
    """One token's attention in latent space, all in float32: ``w_kv_b``
    (rank, H * (nope + v)) folds q_nope into latent-space queries and the
    latent context into each head's values. q: (B,1,H,*); latents
    (B,S,rank) and k_ropes (B,S,rope), keys at positions <= ``pos`` seen
    -> (B, 1, H * v) float32."""
    m = cfg.mla
    B, H = q_nope.shape[0], cfg.num_heads
    S = latents.shape[1]
    mask = (torch.arange(S, device=latents.device) <= pos)[None, None, :]
    wkv_b = w_kv_b.reshape(m.kv_lora_rank, H,
                           m.qk_nope_head_dim + m.v_head_dim)
    w_uk, w_uv = torch.split(wkv_b, [m.qk_nope_head_dim, m.v_head_dim],
                             dim=-1)
    f32 = torch.float32
    # fold q_nope through w_uk -> latent-space queries (B, H, rank)
    q_lat = torch.einsum("bqhn,rhn->bhr", q_nope.to(f32), w_uk.to(f32))
    s = torch.einsum("bhr,bsr->bhs", q_lat, latents.to(f32))
    s = s + torch.einsum("bqhr,bsr->bhs", q_rope.to(f32), k_ropes.to(f32))
    s = s / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    s = s.masked_fill(~mask, float("-inf"))
    pattn = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", pattn, latents.to(f32))
    out = torch.einsum("bhr,rhv->bhv", ctx, w_uv.to(f32))
    return out.reshape(B, 1, H * m.v_head_dim)


def mla_decode(p, x: torch.Tensor, cache: KVCache, pos, cfg: ModelConfig,
               absorbed: bool = True):
    """Decode against the latent cache; writes this token's latent and
    rope key into ``cache.k`` at ``pos`` in place (as ``gqa_decode``) and
    returns the same cache.

    ``absorbed=True`` (the reference's default) folds ``wkv_b`` into the
    query and the output: scores in latent space, float32 einsums over
    ``wkv_b``'s weight read directly, O(S * rank) a step. ``absorbed=False``
    expands the whole cache through ``wkv_b`` (a ``layers.dense`` call of
    B * S rows) and attends with ``decode_sdpa``."""
    m = cfg.mla
    B = x.shape[0]
    pos = position(pos, x.device)
    q_nope, q_rope, latent_new, k_rope_new = _mla_qkv(
        p, x, cfg, pos.reshape(1, 1).expand(B, 1))
    new_entry = torch.cat([latent_new, k_rope_new], dim=-1)
    cache.k.index_copy_(1, pos.reshape(1), new_entry.to(cache.k.dtype))
    latents, k_ropes = torch.split(
        cache.k, [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    if absorbed:
        y = mla_absorbed_attend(q_nope, q_rope, latents, k_ropes,
                                p["wkv_b"]["w"], pos, cfg).to(x.dtype)
    else:
        k, v = _mla_expand_kv(p, latents, k_ropes, cfg)
        q = torch.cat([q_nope, q_rope], dim=-1)
        y = decode_sdpa(q, k, v, pos).reshape(B, 1, -1)
    return L.dense(p["wo"], y), cache


def cross_attn_defs(cfg: ModelConfig) -> Dict[str, object]:
    return gqa_defs(cfg)


def cross_kv(p, memory: torch.Tensor, cfg: ModelConfig):
    """The cross-attention K/V (B, M, KH, D) of a memory (B, M, d), in the
    memory's dtype."""
    B, M = memory.shape[:2]
    k = _split_heads(L.dense(p["wk"], memory), B, M, cfg.num_kv_heads)
    v = _split_heads(L.dense(p["wv"], memory), B, M, cfg.num_kv_heads)
    return k, v


def cross_attn_forward(p, x: torch.Tensor, memory: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    """x: (B,S,d) queries; memory: (B,M,d) encoder or vision states,
    attended without a mask."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = L.dense(p["wq"], x).reshape(B, S, cfg.num_heads, hd)
    k, v = cross_kv(p, memory, cfg)
    out = sdpa(q, k, v, causal=False)
    return L.dense(p["wo"], out.reshape(B, S, -1))


def cross_attn_cached(p, x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """Cross-attention against precomputed K/V (B, M, KH, D): a decode
    step's query (S = 1) through ``sdpa``, as in the reference."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = L.dense(p["wq"], x).reshape(B, S, cfg.num_heads, hd)
    out = sdpa(q, ck, cv, causal=False)
    return L.dense(p["wo"], out.reshape(B, S, -1))
