"""Attention of the LMs: GQA with RoPE, Multi-head Latent Attention (MLA)
and cross-attention (Whisper's decoder, Llama-3.2-Vision's image blocks),
prefill and decode paths.

Port of ``repro/models/attention.py``, sliding windows, query offsets and
``cost_mode`` included.
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
output to q's. A causal ``sdpa`` takes the reference's sliding window and
query offset: query i stands at position i + ``q_offset`` and sees the keys
at positions <= its own and, with ``window`` > 0, only the last ``window``
of them; the three forward kernels (bf16, float32 and the decode route)
take both and skip the key tiles outside the rows' bands. The port follows
the reference's naive core there: its flash core drops ``q_offset``
(ROADMAP Queue 3), so at flashable shapes the reference's ``sdpa`` returns
the unoffset result. A call in which a row would see no key (an offset
``window`` or more past the last key) is refused where the reference's
naive core returns NaN. ``cost_mode=True`` runs the plain version (the
materialized float32 scores), as the reference runs its naive core for its
cost probes. A config with ``attention="windowed"`` runs the GQA layers
with ``window = cfg.window_size`` in the prompt-side ``sdpa`` and the
decode step's ``decode_sdpa``, as the reference's do.
When grad is enabled and an input requires it (training), ``sdpa`` goes
through ``FlashAttention``, a ``torch.autograd.Function``: its forward is
the same kernel, which also saves each row's log-sum-exp, and its
backward is ``flash_attention_bwd`` (the kernel on the card, its plain
version on the CPU), the port of the reference's custom VJP; both take
the window and the query offset, so a windowed config trains. Every
inference path calls the forward kernel alone, as before.
On a device mesh (q, k and v DTensors, launch/train.py's ``mesh=``)
``sdpa`` lays them out as the reference's context-parallel flash does
(``act_sharding.constrain``): the query's sequence over the rules'
"flash_seq" axes beside the batch axes, k and v over the batch axes and
replicated over the rest. ``_flash`` runs through ``local_map`` on each
rank's local q, k and v, so the kernels never see a DTensor, with the
rank's own ``q_offset``: the global position of its first query row
(``act_sharding.shard_start``) plus the caller's. Each rank's dk and dv
are its rows' share of the sum, reduced over the "flash_seq" axes, and
the output is laid out by batch again for the output projection. Where
those axes do not divide the query's length, the query stays whole on
them (``constrain``'s rule for any dim): every rank of them computes the
whole attention of its batch rows, at the caller's offset.
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
    flash_attention_bwd, flash_attention_fwd, flash_attention_plain)
from repro_torch.models import layers as L
from repro_torch.parallel import act_sharding as ash
from repro_torch.parallel.hlo_analysis import flash_region

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
    probabilities from them (reference: ``_make_flash``'s fwd and bwd),
    at the forward's window and query offset."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window=0, q_offset=0):
        out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                       return_lse=True, q_offset=q_offset,
                                       window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.q_offset = causal, window, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=ctx.causal,
                                         q_offset=ctx.q_offset,
                                         window=ctx.window)
        return dq, dk, dv, None, None, None


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, window: int = 0, q_offset: int = 0,
           cost_mode: bool = False) -> torch.Tensor:
    if cost_mode:
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset, window=window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, q_offset)
    return flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset,
                               window=window)


def _local_flash(q, k, v, causal, window=0, q_offset=0, cost_mode=False):
    with flash_region():
        if k.dtype == q.dtype and v.dtype == q.dtype:
            return _flash(q, k, v, causal, window, q_offset, cost_mode)
        # mixed dtypes: the kernel of the promoted dtype, the output in q's
        dt = torch.promote_types(q.dtype,
                                 torch.promote_types(k.dtype, v.dtype))
        return _flash(q.to(dt), k.to(dt), v.to(dt), causal, window,
                      q_offset, cost_mode).to(q.dtype)


def _sharded_flash(q, k, v, causal: bool, window=0, q_offset=0,
                   cost_mode=False):
    """``sdpa`` of DTensors q (B,Sq,H,D), k, v (B,Skv,KH,*) in the
    reference's context-parallel layout: q's batch over the rules' batch
    axes and its sequence over their "flash_seq" axes (kept whole on
    axes that do not divide it), k and v over the batch axes alone.
    ``_flash`` runs on each rank's local rows at their global offset;
    its dk and dv are partial sums over the "flash_seq" axes. The output
    comes back laid out by batch alone."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.parallel.sharding import mesh_axis_sizes, placements_of
    q = ash.constrain(q, "batch", "flash_seq", None, None)
    # each rank's dk and dv are partial sums (below): reduced into k's and
    # v's layout here, where left to the projections' backward they met
    # Whisper's 1500 frames unevenly sharded over "model" (a strided shard
    # that the weight gradient's matmul cannot view)
    k = ash.pin_grad(ash.constrain(k, "batch", None, None, None))
    v = ash.pin_grad(ash.constrain(v, "batch", None, None, None))
    mesh = q.device_mesh
    names, sizes = mesh.mesh_dim_names, mesh_axis_sizes(mesh)
    rules = ash.current_rules() or {}
    qplace = placements_of(L.resolve_spec(
        q.shape, ("batch", "flash_seq", None, None), rules, sizes), names)
    kplace = placements_of(L.resolve_spec(
        k.shape, ("batch", None, None, None), rules, sizes), names)
    # each rank's dk and dv sum over its own query rows alone
    kgrad = tuple(Partial() if qp.is_shard(1) else kp
                  for qp, kp in zip(qplace, kplace))
    start = ash.shard_start(q.shape[1], qplace, mesh, 1)
    out = local_map(_local_flash, out_placements=(qplace,),
                    in_placements=(qplace, kplace, kplace, None, None, None,
                                   None),
                    in_grad_placements=(qplace, kgrad, kgrad, None, None,
                                        None, None),
                    device_mesh=mesh,
                    redistribute_inputs=True)(q, k, v, causal, window,
                                              q_offset + start, cost_mode)
    # the output laid out by batch alone: flattened for the output
    # projection, a sequence shard becomes a strided shard of the tokens,
    # which DTensor's matmul takes under no strategy
    return ash.constrain(out, "batch", None, None, None)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal=True,
         q_offset=0, window=0, cost_mode=False) -> torch.Tensor:
    """q: (B,Sq,H,D); k: (B,Skv,KH,D); v: (B,Skv,KH,Dv) -> (B,Sq,H,Dv) in
    q's dtype, the scores scaled by 1/sqrt(D); k and v may be of another
    dtype than q (computed in the promoted dtype).

    Causal: query i at position i + ``q_offset`` sees keys at positions <=
    its own and, with ``window`` > 0, fewer than ``window`` back (the
    reference's naive core); neither applies without ``causal``. Raises
    ``ValueError`` where a row would see no key (the reference gives NaN
    there; ``check_band``, in the kernel's wrapper and in the plain
    version). ``cost_mode`` runs the plain version."""
    if ash.is_dtensor(q):
        return _sharded_flash(q, k, v, causal, window, q_offset, cost_mode)
    return _local_flash(q, k, v, causal, window, q_offset, cost_mode)


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
    # on a mesh: the probabilities laid out by batch alone (DTensor's
    # einsum miscomputes a local view when the group dim is sharded over
    # the axis that also shards the cache's head width)
    p = ash.constrain(torch.softmax(s, dim=-1), "batch", None, None, None)
    out = torch.einsum("bhgk,bkhd->bhgd", p, cache_v.to(torch.float32))
    # on a mesh: summed over the sequence shards and laid out by batch
    # alone before the heads merge (a view cannot merge split head shards)
    out = ash.constrain(out, "batch", None, None, None)
    return out.reshape(B, 1, H, out.shape[-1]).to(q.dtype)


def gqa_project_qkv(p, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor):
    q = ash.unflatten_last(L.dense(p["wq"], x), (cfg.num_heads, -1))
    k = ash.unflatten_last(L.dense(p["wk"], x), (cfg.num_kv_heads, -1))
    v = ash.unflatten_last(L.dense(p["wv"], x), (cfg.num_kv_heads, -1))
    if cfg.rope_theta > 0:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _window(cfg: ModelConfig) -> int:
    """The layer's sliding window (0: none), as the reference reads it."""
    return cfg.window_size if cfg.attention == "windowed" else 0


def gqa_forward(p, x: torch.Tensor, cfg: ModelConfig, *, positions=None,
                causal=True, cost_mode=False) -> torch.Tensor:
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = gqa_project_qkv(p, x, cfg, positions)
    out = sdpa(q, k, v, causal=causal, window=_window(cfg),
               cost_mode=cost_mode)
    return L.dense(p["wo"], out.reshape(B, S, -1))


def gqa_prefill(p, x: torch.Tensor, cfg: ModelConfig, *, cost_mode=False):
    """Forward + this layer's KV cache content (B, S, KH, D)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = gqa_project_qkv(p, x, cfg, positions)
    out = sdpa(q, k, v, causal=True, window=_window(cfg),
               cost_mode=cost_mode)
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
    ash.write_at(cache.k, at, k.to(cache.k.dtype))
    ash.write_at(cache.v, at, v.to(cache.v.dtype))
    out = decode_sdpa(q, cache.k, cache.v, pos, window=_window(cfg))
    return L.dense(p["wo"], out.reshape(B, 1, -1)), cache


def _mla_qkv(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """-> q_nope (B,S,H,nope), q_rope (B,S,H,rope), the normed latent
    (B,S,rank) and the rope key shared by every head (B,S,rope)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    # on a mesh each latent is normed whole: DTensor's backward of a norm
    # over a sharded dim leaves its gradient sharded over the sequence,
    # which the projection's weight gradient (a matmul over the flattened
    # tokens) cannot take under fake tensors
    q = L.dense(p["wq_b"], L.apply_norm(p["q_norm"], ash.constrain(
        L.dense(p["wq_a"], x), "batch", "seq", None), "rmsnorm"))
    q = q.reshape(B, S, H, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = torch.split(
        q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)
    kv_a = ash.constrain(L.dense(p["wkv_a"], x), "batch", "seq", None)
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


def _mla_attend(p, x: torch.Tensor, cfg: ModelConfig, positions,
                cost_mode=False):
    """(the attention's output projected by ``wo``, latent, rope key)."""
    B, S, _ = x.shape
    q_nope, q_rope, latent, k_rope = _mla_qkv(p, x, cfg, positions)
    k, v = _mla_expand_kv(p, latent, k_rope, cfg)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = sdpa(q, k, v, causal=True, cost_mode=cost_mode)
    return L.dense(p["wo"], out.reshape(B, S, -1)), latent, k_rope


def mla_forward(p, x: torch.Tensor, cfg: ModelConfig, *,
                positions=None, cost_mode=False) -> torch.Tensor:
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    return _mla_attend(p, x, cfg, positions, cost_mode)[0]


def mla_prefill(p, x: torch.Tensor, cfg: ModelConfig, *, cost_mode=False):
    """Forward + this layer's cache content: the latent and the rope key,
    (B, S, kv_lora_rank + qk_rope_head_dim), and no ``v``."""
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    y, latent, k_rope = _mla_attend(p, x, cfg, positions, cost_mode)
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
    # on a mesh: laid out by batch alone before the heads merge (merging
    # head shards leaves a strided shard that later ops cannot take)
    out = ash.constrain(out, "batch", None, None)
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
    ash.write_at(cache.k, pos.reshape(1), new_entry.to(cache.k.dtype))
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
    k = ash.unflatten_last(L.dense(p["wk"], memory), (cfg.num_kv_heads, -1))
    v = ash.unflatten_last(L.dense(p["wv"], memory), (cfg.num_kv_heads, -1))
    return k, v


def cross_attn_forward(p, x: torch.Tensor, memory: torch.Tensor,
                       cfg: ModelConfig, *, cost_mode=False) -> torch.Tensor:
    """x: (B,S,d) queries; memory: (B,M,d) encoder or vision states,
    attended without a mask."""
    B, S, _ = x.shape
    q = ash.unflatten_last(L.dense(p["wq"], x), (cfg.num_heads, -1))
    k, v = cross_kv(p, memory, cfg)
    out = sdpa(q, k, v, causal=False, cost_mode=cost_mode)
    return L.dense(p["wo"], out.reshape(B, S, -1))


def cross_attn_cached(p, x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """Cross-attention against precomputed K/V (B, M, KH, D): a decode
    step's query (S = 1) through ``sdpa``, as in the reference."""
    B, S, _ = x.shape
    q = ash.unflatten_last(L.dense(p["wq"], x), (cfg.num_heads, -1))
    out = sdpa(q, ck, cv, causal=False)
    return L.dense(p["wo"], out.reshape(B, S, -1))
