"""Attention of the dense and MoE LMs: GQA with RoPE, prefill and decode
paths.

Port of the GQA part of ``repro/models/attention.py``. Projections work on
the flat ``(..., n_heads * head_dim)`` layout and go through
``layers.dense``, so the Origami executor's hook routes them into the
Slalom protocol in tier-1. Layouts are the reference's: q (B, S, H, D),
k and v (B, S, KH, D), a layer's ``KVCache`` (B, max_seq, KH, D).

``sdpa`` is the prompt-side attention. The reference serves it with a
plain or a chunked online-softmax core in jnp; both compute the function
of the flash-attention kernel, so here every call goes to
``flash_attention_fwd``: on a CUDA tensor the hand-written kernel (head
widths 32 and 64 of SmolLM, 128 of Qwen3-MoE and Arctic), on a CPU
tensor its plain version. The reference pads an irregular key length
to a tile multiple and masks the padded keys; the kernel masks a ragged
length itself, so such calls go to it unpadded. Sliding windows and query
offsets are not ported. ``decode_sdpa`` (one query
against the cache) has no kernel in the reference and stays plain
PyTorch.

MLA, cross-attention and windowed attention are not ported yet (ROADMAP
Queue 1 item 11).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_fwd)
from repro_torch.models import layers as L

_ROADMAP = "ROADMAP Queue 1 item 11"


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, max_seq, KH, D); stacked: (L, B, ...)
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


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal=True,
         q_offset=0, window=0) -> torch.Tensor:
    """q: (B,Sq,H,D); k,v: (B,Skv,KH,D) -> (B,Sq,H,D) in q's dtype.

    A sliding window or a query offset has no kernel and no caller in the
    port and raises."""
    if window or q_offset:
        raise NotImplementedError(
            f"sdpa with window={window}, q_offset={q_offset} is not ported "
            f"({_ROADMAP})")
    return flash_attention_fwd(q, k, v, causal=causal)


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
    """One-step decode. q: (B,1,H,D); cache: (B,S,KH,D); keys at positions
    <= ``pos`` (an int or a 0-dim tensor; and inside the window) are
    seen."""
    B, _, H, D = q.shape
    S, KH = cache_k.shape[1], cache_k.shape[2]
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
    return out.reshape(B, 1, H, out.shape[-1]).to(q.dtype)


def gqa_project_qkv(p, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = L.dense(p["wq"], x).reshape(B, S, cfg.num_heads, hd)
    k = L.dense(p["wk"], x).reshape(B, S, cfg.num_kv_heads, hd)
    v = L.dense(p["wv"], x).reshape(B, S, cfg.num_kv_heads, hd)
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
