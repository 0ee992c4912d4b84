"""Plain PyTorch oracles of the flash-attention kernels.

Port of ``repro/kernels/flash_attention/ref.py`` (``mha_ref``): plain
materialized softmax attention over GQA-shaped inputs in float32, cast to
the query's dtype — the allclose target of the tiled kernel and the same
function as models/attention.py's plain core. ``mha_ref_lse`` also
returns each row's log-sum-exp and ``mha_bwd_ref`` is the backward of the
reference's custom VJP (``repro/models/attention.py:_make_flash``) from
those residuals, both materialized in float32, with the forward's masks.

The forward oracles take the masks of the reference's naive core
(``repro/models/attention.py:_naive_core``): query i stands at position
i + ``q_offset``; causal keeps keys at positions <= the query's and, with
``window`` > 0, only the last ``window`` of them (qpos - kpos < window).
Without ``causal`` neither the offset nor the window applies. A row that
sees no key (an offset that puts it ``window`` or more past the last key)
is NaN, as in the reference.
"""
from __future__ import annotations

import math

import torch


def band_mask(Sq: int, Skv: int, q_offset: int = 0, window: int = 0,
              device=None) -> torch.Tensor:
    """The causal mask (Sq, Skv): query i (position i + ``q_offset``) sees
    key j when j <= i + q_offset and, with ``window`` > 0, i + q_offset -
    j < window."""
    qpos = torch.arange(Sq, device=device)[:, None]
    if q_offset:
        qpos = qpos + q_offset
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = qpos >= kpos
    if window > 0:
        mask &= (qpos - kpos) < window
    return mask


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            q_offset: int = 0, window: int = 0):
    """(float32 scores over sqrt(D), (B,Sq,KH,G,Skv); the causal mask
    (1,Sq,1,1,Skv) of ``band_mask``, or None)."""
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    qr = q.reshape(B, Sq, KH, H // KH, D).to(torch.float32)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qr, k.to(torch.float32))
    s = s / math.sqrt(D)
    if not causal:
        return s, None
    mask = band_mask(Sq, Skv, q_offset, window, q.device)
    return s, mask[None, :, None, None, :]


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, q_offset: int = 0,
            window: int = 0) -> torch.Tensor:
    """q: (B,Sq,H,D); k,v: (B,Skv,KH,D) -> (B,Sq,H,Dv)."""
    return _attend(q, k, v, causal, False, q_offset, window)[0]


def mha_ref_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = True, q_offset: int = 0, window: int = 0):
    """``mha_ref`` and each row's float32 log-sum-exp (B,Sq,H) of the
    scaled, masked scores."""
    return _attend(q, k, v, causal, True, q_offset, window)


def _attend(q, k, v, causal: bool, want_lse: bool, q_offset: int = 0,
            window: int = 0):
    B, Sq, H, _ = q.shape
    s, mask = _scores(q, k, causal, q_offset, window)
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhgk,bkhd->bqhgd", p, v.to(torch.float32))
    out = out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)
    if not want_lse:
        return out, None
    return out, torch.logsumexp(s, dim=-1).reshape(B, Sq, H)


def mha_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                causal: bool = True, q_offset: int = 0, window: int = 0):
    """(dq, dk, dv) in q's, k's and v's dtypes: the reference's bwd
    materialized in float32 (not autograd). Drow = rowsum(dO * O), P =
    exp(s - lse) (0 where masked: ``band_mask`` of ``q_offset`` and
    ``window`` when causal), dV = P^T dO, dP = dO V^T, dS = P (dP - Drow)
    scale, dQ = dS K, dK = dS^T Q, dK and dV summed over each KV head's G
    query heads. A key no row sees gets zero dK and dV."""
    B, Sq, H, D = q.shape
    KH, Dv = k.shape[2], v.shape[-1]
    G = H // KH
    s, mask = _scores(q, k, causal, q_offset, window)
    p = torch.exp(s - lse.to(torch.float32).reshape(B, Sq, KH, G, 1))
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    do = dout.to(torch.float32).reshape(B, Sq, KH, G, Dv)
    drow = torch.sum(do * out.to(torch.float32).reshape(B, Sq, KH, G, Dv),
                     dim=-1)
    dv = torch.einsum("bqhgk,bqhgd->bkhd", p, do)
    dp = torch.einsum("bqhgd,bkhd->bqhgk", do, v.to(torch.float32))
    ds = p * (dp - drow[..., None]) * (1.0 / math.sqrt(D))
    dq = torch.einsum("bqhgk,bkhd->bqhgd", ds, k.to(torch.float32))
    dk = torch.einsum("bqhgk,bqhgd->bkhd", ds,
                      q.reshape(B, Sq, KH, G, D).to(torch.float32))
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
