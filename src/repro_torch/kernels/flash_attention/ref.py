"""Plain PyTorch oracle of the flash-attention forward kernel.

Port of ``repro/kernels/flash_attention/ref.py`` (``mha_ref``): plain
materialized softmax attention over GQA-shaped inputs in float32, cast to
the query's dtype — the allclose target of the tiled kernel and the same
function as models/attention.py's plain core.
"""
from __future__ import annotations

import math

import torch


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True) -> torch.Tensor:
    """q: (B,Sq,H,D); k,v: (B,Skv,KH,D) -> (B,Sq,H,Dv)."""
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    qr = q.reshape(B, Sq, KH, G, D).to(torch.float32)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qr, k.to(torch.float32))
    s = s / math.sqrt(D)
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Skv, device=q.device)[None, :])
        s = s.masked_fill(~mask[None, :, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhgk,bkhd->bqhgd", p, v.to(torch.float32))
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)
