"""Wrapper of the flash-attention forward kernel
(``csrc/flash_attention.cu``; its float32 kernel is
``csrc/flash_attention_f32.cu``).

Port of ``repro/kernels/flash_attention/flash_attention.py``
(``flash_attention_fwd``): causal or non-causal GQA softmax attention,
q (B, Sq, H, D) against k (B, Skv, KH, D) and v (B, Skv, KH, Dv), bf16 or
float32 in, float32 online-softmax statistics, the output (B, Sq, H, Dv)
in q's dtype. The TPU kernel takes one width for q, k and v; the
reference's jnp flash core, which the port's ``sdpa`` serves with this
kernel, takes a value width apart (MLA: q and k of 96, v of 64). The
kernel is built for the pairs ``HEAD_DIMS`` and raises on any other.
Layouts are the reference's; the kernel reads q, k and v through their
strides, so the projections' views go in as they are (MLA's v is a view
of the ``wkv_b`` projection). The last dim must be unit-stride, and for
bf16 (copied in 16-byte rows) the start and the (b, s, h) strides must be
multiples of 16 bytes: a view that is not is copied first.
Unlike the TPU kernel, no length has to divide a tile: the kernel masks
ragged ``Sq`` and ``Skv`` itself.

A CUDA tensor launches the kernel, a CPU tensor takes
``flash_attention_plain`` (``ref.mha_ref``) beside it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build as KB
from repro_torch.kernels.flash_attention.ref import mha_ref

# the kernel's compiled (q/k width, v width) pairs: SmolLM's 32 and 64;
# 128 of Yi, Qwen2.5, Qwen3-MoE and Arctic; MiniCPM3's MLA (96, 64) and its
# smoke widths (48, 32)
HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (96, 64), (48, 32))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """Plain PyTorch version: materialized float32 softmax attention."""
    return mha_ref(q, k, v, causal=causal)


def _unit_last(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """q: (B,Sq,H,D); k: (B,Skv,KH,D); v: (B,Skv,KH,Dv) -> (B,Sq,H,Dv) in
    q's dtype, the scores scaled by 1/sqrt(D). Causal masking is
    ``qpos >= kpos`` with both positions from 0."""
    if KB.on_cpu(q):
        return flash_attention_plain(q, k, v, causal=causal)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes q, k, v of one dtype in "
                        f"{tuple(_DTYPES)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
    if (q.dim() != 4 or k.dim() != 4 or v.dim() != 4
            or v.shape[:-1] != k.shape[:-1]):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: need (B,Sq,H,D), (B,Skv,KH,D) "
                         f"and (B,Skv,KH,Dv)")
    B, Sq, H, D = q.shape
    _, Skv, KH, Dk = k.shape
    Dv = v.shape[-1]
    if k.shape[0] != B or Dk != D or KH == 0 or H % KH:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}: "
                         f"batch and head dim must match and KH divide H")
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"head dims (q/k {D}, v {Dv}): the kernel is built "
                         f"for {HEAD_DIMS}")
    fit = KB.aligned16 if q.dtype == torch.bfloat16 else _unit_last
    q, k, v = fit(q), fit(k), fit(v)
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    KB.launch("flash_attention", q,
              q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              _DTYPES[q.dtype], B, Sq, Skv, H, KH, D, Dv, int(causal),
              q.stride(0), q.stride(1), q.stride(2),
              k.stride(0), k.stride(1), k.stride(2),
              v.stride(0), v.stride(1), v.stride(2), 1.0 / math.sqrt(D))
    return out
