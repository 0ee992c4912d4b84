"""Wrappers of the flash-attention kernels: the forward
(``csrc/flash_attention.cu``; its float32 kernel is
``csrc/flash_attention_f32.cu``) and the backward
(``csrc/flash_attention_bwd.cu``; its float32 passes are
``csrc/flash_attention_bwd_f32.cu``).

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
of the ``wkv_b`` projection). Both dtypes run on the tensor cores and copy
their rows in 16-byte chunks: the last dim must be unit-stride and the
start and the (b, s, h) strides multiples of 16 bytes, and a view that is
not is copied first.
Unlike the TPU kernel, no length has to divide a tile: the kernel masks
ragged ``Sq`` and ``Skv`` itself.

A causal call also takes the reference's sliding window and query offset
(``repro/models/attention.py``, ``sdpa``'s ``window`` and ``q_offset``;
the Pallas kernel has neither): query i stands at position i + ``q_offset``
and sees the keys at positions kpos <= i + q_offset with, when ``window``
> 0, i + q_offset - kpos < window. The three forward kernels take both as
runtime ints and skip every key tile (the decode route: every key outside
the union of the rows' bands, ``band``) that no row of the tile's queries
sees. Without ``causal`` neither applies, as in the reference. A call in
which some row would see no key (an offset that puts the last row
``window`` or more past the last key) is refused on either device
(``check_band``), where the reference's naive core returns NaN for the
row.

A bf16 call with at most ``DECODE_ROWS`` query rows a KV head (Sq * G: a
decode step's cross attention) takes the split-KV decode route
(``csrc/flash_attention_decode.cu``): a split pass over ``decode_splits``
key splits into a float32 workspace the wrapper allocates, then a combine
pass that merges the splits in order. Either route is one call of the C
entry and counts one ``flash_attention`` launch.

The forward also gives, when asked (``return_lse``), each row's float32
log-sum-exp (B, Sq, H), the residual of the backward; its output is the
same either way. ``flash_attention_bwd`` is the port's kernel for the
backward of the reference's custom VJP (``repro/models/attention.py``,
``_make_flash``): the Pallas kernel has none. From q, k, v, the output,
its gradient and the lse it recomputes each block's probabilities and
returns (dq, dk, dv) in the inputs' dtypes, dk and dv summed over each KV
head's query heads, with no atomics (bit-for-bit repeatable). It takes
the forward's window and query offset: a causal call with either runs
windowed instantiations of both passes, which walk only the tiles of the
rows' bands (a key that no row sees gets zero dk and dv). Both dtypes
run on the tensor cores: bf16 products with P and dS in two bf16 parts,
and float32 in 3xTF32 (each operand as two tf32 parts, three products a
multiply-add, every tensor-core sum in a short chain merged into float32),
which holds the float32 gradients within 1e-5 of the plain version. It is
built for the forward's ``HEAD_DIMS``; its kernels copy q, k, v and dO in
16-byte rows, so their views are fitted as the forward's.

A CUDA tensor launches the kernel, a CPU tensor takes the plain version
beside it (``flash_attention_plain``, ``flash_attention_bwd_plain``:
``ref.mha_ref_lse`` and ``ref.mha_bwd_ref``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build as KB
from repro_torch.kernels.flash_attention.ref import (mha_bwd_ref, mha_ref,
                                                     mha_ref_lse)

# the kernel's compiled (q/k width, v width) pairs: SmolLM's 32 and 64;
# 128 of Yi, Qwen2.5, Qwen3-MoE and Arctic; MiniCPM3's MLA (96, 64) and its
# smoke widths (48, 32)
HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (96, 64), (48, 32))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the decode route (csrc/flash_attention_decode.cu): bf16 calls with at most
# DECODE_ROWS query rows a KV head (the C entry's flash::DECODE_ROWS); its
# split count keeps the split CTAs within DECODE_CTAS, one wave of the split
# pass at two CTAs an SM of an H100's 132 (D 128 holds two an SM), with at
# least DECODE_MIN_KEYS keys a split. A constant, not the card's SM count,
# so a call gives the same bits on any card.
DECODE_ROWS = 16
DECODE_CTAS = 264
DECODE_MIN_KEYS = 64


def band(Sq: int, Skv: int, causal: bool, q_offset: int = 0,
         window: int = 0):
    """(lo, hi): the keys [lo, hi) that some query row of a call sees, the
    union of the rows' bands (the same function as ``flash::band`` in
    ``csrc/flash_common.cuh``). Non-causal: every key."""
    if not causal:
        return 0, Skv
    lo = max(0, q_offset - window + 1) if window > 0 else 0
    return lo, max(lo, min(Skv, Sq + q_offset))


def check_band(Sq: int, Skv: int, causal: bool, q_offset: int,
               window: int):
    """(q_offset, window) of a call as ints, both 0 without ``causal``;
    raises unless every row sees a key: no negative offset or window, and
    with a window no row ``window`` or more past the last key."""
    q_offset, window = (int(q_offset), int(window)) if causal else (0, 0)
    if q_offset < 0 or window < 0:
        raise ValueError(f"q_offset {q_offset} and window {window} must be "
                         f">= 0")
    if causal and window > 0 and Sq > 0 and Sq + q_offset - window >= Skv:
        raise ValueError(
            f"causal attention with window {window} and q_offset "
            f"{q_offset}: query {Sq - 1} (position {Sq - 1 + q_offset}) sees "
            f"none of the {Skv} keys (the reference returns NaN there)")
    return q_offset, window


def decode_splits(B: int, Sq: int, Skv: int, H: int, KH: int,
                  dtype: torch.dtype, *, causal: bool = False,
                  q_offset: int = 0, window: int = 0) -> int:
    """The decode route's key-split count for a call of these shapes, or
    0 for the prefill route (float32, or more than ``DECODE_ROWS`` query
    rows a KV head). The splits cover the call's ``band`` [lo, hi) of n =
    hi - lo keys: split s holds keys [lo + s c, min(lo + (s + 1) c, hi))
    with c = ceil(n / splits); every split, the last included, holds a
    key."""
    if dtype != torch.bfloat16 or Sq * (H // KH) > DECODE_ROWS:
        return 0
    lo, hi = band(Sq, Skv, causal, q_offset, window)
    n = hi - lo
    if n <= 0:
        return 1
    splits = max(1, min(DECODE_CTAS // max(B * KH, 1),
                        n // DECODE_MIN_KEYS))
    chunk = -(-n // splits)
    return -(-n // chunk)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, return_lse: bool = False,
                          q_offset: int = 0, window: int = 0):
    """Plain PyTorch version: materialized float32 softmax attention (and
    with ``return_lse`` each row's float32 log-sum-exp), with the kernels'
    window and query offset, refusing what they refuse
    (``check_band``)."""
    q_offset, window = check_band(q.shape[1], k.shape[1], causal, q_offset,
                                  window)
    if return_lse:
        return mha_ref_lse(q, k, v, causal=causal, q_offset=q_offset,
                           window=window)
    return mha_ref(q, k, v, causal=causal, q_offset=q_offset, window=window)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, dout: torch.Tensor, *,
                              causal: bool = True, q_offset: int = 0,
                              window: int = 0):
    """Plain PyTorch version of the backward: the materialized float32
    formula (not autograd), with the forward's window and query offset,
    refusing what the forward refuses (``check_band``)."""
    q_offset, window = check_band(q.shape[1], k.shape[1], causal, q_offset,
                                  window)
    return mha_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                       q_offset=q_offset, window=window)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(B, Sq, Skv, H, KH, D, Dv) of inputs the kernels take; raises on
    any other."""
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
    return B, Sq, Skv, H, KH, D, Dv


def _strides(*ts):
    return [s for t in ts for s in (t.stride(0), t.stride(1), t.stride(2))]


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, return_lse: bool = False,
                        q_offset: int = 0, window: int = 0):
    """q: (B,Sq,H,D); k: (B,Skv,KH,D); v: (B,Skv,KH,Dv) -> (B,Sq,H,Dv) in
    q's dtype, the scores scaled by 1/sqrt(D); with ``return_lse`` also
    each row's float32 log-sum-exp (B,Sq,H). Causal masking is ``qpos >=
    kpos`` with query i at position i + ``q_offset`` and keys from 0, and
    with ``window`` > 0 also ``qpos - kpos < window``; both are ignored
    without ``causal``. Raises where a row would see no key
    (``check_band``)."""
    q_offset, window = check_band(q.shape[1], k.shape[1], causal, q_offset,
                                  window)
    if KB.on_cpu(q):
        return flash_attention_plain(q, k, v, causal=causal,
                                     return_lse=return_lse,
                                     q_offset=q_offset, window=window)
    B, Sq, Skv, H, KH, D, Dv = _check(q, k, v)
    q, k, v = (KB.aligned16(t) for t in (q, k, v))
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    splits = decode_splits(B, Sq, Skv, H, KH, q.dtype, causal=causal,
                           q_offset=q_offset, window=window)
    # the decode route's (m, l, acc) of every row and split, float32
    ws = (torch.empty(B * KH * splits * Sq * (H // KH) * (Dv + 2),
                      dtype=torch.float32, device=q.device)
          if splits else None)
    KB.launch("flash_attention", q,
              q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              None if lse is None else lse.data_ptr(),
              None if ws is None else ws.data_ptr(),
              _DTYPES[q.dtype], B, Sq, Skv, H, KH, D, Dv, int(causal),
              q_offset, window, splits, *_strides(q, k, v),
              1.0 / math.sqrt(D))
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        q_offset: int = 0, window: int = 0):
    """The backward of ``flash_attention_fwd`` from its residuals: q, k, v,
    the causal flag, ``q_offset`` and ``window`` as the forward took them,
    its output and float32 lse, and dout, the gradient of the output
    (B,Sq,H,Dv) -> (dq, dk, dv) in q's dtype. Raises where the forward
    does (``check_band``)."""
    q_offset, window = check_band(q.shape[1], k.shape[1], causal, q_offset,
                                  window)
    if KB.on_cpu(q):
        return flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                         causal=causal, q_offset=q_offset,
                                         window=window)
    B, Sq, Skv, H, KH, D, Dv = _check(q, k, v)
    for name, t, dt, shape in (("out", out, q.dtype, (B, Sq, H, Dv)),
                               ("dout", dout, q.dtype, (B, Sq, H, Dv)),
                               ("lse", lse, torch.float32, (B, Sq, H))):
        if t.device != q.device or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, expected {dt} {shape} on "
                             f"{q.device}")
    q, k, v, dout = (KB.aligned16(t) for t in (q, k, v, dout.contiguous()))
    out, lse = out.contiguous(), lse.contiguous()
    # every element is written by the kernel (zeros where no pair is seen)
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Skv, KH, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, Skv, KH, Dv), dtype=q.dtype, device=q.device)
    if B == 0 or (Sq == 0 and Skv == 0):
        return dq, dk, dv
    drow = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
    KB.launch("flash_attention_bwd", q,
              q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              dout.data_ptr(), lse.data_ptr(), drow.data_ptr(),
              dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
              _DTYPES[q.dtype], B, Sq, Skv, H, KH, D, Dv, int(causal),
              q_offset, window, *_strides(q, k, v), 1.0 / math.sqrt(D))
    return dq, dk, dv
