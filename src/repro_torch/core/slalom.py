"""Slalom protocol: per-linear-op blinded offload (the tier-1 inner loop).

Port of ``repro/core/slalom.py`` (the fused and trusted data paths).
``blinded_dense(ctx, p, x)`` is a drop-in for models.layers.dense:

    enclave:   x_q = Quant(x);  x_b = (x_q + r) mod p
    device:    y_b = (x_b @ W_q) mod p         <- blind_encode + limb matmul
    enclave:   y   = Dequant((y_b - r@W_q) mod p) (+ bias, fp)

On the device one ``blind_encode`` kernel blinds and limb-encodes the
activations and one fused limb-matmul kernel multiplies, unblinds and
dequantizes (``kernels/limb_matmul/ops.fused_blinded_matmul``). With
``SlalomContext.factors`` set (core/precompute.py) the weight encoding and
the factor matmul ``u = r @ W_q`` are precomputed: a request then issues
exactly one device field matmul per blinded op. ``ctx.integrity`` adds a
Freivalds check of every op (core/integrity.py); ``ctx.trusted`` runs the
field matmul inside the enclave instead (the recovery path, bit-identical
output).

The float op order is the reference's, which is what keeps the fused,
trusted and cross-framework results bit-equal: the activations are scaled
by a reciprocal, ``out_scale = x_scale * w_scale * 2^-k_out``, and the
verification recovers the field value as ``round(y / out_scale)``.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field as dfield
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import blinding as B
from repro_torch.core import integrity as IG
from repro_torch.kernels.blind.ref import quantize as quantize_act
from repro_torch.kernels.limb_matmul.ops import (encode_weight_planes,
                                                 field_matmul,
                                                 fused_blinded_matmul)
from repro_torch.kernels.limb_matmul.ref import from_signed, to_signed


@dataclass
class Telemetry:
    """Shape-derived accounting of one infer (bytes, FLOPs, op counts)."""
    blinded_bytes: int = 0          # enclave->device blinded traffic
    returned_bytes: int = 0         # device->enclave results
    offloaded_flops: int = 0        # linear-op FLOPs run untrusted
    enclave_flops: int = 0          # blinding/unblinding elementwise work
    enclave_peak_feature_bytes: int = 0
    calls: int = 0
    device_matmuls: int = 0         # field matmuls on the request path
    enclave_matmuls: int = 0        # r@W_q factor matmuls on the request
                                    # path (0 when the cache is active)
    verify_ops: int = 0             # blinded ops verified
    verify_flops: int = 0           # fold-check work (enclave side)
    fold_matmuls: int = 0           # on-request W_q@s folds
    trusted_matmuls: int = 0        # enclave-recompute field matmuls

    def record_verify(self, t: int, d_in: int, d_out: int, k: int):
        self.verify_ops += 1
        self.verify_flops += 2 * k * t * (d_in + d_out)

    def record_trusted(self, t: int, d_in: int, d_out: int):
        self.trusted_matmuls += 1
        self.enclave_flops += 2 * t * d_in * d_out

    def record_offload(self, t: int, d_in: int, d_out: int):
        self.blinded_bytes += t * d_in * 4
        self.returned_bytes += t * d_out * 4
        self.offloaded_flops += 2 * t * d_in * d_out
        self.enclave_flops += 2 * t * (d_in + d_out)
        self.enclave_peak_feature_bytes = max(
            self.enclave_peak_feature_bytes, t * max(d_in, d_out) * 4)
        self.calls += 1


@dataclass
class SlalomContext:
    """Session state for one private-inference request.

    ``factors``: per-op precomputed blinding material from
    ``BlindedLayerCache.session_factors``, consumed in call order.
    ``integrity``: the Freivalds policy; ``integrity_log`` collects one
    (checked, failed, corrupted) triple of 0-d bool tensors per verified
    op. ``trusted``: enclave recompute (no device, no blinding, no
    verification). ``unblinded``: verified-open offload — a zero pad, so
    ``u = 0``; verification still applies. ``integrity`` and ``unblinded``
    are per plan segment, scoped by ``segment_overrides``.
    """
    session_key: np.ndarray
    spec: B.BlindingSpec = dfield(default_factory=B.BlindingSpec)
    telemetry: Telemetry = dfield(default_factory=Telemetry)
    step: int = 0
    factors: Optional[List[Dict[str, Any]]] = None
    integrity: IG.IntegrityPolicy = dfield(
        default_factory=IG.IntegrityPolicy.off)
    trusted: bool = False
    unblinded: bool = False
    integrity_log: List[Any] = dfield(default_factory=list)
    _layer_counter: int = 0

    @contextmanager
    def segment_overrides(self, integrity: Optional[IG.IntegrityPolicy],
                          unblinded: bool = False):
        """Scope the verification policy and the unblinded flag to one plan
        segment."""
        prev = self.integrity, self.unblinded
        if integrity is not None:
            self.integrity = integrity
        self.unblinded = unblinded
        try:
            yield self
        finally:
            self.integrity, self.unblinded = prev

    def next_layer_key(self) -> np.ndarray:
        k = B.stream_key(self.session_key, self._layer_counter, self.step)
        self._layer_counter += 1
        return k

    def next_layer_factors(self, t: int, d_in: int, d_out: int,
                           w: torch.Tensor):
        """Blinding + verification material for the next blinded op:
        (w_q, w_scale, w_limbs_or_None, r, u, s, ws). The cached branch
        issues no field matmul; the live branch issues one for ``u``
        (``enclave_matmuls``) and, under a policy with no cached fold
        vectors, one ``W_q @ s`` fold (``fold_matmuls``)."""
        op = self._layer_counter
        dev = w.device
        if self.factors is not None:
            assert op < len(self.factors), (
                f"precompute cache has {len(self.factors)} layers but the "
                f"request reached blinded op #{op} — rebuild the cache for "
                f"this batch shape/partition")
            self._layer_counter += 1
            e = self.factors[op]
            w_q, w_scale = e["w_q"], e["w_scale"]
            w_limbs, r, u = e.get("w_limbs"), e["r"], e["u"]
            if r is None:               # verified-open slot: zero pad
                r = torch.zeros((t, d_in), dtype=torch.int32, device=dev)
                u = torch.zeros((t, d_out), dtype=torch.int32, device=dev)
            else:
                assert tuple(r.shape) == (t, d_in), (
                    f"cached stream shape {tuple(r.shape)} != ({t}, {d_in}) "
                    f"— cache was built for a different batch shape")
            s, ws = e.get("s"), e.get("ws")
        elif self.unblinded:
            self._layer_counter += 1
            w_q, w_scale = B.quantize_weight(w, self.spec)
            r = torch.zeros((t, d_in), dtype=torch.int32, device=dev)
            u = torch.zeros((t, d_out), dtype=torch.int32, device=dev)
            w_limbs = s = ws = None
        else:
            key = self.next_layer_key()
            w_q, w_scale = B.quantize_weight(w, self.spec)
            r = B.blinding_stream(key, (t, d_in), device=dev)
            u = B.unblinding_factor(r, w_q)
            self.telemetry.enclave_matmuls += 1
            w_limbs = s = ws = None
        if self.integrity.enabled and s is None:
            s = IG.fold_stream(self.session_key, op, self.step, d_out,
                               self.integrity.k, device=dev)
            ws = field_matmul(w_q, s)
            self.telemetry.fold_matmuls += 1
            self.telemetry.verify_flops += 2 * d_in * d_out * self.integrity.k
        return w_q, w_scale, w_limbs, r, u, s, ws


def _absmax_scale(xt: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(xt.to(torch.float32).abs().max(), 1e-9)


def blinded_dense(ctx: SlalomContext, p, x: torch.Tensor) -> torch.Tensor:
    """Drop-in for layers.dense running the Slalom protocol.

    p: {"w": (d_in, d_out) float [, "b": (d_out,)]}; x: (..., d_in)."""
    w = p["w"]
    d_in, d_out = w.shape
    lead = tuple(x.shape[:-1])
    t = 1
    for s_ in lead:
        t *= s_
    xt = x.reshape(t, d_in).to(torch.float32)
    spec = ctx.spec
    k_out = spec.k_act + spec.k_w
    op_index = ctx._layer_counter

    if ctx.trusted:
        # enclave recompute: the blinding would cancel exactly, so the
        # enclave multiplies its own quantized operand; same float op
        # order as the fused data path, hence bit-identical output
        ctx._layer_counter += 1
        w_q, w_scale = B.quantize_weight(w, spec)
        x_scale = _absmax_scale(xt)
        xs = xt * (1.0 / x_scale)
        y_field = field_matmul(from_signed(quantize_act(xs, spec.k_act)), w_q)
        y = (to_signed(y_field).to(torch.float32)
             * (x_scale * w_scale)) * (2.0 ** -k_out)
        ctx.telemetry.record_trusted(t, d_in, d_out)
        if "b" in p:
            y = y + p["b"].to(torch.float32)
        return y.reshape(lead + (d_out,)).to(x.dtype)

    w_q, w_scale, w_limbs, r, u, s, ws = ctx.next_layer_factors(
        t, d_in, d_out, w)
    x_scale = _absmax_scale(xt)
    verify = ctx.integrity.enabled
    if w_limbs is None:
        w_limbs = encode_weight_planes(w_q)
    out_scale = x_scale * w_scale * (2.0 ** -k_out)
    y = fused_blinded_matmul(xt, r, w_limbs, u, 1.0 / x_scale, out_scale,
                             k_bits=spec.k_act)
    if verify:
        will_check = IG.decide(ctx.integrity, ctx.session_key, op_index,
                               ctx.step)
        # the fused kernel unblinds + dequantizes in-register; |y_q| <= HALF
        # < 2^22 and the only inexact step is one f32 multiply, so round()
        # recovers the signed field result exactly
        y_q = torch.round(y / out_scale).to(torch.int32)
        y_field = from_signed(y_q)
        # post-unblind identity y_q @ s = x_q @ ws (mod p): x_q is the
        # enclave's own quantization of its activations, bit-identical to
        # the kernel's (same reciprocal, same round and clip)
        x_field = from_signed(quantize_act(xt * (1.0 / x_scale), spec.k_act))
        checked, failed = IG.checked_pair(y_field, x_field, s, ws, will_check)
        ctx.integrity_log.append(
            (checked, failed, torch.zeros((), dtype=torch.bool,
                                          device=y.device)))
        ctx.telemetry.record_verify(t, d_in, d_out, ctx.integrity.k)
        y = to_signed(y_field).to(torch.float32) * out_scale
    ctx.telemetry.device_matmuls += 1
    if "b" in p:
        y = y + p["b"].to(torch.float32)
    ctx.telemetry.record_offload(t, d_in, d_out)
    return y.reshape(lead + (d_out,)).to(x.dtype)


def extract_patches(x: torch.Tensor, kh: int, kw: int, stride: int = 1):
    """NHWC SAME patch extraction for stride 1 and an odd kernel.

    Returns ((B*H*W, cin*kh*kw) patches, (B, H, W)); rows are ordered
    (b, h, w) and columns (c, i, j), the order of the reference's
    ``conv_general_dilated_patches`` — pair with ``conv_weight_cols``."""
    assert stride == 1 and kh % 2 == 1 and kw % 2 == 1, (kh, kw, stride)
    b, h, wd, c = x.shape
    cols = F.unfold(x.permute(0, 3, 1, 2), (kh, kw),
                    padding=(kh // 2, kw // 2))          # (B, C*kh*kw, H*W)
    return cols.transpose(1, 2).reshape(-1, c * kh * kw), (b, h, wd)


def conv_weight_cols(w: torch.Tensor) -> torch.Tensor:
    """(kh, kw, cin, cout) -> (cin*kh*kw, cout), matching extract_patches."""
    kh, kw, cin, cout = w.shape
    return w.permute(2, 0, 1, 3).reshape(cin * kh * kw, cout)


def blinded_conv2d(ctx: SlalomContext, p, x: torch.Tensor,
                   stride: int = 1) -> torch.Tensor:
    """Blinded 3x3 SAME conv: patch extraction, then a blinded matmul."""
    w = p["w"]
    cout = w.shape[3]
    xcol, out_hw = extract_patches(x, w.shape[0], w.shape[1], stride)
    y = blinded_dense(ctx, {"w": conv_weight_cols(w), "b": p["b"]}, xcol)
    return y.reshape(out_hw + (cout,))
