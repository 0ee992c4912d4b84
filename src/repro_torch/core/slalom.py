"""Slalom protocol: per-linear-op blinded offload (the tier-1 inner loop).

Port of ``repro/core/slalom.py``. ``blinded_dense(ctx, p, x)`` is a
drop-in for models.layers.dense:

    enclave:   x_q = Quant(x);  x_b = (x_q + r) mod p
    device:    y_b = (x_b @ W_q) mod p
    enclave:   y   = Dequant((y_b - r@W_q) mod p) (+ bias, fp)

Two data paths (``SlalomContext.impl``):

- ``"fused"`` (default): one ``blind_encode`` kernel blinds and
  limb-encodes the activations and one fused limb-matmul kernel
  multiplies, unblinds and dequantizes
  (``kernels/limb_matmul/ops.fused_blinded_matmul``);
- ``"unfused"``: separate ``blind``, limb matmul and ``unblind`` kernels;
  the device result ``y_b`` exists in the blinded domain and is verified
  there (``y_b @ s = x_b @ ws``).

With ``SlalomContext.factors`` set (core/precompute.py) the weight encoding
and the factor matmul ``u = r @ W_q`` are precomputed: a request then
issues exactly one device field matmul per blinded op. ``ctx.integrity``
adds a Freivalds check of every op (core/integrity.py), ``ctx.fault``
injects a dishonest device under it (runtime/faults.py), ``ctx.trusted``
runs the field matmul inside the enclave instead (the recovery path,
bit-identical output) and ``ctx.plane`` shards the device matmul across an
offload plane's device pool (parallel/offload_sharding.py).

The LM path calls ``blinded_dense`` on (B, S, d) bf16 activations: the
op runs on the float32 rows (B*S, d) and its result is cast back to the
activations' dtype, as in the reference. A decode op's ``step`` is its
token position (a prompt op's is 0), so every (session, token, op) draws
its own pad, fold vectors and check decision. The reference also takes a
``scanned`` verdict (and ``SlalomContext.per_op``) to skip verification
of ops traced once under ``lax.scan`` for many layers; the port runs
eagerly, every call is exactly one op, and the switch has no counterpart:
ops are numbered by ``_layer_counter`` in call order, the numbering the
reference's per-op decode and prefill traces use. This is a deliberate
departure where the reference scans: its LM forward ``infer`` and
``generate_origami`` trace each projection once for a segment's layers,
so one pad blinds that projection in every layer, the Freivalds policy
is dropped and the counters count traced calls. The port draws a fresh
pad per runtime op and checks each; the logits are the same, since the
blinding cancels exactly (ROADMAP Queue 3).

The float op order is the reference's, which is what keeps the fused,
unfused, trusted and cross-framework results bit-equal: the fused path
scales the activations by a reciprocal, the unfused path divides, and the
trusted path copies whichever is active; ``out_scale = x_scale * w_scale *
2^-k_out``, and the fused verification recovers the field value as
``round(y / out_scale)``.
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
from repro_torch.core import prng, tracing
from repro_torch.kernels.blind.ref import quantize as quantize_act
from repro_torch.kernels.limb_matmul.ops import (encode_weight_planes,
                                                 field_matmul,
                                                 fused_blinded_matmul)
from repro_torch.kernels.limb_matmul.ref import P, from_signed, to_signed

# fault keys live in their own fold_in domain, disjoint from the blinding
# streams and the verify keys (core/integrity.py)
FAULT_DOMAIN = 0xFA17


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

    ``impl``: "fused" | "unfused" data path. ``factors``: per-op
    precomputed blinding material from ``BlindedLayerCache.session_factors``,
    consumed in call order. ``integrity``: the Freivalds policy; ``fault``:
    a runtime/faults.DishonestDevice under the device matmul;
    ``integrity_log`` collects one (checked, failed, corrupted) triple of
    0-d bool tensors per verified or fault-injected op. ``trusted``:
    enclave recompute (no device, no blinding, no verification).
    ``unblinded``: verified-open offload — a zero pad, so ``u = 0``;
    verification still applies. ``plane``: a
    parallel/offload_sharding.OffloadPlane that shards every device matmul
    across its pool; ``shard`` is the per-segment plan.ShardPolicy.
    ``integrity``, ``unblinded`` and ``shard`` are per plan segment,
    scoped by ``segment_overrides``.
    """
    session_key: np.ndarray
    spec: B.BlindingSpec = dfield(default_factory=B.BlindingSpec)
    telemetry: Telemetry = dfield(default_factory=Telemetry)
    step: int = 0
    impl: str = "fused"                       # "fused" | "unfused"
    factors: Optional[List[Dict[str, Any]]] = None
    integrity: IG.IntegrityPolicy = dfield(
        default_factory=IG.IntegrityPolicy.off)
    fault: Optional[Any] = None               # runtime/faults.DishonestDevice
    trusted: bool = False
    unblinded: bool = False
    plane: Optional[Any] = None               # offload_sharding.OffloadPlane
    shard: Optional[Any] = None               # plan.ShardPolicy override
    integrity_log: List[Any] = dfield(default_factory=list)
    _layer_counter: int = 0

    @contextmanager
    def segment_overrides(self, integrity: Optional[IG.IntegrityPolicy],
                          unblinded: bool = False,
                          shard: Optional[Any] = None):
        """Scope the verification policy, the unblinded flag and the shard
        policy to one plan segment."""
        prev = self.integrity, self.unblinded, self.shard
        if integrity is not None:
            self.integrity = integrity
        self.unblinded = unblinded
        if shard is not None:
            self.shard = shard
        try:
            yield self
        finally:
            self.integrity, self.unblinded, self.shard = prev

    def next_layer_key(self) -> np.ndarray:
        k = B.stream_key(self.session_key, self._layer_counter, self.step)
        self._layer_counter += 1
        return k

    def fault_key(self, op_index: int) -> np.ndarray:
        return B.stream_key(prng.fold_in(self.session_key, FAULT_DOMAIN),
                            op_index, self.step)

    def next_layer_factors(self, t: int, d_in: int, d_out: int,
                           w: torch.Tensor):
        """Blinding + verification material for the next blinded op:
        (w_q, w_scale, w_limbs_or_None, r, u, s, ws, shard_folds). The
        cached branch issues no field matmul; the live branch issues one
        for ``u`` (``enclave_matmuls``) and, under a policy with no cached
        fold vectors, one ``W_q @ s`` fold (``fold_matmuls``).
        ``shard_folds`` is the cache's per-shard (s_j, ws_j) list for the
        offload plane (None: the plane derives it live)."""
        op = self._layer_counter
        dev = w.device
        sf = None
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
            sf = e.get("shard_folds")
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
        return w_q, w_scale, w_limbs, r, u, s, ws, sf


def _absmax_scale(xt: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(xt.to(torch.float32).abs().max(), 1e-9)


def _scaled(ctx: SlalomContext, xt: torch.Tensor,
            x_scale: torch.Tensor) -> torch.Tensor:
    """The activations over their scale in the active data path's float op
    order: the fused kernel multiplies by the reciprocal, the unfused path
    divides."""
    return xt * (1.0 / x_scale) if ctx.impl == "fused" else xt / x_scale


def blinded_dense(ctx: SlalomContext, p, x: torch.Tensor) -> torch.Tensor:
    """Drop-in for layers.dense running the Slalom protocol.

    p: {"w": (d_in, d_out) float [, "b": (d_out,)]}; x: (..., d_in). Each
    op runs under an ``op.blinded`` or ``op.trusted`` span (shapes and
    placement flags, never operands) when a tracer is ambient."""
    with tracing.maybe_span(
            "op.trusted" if ctx.trusted else "op.blinded", "step",
            layer=ctx._layer_counter, d_in=int(p["w"].shape[0]),
            d_out=int(p["w"].shape[1]),
            verified_open=bool(ctx.unblinded)):
        return _blinded_dense(ctx, p, x)


def _blinded_dense(ctx: SlalomContext, p, x: torch.Tensor) -> torch.Tensor:
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
        # order as the active data path, hence bit-identical output
        ctx._layer_counter += 1
        w_q, w_scale = B.quantize_weight(w, spec)
        x_scale = _absmax_scale(xt)
        xs = _scaled(ctx, xt, x_scale)
        y_field = field_matmul(from_signed(quantize_act(xs, spec.k_act)), w_q)
        y = (to_signed(y_field).to(torch.float32)
             * (x_scale * w_scale)) * (2.0 ** -k_out)
        ctx.telemetry.record_trusted(t, d_in, d_out)
        return _finish(p, y, lead, d_out, x.dtype)

    w_q, w_scale, w_limbs, r, u, s, ws, sf = ctx.next_layer_factors(
        t, d_in, d_out, w)
    x_scale = _absmax_scale(xt)
    if ctx.plane is not None:
        # the device matmul shards across the plane's pool with
        # shard-local Freivalds checks, single-shard retry and per-device
        # faults; every shard is checked, so the op-level log records a
        # verified op with no unrecovered failure (the plane's ShardReport
        # carries the detection and recovery counts)
        k = ctx.integrity.k if ctx.integrity.enabled else 1
        x_b = B.blind_activations(_scaled(ctx, xt, x_scale), r, spec)
        y_b = ctx.plane.matmul(
            x_b, w_q, session_key=ctx.session_key, op_index=op_index,
            step=ctx.step, k=k, folds=sf,
            mode=ctx.shard.mode if ctx.shard is not None else None,
            group=ctx.shard.devices if ctx.shard is not None else None)
        if ctx.impl == "fused":
            out_scale = x_scale * w_scale * (2.0 ** -k_out)
            y = (to_signed(torch.remainder(y_b - u + P, P)).to(torch.float32)
                 * out_scale)
        else:
            y = B.unblind_result(y_b, u, spec) * (x_scale * w_scale)
        true = torch.ones((), dtype=torch.bool, device=y.device)
        ctx.integrity_log.append((true, ~true, ~true))
        ctx.telemetry.record_verify(t, d_in, d_out, k)
        ctx.telemetry.device_matmuls += 1
        ctx.telemetry.record_offload(t, d_in, d_out)
        return _finish(p, y, lead, d_out, x.dtype)

    verify = ctx.integrity.enabled
    inject = ctx.fault is not None
    will_check = (IG.decide(ctx.integrity, ctx.session_key, op_index,
                            ctx.step) if verify or inject else False)
    checked = failed = corrupted = None
    if ctx.impl == "fused":
        if w_limbs is None:
            w_limbs = encode_weight_planes(w_q)
        out_scale = x_scale * w_scale * (2.0 ** -k_out)
        y = fused_blinded_matmul(xt, r, w_limbs, u, 1.0 / x_scale, out_scale,
                                 k_bits=spec.k_act)
        if verify or inject:
            # the fused kernel unblinds + dequantizes in-register; |y_q| <=
            # HALF < 2^22 and the only inexact step is one f32 multiply, so
            # round() recovers the signed field result exactly
            y_field = from_signed(torch.round(y / out_scale).to(torch.int32))
            if inject:
                y_field, corrupted = ctx.fault.corrupt(
                    y_field, op_index=op_index, key=ctx.fault_key(op_index),
                    will_verify=will_check)
            if verify:
                # post-unblind identity y_q @ s = x_q @ ws (mod p): x_q is
                # the enclave's own quantization of its activations,
                # bit-identical to the kernel's (same reciprocal, same
                # round and clip)
                x_field = from_signed(quantize_act(xt * (1.0 / x_scale),
                                                   spec.k_act))
                checked, failed = IG.checked_pair(y_field, x_field, s, ws,
                                                  will_check)
            y = to_signed(y_field).to(torch.float32) * out_scale
    else:
        # blind, device field matmul, unblind: three kernels, and the
        # device result exists in the blinded domain
        x_b = B.blind_activations(xt / x_scale, r, spec)
        y_b = field_matmul(x_b, w_q)
        if inject:
            y_b, corrupted = ctx.fault.corrupt(
                y_b, op_index=op_index, key=ctx.fault_key(op_index),
                will_verify=will_check)
        if verify:
            # blinded-domain identity: y_b @ s = x_b @ ws (mod p)
            checked, failed = IG.checked_pair(y_b, x_b, s, ws, will_check)
        y = B.unblind_result(y_b, u, spec) * (x_scale * w_scale)
    if verify or inject:
        no = torch.zeros((), dtype=torch.bool, device=y.device)
        ctx.integrity_log.append(tuple(v if v is not None else no
                                       for v in (checked, failed, corrupted)))
        if verify:
            ctx.telemetry.record_verify(t, d_in, d_out, ctx.integrity.k)
    ctx.telemetry.device_matmuls += 1
    ctx.telemetry.record_offload(t, d_in, d_out)
    return _finish(p, y, lead, d_out, x.dtype)


def _finish(p, y: torch.Tensor, lead, d_out: int,
            dtype: torch.dtype) -> torch.Tensor:
    """Bias add (float) and the caller's shape and dtype."""
    if "b" in p:
        y = y + p["b"].to(torch.float32)
    return y.reshape(tuple(lead) + (d_out,)).to(dtype)


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
