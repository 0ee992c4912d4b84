"""Precomputed blinding material: weight quantization + unblinding factors
off the request path.

Port of ``repro/core/precompute.py``. ``BlindedLayerCache`` holds, per
blinded op, the field weights, their absmax scale and their limb planes
(computed once per model, ``from_records``), and generates per session
the blinding stream ``r``, the factor ``u = (r @ W_q) mod p`` and, under
an integrity policy, the fold vectors ``s`` and ``ws = (W_q @ s) mod p``
(``session_factors``), and with an offload plane attached the per-shard
fold vectors of its shard-local checks. ``prefetch`` computes a future
session's set ahead of its request; ``take`` pops it, or computes it on
the spot.

Factor keys are ``stream_key(session_key, layer_index, step)``, the keys
the live path draws, so cached and live results are bit-identical. For
the decode walk ``step`` is the token index: a TokenSlotRing
(runtime/sessions.py) prefetches ``session_factors(key, step=token)`` from
its refill thread while the consumer takes them, so the buffer is guarded
by a lock.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import blinding as B
from repro_torch.core import integrity as IG
from repro_torch.kernels.limb_matmul.ops import encode_weight_planes, field_matmul


@dataclass(frozen=True)
class CachedLayer:
    """Per-blinded-op static material. ``unblinded``: verified-open slot
    (zero pad). ``policy``: this op's Freivalds policy (``None`` inherits
    the cache-wide one)."""
    t: int                      # activation rows (batch-shape dependent)
    d_in: int
    d_out: int
    w_q: torch.Tensor           # (d_in, d_out) int32 field
    w_limbs: torch.Tensor       # (3, Kp, d_out) int8, padded to the plan
    w_scale: torch.Tensor       # () float32 absmax scale
    unblinded: bool = False
    policy: Optional[IG.IntegrityPolicy] = None


class BlindedLayerCache:
    """Quantize-once weight cache + per-session blinding-factor store."""

    # a session's r tensors can pin hundreds of MB at full width; double
    # buffering needs one set in flight, two leave slack
    MAX_PREFETCHED = 2

    def __init__(self, layers: List[CachedLayer], spec: B.BlindingSpec,
                 integrity: Optional[IG.IntegrityPolicy] = None):
        self.layers = layers
        self.spec = spec
        self.integrity = integrity or IG.IntegrityPolicy.off()
        # the offload plane's shard count (core/origami.py sets it): above 1
        # each factor set also carries per-shard fold vectors
        self.shards = 1
        self.factor_matmuls = 0          # r@W_q matmuls issued off-path
        self.fold_matmuls = 0            # W_q@s fold matmuls issued off-path
        self._ready: Dict[Tuple[bytes, int], List[Dict[str, Any]]] = {}
        self._max_prefetched = self.MAX_PREFETCHED
        self._lock = threading.Lock()

    @classmethod
    def from_records(cls, records: List[Dict[str, Any]], spec: B.BlindingSpec,
                     integrity: Optional[IG.IntegrityPolicy] = None
                     ) -> "BlindedLayerCache":
        """records: one {"kind", "w", "t", "d_in", "d_out"} per offloaded
        op in call order (models/vgg.py:blinded_op_records), optionally
        with "unblinded" and "policy". Conv records carry the raw HWIO
        weight; the im2col column order is applied here."""
        from repro_torch.core.slalom import conv_weight_cols
        layers = []
        for rec in records:
            w = (conv_weight_cols(rec["w"]) if rec["kind"] == "conv"
                 else rec["w"])
            w_q, w_scale = B.quantize_weight(w, spec)
            layers.append(CachedLayer(
                t=rec["t"], d_in=rec["d_in"], d_out=rec["d_out"],
                w_q=w_q, w_limbs=encode_weight_planes(w_q), w_scale=w_scale,
                unblinded=bool(rec.get("unblinded", False)),
                policy=rec.get("policy")))
        return cls(layers, spec, integrity=integrity)

    @staticmethod
    def _skey(session_key, step: int) -> Tuple[bytes, int]:
        return np.asarray(session_key, np.uint32).tobytes(), step

    def session_factors(self, session_key, step: int = 0) -> List[Dict]:
        """(r, u) — under an integrity policy (s, ws), and with
        ``shards`` > 1 the per-shard (s_j, ws_j) — for every cached layer,
        on the device that holds its weights."""
        factors = []
        for i, lyr in enumerate(self.layers):
            dev = lyr.w_q.device
            if lyr.unblinded:
                r = u = None     # zero pad: the consumer makes the zeros
            else:
                key = B.stream_key(session_key, i, step)
                r = B.blinding_stream(key, (lyr.t, lyr.d_in), device=dev)
                u = field_matmul(r, lyr.w_q)
                with self._lock:     # a ring's refill thread counts too
                    self.factor_matmuls += 1
            entry = {"r": r, "u": u, "w_q": lyr.w_q,
                     "w_limbs": lyr.w_limbs, "w_scale": lyr.w_scale}
            pol = lyr.policy if lyr.policy is not None else self.integrity
            if pol.enabled:
                entry["s"] = IG.fold_stream(session_key, i, step, lyr.d_out,
                                            pol.k, device=dev)
                entry["ws"] = field_matmul(lyr.w_q, entry["s"])
                with self._lock:
                    self.fold_matmuls += 1
            if self.shards > 1:
                # shards are always checked: k falls back to 1 with the
                # policy off
                k = pol.k if pol.enabled else 1
                folds = []
                for j in range(self.shards):
                    s_j = IG.shard_fold_stream(session_key, i, step, j,
                                               lyr.d_out, k, device=dev)
                    folds.append((s_j, field_matmul(lyr.w_q, s_j)))
                    with self._lock:
                        self.fold_matmuls += 1
                entry["shard_folds"] = folds
            factors.append(entry)
        return factors

    @property
    def max_prefetched(self) -> int:
        """Buffered factor sets before the oldest is evicted (a
        TokenSlotRing raises it to its depth)."""
        return self._max_prefetched

    @max_prefetched.setter
    def max_prefetched(self, n: int) -> None:
        self._max_prefetched = max(1, int(n))

    def prefetch(self, session_key, step: int = 0) -> None:
        """Compute a future session's factors now (evicting the oldest
        buffered set beyond ``max_prefetched``)."""
        k = self._skey(session_key, step)
        with self._lock:
            if k in self._ready:
                return
        factors = self.session_factors(session_key, step)
        with self._lock:
            while len(self._ready) >= self._max_prefetched:
                self._ready.pop(next(iter(self._ready)))
            self._ready.setdefault(k, factors)

    def prefetched(self, session_key, step: int = 0) -> bool:
        with self._lock:
            return self._skey(session_key, step) in self._ready

    def clear_prefetch(self) -> None:
        """Drop all buffered factor sets (e.g. when a server goes idle)."""
        with self._lock:
            self._ready.clear()

    def discard(self, session_key, step: int = 0) -> None:
        """Drop a prefetched set that will never be taken."""
        with self._lock:
            self._ready.pop(self._skey(session_key, step), None)

    def take(self, session_key, step: int = 0) -> List[Dict]:
        """Pop prefetched factors for this session, or compute them now."""
        with self._lock:
            hit = self._ready.pop(self._skey(session_key, step), None)
        return hit or self.session_factors(session_key, step)

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    def weight_bytes(self) -> int:
        """Cache footprint of the static half (w_q + limb planes + scale)."""
        return sum(lyr.w_q.numel() * 4 + lyr.w_limbs.numel() + 4
                   for lyr in self.layers)
