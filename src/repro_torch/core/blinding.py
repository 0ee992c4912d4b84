"""Cryptographic blinding: streams, quantized weights, unblinding factors.

Port of ``repro/core/blinding.py``. The blinding stream ``r`` is a one-time
pad over Z_p drawn from the counter-based threefry generator (core/prng.py)
keyed by (session_key, layer, step), so the port draws the reference's
pads bit for bit. For any x_q, (x_q + r) mod p with r uniform is uniform:
the untrusted device sees a one-time pad.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.kernels.blind.blind import blind, unblind
from repro_torch.kernels.limb_matmul.ops import field_matmul
from repro_torch.kernels.limb_matmul.ref import HALF, P, from_signed


@dataclass(frozen=True)
class BlindingSpec:
    """Quantization scales. Combined dot products must stay within ±HALF:
    K * 2^(k_act + k_w) * |x| * |w| < HALF."""
    k_act: int = 8
    k_w: int = 7


def stream_key(session_key: np.ndarray, layer_id: int,
               step: int = 0) -> np.ndarray:
    return prng.fold_in(prng.fold_in(session_key, layer_id), step)


def blinding_stream(key: np.ndarray, shape: Tuple[int, ...],
                    device="cpu") -> torch.Tensor:
    """Uniform field elements in [0, p), int32."""
    return prng.randint(key, shape, 0, P, device=device)


def quantize_weight(w: torch.Tensor, spec: BlindingSpec):
    """float weight -> (W_q in [0, p) int32, 0-d float32 absmax scale),
    with W ≈ signed(W_q) * scale * 2^-k_w. Divides by the scale, as the
    reference does."""
    wf = w.to(torch.float32)
    scale = torch.clamp_min(wf.abs().max(), 1e-9)
    q = torch.clamp(torch.round(wf / scale * (2.0 ** spec.k_w)),
                    -HALF, HALF).to(torch.int32)
    return from_signed(q), scale


def unblinding_factor(r: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """u = (r @ W_q) mod p — the enclave's precomputed factor."""
    return field_matmul(r, w_q)


def blind_activations(x: torch.Tensor, r: torch.Tensor,
                      spec: BlindingSpec) -> torch.Tensor:
    """(quantize(x, k_act) mod p + r) mod p — the unfused path's blind."""
    return blind(x, r, spec.k_act)


def unblind_result(y_b: torch.Tensor, u: torch.Tensor, spec: BlindingSpec,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """signed((y_b - u) mod p) / 2^(k_act + k_w) — the unfused unblind."""
    return unblind(y_b, u, spec.k_act + spec.k_w).to(out_dtype)
