"""Wrapper of the ``blind_encode`` CUDA kernel (``csrc/blind_encode.cu``).

Port of ``repro/kernels/blind/blind.py:blind_encode_pallas``: scale,
quantize, blind and limb-encode the activations in one pass, emitting the
``(3, M, Kp)`` int8 planes the limb matmul reads. ``blind_encode`` launches
the kernel for a CUDA tensor and takes ``blind_encode_plain`` for a CPU
tensor; there is no fallback between the two.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build as KB
from repro_torch.kernels.blind.ref import blind_encode_ref


def blind_encode_plain(x: torch.Tensor, r: torch.Tensor,
                       inv_scale: torch.Tensor, k_bits: int,
                       Kp: int) -> torch.Tensor:
    """Plain PyTorch version: the oracle's planes, zero-padded to Kp."""
    planes = blind_encode_ref(x, r, inv_scale, k_bits)
    return F.pad(planes, (0, Kp - x.shape[1]))


def blind_encode(x: torch.Tensor, r: torch.Tensor, inv_scale: torch.Tensor,
                 k_bits: int, Kp: int) -> torch.Tensor:
    """x: (M, K) float32; r: (M, K) int32 in [0, p); inv_scale: 0-d
    float32 on x's device; Kp >= K. Returns (3, M, Kp) int8 limb planes of
    the blinded activations (zero digits in columns K..Kp-1)."""
    M, K = x.shape
    assert Kp >= K, (Kp, K)
    if KB.on_cpu(x):
        return blind_encode_plain(x, r, inv_scale, k_bits, Kp)
    KB.require(x, "x", torch.float32, x.device, 2)
    KB.require(r, "r", torch.int32, x.device, 2)
    KB.require(inv_scale, "inv_scale", torch.float32, x.device)
    if r.shape != x.shape or inv_scale.numel() != 1:
        raise ValueError(f"shapes x {tuple(x.shape)}, r {tuple(r.shape)}, "
                         f"inv_scale {tuple(inv_scale.shape)}")
    out = torch.empty((3, M, Kp), dtype=torch.int8, device=x.device)
    code = KB.lib().repro_blind_encode(
        x.data_ptr(), r.data_ptr(), inv_scale.data_ptr(), out.data_ptr(),
        M, K, Kp, k_bits, KB.stream(x))
    KB.check(code, "blind_encode")
    KB.LAUNCHES["blind_encode"] += 1
    return out
