"""Wrappers of the blinding kernels (``csrc/blind_encode.cu``,
``csrc/blind.cu``).

Ports of ``repro/kernels/blind/blind.py``:

- ``blind_encode`` (``blind_encode_pallas``): scale, quantize, blind and
  limb-encode the activations in one pass, emitting the ``(3, M, Kp)``
  int8 planes the limb matmul reads (the fused data path);
- ``blind`` (``blind_pallas``) and ``unblind`` (``unblind_pallas``): the
  elementwise blind and unblind + dequantize passes of the unfused data
  path, on tensors of any shape.

Each launches its kernel for a CUDA tensor and takes the ``*_plain``
version beside it for a CPU tensor; there is no fallback between the two.
``blind`` and ``unblind`` record ``kernel.blind_encode`` and
``kernel.unblind`` spans (the reference's names) when a tracer with kernel
spans is ambient (core/tracing.profiled_kernel).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import tracing
from repro_torch.kernels import build as KB
from repro_torch.kernels.blind.ref import (blind_encode_ref, blind_ref,
                                           unblind_ref)


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
    KB.launch("blind_encode", x, x.data_ptr(), r.data_ptr(),
              inv_scale.data_ptr(), out.data_ptr(), M, K, Kp, k_bits)
    return out


def blind_plain(x: torch.Tensor, r: torch.Tensor, k_bits: int) -> torch.Tensor:
    """Plain PyTorch version of ``blind`` (the oracle)."""
    return blind_ref(x, r, k_bits)


def blind(x: torch.Tensor, r: torch.Tensor, k_bits: int) -> torch.Tensor:
    """x: float32 (...); r: int32 field (...) in [0, p), same shape.
    Returns the blinded int32 field ``(quantize(x, k) mod p + r) mod p``."""
    return tracing.profiled_kernel("kernel.blind_encode", _blind, x, r,
                                   k_bits)


def _blind(x: torch.Tensor, r: torch.Tensor, k_bits: int) -> torch.Tensor:
    if KB.on_cpu(x):
        return blind_plain(x, r, k_bits)
    KB.require(x, "x", torch.float32, x.device)
    KB.require(r, "r", torch.int32, x.device)
    if r.shape != x.shape:
        raise ValueError(f"shapes x {tuple(x.shape)}, r {tuple(r.shape)}")
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    KB.launch("blind", x, x.data_ptr(), r.data_ptr(), out.data_ptr(),
              x.numel(), k_bits)
    return out


def unblind_plain(y: torch.Tensor, u: torch.Tensor,
                  k_out_bits: int) -> torch.Tensor:
    """Plain PyTorch version of ``unblind`` (the oracle), float32."""
    return unblind_ref(y, u, k_out_bits, torch.float32)


def unblind(y: torch.Tensor, u: torch.Tensor, k_out_bits: int) -> torch.Tensor:
    """y, u: int32 field (...) in [0, p), same shape. Returns float32
    ``signed((y - u + p) mod p) / 2^k_out``."""
    return tracing.profiled_kernel("kernel.unblind", _unblind, y, u,
                                   k_out_bits)


def _unblind(y: torch.Tensor, u: torch.Tensor, k_out_bits: int) -> torch.Tensor:
    if KB.on_cpu(y):
        return unblind_plain(y, u, k_out_bits)
    KB.require(y, "y", torch.int32, y.device)
    KB.require(u, "u", torch.int32, y.device)
    if u.shape != y.shape:
        raise ValueError(f"shapes y {tuple(y.shape)}, u {tuple(u.shape)}")
    out = torch.empty(y.shape, dtype=torch.float32, device=y.device)
    KB.launch("unblind", y, y.data_ptr(), u.data_ptr(), out.data_ptr(),
              y.numel(), k_out_bits)
    return out
