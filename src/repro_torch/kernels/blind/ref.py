"""Plain PyTorch oracle for the blind / unblind elementwise ops.

Port of ``repro/kernels/blind/ref.py``:

blind:    y = (round(x * 2^k) mod p + r) mod p          (enclave -> device)
unblind:  x = signed((y - u) mod p) / 2^(k_x + k_w)     (device -> enclave)

``torch.round`` rounds half to even, like ``jnp.round``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.limb_matmul.ref import (HALF, P, from_signed,
                                                 to_limbs, to_signed)


def quantize(x: torch.Tensor, k_bits: int) -> torch.Tensor:
    """float -> signed-canonical field int32 with scale 2^k (clipped)."""
    scaled = torch.round(x.to(torch.float32) * (2.0 ** k_bits))
    return torch.clamp(scaled, -HALF, HALF).to(torch.int32)


def dequantize(s: torch.Tensor, k_bits: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (s.to(torch.float32) / (2.0 ** k_bits)).to(dtype)


def blind_ref(x: torch.Tensor, r: torch.Tensor, k_bits: int) -> torch.Tensor:
    """x float, r field [0, p) -> blinded field [0, p)."""
    return torch.remainder(from_signed(quantize(x, k_bits)) + r, P)


def unblind_ref(y: torch.Tensor, u: torch.Tensor, k_out_bits: int,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """y field, u field -> dequantized float (scale 2^k_out)."""
    return dequantize(to_signed(torch.remainder(y - u + P, P)), k_out_bits,
                      dtype)


def blind_encode_ref(x: torch.Tensor, r: torch.Tensor,
                     inv_scale: torch.Tensor, k_bits: int) -> torch.Tensor:
    """Oracle of the fused scale + quantize + blind + limb-encode kernel.

    x: (M, K) float; r: (M, K) int32 field; inv_scale: 0-d float32
    reciprocal of the activation scale. Returns (3, M, K) int8 limb planes.
    Multiplies by the reciprocal (no division), as the kernel does."""
    xs = x.to(torch.float32) * inv_scale.to(torch.float32).reshape(())
    b = torch.remainder(from_signed(quantize(xs, k_bits)) + r, P)
    return to_limbs(to_signed(b)).permute(2, 0, 1).contiguous()
