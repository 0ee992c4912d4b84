"""Wrappers of the ``limb_matmul`` CUDA kernels (``csrc/limb_matmul.cu``).

Ports of ``repro/kernels/limb_matmul/limb_matmul.py``:

- ``limb_matmul_planes``: field product of limb planes, (M, N) int32 in
  [0, p) (``limb_matmul_planes`` on the TPU);
- ``limb_matmul_planes_fused``: the same product with the unblind +
  dequantize epilogue, (M, N) float32 (``limb_matmul_planes_fused``).

Planes keep the reference layout, x (3, M, Kp) and w (3, Kp, N) int8 with
Kp a multiple of ``K_ALIGN`` (ops.py pads); the kernel reads the weight
planes transposed to (3, N, Kp). A CUDA tensor launches the kernel, a CPU
tensor takes the ``*_plain`` version beside it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as KB
from repro_torch.kernels.limb_matmul.ref import limb_product, to_signed, P

K_ALIGN = 32            # the kernel's K tile: Kp must be a multiple of it


def _check_planes(x_limbs: torch.Tensor, w_limbs: torch.Tensor) -> None:
    KB.require(x_limbs, "x_limbs", torch.int8, x_limbs.device, 3)
    KB.require(w_limbs, "w_limbs", torch.int8, x_limbs.device, 3)
    if (x_limbs.shape[0] != 3 or w_limbs.shape[0] != 3
            or x_limbs.shape[2] != w_limbs.shape[1]
            or x_limbs.shape[2] % K_ALIGN):
        raise ValueError(f"limb planes {tuple(x_limbs.shape)} x "
                         f"{tuple(w_limbs.shape)}: need (3, M, Kp) x "
                         f"(3, Kp, N) with Kp % {K_ALIGN} == 0")


def limb_matmul_planes_plain(x_limbs: torch.Tensor,
                             w_limbs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: exact float64 limb products (ref.py)."""
    return limb_product(x_limbs, w_limbs)


def limb_matmul_planes(x_limbs: torch.Tensor,
                       w_limbs: torch.Tensor) -> torch.Tensor:
    """x_limbs: (3, M, Kp) int8; w_limbs: (3, Kp, N) int8 ->
    (M, N) int32 field product in [0, p)."""
    if KB.on_cpu(x_limbs):
        return limb_matmul_planes_plain(x_limbs, w_limbs)
    _check_planes(x_limbs, w_limbs)
    _, M, Kp = x_limbs.shape
    N = w_limbs.shape[2]
    # the kernel copies the planes in 16-byte chunks
    x_limbs = KB.aligned16(x_limbs)
    w_t = KB.aligned16(w_limbs.transpose(1, 2).contiguous())
    out = torch.empty((M, N), dtype=torch.int32, device=x_limbs.device)
    KB.launch("limb_matmul", x_limbs, x_limbs.data_ptr(), w_t.data_ptr(),
              out.data_ptr(), M, N, Kp)
    return out


def wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values taken mod 2^32 into [-2^31, 2^31): int32 wraparound."""
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def limb_matmul_planes_fused_plain(x_limbs: torch.Tensor,
                                   w_limbs: torch.Tensor, u: torch.Tensor,
                                   scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the fused epilogue, the reference's
    ``mod(acc - u + p, p)`` with ``acc - u + p`` wrapping in int32, signed,
    times ``scale`` (one float32 multiply)."""
    acc = limb_product(x_limbs, w_limbs)
    d = wrap_int32(acc.to(torch.int64) - u.to(torch.int64) + P)
    s = to_signed(torch.remainder(d, P).to(torch.int32))
    return s.to(torch.float32) * scale.to(torch.float32).reshape(())


def limb_matmul_planes_fused(x_limbs: torch.Tensor, w_limbs: torch.Tensor,
                             u: torch.Tensor,
                             scale: torch.Tensor) -> torch.Tensor:
    """Field matmul with the fused unblind + dequantize epilogue.

    u: (M, N) int32, any value: the epilogue computes the reference's
    ``mod(acc - u + p, p)`` with the sum wrapping in int32 (one integer
    remainder per output); scale: 0-d float32 on the planes' device.
    Returns (M, N) float32."""
    if KB.on_cpu(x_limbs):
        return limb_matmul_planes_fused_plain(x_limbs, w_limbs, u, scale)
    _check_planes(x_limbs, w_limbs)
    _, M, Kp = x_limbs.shape
    N = w_limbs.shape[2]
    KB.require(u, "u", torch.int32, x_limbs.device, 2)
    KB.require(scale, "scale", torch.float32, x_limbs.device)
    if tuple(u.shape) != (M, N) or scale.numel() != 1:
        raise ValueError(f"u {tuple(u.shape)} (want {(M, N)}), scale "
                         f"{tuple(scale.shape)}")
    # the kernel copies the planes in 16-byte chunks
    x_limbs = KB.aligned16(x_limbs)
    w_t = KB.aligned16(w_limbs.transpose(1, 2).contiguous())
    out = torch.empty((M, N), dtype=torch.float32, device=x_limbs.device)
    KB.launch("limb_matmul_fused", x_limbs, x_limbs.data_ptr(),
              w_t.data_ptr(), u.data_ptr(), scale.data_ptr(), out.data_ptr(),
              M, N, Kp)
    return out
