"""Public field-arithmetic ops over the limb kernels.

Port of ``repro/kernels/limb_matmul/ops.py``. Each op limb-encodes and
pads its operands to the port's block plan and calls the kernel wrappers,
which launch the CUDA kernels for CUDA tensors and take their plain
versions for CPU tensors:

- ``field_matmul(x, w)``: (X @ W) mod p — the factors ``u = r @ W_q``, the
  fold material ``ws = W_q @ s`` and the trusted enclave recompute;
- ``fused_blinded_matmul``: ``blind_encode`` then the fused limb matmul —
  the one device op of every blinded layer;
- ``field_fold(x, s)``: the skinny Freivalds fold.

The padding plan is the port's own: only K is padded, to the kernel's
32-digit K tile (the reference pads every dim to 128 lanes, so K = 27
cost 128); M and N are masked inside the kernels. Padding adds zero
digits, so no result depends on the plan.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core import tracing
from repro_torch.kernels.blind.blind import blind_encode
from repro_torch.kernels.limb_matmul import ref
from repro_torch.kernels.limb_matmul.fold import limb_fold_planes
from repro_torch.kernels.limb_matmul.limb_matmul import (
    K_ALIGN, limb_matmul_planes, limb_matmul_planes_fused)

BM = BN = 64            # output tile of the limb matmul kernel

Scalar = Union[float, torch.Tensor]


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def block_plan(M: int, K: int, N: int) -> Tuple[int, int, int, int, int, int]:
    """(bm, bn, bk, Mp, Kp, Np) of the limb matmul: K rounds up to the
    kernel's K tile; M and N are not padded. The (K, N) half does not
    depend on M, so weight planes encoded once line up with activations
    encoded per request."""
    return BM, BN, K_ALIGN, M, _round_up(K, K_ALIGN), N


def field_planes(x_field: torch.Tensor, Kp: int) -> torch.Tensor:
    """(M, K) int32 field matrix -> (3, M, Kp) int8 limb planes."""
    planes = ref.to_limbs(ref.to_signed(x_field)).permute(2, 0, 1)
    return F.pad(planes, (0, Kp - x_field.shape[1])).contiguous()


def encode_weight_planes(w_field: torch.Tensor) -> torch.Tensor:
    """(K, N) int32 field weights -> (3, Kp, N) int8 limb planes padded to
    the block plan. Done once per layer by the precompute cache."""
    K, N = w_field.shape
    Kp = block_plan(1, K, N)[4]
    planes = ref.to_limbs(ref.to_signed(w_field)).permute(2, 0, 1)
    return F.pad(planes, (0, 0, 0, Kp - K)).contiguous()


def field_matmul(x_field: torch.Tensor, w_field: torch.Tensor) -> torch.Tensor:
    """(X @ W) mod p. x: (M, K) int32 in [0, p); w: (K, N) int32 in [0, p).
    Returns (M, N) int32 in [0, p). A ``kernel.limb_matmul`` span when a
    tracer with kernel spans is ambient (core/tracing.profiled_kernel)."""
    return tracing.profiled_kernel("kernel.limb_matmul", _field_matmul,
                                   x_field, w_field)


def _field_matmul(x_field: torch.Tensor, w_field: torch.Tensor) -> torch.Tensor:
    M, K = x_field.shape
    K2, N = w_field.shape
    assert K == K2, (x_field.shape, w_field.shape)
    Kp = block_plan(M, K, N)[4]
    return limb_matmul_planes(field_planes(x_field, Kp),
                              encode_weight_planes(w_field))


def _scalar(v: Scalar, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32,
                           device=like.device).reshape(())


def fused_blinded_matmul(x: torch.Tensor, r: torch.Tensor,
                         w_limbs: torch.Tensor, u: torch.Tensor,
                         inv_scale: Scalar, out_scale: Scalar, *,
                         k_bits: int) -> torch.Tensor:
    """Blind -> limb-encode -> field matmul -> unblind -> dequantize.

    x: (M, K) float activations (unscaled); r: (M, K) int32 blinding
    stream; w_limbs: (3, Kp, N) int8 weight planes (``encode_weight_planes``);
    u: (M, N) int32 unblinding factors; inv_scale: reciprocal of the
    activation scale; out_scale: x_scale * w_scale * 2^-k_out. Returns
    (M, N) float32 ``signed(mod(acc - u + p, p)) * out_scale`` with
    ``acc = (blind(x * inv) @ W) mod p``, the sum taken in wrapping int32
    arithmetic as the reference takes it: any int32 ``u`` gives the
    reference's result, not only u in [0, p). One
    ``kernel.fused_blind_matmul`` span covers both launches.
    """
    return tracing.profiled_kernel(
        "kernel.fused_blind_matmul", _fused_blinded_matmul, x, r, w_limbs, u,
        inv_scale, out_scale, k_bits=k_bits)


def _fused_blinded_matmul(x: torch.Tensor, r: torch.Tensor,
                          w_limbs: torch.Tensor, u: torch.Tensor,
                          inv_scale: Scalar, out_scale: Scalar, *,
                          k_bits: int) -> torch.Tensor:
    M, K = x.shape
    N = u.shape[1]
    Kp = block_plan(M, K, N)[4]
    assert tuple(w_limbs.shape) == (3, Kp, N), (tuple(w_limbs.shape), Kp, N)
    xl = blind_encode(x.to(torch.float32).contiguous(), r.contiguous(),
                      _scalar(inv_scale, x), k_bits, Kp)
    return limb_matmul_planes_fused(xl, w_limbs, u.contiguous(),
                                    _scalar(out_scale, x))


def field_fold(x_field: torch.Tensor, s_field: torch.Tensor) -> torch.Tensor:
    """Freivalds fold (X @ S) mod p for a skinny fold matrix.

    x_field: (M, K) int32 in [0, p); s_field: (K, kf) int32 in [0, p).
    Returns (M, kf) int32 in [0, p). A ``kernel.fold`` span when traced."""
    return tracing.profiled_kernel("kernel.fold", _field_fold, x_field,
                                   s_field)


def _field_fold(x_field: torch.Tensor, s_field: torch.Tensor) -> torch.Tensor:
    M, K = x_field.shape
    K2, kf = s_field.shape
    assert K == K2, (x_field.shape, s_field.shape)
    s_planes = encode_weight_planes(s_field)
    return limb_fold_planes(field_planes(x_field, s_planes.shape[1]),
                            s_planes)
