"""Plain PyTorch oracle for the blinded modular matmul (Z_p, p = 2^23 - 15).

Port of ``repro/kernels/limb_matmul/ref.py``. Signed-canonical field
elements s in [-(p-1)/2, (p-1)/2] are written in balanced base-256: three
int8 digits l0 + 256*l1 + 65536*l2 with l_i in [-128, 127]. A field matmul
is nine limb products P_ij = X_i @ W_j recombined as
sum_ij P_ij * 256^(i+j) mod p.

Field tensors are int32 in [0, p). ``torch.remainder`` (never ``fmod``)
keeps the divisor's sign, like ``jnp.mod``. The limb products run as
float64 GEMMs, which are exact: every partial sum is at most K * 2^14,
far below 2^53, and PyTorch has no integer matmul on CUDA.
"""
from __future__ import annotations

import torch

P = (1 << 23) - 15           # 8388593, prime
HALF = (P - 1) // 2          # signed-canonical bound
MAX_K = 1 << 17              # int32 accumulation bound of the reference

# 256^s mod p for the five limb powers s = i + j (2^23 = p + 15, so
# 256^3 = 2^24 is 30 and 256^4 is 30 * 256 mod p)
POW256 = (1, 256, 65536, 30, 7680)


def to_signed(v: torch.Tensor) -> torch.Tensor:
    """Field element [0, p) -> signed canonical [-(p-1)/2, (p-1)/2]."""
    v = v.to(torch.int32)
    return torch.where(v > HALF, v - P, v)


def from_signed(s: torch.Tensor) -> torch.Tensor:
    """Signed canonical -> [0, p)."""
    return torch.remainder(s.to(torch.int32), P)


def to_limbs(s: torch.Tensor) -> torch.Tensor:
    """Signed canonical int32 -> (..., 3) int8 balanced base-256 digits.

    ``(v & 255)`` is ``v mod 256`` in two's complement and ``(s - l0) >> 8``
    is an exact division (arithmetic shift of a multiple of 256)."""
    s = s.to(torch.int32)
    l0 = ((s + 128) & 255) - 128
    s1 = (s - l0) >> 8
    l1 = ((s1 + 128) & 255) - 128
    s2 = (s1 - l1) >> 8
    return torch.stack([l0, l1, s2], dim=-1).to(torch.int8)


def from_limbs(limbs: torch.Tensor) -> torch.Tensor:
    """(..., 3) int8 -> signed canonical int32."""
    l = limbs.to(torch.int32)
    return l[..., 0] + 256 * l[..., 1] + 65536 * l[..., 2]


def mod_mul_pow256(y: torch.Tensor, k: int) -> torch.Tensor:
    """(y * 256**k) mod p without int32 overflow, y in [0, p)."""
    y = y.to(torch.int32)
    for _ in range(k):
        y = torch.remainder(y * 256, P)      # y*256 < 2^31
    return y


def limb_product(xl: torch.Tensor, wl: torch.Tensor) -> torch.Tensor:
    """Field product of limb planes: xl (3, M, K), wl (3, K, N) int8 ->
    (M, N) int32 in [0, p).

    The nine float64 products are grouped by limb power s = i + j; a group
    sum is at most 3 * K * 2^14 in magnitude, exact in float64 and in
    int64. Each group is reduced mod p and shifted by 256^s mod p."""
    xf = xl.to(torch.float64)
    wf = wl.to(torch.float64)
    acc = torch.zeros((xl.shape[1], wl.shape[2]), dtype=torch.int32,
                      device=xl.device)
    for s in range(5):
        g = None
        for i in range(max(0, s - 2), min(2, s) + 1):
            pij = xf[i] @ wf[s - i]
            g = pij if g is None else g + pij
        gs = torch.remainder(g.to(torch.int64), P).to(torch.int32)
        acc = torch.remainder(acc + mod_mul_pow256(gs, s), P)
    return acc


def field_matmul_ref(x_field: torch.Tensor,
                     w_field: torch.Tensor) -> torch.Tensor:
    """Exact (X @ W) mod p for field matrices in [0, p).

    x_field: (M, K) int32; w_field: (K, N) int32, K <= 2^17."""
    K = x_field.shape[-1]
    assert K <= MAX_K, f"K={K} exceeds the exactness bound {MAX_K}"
    xl = to_limbs(to_signed(x_field)).permute(2, 0, 1)     # (3, M, K)
    wl = to_limbs(to_signed(w_field)).permute(2, 0, 1)     # (3, K, N)
    return limb_product(xl, wl)


def field_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.remainder(a.to(torch.int32) + b.to(torch.int32), P)


def field_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.remainder(a.to(torch.int32) - b.to(torch.int32), P)
