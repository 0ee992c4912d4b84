"""Wrapper of the ``limb_fold`` CUDA kernel (``csrc/limb_fold.cu``).

Port of ``repro/kernels/limb_matmul/fold.py:limb_fold_planes``: the
Freivalds fold ``(Y @ S) mod p`` of a (3, M, Kp) limb-plane operand against
a skinny (3, Kp, kf) fold matrix. The kernel folds up to ``FOLD_COLS``
columns a launch (on the tensor cores, 16 or 64 rows of Y a block); wider
fold matrices go in groups.
A CPU tensor takes ``limb_fold_planes_plain``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as KB
from repro_torch.kernels.limb_matmul.limb_matmul import K_ALIGN
from repro_torch.kernels.limb_matmul.ref import limb_product

FOLD_COLS = 4
MAX_KP = 1 << 20        # the deepest fold a launch takes


def limb_fold_planes_plain(x_limbs: torch.Tensor,
                           s_limbs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: exact float64 limb products (ref.py)."""
    return limb_product(x_limbs, s_limbs)


def limb_fold_planes(x_limbs: torch.Tensor,
                     s_limbs: torch.Tensor) -> torch.Tensor:
    """x_limbs: (3, M, Kp) int8; s_limbs: (3, Kp, kf) int8 ->
    (M, kf) int32 in [0, p)."""
    if KB.on_cpu(x_limbs):
        return limb_fold_planes_plain(x_limbs, s_limbs)
    KB.require(x_limbs, "x_limbs", torch.int8, x_limbs.device, 3)
    KB.require(s_limbs, "s_limbs", torch.int8, x_limbs.device, 3)
    _, M, Kp = x_limbs.shape
    kf = s_limbs.shape[2]
    if (x_limbs.shape[0] != 3 or s_limbs.shape[:2] != (3, Kp)
            or Kp % K_ALIGN or Kp > MAX_KP or kf < 1):
        raise ValueError(f"fold planes {tuple(x_limbs.shape)} x "
                         f"{tuple(s_limbs.shape)}: need (3, M, Kp) x "
                         f"(3, Kp, kf), Kp % {K_ALIGN} == 0, Kp <= {MAX_KP}")
    # the kernel copies the planes in 16-byte chunks
    x_limbs = KB.aligned16(x_limbs)
    outs = []
    for c0 in range(0, kf, FOLD_COLS):
        s_t = KB.aligned16(
            s_limbs[:, :, c0:c0 + FOLD_COLS].transpose(1, 2).contiguous())
        cols = s_t.shape[1]
        out = torch.empty((M, cols), dtype=torch.int32,
                          device=x_limbs.device)
        KB.launch("limb_fold", x_limbs, x_limbs.data_ptr(), s_t.data_ptr(),
                  out.data_ptr(), M, Kp, cols)
        outs.append(out)
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
