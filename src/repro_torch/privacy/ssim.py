"""SSIM (Wang et al. 2004), the paper's reconstruction metric.

Port of ``repro/privacy/ssim.py``: the local means are a depthwise
``conv2d`` with a uniform window over NHWC images, zero-padded as XLA's
SAME padding pads ((win - 1) // 2 before, win // 2 after) and divided by
the in-bounds window mass, so border statistics are not deflated.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _avg_pool_same(x: torch.Tensor, win: int) -> torch.Tensor:
    """Uniform-window local mean of (B, H, W, C), SAME padding, normalized
    by the true in-bounds window mass."""
    c = x.shape[-1]
    lo, hi = (win - 1) // 2, win // 2
    pad = (lo, hi, lo, hi)
    k = torch.ones((c, 1, win, win), dtype=x.dtype, device=x.device)
    sums = F.conv2d(F.pad(x.permute(0, 3, 1, 2), pad), k, groups=c)
    ones = torch.ones((1, 1) + tuple(x.shape[1:3]), dtype=x.dtype,
                      device=x.device)
    counts = F.conv2d(F.pad(ones, pad), k[:1])
    return (sums / counts).permute(0, 2, 3, 1)


def ssim(x: torch.Tensor, y: torch.Tensor, *, win: int = 7,
         data_range: float = 1.0) -> torch.Tensor:
    """Mean SSIM over the batch. x, y: (B, H, W, C) in [0, data_range]."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mx = _avg_pool_same(x, win)
    my = _avg_pool_same(y, win)
    mxx = _avg_pool_same(x * x, win)
    myy = _avg_pool_same(y * y, win)
    mxy = _avg_pool_same(x * y, win)
    vx = mxx - mx * mx
    vy = myy - my * my
    cxy = mxy - mx * my
    s = ((2 * mx * my + c1) * (2 * cxy + c2)
         / ((mx * mx + my * my + c1) * (vx + vy + c2)))
    return s.mean()


def ssim_per_image(x: torch.Tensor, y: torch.Tensor, *, win: int = 7,
                   data_range: float = 1.0) -> torch.Tensor:
    """SSIM of each image pair, (B,)."""
    return torch.stack([ssim(a[None], b[None], win=win,
                             data_range=data_range) for a, b in zip(x, y)])
