"""Conditional GAN adversary (paper §IV/§V): reconstruct X from Θ(X).

Port of ``repro/privacy/cgan.py``, NHWC like the reference. Generator:
encoder convs -> residual blocks -> nearest-upsample decoder (paper Fig.
6). Discriminator: downsampling convs on the image, the condition feature
map concatenated at matching spatial resolution, convs -> mean over H and
W -> dense -> logit (paper §V-A).

Training uses the non-saturating GAN loss plus a λ·L1 reconstruction term
(pix2pix-style). The L1 term only *strengthens* the adversary, so SSIM
numbers remain a conservative privacy bound.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.models import layers as L


# ----------------------------------------------------------------------------
# param defs
# ----------------------------------------------------------------------------

def _conv(cin, cout, k=3):
    return L.conv_def(cin, cout, k)


def generator_defs(feat_hw: int, feat_c: int, img_size: int = 32,
                   width: int = 32):
    """feat_hw: spatial size of the condition feature map Θ(X)."""
    n_down = max(0, int(math.log2(max(feat_hw // 4, 1))))
    n_up = int(math.log2(img_size / (feat_hw / (2 ** n_down))))
    d: Dict[str, object] = {"in": _conv(feat_c, width)}
    c = width
    for i in range(n_down):
        d[f"down{i}"] = _conv(c, min(2 * c, 128))
        c = min(2 * c, 128)
    for i in range(2):
        d[f"res{i}a"] = _conv(c, c)
        d[f"res{i}b"] = _conv(c, c)
    for i in range(n_up):
        nc = max(c // 2, width)
        d[f"up{i}"] = _conv(c, nc)
        c = nc
    d["out"] = _conv(c, 3)
    return d, (n_down, n_up)


def resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(x, (B, h, w, C), "nearest")`` of NHWC ``x``:
    half-pixel centres, output index i reads input
    floor((i + 0.5) * in / out), computed in float32 as jax computes it.
    An upsampling by a whole factor k reads input i // k: it repeats each
    row k times by ``expand``, whose backward is a plain sum (index_select's
    is ``index_add_``, with atomics on the card: not repeatable)."""
    for dim, n in ((1, h), (2, w)):
        m = x.shape[dim]
        if m == n:
            continue
        if n % m == 0:
            k = n // m
            shape = list(x.shape)
            x = x.unsqueeze(dim + 1).expand(*shape[:dim + 1], k,
                                            *shape[dim + 1:])
            x = x.flatten(dim, dim + 1)
            continue
        pos = (torch.arange(n, dtype=torch.float32, device=x.device)
               + 0.5) * m / n
        x = x.index_select(dim, torch.floor(pos).to(torch.long))
    return x


def _leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """``jax.nn.leaky_relu``: its gradient at 0 is 1."""
    return torch.where(x >= 0, x, slope * x)


def generator_apply(p, feat: torch.Tensor,
                    shape_meta: Tuple[int, int]) -> torch.Tensor:
    n_down, n_up = shape_meta
    x = torch.relu(L.conv2d(p["in"], feat.to(torch.float32)))
    for i in range(n_down):
        x = torch.relu(L.conv2d(p[f"down{i}"], x, stride=2))
    for i in range(2):
        h = torch.relu(L.conv2d(p[f"res{i}a"], x))
        x = x + L.conv2d(p[f"res{i}b"], h)
    for i in range(n_up):
        x = resize_nearest(x, 2 * x.shape[1], 2 * x.shape[2])
        x = torch.relu(L.conv2d(p[f"up{i}"], x))
    return torch.sigmoid(L.conv2d(p["out"], x))


def discriminator_defs(feat_hw: int, feat_c: int, img_size: int = 32,
                       width: int = 32):
    n_down = int(math.log2(img_size / feat_hw)) if feat_hw < img_size else 0
    d: Dict[str, object] = {"in": _conv(3, width, k=4)}
    c = width
    for i in range(n_down):
        d[f"down{i}"] = _conv(c, min(2 * c, 128), k=4)
        c = min(2 * c, 128)
    d["merge"] = _conv(c + feat_c, 128, k=4)
    d["conv2"] = _conv(128, 128, k=4)
    d["head"] = L.dense_def(128, 1, ("embed", None), bias=True)
    return d, n_down


def discriminator_apply(p, img: torch.Tensor, feat: torch.Tensor,
                        n_down: int) -> torch.Tensor:
    x = _leaky_relu(L.conv2d(p["in"], img.to(torch.float32)))
    for i in range(n_down):
        x = _leaky_relu(L.conv2d(p[f"down{i}"], x, stride=2))
    if feat.shape[1] != x.shape[1]:     # align spatial dims if off by 2^k
        feat = resize_nearest(feat, x.shape[1], x.shape[2])
    x = torch.cat([x, feat.to(torch.float32)], dim=-1)
    x = _leaky_relu(L.conv2d(p["merge"], x))
    x = _leaky_relu(L.conv2d(p["conv2"], x, stride=2))
    x = torch.mean(x, dim=(1, 2))
    return L.dense(p["head"], x)[:, 0]


# ----------------------------------------------------------------------------
# losses
# ----------------------------------------------------------------------------

def bce_logits(logit: torch.Tensor, target: float) -> torch.Tensor:
    return torch.mean(torch.maximum(logit, torch.zeros_like(logit))
                      - logit * target
                      + torch.log1p(torch.exp(-torch.abs(logit))))


def g_loss_fn(gp, dp, feat, real, meta_g, meta_d, l1_weight: float = 50.0):
    fake = generator_apply(gp, feat, meta_g)
    adv = bce_logits(discriminator_apply(dp, fake, feat, meta_d), 1.0)
    l1 = torch.mean(torch.abs(fake - real))
    return adv + l1_weight * l1, fake


def d_loss_fn(dp, gp, feat, real, meta_g, meta_d):
    fake = generator_apply(gp, feat, meta_g).detach()
    lr_ = bce_logits(discriminator_apply(dp, real, feat, meta_d), 1.0)
    lf = bce_logits(discriminator_apply(dp, fake, feat, meta_d), 0.0)
    return lr_ + lf
