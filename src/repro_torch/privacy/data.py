"""Synthetic procedural image dataset for the c-GAN privacy evaluation.

Port of ``repro/privacy/data.py`` (a copy: numpy only, and the port imports
nothing of the reference). ImageNet is not available offline; reconstruction-learnability only needs a
*structured, diverse* distribution, so we generate colored geometric scenes
(gradient background + rectangles + circles + stripes) deterministically
from an index. SSIM trends across partition layers are what the paper's
Fig. 7/8 measure, and these transfer: early conv features retain the scene
geometry, deep/pooled features do not.
"""
from __future__ import annotations

import numpy as np


def make_image(idx: int, size: int = 32) -> np.ndarray:
    rng = np.random.default_rng(1_000_003 * idx + 17)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = np.zeros((size, size, 3), np.float32)
    # gradient background
    c0, c1 = rng.random(3), rng.random(3)
    ang = rng.random() * 2 * np.pi
    t = (np.cos(ang) * xx + np.sin(ang) * yy)
    t = (t - t.min()) / (np.ptp(t) + 1e-9)
    img += c0 * (1 - t[..., None]) + c1 * t[..., None]
    # rectangles
    for _ in range(rng.integers(1, 4)):
        x0, y0 = rng.integers(0, size - 4, 2)
        w, h = rng.integers(3, size // 2, 2)
        img[y0:y0 + h, x0:x0 + w] = rng.random(3)
    # circle
    for _ in range(rng.integers(1, 3)):
        cx, cy = rng.random(2) * size
        r = rng.random() * size / 3 + 2
        mask = (xx * size - cx) ** 2 + (yy * size - cy) ** 2 < r ** 2
        img[mask] = rng.random(3)
    # stripes
    if rng.random() < 0.5:
        period = rng.integers(2, 6)
        phase = rng.integers(0, period)
        stripe = ((np.arange(size) + phase) // period) % 2 == 0
        img[:, stripe] = 0.7 * img[:, stripe] + 0.3 * rng.random(3)
    return np.clip(img, 0.0, 1.0)


def make_batch(start: int, n: int, size: int = 32) -> np.ndarray:
    return np.stack([make_image(start + i, size) for i in range(n)])


def dataset(n: int, size: int = 32, seed_offset: int = 0) -> np.ndarray:
    return make_batch(seed_offset, n, size)
