"""Counter-based threefry2x32, bit-equal to the ``jax.random`` calls the
serving path uses (``PRNGKey``, ``fold_in``, ``split``, ``bits``,
``randint``, ``uniform``) and the sampler of token generation
(``gumbel``, ``categorical``).

The keystream and MAC of the request channel (core/sealing.py), the
blinding pads (core/blinding.py) and the Freivalds fold vectors
(core/integrity.py) all come from this generator, so a port that draws
the same numbers as the reference can be held bit-for-bit against it, and
a request sealed by one package opens under the other. Unlike a
``torch.Generator`` the stream does not depend on the device.

Keys are host-side ``(2,)`` uint32 numpy arrays (the raw data of a jax
threefry key); key derivations run on Python ints. Bulk draws run as
int64 torch ops masked to 32 bits, on the device the caller names
(PyTorch's uint32 support is partial). The partitionable counter layout
is the one ``jax_threefry_partitionable=True`` selects, the default of
current jax.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

PARTITIONABLE = True         # counter layout of jax_threefry_partitionable
MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Word = Union[int, torch.Tensor]


def _threefry2x32(k0: int, k1: int, x0: Word, x1: Word) -> Tuple[Word, Word]:
    """Threefry-2x32 hash (20 rounds) of counter words (x0, x1) under the
    key (k0, k1). Works on Python ints and on int64 tensors of values in
    [0, 2^32); every step is masked back to 32 bits."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def _key_words(key) -> Tuple[int, int]:
    k = np.asarray(key, dtype=np.uint32).reshape(2)
    return int(k[0]), int(k[1])


def _as_key(k0: int, k1: int) -> np.ndarray:
    return np.asarray([k0, k1], dtype=np.uint32)


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` with 32-bit jax types: the seed is
    taken as a 32-bit integer, so the high key word is zero."""
    return _as_key(0, int(seed) & MASK)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in``: hash the counter pair (0, data)."""
    k0, k1 = _key_words(key)
    return _as_key(*_threefry2x32(k0, k1, 0, int(data) & MASK))


def split(key, num: int = 2) -> Sequence[np.ndarray]:
    """``jax.random.split`` (partitionable layout): key i hashes (0, i)."""
    k0, k1 = _key_words(key)
    return [_as_key(*_threefry2x32(k0, k1, 0, i)) for i in range(num)]


def bits(key, shape: Tuple[int, ...], device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values in
    [0, 2^32): element n hashes the counter pair (n >> 32, n & mask) and
    the two output words are xored."""
    k0, k1 = _key_words(key)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = _threefry2x32(k0, k1, idx >> 32, idx & MASK)
    return (b0 ^ b1).reshape(shape)


def mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 tensors of values in [0, 2^32), without
    int64 overflow: b is split into 16-bit halves."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def randint(key, shape: Tuple[int, ...], minval: int, maxval: int,
            device="cpu") -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)``.

    jax draws two 32-bit words per element and reduces
    ``(hi % span) * (2^32 % span) + lo % span`` mod span, where it computes
    2^32 % span as (2^16 % span)^2 in wrapping uint32 arithmetic. For
    spans above 2^16 (the field, p = 2^23 - 15) that multiplier wraps to
    0, so the high word never reaches the result and is not drawn here."""
    assert 0 <= minval < maxval <= (1 << 31) - 1, (minval, maxval)
    span = maxval - minval
    mult = ((((1 << 16) % span) ** 2) & MASK) % span
    k_hi, k_lo = split(key)
    off = bits(k_lo, shape, device) % span
    if mult:
        hi = bits(k_hi, shape, device) % span
        off = ((mul32(hi, torch.full_like(hi, mult)) + off) & MASK) % span
    return (off + minval).to(torch.int32)


def uniform(key, shape: Tuple[int, ...] = (), minval: float = 0.0,
            maxval: float = 1.0, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: 23
    random mantissa bits under the exponent of 1.0, minus 1, then
    ``max(minval, f * (maxval - minval) + minval)`` in float32."""
    b = bits(key, tuple(shape) or (1,), device)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # the bounds and their difference as float32 values, as jax takes them
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    return torch.clamp_min(_fma32(f, span, lo), float(lo)).reshape(shape)


def _fma32(f: torch.Tensor, a: np.float32, b: np.float32) -> torch.Tensor:
    """``f * a + b`` rounded once to float32, as the FMA into which XLA:CPU
    contracts jax's multiply and add. The product of two float32 values
    is exact in float64; the sum is rounded there to odd (its error,
    from TwoSum, sets the last bit), and a float64 rounded to odd rounds
    to float32 as the exact sum does."""
    p = f.to(torch.float64) * float(a)
    s = p + float(b)
    bb = s - p
    err = (p - (s - bb)) + (float(b) - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, math.inf),
                         torch.full_like(s, -math.inf))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def gumbel(key, shape: Tuple[int, ...], device="cpu") -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` in its default "low"
    mode: ``-log(-log(u))`` of a uniform draw on [tiny, 1). The draw is
    bit-equal to jax; torch's ``log`` and XLA's may differ in the last
    ulp, so the noise is held to jax within a few ulps."""
    tiny = float(torch.finfo(torch.float32).tiny)
    u = uniform(key, shape, minval=tiny, maxval=1.0, device=device)
    return -torch.log(-torch.log(u))


def categorical(key, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis)`` with replacement: the
    Gumbel-max trick, ``argmax(logits + gumbel)`` over ``axis`` (the first
    index of the largest, as ``jnp.argmax``). The noise is drawn over
    ``logits``' shape in its dtype (float32 here), on its device."""
    assert logits.dtype == torch.float32, logits.dtype
    g = gumbel(key, tuple(logits.shape), device=logits.device)
    return torch.argmax(g + logits, dim=axis)
