"""Counter-based threefry2x32, bit-equal to the ``jax.random`` calls the
serving path uses (``PRNGKey``, ``fold_in``, ``split``, ``bits``,
``randint``, ``uniform``) and the sampler of token generation
(``gumbel``, ``categorical``); ``normal``, which draws the initial weights
of ``models/layers.init_params_keyed``, is held to jax within 4 ulps.

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


def _counter_bits(key, lo: int, hi: int, device) -> torch.Tensor:
    """Elements [lo, hi) of the flat stream ``bits`` draws, as int64."""
    k0, k1 = _key_words(key)
    idx = torch.arange(lo, hi, dtype=torch.int64, device=device)
    b0, b1 = _threefry2x32(k0, k1, idx >> 32, idx & MASK)
    return b0 ^ b1


def bits(key, shape: Tuple[int, ...], device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values in
    [0, 2^32): element n hashes the counter pair (n >> 32, n & mask) and
    the two output words are xored."""
    return _counter_bits(key, 0, math.prod(shape), device).reshape(shape)


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
    return _uniform_of_bits(b, minval, maxval).reshape(shape)


def _uniform_of_bits(b: torch.Tensor, minval: float,
                     maxval: float) -> torch.Tensor:
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # the bounds and their difference as float32 values, as jax takes them
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    return torch.clamp_min(_fma32(f, span, lo), float(lo))


def _fma32(f: torch.Tensor, a, b) -> torch.Tensor:
    """``f * a + b`` rounded once to float32, as the FMA into which XLA:CPU
    contracts jax's multiply and add (``a`` and ``b`` float32 scalars or
    tensors). The product of two float32 values is exact in float64; the
    sum is rounded there to odd (its error, from TwoSum, sets the last
    bit), and a float64 rounded to odd rounds to float32 as the exact sum
    does."""
    a = torch.as_tensor(a, dtype=torch.float64, device=f.device)
    b = torch.as_tensor(b, dtype=torch.float64, device=f.device)
    p = f.to(torch.float64) * a
    s = p + b
    bb = s - p
    err = (p - (s - bb)) + (b - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, math.inf),
                         torch.full_like(s, -math.inf))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


# Giles' single-precision erfinv, the coefficients XLA uses (for w < 5 and
# w >= 5, highest degree first)
_ERFINV_LT = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)


def _erfinv32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erfinv: Giles' polynomial in w = -log1p(-x^2), its
    multiply-adds fused as XLA:CPU fuses them. torch's ``log1p`` is not
    XLA's, so a few results differ from jax in the last ulps."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(
            lt, torch.tensor(np.float32(_ERFINV_LT[i]), device=x.device),
            torch.tensor(np.float32(_ERFINV_GE[i]), device=x.device))

    p = coef(0)
    for i in range(1, len(_ERFINV_LT)):
        p = _fma32(p, w, coef(i))
    return torch.where(x.abs() == 1, x * math.inf, p * x)


# elements a ``normal`` draw computes at once: each holds ~100 bytes of
# int64 and float64 temporaries, so a leaf of 10^9 values (MiniCPM3-4B's
# stacked MLP) is drawn in counter ranges
NORMAL_CHUNK = 1 << 25


def normal(key, shape: Tuple[int, ...], device="cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: sqrt(2) * erfinv(u) of
    a uniform draw on (-1, 1). The draw is bit-equal to jax; the erfinv
    is within 4 ulps of XLA's (99% of 100,000 draws of ``PRNGKey(0)``
    bit-equal, the largest gap 3 ulps, on the CPU). Every element is a
    function of its counter alone, so the stream is drawn
    ``NORMAL_CHUNK`` counters at a time into the output: the same bits at
    any ``NORMAL_CHUNK``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float32, device=device)
    for a in range(0, n, NORMAL_CHUNK):
        b = min(a + NORMAL_CHUNK, n)
        u = _uniform_of_bits(_counter_bits(key, a, b, device), lo, 1.0)
        out[a:b] = _erfinv32(u) * float(np.float32(np.sqrt(2.0)))
    return out.reshape(shape)


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
