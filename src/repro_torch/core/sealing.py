"""Encrypted request channel: counter-mode stream cipher + keyed MAC.

Port of ``repro/core/sealing.py``, bit-equal to it: the same keystream
(threefry, core/prng.py), the same ciphertext and the same tag, so a box
sealed by either package opens under the other. Not production AES-GCM,
but a functional stand-in with the same interface and cost shape.

The MAC is the polynomial recurrence acc <- acc * c0 + w + c1 (mod 2^32)
over the length-prefixed nonce and the ciphertext. The recurrence is
linear, so it is evaluated in closed form on the device instead of one
word at a time:

    acc_n = c0^n * acc_0 + sum_i (w_i + c1) * c0^(n-1-i)   (mod 2^32)

with the powers of c0 built by doubling. The accept decision compares the
canonical little-endian uint32 encodings of the tags with
``hmac.compare_digest`` (constant time).

A box holds the ciphertext as int64 uint32 bit patterns (shape of the
plaintext), the nonce as a uint32 numpy array and the tag as an int.
"""
from __future__ import annotations

import hmac
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import prng

MASK = prng.MASK
_MAC_DOMAIN = 0xA11CE
_MAC_INIT = 0x9E3779B9


class SealedBox(NamedTuple):
    ciphertext: torch.Tensor     # int64 uint32 bit patterns
    nonce: np.ndarray            # (>=2,) uint32 (word 2+: direction tag)
    mac: int                     # uint32 tag


def _keystream(key, nonce: np.ndarray, n: int, device) -> torch.Tensor:
    """Nonce words fold in one after another, so nonces of different
    lengths live in disjoint key domains."""
    k = np.asarray(key, np.uint32)
    for word in np.asarray(nonce, np.uint32).reshape(-1):
        k = prng.fold_in(k, int(word))
    return prng.bits(k, (n,), device=device)


def _powers(c: int, n: int, device) -> torch.Tensor:
    """[c^0, c^1, ..., c^(n-1)] mod 2^32 as int64, by doubling."""
    pw = torch.ones(1, dtype=torch.int64, device=device)
    while pw.numel() < n:
        step = torch.full_like(pw, pow(c, pw.numel(), 1 << 32))
        pw = torch.cat([pw, prng.mul32(pw, step)])
    return pw[:n]


def _mac(key, words: torch.Tensor) -> int:
    """Carter-Wegman-style polynomial MAC over u32 words (mod 2^32)."""
    k = prng.fold_in(np.asarray(key, np.uint32), _MAC_DOMAIN)
    coeff = prng.bits(k, (2,)).tolist()
    c0, c1 = coeff[0] | 1, coeff[1]            # odd: a unit mod 2^32
    n = words.numel()
    pw = _powers(c0, n, words.device).flip(0)  # c0^(n-1-i)
    terms = prng.mul32((words.reshape(-1) + c1) & MASK, pw)
    tail = int(terms.sum().item()) & MASK      # n * 2^32 < 2^63
    return (pow(c0, n, 1 << 32) * _MAC_INIT + tail) & MASK


def _authenticated_words(nonce: np.ndarray, ct: torch.Tensor) -> torch.Tensor:
    """MAC input: length-prefixed nonce || ciphertext (the nonce selects
    the keystream, so it is authenticated)."""
    n = np.asarray(nonce, np.uint32).reshape(-1)
    head = torch.tensor([n.size, *n.tolist()], dtype=torch.int64,
                        device=ct.device)
    return torch.cat([head, ct.reshape(-1)])


def _float_bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & MASK


def _bits_float(b: torch.Tensor) -> torch.Tensor:
    signed = torch.where(b >= (1 << 31), b - (1 << 32), b)
    return signed.to(torch.int32).view(torch.float32)


def seal(key, x: torch.Tensor, nonce: np.ndarray) -> SealedBox:
    """Encrypt + authenticate a float tensor under the session key, on
    x's device."""
    nonce = np.asarray(nonce, np.uint32)
    bits = _float_bits(x)
    ct = bits ^ _keystream(key, nonce, bits.numel(), x.device).reshape(
        bits.shape)
    return SealedBox(ciphertext=ct, nonce=nonce,
                     mac=_mac(key, _authenticated_words(nonce, ct)))


def unseal(key, box: SealedBox,
           shape: Tuple[int, ...]) -> Tuple[torch.Tensor, bool]:
    """Returns (plaintext, mac_ok), on the ciphertext's device."""
    ct = box.ciphertext.reshape(-1).to(torch.int64)
    want = _mac(key, _authenticated_words(box.nonce, ct))
    ks = _keystream(key, box.nonce, ct.numel(), ct.device)
    ok = hmac.compare_digest(np.asarray(want, np.uint32).tobytes(),
                             np.asarray(box.mac, np.uint32).tobytes())
    return _bits_float(ct ^ ks).reshape(shape), ok
