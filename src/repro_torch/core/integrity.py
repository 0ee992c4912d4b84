"""Freivalds-verified offload: probabilistic checks over the untrusted
field matmul.

Port of ``repro/core/integrity.py``. Per (session, layer, step) the enclave
draws fold vectors ``s`` uniform over Z_p^(d_out x k) and precomputes
``ws = (W_q @ s) mod p``; a device result ``y`` of ``x @ W_q`` is accepted
iff ``y @ s ≡ x @ ws (mod p)``, evaluated as one fold
``[y | x] @ [s; -ws] ≡ 0``. A wrong result escapes a check with
probability p^-k. Keys derive from ``fold_in(session_key, VERIFY_DOMAIN)``,
disjoint from the blinding streams, exactly as in the reference.

The port runs eagerly: the reference's ``lax.cond`` is an ``if`` on the
host-side sampling decision, and a skipped check costs no fold.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import blinding as B
from repro_torch.core import prng
from repro_torch.kernels.limb_matmul.ops import field_fold
from repro_torch.kernels.limb_matmul.ref import P

VERIFY_DOMAIN = 0x5ECC
_SUB_FOLD = 0      # -> fold-vector draw
_SUB_DECIDE = 1    # -> sampled-mode check/skip decision
_SUB_SHARD = 2     # -> per-shard fold-vector draws (offload plane)

MODES = ("off", "sampled", "full")


@dataclass(frozen=True)
class IntegrityPolicy:
    """``mode``: "off" | "sampled" | "full"; ``rate``: per-op check
    probability under "sampled"; ``k``: independent Freivalds repetitions
    (soundness 1 - p^-k)."""
    mode: str = "off"
    rate: float = 0.25
    k: int = 1

    def __post_init__(self):
        assert self.mode in MODES, self.mode
        assert self.k >= 1, self.k
        assert 0.0 <= self.rate <= 1.0, self.rate

    @property
    def enabled(self) -> bool:
        return self.mode != "off"

    @classmethod
    def off(cls) -> "IntegrityPolicy":
        return cls("off")

    @classmethod
    def full(cls, k: int = 1) -> "IntegrityPolicy":
        return cls("full", k=k)

    @classmethod
    def sampled(cls, rate: float = 0.25, k: int = 1) -> "IntegrityPolicy":
        return cls("sampled", rate=rate, k=k)


def verify_root(session_key: np.ndarray) -> np.ndarray:
    return prng.fold_in(session_key, VERIFY_DOMAIN)


def op_key(session_key: np.ndarray, layer_id: int, step: int = 0) -> np.ndarray:
    return B.stream_key(verify_root(session_key), layer_id, step)


def fold_stream(session_key: np.ndarray, layer_id: int, step: int,
                d_out: int, k: int, device="cpu") -> torch.Tensor:
    """The fold vectors ``s``: (d_out, k) uniform field elements."""
    key = prng.fold_in(op_key(session_key, layer_id, step), _SUB_FOLD)
    return B.blinding_stream(key, (d_out, k), device=device)


def shard_fold_stream(session_key: np.ndarray, layer_id: int, step: int,
                      shard: int, d_out: int, k: int,
                      device="cpu") -> torch.Tensor:
    """Per-shard fold vectors of the offload plane: each shard of one
    offloaded matmul is checked with its own (d_out, k) draw."""
    key = prng.fold_in(prng.fold_in(op_key(session_key, layer_id, step),
                                    _SUB_SHARD), shard)
    return B.blinding_stream(key, (d_out, k), device=device)


def decide(policy: IntegrityPolicy, session_key: np.ndarray, layer_id: int,
           step: int = 0) -> bool:
    """Per-op check/skip decision: always under "full", never under "off",
    a Bernoulli(rate) draw from the verify key under "sampled"."""
    if policy.mode == "full":
        return True
    if policy.mode == "off":
        return False
    key = prng.fold_in(op_key(session_key, layer_id, step), _SUB_DECIDE)
    return bool(prng.uniform(key) < np.float32(policy.rate))


def fold_check(y_field: torch.Tensor, x_field: torch.Tensor,
               s: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """Freivalds identity ``y @ s ≡ x @ ws (mod p)`` as a 0-d bool tensor.

    y_field: (t, d_out) in [0, p); x_field: (t, d_in); s: (d_out, k);
    ws: (d_in, k) = (W_q @ s) mod p."""
    yx = torch.cat([y_field, x_field], dim=1)
    s_neg = torch.cat([s, torch.remainder(P - ws, P)], dim=0)
    return (field_fold(yx, s_neg) == 0).all()


def checked_pair(y_field: torch.Tensor, x_field: torch.Tensor,
                 s: torch.Tensor, ws: torch.Tensor, will_check: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(checked, failed) 0-d bool tensors; no fold runs when the policy
    decided to skip this op."""
    dev = y_field.device
    if not will_check:
        no = torch.zeros((), dtype=torch.bool, device=dev)
        return no, no
    return (torch.ones((), dtype=torch.bool, device=dev),
            ~fold_check(y_field, x_field, s, ws))


@dataclass
class IntegrityReport:
    """Per-infer verification outcome: one slot per verified or
    fault-injected blinded op, in call order (empty when the policy is off
    and no injector is installed)."""
    checked: torch.Tensor          # (n_ops,) bool — check actually ran
    failed: torch.Tensor           # (n_ops,) bool — check ran and mismatched
    corrupted: torch.Tensor        # (n_ops,) bool — fault-injector ground
                                   # truth; all False on an honest device

    @property
    def n_ops(self) -> int:
        return int(self.checked.shape[0])

    @property
    def n_checked(self) -> int:
        return int(self.checked.sum().item())

    @property
    def n_failed(self) -> int:
        return int(self.failed.sum().item())

    @property
    def n_corrupted(self) -> int:
        return int(self.corrupted.sum().item())

    @property
    def ok(self) -> bool:
        return self.n_failed == 0

    @classmethod
    def empty(cls) -> "IntegrityReport":
        z = torch.zeros((0,), dtype=torch.bool)
        return cls(checked=z, failed=z, corrupted=z)
