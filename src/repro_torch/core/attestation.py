"""Remote-attestation simulation: enclave measurement & quote verification.

Port of ``repro/core/attestation.py``. The measurement is a structural hash
over the tier-1 code identity (config JSON, partition, field modulus,
weight digests, plan digest), computed exactly as the reference computes
it, so the same weights and plan give the same ``Quote`` in both packages.
"""
from __future__ import annotations

import dataclasses
import hashlib
import hmac
import json
from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.limb_matmul.ref import P


def _leaves(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, object]]:
    """(path string, leaf) of a nested dict, the path spelled as
    ``str()`` of a jax key path: "(DictKey(key='l0'), DictKey(key='b'))"."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], path + (k,))
        return
    yield "(" + ", ".join(f"DictKey(key={k!r})" for k in path) + ")", tree


def _digest_params(params, max_bytes: int = 1 << 16) -> str:
    h = hashlib.sha256()
    for path, leaf in sorted(_leaves(params), key=lambda kv: kv[0]):
        h.update(path.encode())
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
            if leaf.dtype == torch.bfloat16:
                # numpy has no bfloat16: its raw bytes, as the reference
                # hashes its ml_dtypes leaves
                leaf = leaf.view(torch.int16)
            leaf = leaf.numpy()
        arr = np.asarray(leaf).reshape(-1)
        h.update(np.asarray(arr[: max_bytes // max(arr.itemsize, 1)]).tobytes())
    return h.hexdigest()


@dataclass(frozen=True)
class Quote:
    measurement: str
    config_name: str
    partition: int
    field_p: int
    protocol_version: str = "origami-1"
    plan_digest: str = ""


def measure_enclave(cfg: ModelConfig, params, partition: int,
                    plan_digest: str = "") -> Quote:
    ident = {
        "config": cfg.to_json(),
        "partition": partition,
        "field_p": P,
        "weights": _digest_params(params),
    }
    if plan_digest:
        ident["plan"] = plan_digest
    m = hashlib.sha256(json.dumps(ident, sort_keys=True).encode()).hexdigest()
    return Quote(measurement=m, config_name=cfg.name, partition=partition,
                 field_p=P, plan_digest=plan_digest)


def _canonical(quote: Quote) -> bytes:
    return hashlib.sha256(json.dumps(
        dataclasses.asdict(quote), sort_keys=True).encode()).digest()


def verify_quote(quote: Quote, expected: Quote) -> bool:
    """Constant-time quote check over canonical digests."""
    return hmac.compare_digest(_canonical(quote), _canonical(expected))
