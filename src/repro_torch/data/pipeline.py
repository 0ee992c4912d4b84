"""Deterministic sharded synthetic data pipeline.

Port of ``repro/data/pipeline.py``, the same numpy code, so the same
(seed, shard, step) gives the reference's batches. Token streams come
from a counter-based generator keyed by (seed, shard, step): each
data-parallel host materializes exactly its slice with no coordination,
resumption at any step is exact (no state to checkpoint beyond the step
counter), and elastic re-sharding just changes the (shard, num_shards)
split. The "language" is a mixture of Zipfian unigrams and repeated motifs
so a small LM shows a real learning curve.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 16
    motif_prob: float = 0.5


class TokenPipeline:
    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1):
        assert cfg.global_batch % num_shards == 0
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards

    def _rng(self, step: int, row: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.cfg.seed * 0x9E3779B1 + step) * 65536
            + self.shard * self.local_batch + row)

    def _sample_row(self, rng: np.random.Generator) -> np.ndarray:
        c = self.cfg
        # Zipfian unigrams clipped to vocab
        row = rng.zipf(c.zipf_a, size=c.seq_len).astype(np.int64)
        row = (row - 1) % c.vocab_size
        # overlay repeated motifs (learnable structure)
        pos = 0
        while pos + 2 * c.motif_len < c.seq_len:
            if rng.random() < c.motif_prob:
                motif = row[pos: pos + c.motif_len]
                row[pos + c.motif_len: pos + 2 * c.motif_len] = motif
                pos += 2 * c.motif_len
            else:
                pos += c.motif_len
        return row.astype(np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rows = [self._sample_row(self._rng(step, r))
                for r in range(self.local_batch)]
        return {"tokens": np.stack(rows)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
