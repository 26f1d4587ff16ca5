"""Deterministic, index-addressable synthetic token pipeline.

Every (step, row, position) maps to a token via a stateless splitmix64
hash, so ANY host can recompute ANY shard of ANY step without coordination
— this is the fault-tolerance/straggler story: no data-loader state to
checkpoint or hand off, restart = recompute.

numpy only: the batches are host arrays, which the step functions move to
the parameters' device.
"""
from __future__ import annotations

import numpy as np


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


class TokenPipeline:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed

    def _tokens(self, step: int, rows: np.ndarray) -> np.ndarray:
        pos = np.arange(self.seq_len + 1, dtype=np.uint64)[None, :]
        base = (np.uint64(self.seed) << np.uint64(48)) \
            ^ (np.uint64(step) << np.uint64(24))
        idx = base ^ (rows.astype(np.uint64)[:, None] << np.uint64(40)) ^ pos
        h = _splitmix64(idx)
        return (h % np.uint64(self.vocab_size)).astype(np.int32)

    def global_batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Full batch: tokens [B, S], labels [B, S] (next-token)."""
        rows = np.arange(self.global_batch)
        seq = self._tokens(step, rows)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    def shard_at(self, step: int, shard: int, num_shards: int):
        """Rows owned by one data-parallel shard; recomputable anywhere."""
        if self.global_batch % num_shards:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split into {num_shards} shards")
        per = self.global_batch // num_shards
        rows = np.arange(shard * per, (shard + 1) * per)
        seq = self._tokens(step, rows)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    def mask_at(self, step: int, mask_prob: float = 0.08) -> np.ndarray:
        """Deterministic mask positions (encoder-only masked prediction)."""
        rows = np.arange(self.global_batch, dtype=np.uint64)
        pos = np.arange(self.seq_len, dtype=np.uint64)[None, :]
        idx = (np.uint64(self.seed + 7) << np.uint64(48)) \
            ^ (np.uint64(step) << np.uint64(24)) \
            ^ (rows[:, None] << np.uint64(40)) ^ pos
        h = _splitmix64(idx)
        return (h % np.uint64(10_000)) < np.uint64(int(mask_prob * 10_000))
