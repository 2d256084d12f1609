"""Host-side data pipelines (twin of ``repro.data.pipeline``, numpy
only); the same seed gives the reference's batches bit for bit.

``TokenPipeline`` — deterministic synthetic LM token stream, seeded per
(host, step) so that every data-parallel host draws a disjoint,
reproducible shard with no coordination; the step index is the only
state, so a run resumed from a checkpoint replays the exact stream.

``ArrayPipeline`` — minibatches over in-memory arrays with per-epoch
shuffling and sharded slicing for the retrieval workloads.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    """Synthetic but structured tokens: Zipfian unigrams, and a random
    motif written over a random window of every row (the same for the
    batch), so that an LM has signal to fit."""
    vocab_size: int
    seq_len: int
    global_batch: int
    num_hosts: int = 1
    host_id: int = 0
    seed: int = 0

    def __post_init__(self):
        assert self.global_batch % self.num_hosts == 0
        self.local_batch = self.global_batch // self.num_hosts
        ranks = np.arange(1, self.vocab_size + 1, dtype=np.float64)
        probs = 1.0 / ranks
        self._probs = (probs / probs.sum()).astype(np.float64)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """This host's batch at ``step``: {"tokens", "labels"} int32
        (local_batch, seq_len), the labels a copy of the tokens."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.host_id)
        toks = rng.choice(self.vocab_size,
                          size=(self.local_batch, self.seq_len),
                          p=self._probs).astype(np.int32)
        motif_len = min(32, self.seq_len)
        motif = rng.integers(0, self.vocab_size, motif_len, dtype=np.int32)
        start = int(rng.integers(0, max(self.seq_len - motif_len, 1)))
        toks[:, start: start + motif_len] = motif[None, :]
        return {"tokens": toks, "labels": toks.copy()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


@dataclasses.dataclass
class ArrayPipeline:
    """Shuffled minibatches over (x, y) arrays; optional host sharding."""
    x: np.ndarray
    y: np.ndarray
    batch_size: int
    num_hosts: int = 1
    host_id: int = 0
    seed: int = 0
    drop_remainder: bool = True

    def epoch(self, epoch_idx: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        rng = np.random.default_rng(self.seed * 7919 + epoch_idx)
        perm = rng.permutation(len(self.x))
        shard = perm[self.host_id:: self.num_hosts]
        nb = len(shard) // self.batch_size
        end = nb * self.batch_size if self.drop_remainder else len(shard)
        for s in range(0, end, self.batch_size):
            idx = shard[s: s + self.batch_size]
            yield self.x[idx], self.y[idx]

    def num_batches(self) -> int:
        return (len(self.x) // self.num_hosts) // self.batch_size
