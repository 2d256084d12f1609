"""Host-side minibatching (twin of ``repro.data.pipeline``, numpy only).

``ArrayPipeline`` — minibatches over in-memory arrays with per-epoch
shuffling and sharded slicing for the retrieval workloads; the same
seed gives the reference's batches bit for bit.  ``TokenPipeline``
(the synthetic LM token stream) waits for ROADMAP item 22 (LM
training).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


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
