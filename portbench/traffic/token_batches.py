"""Training traffic (kind ``token_batches``): the token shards the
trainer's data pipeline reads, made by the benchmark.

The port's ``DiffusionDataPipeline`` decides which shard each batch comes
from and where in it (its cache-affinity dispatch over ``hosts`` data
hosts, with its own locality of reference); the shards' contents are this
store's, uniform token ids drawn from a generator seeded by (seed, shard
id).  The file's other keys size the job: ``batch`` x ``seq`` tokens a
step, the optimizer (``opt``), the schedule's ``total_steps`` (warm-up a
tenth of it) and the ``check_steps`` the reference follows.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


class ShardStore:
    """Stands in the pipeline's object store: ``fetch(spec)`` returns the
    shard's tokens (int32 [spec.num_tokens])."""

    def __init__(self, seed: int, vocab: int):
        self.seed, self.vocab = int(seed), int(vocab)
        self.reads = 0
        self.bytes_read = 0

    def fetch(self, spec) -> np.ndarray:
        self.reads += 1
        self.bytes_read += spec.nbytes
        rng = np.random.default_rng([self.seed, 4, int(spec.shard_id)])
        return rng.integers(0, self.vocab, size=(spec.num_tokens,), dtype=np.int32)


def make(params: Dict[str, Any], seed: int, vocab: int) -> ShardStore:
    return ShardStore(seed, vocab)
