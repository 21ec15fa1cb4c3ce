"""Deterministic sharded LM-token pipeline with host-failure reassignment.

The corpus is a virtual stream of synthetic documents: shard ``s`` of step
``t`` is a pure function of (seed, t, s), so ANY host can (re)produce ANY
shard — this is what makes the loader elastic: when the straggler monitor
marks a host dead, its shards are deterministically reassigned and the global
batch for step t is byte-identical to what it would have been.

Documents are Zipf-token sequences with a planted bigram structure so small
models have signal to learn (loss visibly decreases in the examples).

The reference package's loader, numpy only and unchanged, so both packages
draw byte-identical batches; the train loop moves them to the device.
``_shard_tokens`` loops over the sequence on the host (a step of a 4,096-token
batch runs 4,096 numpy iterations before the card's work).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from repro_torch.distributed.straggler import StragglerMonitor


def _shard_tokens(
    seed: int, step: int, shard: int, n_rows: int, seq_len: int, vocab: int
) -> np.ndarray:
    """Pure function (seed, step, shard) → (n_rows, seq_len+1) int32."""
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step, shard]).generate_state(4)
    )
    # planted bigram chain: next token ~ 0.6 * (prev*17+3 mod V) + 0.4 * Zipf
    z = rng.zipf(1.5, size=(n_rows, seq_len + 1)) % vocab
    out = np.empty((n_rows, seq_len + 1), dtype=np.int32)
    out[:, 0] = z[:, 0]
    follow = rng.random((n_rows, seq_len)) < 0.6
    for j in range(1, seq_len + 1):
        det = (out[:, j - 1] * 17 + 3) % vocab
        out[:, j] = np.where(follow[:, j - 1], det, z[:, j])
    return out


@dataclass
class TokenLoader:
    """Global-batch iterator over deterministic shards.

    ``global_batch`` rows per step, split into ``n_shards`` shards; each host
    materializes the shards the monitor's plan assigns it. On a single-host
    run (tests/examples) all shards are local, but the shard math is identical
    to the 1000-node layout.
    """

    global_batch: int
    seq_len: int
    vocab: int
    seed: int = 0
    n_shards: int = 8
    host: int = 0
    monitor: Optional[StragglerMonitor] = None

    def __post_init__(self):
        import math

        if self.global_batch % self.n_shards:
            # clamp to the largest shard count dividing the batch
            self.n_shards = math.gcd(self.n_shards, self.global_batch) or 1
        self.rows_per_shard = self.global_batch // self.n_shards

    def shards_for_step(self, step: int) -> list[int]:
        if self.monitor is None:
            return list(range(self.n_shards))
        plan = self.monitor.plan_shards(self.n_shards)
        return plan.get(self.host, [])

    def load_shard(self, step: int, shard: int) -> np.ndarray:
        return _shard_tokens(
            self.seed, step, shard, self.rows_per_shard, self.seq_len, self.vocab
        )

    def batch(self, step: int, shards: Optional[list[int]] = None) -> dict:
        """Assemble (this host's view of) the global batch for ``step``."""
        shards = self.shards_for_step(step) if shards is None else shards
        rows = np.concatenate([self.load_shard(step, s) for s in shards], axis=0)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
