"""Deterministic, shardable, checkpointable synthetic token stream.

The port's copy of the JAX package's ``repro.data.pipeline`` (numpy
only; the port imports nothing of the reference), giving the same
batches bit for bit:

  * sharded: each data-parallel host pulls only its batch shard, derived
    from (seed, step, shard_id), with no coordination;
  * checkpointable: the state is the step, stored with the training
    checkpoint, so a resume is exact;
  * deterministic: the same (seed, step, shard) gives the same batch on
    any host (a generator seeded from them, no carried state).

The "documents" are Zipf-distributed first tokens followed by a fixed
Markov chain of ``markov_k`` successors a token, so the cross entropy
has structure to learn.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    n_shards: int = 1
    shard_id: int = 0
    seed: int = 0
    markov_k: int = 64  # smaller = more learnable structure

    def __post_init__(self) -> None:
        if self.global_batch % self.n_shards:
            raise ValueError(f"global batch {self.global_batch} does not split over "
                             f"{self.n_shards} shards")
        rng = np.random.default_rng(self.seed)
        # fixed Markov transition table: tok -> one of markov_k successors
        self.succ = rng.integers(0, self.vocab, (self.vocab, self.markov_k))

    @property
    def shard_batch(self) -> int:
        return self.global_batch // self.n_shards

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """This shard's batch of ``step``: ``tokens`` and ``labels`` (the
        tokens shifted by one), int32 [shard_batch, seq_len]."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 4096 + self.shard_id
        )
        b, s = self.shard_batch, self.seq_len
        toks = np.empty((b, s + 1), dtype=np.int32)
        toks[:, 0] = rng.zipf(1.3, b) % self.vocab
        choices = rng.integers(0, self.markov_k, (b, s))
        for t in range(s):
            toks[:, t + 1] = self.succ[toks[:, t], choices[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
