"""A frozen copy of the port's synthetic token stream.

Copied from ``repro_torch/data/pipeline.py`` so that a change to the
program cannot change the benchmark's inputs: Zipf-distributed first
tokens followed by a fixed Markov chain of ``markov_k`` successors a
token, each batch drawn from (seed, step) alone.  ``tokens`` and
``labels`` (the tokens shifted by one) are int32 [batch, seq].
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
    seed: int = 0
    markov_k: int = 64

    def __post_init__(self) -> None:
        rng = np.random.default_rng(self.seed)
        self.succ = rng.integers(0, self.vocab, (self.vocab, self.markov_k))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed * 1_000_003 + step) * 4096)
        b, s = self.global_batch, self.seq_len
        toks = np.empty((b, s + 1), dtype=np.int32)
        toks[:, 0] = rng.zipf(1.3, b) % self.vocab
        choices = rng.integers(0, self.markov_k, (b, s))
        for t in range(s):
            toks[:, t + 1] = self.succ[toks[:, t], choices[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
