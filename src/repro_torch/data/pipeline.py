"""Token data pipeline for the training examples.

A copy of ``repro/data/pipeline.py`` (the port imports nothing of the JAX
package): a deterministic, step-indexed synthetic corpus, seeded per step
so that fault recovery replays exactly (``training/fault_tolerance.py``),
with a Zipfian unigram and a Markov bigram structure so that the loss
actually decreases.  Each data-parallel rank draws its slice of the global
batch by rank-offset seeding; no host exchange is needed.  The same config
gives the same arrays as the JAX package's, bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        # fixed unigram (zipf) + sparse bigram preference matrix
        ranks = np.arange(1, V + 1)
        p = 1.0 / ranks ** cfg.zipf_a
        self.unigram = p / p.sum()
        self.next_pref = rng.integers(0, V, size=V)   # favored successor

    def batch(self, step: int, rank: int = 0, n_ranks: int = 1) -> dict:
        """Global-batch slice for this rank at this step (deterministic)."""
        cfg = self.cfg
        per = cfg.global_batch // n_ranks
        rng = np.random.default_rng(
            (cfg.seed, step, rank))                  # replayable
        toks = np.empty((per, cfg.seq_len + 1), np.int32)
        toks[:, 0] = rng.choice(cfg.vocab_size, size=per, p=self.unigram)
        for t in range(cfg.seq_len):
            stay = rng.random(per) < 0.65            # predictable structure
            rnd = rng.choice(cfg.vocab_size, size=per, p=self.unigram)
            toks[:, t + 1] = np.where(stay, self.next_pref[toks[:, t]], rnd)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
