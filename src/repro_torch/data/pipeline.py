"""Deterministic synthetic token pipeline (the data substrate): a copy of
the JAX package's, numpy only, so both packages draw the same batches.

Produces an infinite, seeded stream of packed LM batches, sharded by
data-parallel host: each host materializes only its shard (production
pattern), with a skewed unigram distribution plus Markov structure so the
loss actually decreases during the example runs.
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
    n_hosts: int = 1
    host_id: int = 0


class TokenStream:
    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.n_hosts == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_hosts
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # skewed unigram + sparse bigram structure (learnable signal)
        self.unigram = rng.dirichlet(np.full(min(v, 4096), 0.1))
        self.hot = rng.integers(0, v, size=(min(v, 4096),))
        self.step = 0

    def next_batch(self) -> dict:
        c = self.cfg
        rng = np.random.default_rng(
            (c.seed, self.step, c.host_id, 7919))
        self.step += 1
        idx = rng.choice(len(self.unigram), p=self.unigram,
                         size=(self.local_batch, c.seq_len))
        toks = self.hot[idx]
        # Markov smoothing: each token sometimes repeats its predecessor
        rep = rng.random((self.local_batch, c.seq_len)) < 0.3
        toks[:, 1:] = np.where(rep[:, 1:], toks[:, :-1], toks[:, 1:])
        tokens = toks.astype(np.int32)
        labels = np.concatenate(
            [tokens[:, 1:], np.full((self.local_batch, 1), -1, np.int32)],
            axis=1)
        return {"tokens": tokens, "labels": labels}

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict):
        self.step = int(state["step"])
