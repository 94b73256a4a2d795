"""LM batch sources (counterpart of ``repro/data/pipeline.py``, the
``synthetic`` source).  Batch ``i`` depends only on ``(config, i)``, and
the numpy ``RandomState`` draws are the JAX package's, so both packages see
identical batches."""

from __future__ import annotations

from typing import Dict

import numpy as np


class SyntheticLM:
    """Documents = noisy walks over a per-document Markov chain."""

    def __init__(self, vocab: int, seq_len: int, batch_size: int,
                 seed: int = 0, n_chains: int = 64, order_vocab: int = 512):
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.seed = seed
        base = np.random.RandomState(seed)
        self.n_chains = n_chains
        self._next = base.randint(
            0, min(vocab, order_vocab),
            size=(n_chains, min(vocab, order_vocab), 4)).astype(np.int32)

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState((self.seed * 1_000_003 + index) % 2**31)
        B, S = self.batch_size, self.seq_len
        chains = rng.randint(0, self.n_chains, size=B)
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.randint(0, self._next.shape[1], size=B)
        noise = rng.random((B, S)) < 0.05
        branch = rng.randint(0, 4, size=(B, S))
        rand_tok = rng.randint(0, self._next.shape[1], size=(B, S))
        for t in range(S):
            nxt = self._next[chains, toks[:, t], branch[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_source(kind: str, vocab: int, seq_len: int, batch_size: int,
                seed: int = 0):
    if kind == "synthetic":
        return SyntheticLM(vocab, seq_len, batch_size, seed)
    raise ValueError(f"unknown data source {kind!r}; the port has "
                     "'synthetic' only")
