"""The generator of training batches a traffic file sizes
(``gpubench/traffic/<name>.json``: ``batch`` rows of ``seq`` tokens, split
by the step into ``accum`` microbatches).  Documents are noisy walks over
one of 64 random Markov chains on the first 512 token ids, each position
taking one of 4 successors, or with probability 0.05 a random token.
Batch ``i`` depends only on ``(seed, i)``; every seed draws the same
sizes.  This is the synthetic source of the program's data pipeline
(``repro_torch.data.pipeline.SyntheticLM``) with its constants, frozen
here so that the benchmark's inputs cannot change under it."""

from __future__ import annotations

from typing import Dict

import numpy as np

CHAINS, ORDER_VOCAB, BRANCHES, NOISE = 64, 512, 4, 0.05


class MarkovLM:
    def __init__(self, vocab: int, seq_len: int, batch_size: int, seed: int):
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.seed = seed
        width = min(vocab, ORDER_VOCAB)
        base = np.random.RandomState(seed % 2**32)
        self._next = base.randint(0, width, size=(CHAINS, width, BRANCHES)
                                  ).astype(np.int32)

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState((self.seed * 1_000_003 + index) % 2**31)
        B, S = self.batch_size, self.seq_len
        width = self._next.shape[1]
        chain = rng.randint(0, CHAINS, size=B)
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.randint(0, width, size=B)
        noise = rng.random((B, S)) < NOISE
        branch = rng.randint(0, BRANCHES, size=(B, S))
        rand_tok = rng.randint(0, width, size=(B, S))
        for t in range(S):
            nxt = self._next[chain, toks[:, t], branch[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def source(traffic: dict, vocab: int, seed: int) -> MarkovLM:
    """The generator a traffic file describes, for a model of ``vocab``."""
    return MarkovLM(vocab, traffic["seq"], traffic["batch"], seed)
