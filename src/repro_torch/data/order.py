"""Deterministic sample-order spec: a pure ``sample index -> window`` map
(a copy of ``repro/data/order.py``: both packages visit the same windows).

The training stream over a corpus of ``n_windows`` fixed-length windows is
a seeded shuffle, re-shuffled every epoch.  Instead of materializing (and
checkpointing) a permutation array, the shuffle is a **format-preserving
Feistel cipher** over ``[0, n_windows)``: ``window(s)`` for global sample
index ``s`` is a pure function of ``(seed, n_windows, s)`` — O(1) memory,
vectorized over numpy int64 arrays, identical in every process.

That purity is the whole design: any step's batch is recomputable from the
step number alone, so

* SIGTERM + ``--resume`` realigns the stream with **no loader state** in
  the checkpoint,
* worker processes can materialize batch ``i`` in any order and the stream
  is still exactly ``start, start+1, ...``,
* changing worker count / host topology cannot change sample order.

Mechanics: sample ``s`` lives in epoch ``e = s // n`` at offset
``r = s % n``; the window is ``perm_e(r)`` where ``perm_e`` is a 4-round
balanced Feistel network on ``2h`` bits (``2h >= bits(n-1)``), keyed by
``splitmix64(seed, e, round)``, with cycle-walking to stay inside
``[0, n)`` (expected < 2 walks/sample since ``2^2h < 4n``).  Each epoch is
a true permutation of ``range(n)`` (tested), so every window is visited
exactly once per epoch.
"""

from __future__ import annotations

import numpy as np

_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — the per-round hash (vectorized, uint64;
    arithmetic is intentionally mod 2^64)."""
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15)) & _MASK64
        x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) \
            & _MASK64
        x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) \
            & _MASK64
        return x ^ (x >> np.uint64(31))


class SampleOrder:
    """Seeded shuffle over ``n_windows`` as a pure index map.

    ``window(s)`` / ``windows(array)`` give the corpus window of global
    sample ``s`` (samples ``[k*B, (k+1)*B)`` form batch ``k`` of size
    ``B``).  No state, no RNG objects — see module docstring.
    """

    ROUNDS = 4

    def __init__(self, n_windows: int, seed: int = 0):
        if n_windows <= 0:
            raise ValueError(f"n_windows must be positive, got {n_windows}")
        self.n_windows = int(n_windows)
        self.seed = int(seed)
        # 2h bits cover n-1; h >= 1 so both Feistel halves are non-trivial
        bits = max(int(n_windows - 1).bit_length(), 2)
        self._h = np.uint64((bits + 1) // 2)
        self._hmask = np.uint64((1 << int(self._h)) - 1)
        self._domain = np.uint64(1) << (np.uint64(2) * self._h)

    def _round_keys(self, epoch: np.ndarray) -> list:
        with np.errstate(over="ignore"):
            base = (np.uint64(self.seed & 0xFFFFFFFFFFFFFFFF)
                    + np.uint64(0xA5A5A5A5) * epoch.astype(np.uint64)) \
                & _MASK64
            return [_splitmix64(
                (base + np.uint64(r) * np.uint64(0xD1B54A32D192ED03))
                & _MASK64) for r in range(self.ROUNDS)]

    def _feistel(self, x: np.ndarray, keys: list) -> np.ndarray:
        left, right = x >> self._h, x & self._hmask
        for k in keys:
            with np.errstate(over="ignore"):
                mixed = _splitmix64((right + k) & _MASK64)
            left, right = right, left ^ (mixed & self._hmask)
        return (left << self._h) | right

    def windows(self, samples: np.ndarray) -> np.ndarray:
        """Vectorized ``sample index -> window index`` (int64 in, int64
        out, all in ``[0, n_windows)``)."""
        samples = np.asarray(samples, np.int64)
        if np.any(samples < 0):
            raise ValueError("sample indices must be non-negative")
        n = np.uint64(self.n_windows)
        epoch = (samples // self.n_windows).astype(np.uint64)
        x = (samples % self.n_windows).astype(np.uint64)
        keys = self._round_keys(epoch)
        x = self._feistel(x, keys)
        # cycle-walk: re-encipher until back inside [0, n) — the walk is a
        # permutation of the 2^2h domain, so distinct inputs stay distinct
        out = np.where(x < n, x, np.uint64(0))
        todo = x >= n
        while np.any(todo):
            x = np.where(todo, self._feistel(x, keys), x)
            done_now = todo & (x < n)
            out = np.where(done_now, x, out)
            todo = todo & ~done_now
        return out.astype(np.int64)

    def window(self, sample: int) -> int:
        return int(self.windows(np.asarray([sample]))[0])

    def epoch_of(self, sample: int) -> int:
        return int(sample) // self.n_windows
