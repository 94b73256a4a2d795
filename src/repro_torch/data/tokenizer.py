"""Tokenizers for the corpus store: byte-level and a trainable byte-BPE
(a copy of ``repro/data/tokenizer.py``: the merges and ``config_hash`` are
the JAX package's, because they feed the corpus hash).

Both are numpy/pure-python only — this module is imported inside data
worker processes (``repro_torch.data.workers``), and keeping ``torch`` out
of the import graph keeps spawn-start cheap and away from CUDA.

Contract shared by both:

* ``encode(text) -> np.ndarray`` of token ids (dtype fits ``vocab_size``),
* ``decode(ids) -> str`` with ``decode(encode(t)) == t`` for any UTF-8
  text (byte-level base alphabet: nothing is out-of-vocabulary),
* ``to_json`` / ``from_json`` round-trip the trained state, so the
  corpus index can pin the exact tokenizer it was built with
  (``config_hash`` feeds the corpus hash).

The BPE is the standard byte-level scheme: pre-tokenize into
whitespace-glued words (a space belongs to the word it precedes, so
merges never straddle word boundaries and decoding is pure
concatenation), then greedily apply learned merges by rank.  Training
recounts pairs per merge over the unique-word histogram — O(merges ×
unique words), plenty for fixture-scale corpora, and deterministic:
ties break on the lexicographically smallest pair.
"""

from __future__ import annotations

import hashlib
import json
import re
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

# a word = optional leading whitespace glued to the following non-space run,
# or a trailing whitespace-only run; concatenating words restores the text.
_WORD_RE = re.compile(r"\s*\S+|\s+$")


def dtype_for_vocab(vocab_size: int) -> np.dtype:
    """Smallest packed dtype the store uses for this alphabet."""
    return np.dtype(np.uint16 if vocab_size <= (1 << 16) else np.uint32)


class ByteTokenizer:
    """Identity byte-level tokenizer: one token per UTF-8 byte."""

    kind = "byte"

    def __init__(self):
        self.vocab_size = 256

    def encode(self, text: str) -> np.ndarray:
        return np.frombuffer(text.encode("utf-8"), np.uint8) \
            .astype(dtype_for_vocab(self.vocab_size))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(np.asarray(ids, np.uint8)).decode("utf-8",
                                                       errors="replace")

    def to_json(self) -> dict:
        return {"kind": self.kind, "vocab_size": self.vocab_size}

    @classmethod
    def from_json(cls, obj: dict) -> "ByteTokenizer":
        tok = cls()
        assert obj["kind"] == cls.kind
        return tok

    def config_hash(self) -> str:
        return hashlib.sha256(
            json.dumps(self.to_json(), sort_keys=True).encode()).hexdigest()


class BPETokenizer:
    """Byte-level BPE: 256 byte tokens + trained merges.

    ``merges`` is an ordered list of ``(left_id, right_id)`` pairs; merge
    ``i`` defines token ``256 + i``.  Encoding applies merges greedily by
    rank within each word (lowest-rank pair first — the classic BPE encode
    loop), which is exactly the GIL-heavy per-batch work the process-worker
    path exists for.
    """

    kind = "bpe"

    def __init__(self, merges: Sequence[Tuple[int, int]] = ()):
        self.merges: List[Tuple[int, int]] = [tuple(m) for m in merges]
        self.vocab_size = 256 + len(self.merges)
        self._ranks: Dict[Tuple[int, int], int] = {
            m: i for i, m in enumerate(self.merges)}
        # token id -> raw bytes, built bottom-up (merge i only references
        # ids < 256 + i)
        self._bytes: List[bytes] = [bytes([b]) for b in range(256)]
        for a, b in self.merges:
            self._bytes.append(self._bytes[a] + self._bytes[b])

    # -- train -------------------------------------------------------------
    @classmethod
    def train(cls, texts: Iterable[str], vocab_size: int) -> "BPETokenizer":
        """Learn ``vocab_size - 256`` merges from ``texts``.

        Deterministic: pair counts are exact over the unique-word
        histogram and ties break on the smallest pair tuple."""
        if vocab_size < 256:
            raise ValueError(f"vocab_size {vocab_size} < 256 byte alphabet")
        words: Dict[Tuple[int, ...], int] = {}
        for text in texts:
            for m in _WORD_RE.finditer(text):
                w = tuple(m.group().encode("utf-8"))
                words[w] = words.get(w, 0) + 1
        merges: List[Tuple[int, int]] = []
        for new_id in range(256, vocab_size):
            counts: Dict[Tuple[int, int], int] = {}
            for w, c in words.items():
                for pair in zip(w, w[1:]):
                    counts[pair] = counts.get(pair, 0) + c
            if not counts:
                break
            best = min(counts.items(), key=lambda kv: (-kv[1], kv[0]))[0]
            if counts[best] < 2:
                break  # nothing left worth merging
            merges.append(best)
            words = {cls._merge_word(w, best, new_id): c
                     for w, c in words.items()}
        return cls(merges)

    @staticmethod
    def _merge_word(w: Tuple[int, ...], pair: Tuple[int, int],
                    new_id: int) -> Tuple[int, ...]:
        out: List[int] = []
        i = 0
        while i < len(w):
            if i + 1 < len(w) and (w[i], w[i + 1]) == pair:
                out.append(new_id)
                i += 2
            else:
                out.append(w[i])
                i += 1
        return tuple(out)

    # -- encode / decode ---------------------------------------------------
    def _encode_word(self, w: List[int]) -> List[int]:
        while len(w) > 1:
            best_rank, best_i = None, -1
            for i in range(len(w) - 1):
                r = self._ranks.get((w[i], w[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            w[best_i:best_i + 2] = [256 + best_rank]
        return w

    def encode(self, text: str) -> np.ndarray:
        ids: List[int] = []
        for m in _WORD_RE.finditer(text):
            ids.extend(self._encode_word(list(m.group().encode("utf-8"))))
        return np.asarray(ids, dtype_for_vocab(self.vocab_size))

    def decode(self, ids: Sequence[int]) -> str:
        return b"".join(self._bytes[int(i)] for i in np.asarray(ids).ravel()) \
            .decode("utf-8", errors="replace")

    # -- serialization -----------------------------------------------------
    def to_json(self) -> dict:
        return {"kind": self.kind, "vocab_size": self.vocab_size,
                "merges": [list(m) for m in self.merges]}

    @classmethod
    def from_json(cls, obj: dict) -> "BPETokenizer":
        assert obj["kind"] == cls.kind
        return cls([tuple(m) for m in obj["merges"]])

    def config_hash(self) -> str:
        return hashlib.sha256(
            json.dumps(self.to_json(), sort_keys=True).encode()).hexdigest()


def make_tokenizer(kind: str, texts: Iterable[str] = (),
                   vocab_size: int = 512):
    if kind == "byte":
        return ByteTokenizer()
    if kind == "bpe":
        return BPETokenizer.train(texts, vocab_size)
    raise ValueError(f"unknown tokenizer kind {kind!r}; choices: byte|bpe")


def tokenizer_from_json(obj: dict):
    cls = {ByteTokenizer.kind: ByteTokenizer, BPETokenizer.kind: BPETokenizer}
    return cls[obj["kind"]].from_json(obj)
