"""Tokenized-corpus shard store: packed token shards + JSON index, read
back through ``np.memmap`` (a copy of ``repro/data/store.py``: a corpus
either package builds is byte for byte the other's, ``corpus_hash``
included).

Layout (one directory per corpus)::

    <dir>/corpus.json        # index: dtype, shard table, splits, hashes
    <dir>/tokenizer.json     # exact tokenizer state (byte or BPE merges)
    <dir>/train_00000.bin …  # packed little-endian uint16/uint32 tokens
    <dir>/eval_00000.bin     # held-out split (tail fraction of the stream)

Design points:

* **Packed + mmapped** — a shard is raw tokens, nothing else; readers map
  it with ``np.memmap`` so a 100-GiB corpus costs no RSS and a random
  window is one page-in.  ``uint16`` when the vocab fits, else ``uint32``.
* **Windows, not documents** — training samples are fixed-length windows
  of ``seq_len + 1`` tokens at stride ``seq_len`` (label of position t is
  token t+1; consecutive windows share one boundary token).  Windows
  never cross shard boundaries, so ``window -> (shard, offset)`` is a
  ``searchsorted`` over cumulative per-shard window counts.
* **Held-out split at build time** — the eval tail is separated when the
  corpus is written, so train/eval windows can never overlap no matter
  what seq_len readers later pick.
* **Content hash** — sha256 over shard bytes + tokenizer config, stored
  in the index; checkpoint manifests record it so a resume onto a
  different corpus fails loudly instead of silently training on the
  wrong data.
* **Picklable readers** — ``TokenStore`` / ``SplitView`` drop their
  memmaps on pickle and re-open them lazily in the child: worker
  processes (``repro_torch.data.workers``) inherit only the path.

No torch imports here (worker-process import graph must stay numpy-only).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.data.tokenizer import dtype_for_vocab, tokenizer_from_json

INDEX_NAME = "corpus.json"
TOKENIZER_NAME = "tokenizer.json"
FORMAT_VERSION = 1


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

def write_corpus(directory: str, tokens: np.ndarray, tokenizer, *,
                 shard_tokens: int = 1 << 22,
                 eval_fraction: float = 0.05,
                 source_desc: str = "") -> dict:
    """Pack one token stream into shards + index under ``directory``.

    The last ``eval_fraction`` of the stream becomes the eval split
    (document order preserved — the held-out tail, not a random sample,
    so eval text is contiguous prose).  Returns the index dict."""
    os.makedirs(directory, exist_ok=True)
    dt = dtype_for_vocab(tokenizer.vocab_size)
    tokens = np.ascontiguousarray(tokens.astype(dt))
    if tokens.ndim != 1 or tokens.size < 4:
        raise ValueError(f"need a flat token stream, got shape "
                         f"{tokens.shape}")
    n_eval = int(tokens.size * eval_fraction)
    splits = {"train": tokens[:tokens.size - n_eval],
              "eval": tokens[tokens.size - n_eval:]}

    tok_json = tokenizer.to_json()
    with open(os.path.join(directory, TOKENIZER_NAME), "w") as f:
        json.dump(tok_json, f)

    h = hashlib.sha256()
    h.update(json.dumps(tok_json, sort_keys=True).encode())
    index: dict = {"version": FORMAT_VERSION, "dtype": dt.name,
                   "vocab_size": tokenizer.vocab_size,
                   "tokenizer_kind": tokenizer.kind,
                   "source": source_desc, "splits": {}}
    for split, toks in splits.items():
        shards: List[dict] = []
        for i, lo in enumerate(range(0, max(toks.size, 1), shard_tokens)):
            chunk = toks[lo:lo + shard_tokens]
            if chunk.size == 0 and i > 0:
                break
            name = f"{split}_{i:05d}.bin"
            data = chunk.astype(dt.newbyteorder("<")).tobytes()
            with open(os.path.join(directory, name), "wb") as f:
                f.write(data)
            h.update(split.encode())
            h.update(data)
            shards.append({"file": name, "n_tokens": int(chunk.size)})
        index["splits"][split] = {"shards": shards,
                                 "n_tokens": int(toks.size)}
    index["corpus_hash"] = h.hexdigest()
    with open(os.path.join(directory, INDEX_NAME), "w") as f:
        json.dump(index, f, indent=1)
    return index


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

class SplitView:
    """Windowed mmap view of one split's shard list.

    ``n_windows(seq_len)`` / ``window(i, seq_len)``: window ``i`` is
    ``seq_len + 1`` tokens starting at ``i * seq_len`` *within its shard*
    (windows never straddle shards; a shard holds
    ``(n_tokens - 1) // seq_len`` of them)."""

    def __init__(self, directory: str, shards: Sequence[dict],
                 dtype: np.dtype):
        self.directory = directory
        self.shards = [dict(s) for s in shards]
        self.dtype = np.dtype(dtype)
        self._maps: Optional[List[np.memmap]] = None
        # seq_len -> (per-shard window counts, exclusive cumsum): built
        # once per seq_len — the window gather is the per-step hot path
        self._tables: Dict[int, tuple] = {}

    @property
    def n_tokens(self) -> int:
        return sum(s["n_tokens"] for s in self.shards)

    def _mapped(self) -> List[np.memmap]:
        if self._maps is None:
            self._maps = [
                np.memmap(os.path.join(self.directory, s["file"]),
                          dtype=self.dtype.newbyteorder("<"), mode="r",
                          shape=(s["n_tokens"],))
                for s in self.shards if s["n_tokens"] > 0]
        return self._maps

    def _window_table(self, seq_len: int) -> tuple:
        if seq_len not in self._tables:
            counts = np.asarray(
                [max(s["n_tokens"] - 1, 0) // seq_len
                 for s in self.shards if s["n_tokens"] > 0], np.int64)
            self._tables[seq_len] = (counts, np.cumsum(counts))
        return self._tables[seq_len]

    def n_windows(self, seq_len: int) -> int:
        return int(self._window_table(seq_len)[0].sum())

    def window(self, i: int, seq_len: int) -> np.ndarray:
        """Window ``i``: ``(seq_len + 1,)`` tokens (inputs + shifted
        labels), copied out of the mmap."""
        return self.windows(np.asarray([i], np.int64), seq_len)[0]

    def windows(self, idx: np.ndarray, seq_len: int) -> np.ndarray:
        """Gather a batch of windows -> ``(len(idx), seq_len + 1)``.
        One vectorized ``searchsorted`` over the cached shard table; the
        mmap reads are the only per-row work."""
        idx = np.asarray(idx, np.int64)
        counts, cum = self._window_table(seq_len)
        total = int(cum[-1]) if len(cum) else 0
        if idx.size and (idx.min() < 0 or idx.max() >= total):
            raise IndexError(f"window index out of range [0, {total})")
        shard_of = np.searchsorted(cum, idx, side="right")
        local = idx - np.where(shard_of > 0, cum[shard_of - 1], 0)
        maps = self._mapped()
        return np.stack([
            np.asarray(maps[s][o:o + seq_len + 1], np.int64)
            for s, o in zip(shard_of, local * seq_len)])

    def tokens(self) -> np.ndarray:
        """The whole split as one array (tests/detokenization only —
        materializes the stream)."""
        maps = self._mapped()
        if not maps:
            return np.zeros((0,), np.int64)
        return np.concatenate([np.asarray(m, np.int64) for m in maps])

    # memmaps don't pickle: drop them, re-open lazily in the child process
    def __getstate__(self):
        d = dict(self.__dict__)
        d["_maps"] = None
        return d


class TokenStore:
    """A built corpus directory: index + tokenizer + split views."""

    def __init__(self, directory: str):
        self.directory = directory
        with open(os.path.join(directory, INDEX_NAME)) as f:
            self.index = json.load(f)
        if self.index.get("version") != FORMAT_VERSION:
            raise ValueError(
                f"corpus {directory} has format version "
                f"{self.index.get('version')}, reader supports "
                f"{FORMAT_VERSION}")
        self.dtype = np.dtype(self.index["dtype"])
        self.vocab_size = int(self.index["vocab_size"])
        self.corpus_hash = self.index["corpus_hash"]
        self._tokenizer = None
        self._views: Dict[str, SplitView] = {}

    @property
    def tokenizer(self):
        if self._tokenizer is None:
            with open(os.path.join(self.directory, TOKENIZER_NAME)) as f:
                self._tokenizer = tokenizer_from_json(json.load(f))
        return self._tokenizer

    def split(self, name: str) -> SplitView:
        if name not in self._views:
            if name not in self.index["splits"]:
                raise KeyError(f"corpus {self.directory} has no split "
                               f"{name!r}; has {list(self.index['splits'])}")
            self._views[name] = SplitView(
                self.directory, self.index["splits"][name]["shards"],
                self.dtype)
        return self._views[name]

    def verify_hash(self) -> bool:
        """Recompute the content hash from bytes on disk (slow; tests and
        the build CLI's --verify use it)."""
        h = hashlib.sha256()
        with open(os.path.join(self.directory, TOKENIZER_NAME)) as f:
            h.update(json.dumps(json.load(f), sort_keys=True).encode())
        for split in self.index["splits"]:
            for s in self.index["splits"][split]["shards"]:
                h.update(split.encode())
                with open(os.path.join(self.directory, s["file"]), "rb") as f:
                    h.update(f.read())
        return h.hexdigest() == self.corpus_hash

    def __getstate__(self):
        d = dict(self.__dict__)
        d["_tokenizer"] = None
        d["_views"] = {}
        return d
