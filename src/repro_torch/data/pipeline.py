"""LM data pipeline (counterpart of ``repro/data/pipeline.py``): batch
sources and background prefetch with exact resumability.

Sources (all share the contract *batch ``i`` depends only on
``(config, i)``*, and every batch is bitwise the JAX package's batch ``i``:
the numpy draws, the window map and the sample order are the same code):

* ``synthetic``: a mixture of repeated n-gram "grammars" per document,
* ``bytes``: byte-level tokens from any local file glob,
* ``corpus``: fixed-length windows over a pre-tokenized mmap shard store
  (``repro_torch.data.store``) visited in the pure seeded-shuffle order of
  ``repro_torch.data.order`` — the real pre-training path, with per-host DP
  slicing (``dp_rank``/``dp_size``),
* :class:`TokenizingTextLM`: on-the-fly BPE over raw text — the GIL-heavy
  source the process-worker path
  (``repro_torch.data.workers.ProcessPrefetcher``) exists for;
* :class:`WithEncoderFrames` around any of them: the encoder-decoder
  batches' seeded frame embeddings.

Prefetch runs in a daemon thread with a bounded queue; source exceptions
are captured and re-raised in the consumer (``__next__``), never swallowed
in the worker thread.

This module imports numpy and the standard library only, never torch:
spawned data workers unpickle these sources and must start cheaply,
without CUDA.
"""

from __future__ import annotations

import glob as globlib
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

_ERROR = object()   # Prefetcher queue sentinel: (index slot) for failures


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


class ByteLM:
    """Byte-level tokens from local files (self-hosting corpus: this repo)."""

    def __init__(self, pattern: str, seq_len: int, batch_size: int,
                 seed: int = 0, vocab: int = 256):
        paths = sorted(globlib.glob(pattern, recursive=True))
        if not paths:
            raise FileNotFoundError(f"no files match {pattern!r}")
        blobs = []
        for p in paths:
            try:
                with open(p, "rb") as f:
                    blobs.append(np.frombuffer(f.read(), np.uint8))
            except OSError:
                continue
        self.data = np.concatenate(blobs).astype(np.int32) % vocab
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.seed = seed

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState((self.seed * 1_000_003 + index) % 2**31)
        B, S = self.batch_size, self.seq_len
        starts = rng.randint(0, len(self.data) - S - 1, size=B)
        toks = np.stack([self.data[s:s + S + 1] for s in starts])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class CorpusLM:
    """Fixed-length windows over a pre-tokenized mmap corpus
    (``repro_torch.data.store``), visited in the pure seeded-shuffle order
    of ``repro_torch.data.order.SampleOrder``.

    ``batch_size`` is the GLOBAL batch; ``dp_rank``/``dp_size`` slice it
    per host (rank ``r`` produces rows ``[r·B/H, (r+1)·B/H)`` of every
    batch — concatenating the slices over ranks reproduces the full
    batch bitwise, so per-host loading composes with the sharded train
    path's ``batch_shardings``).  ``split='eval'`` defaults to the
    sequential (unshuffled) order the eval harness streams in.

    Picklable (the mmap re-opens lazily in the child) — this is the
    source the process workers are built around."""

    def __init__(self, corpus_dir: str, seq_len: int, batch_size: int,
                 seed: int = 0, split: str = "train",
                 shuffle: Optional[bool] = None,
                 dp_rank: int = 0, dp_size: int = 1):
        from repro_torch.data.order import SampleOrder
        from repro_torch.data.store import TokenStore
        if batch_size % dp_size:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"dp_size {dp_size}")
        if not 0 <= dp_rank < dp_size:
            raise ValueError(f"dp_rank {dp_rank} outside [0, {dp_size})")
        self.store = TokenStore(corpus_dir)
        self.view = self.store.split(split)
        self.seq_len = seq_len
        self.batch_size = batch_size          # global
        self.local_batch = batch_size // dp_size
        self.dp_rank, self.dp_size = dp_rank, dp_size
        self.seed = seed
        self.split = split
        self.vocab = self.store.vocab_size
        self.n_windows = self.view.n_windows(seq_len)
        if self.n_windows < 1:
            raise ValueError(
                f"corpus split {split!r} has no seq_len={seq_len} windows "
                f"({self.view.n_tokens} tokens)")
        self.shuffle = (split == "train") if shuffle is None else shuffle
        self.order = SampleOrder(self.n_windows, seed) if self.shuffle \
            else None

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        base = index * self.batch_size + self.dp_rank * self.local_batch
        samples = np.arange(base, base + self.local_batch, dtype=np.int64)
        wins = self.order.windows(samples) if self.order is not None \
            else samples % self.n_windows
        toks = self.view.windows(wins, self.seq_len).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class TokenizingTextLM:
    """On-the-fly BPE over raw text: every ``batch(i)`` ENCODES text —
    deliberately GIL-bound pure-python work.  This is the
    tokenization-heavy source the process-worker benchmark gates on; the
    pre-tokenized :class:`CorpusLM` is the fast path for training."""

    def __init__(self, text: str, tokenizer, seq_len: int, batch_size: int,
                 seed: int = 0, chars_per_token: int = 6):
        self.text = text
        self.tokenizer = tokenizer
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.seed = seed
        self.span = (seq_len + 1) * chars_per_token
        if len(text) <= self.span:
            raise ValueError(f"text of {len(text)} chars too short for "
                             f"span {self.span}")

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState((self.seed * 1_000_003 + index) % 2**31)
        starts = rng.randint(0, len(self.text) - self.span,
                             size=self.batch_size)
        S = self.seq_len
        toks = np.zeros((self.batch_size, S + 1), np.int32)
        for r, s in enumerate(starts):
            ids = self.tokenizer.encode(self.text[s:s + self.span])
            ids = ids[:S + 1]
            toks[r, :len(ids)] = ids
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class WithEncoderFrames:
    """Encoder-decoder adapter: rides deterministic frame embeddings
    ``(B, n_frames, d_model)`` f32 along each batch of ``source`` (the
    audio front end's stub for seamless-style training), as
    ``enc_embeds``.  ``batch(i)`` depends only on ``i``: the frames are
    ``np.random.RandomState(i).randn``, the reference's, bitwise."""

    def __init__(self, source, n_frames: int, d_model: int):
        self.source = source
        self.n_frames = n_frames
        self.d_model = d_model
        self.batch_size = source.batch_size

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        b = dict(self.source.batch(index))
        rng = np.random.RandomState(index)
        b["enc_embeds"] = rng.randn(
            self.batch_size, self.n_frames, self.d_model).astype(np.float32)
        return b


def stack_batches(batches) -> Dict[str, np.ndarray]:
    """Stack a list of ``batch(i)`` dicts along a new leading axis —
    the xs of the train loop's scan-over-steps superstep."""
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


class Prefetcher:
    """Bounded-queue background prefetch over ``source.batch(i)``,
    resumable from any step.  Usable as a context manager; batch order is
    exactly ``start_step, start_step+1, ...`` (the consumer may assert the
    yielded index for stream-alignment checks).

    A ``source.batch(i)`` exception does NOT kill the worker silently:
    it is captured, enqueued behind any already-produced batches, and
    re-raised in the consumer's ``__next__`` (repeatedly, if called
    again).  ``close()`` joins the thread (bounded wait), not just sets
    the stop event."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._step = start_step
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        i = self._step
        pending = None
        while not self._stop.is_set():
            if pending is None:
                try:
                    pending = (i, self.source.batch(i))  # computed once
                except BaseException as e:  # noqa: BLE001 - re-raised in
                    self._exc = e           # the consumer, not swallowed
                    pending = (_ERROR, e)
            try:
                self._q.put(pending, timeout=0.5)
                if pending[0] is _ERROR:
                    return
                pending = None
                i += 1
            except queue.Full:   # retry the put only — never the batch gen
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        while True:
            if self._exc is not None:
                # producer is dead (or dying): drain what it finished,
                # then (re-)raise its error instead of blocking forever
                try:
                    i, b = self._q.get_nowait()
                except queue.Empty:
                    raise self._exc
            else:
                i, b = self._q.get()
            if i is _ERROR:
                raise b
            return i, b

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self, timeout: float = 5.0):
        """Stop and JOIN the producer.  The queue is drained while
        joining so a producer blocked in ``put`` returns immediately
        instead of sitting out its 0.5 s timeout — ``close()`` runs once
        per ``TrainLoop.run``, and that stall was measurable in the step
        benchmark's short runs."""
        import time as _time
        self._stop.set()
        deadline = _time.monotonic() + timeout
        while self._thread.is_alive() and _time.monotonic() < deadline:
            try:
                self._q.get_nowait()   # unblock a put()-blocked producer
            except queue.Empty:
                pass
            self._thread.join(0.05)


def make_source(kind: str, vocab: int, seq_len: int, batch_size: int,
                seed: int = 0, pattern: Optional[str] = None,
                enc_frames: int = 0, enc_dim: int = 0,
                corpus_dir: Optional[str] = None, split: str = "train",
                dp_rank: int = 0, dp_size: int = 1):
    """The reference's ``make_source``.  ``split='eval'`` builds the
    held-out stream: the corpus eval split (sequential windows) for
    ``corpus``, a disjoint seed stream for the synthetic/bytes proxies
    (``vocab`` must cover the model's table; the corpus source uses the
    store's own vocab and merely checks it fits).

    ``enc_frames``/``enc_dim`` > 0 wrap the source in
    :class:`WithEncoderFrames` (encoder-decoder training batches)."""
    eval_split = split == "eval"
    if eval_split and kind != "corpus":
        seed = seed ^ 0x5EED_E7A1  # disjoint deterministic stream
    if kind == "synthetic":
        src = SyntheticLM(vocab, seq_len, batch_size, seed)
    elif kind == "bytes":
        src = ByteLM(pattern or "src/**/*.py", seq_len, batch_size, seed,
                     vocab=min(vocab, 256))
    elif kind == "corpus":
        if not corpus_dir:
            raise ValueError("data kind 'corpus' needs corpus_dir "
                             "(--corpus-dir: a directory built by "
                             "repro_torch.data.build_corpus)")
        src = CorpusLM(corpus_dir, seq_len, batch_size, seed=seed,
                       split=split, dp_rank=dp_rank, dp_size=dp_size)
        if src.vocab > vocab:
            raise ValueError(f"corpus vocab {src.vocab} exceeds model "
                             f"vocab {vocab}")
    else:
        raise ValueError(f"unknown data source {kind!r}")
    if enc_frames and enc_dim:
        src = WithEncoderFrames(src, enc_frames, enc_dim)
    return src
