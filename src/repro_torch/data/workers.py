"""Process-worker batch loading: a multiprocessing pool materializing
``source.batch(i)`` into shared memory behind the thread-``Prefetcher``'s
exact ``(index, batch)`` queue contract (a copy of
``repro/data/workers.py``).

Why processes: the thread Prefetcher decouples *latency* but not *CPU* —
a tokenization-heavy source (pure-python BPE encode) holds the GIL, so
the producer thread and the training host serialize.  Worker processes
each own an interpreter; throughput scales with workers.

Transport: one ``SharedMemory`` segment carved into ``depth`` slots.  A
worker computes a batch, claims a free slot, writes each array into the
slot, and sends ``(index, slot, layout)`` over the (tiny) result queue —
batch payloads never pass through a pickle pipe.  The parent reorders
out-of-order completions in a small dict and emits strictly
``start_step, start_step+1, ...``; because every source's ``batch(i)``
is a pure function of ``i``, the emitted stream is **bitwise identical**
to the thread path for any worker count (tested).

Determinism / resume: nothing here has state worth checkpointing — kill
it, change ``num_workers``, restart at any step; the stream realigns by
construction.

Failure modes mirror the fixed thread Prefetcher: a worker exception is
shipped back (as a pickled exception + formatted traceback) and
re-raised in the consumer's ``__next__``; ``close()`` tears down the
pool (join with timeout, then terminate) and unlinks the segment.

The default start method is ``spawn`` — fork-safety with an initialized
CUDA context in the parent is not worth betting on — which is why the
whole ``repro_torch.data`` store/order/tokenizer/pipeline import graph
stays numpy-only: child startup is an interpreter + numpy import, and no
data worker ever creates a CUDA context.  (Spawn does re-import the
parent's ``__main__``; the port's entry points keep their work under the
``__main__`` check, so that import runs no phase.)
"""

from __future__ import annotations

import multiprocessing as mp
import queue as queue_lib
import threading
import traceback
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

_STOP = None        # task-queue sentinel


def _slot_layout(batch: Dict[str, np.ndarray]) -> Tuple[list, int]:
    """(per-key (name, shape, dtype, offset) table, total bytes) for one
    batch dict — every source yields fixed shapes, so one probe sizes
    the slots for the whole run."""
    layout, off = [], 0
    for k in sorted(batch):
        a = np.ascontiguousarray(batch[k])
        layout.append((k, a.shape, a.dtype.str, off))
        off += a.nbytes
    return layout, off


def _write_slot(buf: memoryview, base: int, batch: Dict[str, np.ndarray],
                layout: list):
    for k, shape, dtype, off in layout:
        a = np.ascontiguousarray(batch[k]).astype(dtype, copy=False)
        dst = np.ndarray(shape, dtype, buffer=buf, offset=base + off)
        dst[...] = a


def _read_slot(buf: memoryview, base: int, layout: list
               ) -> Dict[str, np.ndarray]:
    out = {}
    for k, shape, dtype, off in layout:
        src = np.ndarray(shape, dtype, buffer=buf, offset=base + off)
        out[k] = np.array(src, copy=True)   # copy out before slot reuse
    return out


def _worker_main(source, shm_name: str, slot_bytes: int, tasks, free,
                 results):
    """Worker process body: batch -> claim slot -> write -> report."""
    from multiprocessing import shared_memory
    shm = shared_memory.SharedMemory(name=shm_name)
    try:
        while True:
            i = tasks.get()
            if i is _STOP:
                return
            try:
                batch = source.batch(i)
                layout, nbytes = _slot_layout(batch)
                if nbytes > slot_bytes:
                    raise ValueError(
                        f"batch {i} needs {nbytes}B > slot {slot_bytes}B "
                        f"(source shapes changed mid-stream?)")
                slot = free.get()
                _write_slot(shm.buf, slot * slot_bytes, batch, layout)
                results.put(("ok", i, slot, layout))
            except Exception as e:  # noqa: BLE001 - shipped to consumer
                results.put(("err", i, e, traceback.format_exc()))
                return
    finally:
        shm.close()


class ProcessPrefetcher:
    """Drop-in for :class:`repro_torch.data.pipeline.Prefetcher` backed by
    ``num_workers`` processes + shared-memory slots.  Same protocol:
    iterate for ``(index, batch)`` pairs in exact step order; ``close()``
    (or the context manager) tears the pool down."""

    def __init__(self, source, start_step: int = 0, depth: int = 4,
                 num_workers: int = 2, mp_method: str = "spawn"):
        from multiprocessing import shared_memory
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        self.source = source
        self._next_emit = start_step
        depth = max(depth, num_workers + 1)
        ctx = mp.get_context(mp_method)
        # one probe batch sizes the slots (recomputed by a worker — the
        # probe is discarded so the emitted stream has a single producer)
        layout, nbytes = _slot_layout(source.batch(start_step))
        self._slot_bytes = max(nbytes, 1)
        self._shm = shared_memory.SharedMemory(
            create=True, size=self._slot_bytes * depth)
        # BOUNDED task queue: the queue's own maxsize is the feeder's
        # backpressure (mp.Queue.qsize() is unimplemented on macOS, so a
        # qsize-based high-water mark is not portable)
        self._tasks = ctx.Queue(maxsize=depth + num_workers)
        self._free = ctx.Queue()
        for s in range(depth):
            self._free.put(s)
        self._results = ctx.Queue()
        self._procs: List = [
            ctx.Process(target=_worker_main,
                        args=(source, self._shm.name, self._slot_bytes,
                              self._tasks, self._free, self._results),
                        daemon=True)
            for _ in range(num_workers)]
        for p in self._procs:
            p.start()
        # feeder thread keeps ~depth tasks in flight (bounded by the task
        # queue's maxsize; workers additionally block on the free-slot
        # ring, so host memory never grows with the step count)
        self._stop = threading.Event()
        self._feeder = threading.Thread(target=self._feed,
                                        args=(start_step,), daemon=True)
        self._feeder.start()
        self._pending: Dict[int, Tuple[int, list]] = {}
        self._exc: Optional[BaseException] = None
        self._exc_at: Optional[int] = None   # first failed batch index
        self._closed = False

    def _feed(self, start: int):
        i = start
        while not self._stop.is_set():
            try:
                self._tasks.put(i, timeout=0.1)
                i += 1
            except queue_lib.Full:   # bounded queue = the backpressure
                continue

    # -- consumer ----------------------------------------------------------
    def __iter__(self) -> Iterator:
        return self

    def _absorb(self, msg):
        """Copy a completion out of its slot and free the slot
        IMMEDIATELY — holding slots for out-of-order pendings could
        exhaust the ring while the wanted batch's worker blocks on
        ``free.get()`` (classic reorder deadlock).  Pending host copies
        are bounded by the feeder high-water mark."""
        if msg[0] == "err":
            _, i, exc, tb = msg
            if self._exc_at is None or i < self._exc_at:
                exc.args = (f"{exc.args[0] if exc.args else exc!r} "
                            f"[in data worker, batch {i}]\n{tb}",) \
                    + tuple(exc.args[1:])
                self._exc, self._exc_at = exc, i
            return
        _, i, slot, layout = msg
        batch = _read_slot(self._shm.buf, slot * self._slot_bytes, layout)
        self._free.put(slot)
        if i >= self._next_emit:
            self._pending[i] = batch

    def __next__(self):
        want = self._next_emit
        while want not in self._pending:
            try:                      # drain everything already completed
                self._absorb(self._results.get_nowait())
                continue
            except queue_lib.Empty:
                pass
            if self._exc is not None:
                # the stream is valid strictly below the first failed
                # index (workers take tasks in order, so batches < exc_at
                # belong to workers that finished or are still alive) —
                # raise only once the consumer reaches it, or when the
                # whole pool is dead and the batch can never arrive
                if (self._exc_at is None or want >= self._exc_at
                        or not any(p.is_alive() for p in self._procs)):
                    raise self._exc
            try:
                self._absorb(self._results.get(timeout=0.5))
            except queue_lib.Empty:
                if not any(p.is_alive() for p in self._procs):
                    self._exc = RuntimeError(
                        "all data workers exited without producing "
                        f"batch {want}")
        batch = self._pending.pop(want)
        self._next_emit = want + 1
        return want, batch

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self) -> "ProcessPrefetcher":
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self, timeout: float = 5.0):
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._feeder.join(timeout)
        for _ in self._procs:
            try:
                self._tasks.put_nowait(_STOP)
            except queue_lib.Full:
                break
        deadline = timeout
        for p in self._procs:
            p.join(timeout=max(deadline / max(len(self._procs), 1), 0.2))
            if p.is_alive():
                p.terminate()
                p.join(timeout=1.0)
        for q in (self._tasks, self._free, self._results):
            q.cancel_join_thread()
            q.close()
        try:
            self._shm.close()
            self._shm.unlink()
        except FileNotFoundError:
            pass
