"""Atomic checkpoints in the JAX package's on-disk format (counterpart of
``repro/checkpoint/manager.py``), so each package reads the other's.

Layout, one directory per step::

    <dir>/step_000000123/
        manifest.json     # step, each leaf's shape and numpy dtype name, run
        arr_000000.bin    # each leaf's raw bytes, C order, in flatten order
        COMMITTED         # written last

The tree is flattened in JAX order (sorted dict keys at every level), so a
training checkpoint ``{"opt": ..., "params": ...}`` has the optimizer state
first.  A directory is written as ``step_%09d.tmp`` and renamed; only
committed steps count, and the newest ``gc_keep`` are kept.

Dtype names are numpy's: ``float32``, ``int8``, ``int32``, ``uint32``, and
``bfloat16`` for bf16 leaves, whose bytes are the raw 16-bit patterns.  No
``ml_dtypes`` is needed on either side.

A tree whose leaves are shards of a placed layout (``--shard-params
auto``) is saved whole: ``save(gather=...)`` gathers each leaf on every
rank before its host copy, and only the writing rank copies and writes.
``restore(place=...)`` cuts each whole leaf to the resuming run's shard as
it is read, so a checkpoint crosses layouts and device counts.

``save`` is asynchronous by default.  The port's kernels update parameters
and moments in place, so every leaf is copied to the host before the writer
thread starts: a later step cannot reach the bytes being written.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim.base import flatten_with_paths, unflatten

# torch dtype -> manifest name; bf16 travels as its uint16 bit pattern
_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
          torch.int8: "int8", torch.int32: "int32", torch.uint32: "uint32"}


class StructureMismatch(ValueError):
    """The checkpoint's leaves do not match the requested ``like`` tree in
    count or shape (e.g. a state saved under another codec); callers catch
    it to restore into another layout and convert."""


def to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of ``t`` as ``(array, manifest dtype name)``; a bf16
    tensor becomes its uint16 bit pattern."""
    if t.dtype not in _NAMES:
        raise TypeError(f"no checkpoint dtype for {t.dtype}")
    h = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return h.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return h.numpy(), _NAMES[t.dtype]


def from_numpy(a: np.ndarray, name: str, dtype: Optional[torch.dtype],
               device) -> torch.Tensor:
    """Inverse of :func:`to_numpy`: ``a`` holds the bytes of a leaf of
    manifest dtype ``name``; the result is cast to ``dtype`` if given."""
    if name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    return t.to(device)


def _np_dtype(name: str) -> np.dtype:
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


class CheckpointManager:
    def __init__(self, directory: str, gc_keep: int = 3,
                 run_meta: Optional[dict] = None):
        """``run_meta`` (JSON-serializable) is stamped into every manifest
        under ``"run"``: the launcher records the data provenance and the
        state codec there."""
        self.dir = directory
        self.gc_keep = gc_keep
        self.run_meta = run_meta
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}")

    def committed_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp") \
                    and os.path.exists(os.path.join(self.dir, name,
                                                    "COMMITTED")):
                steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def manifest(self, step: Optional[int] = None) -> dict:
        """The saved manifest of ``step`` (default: the latest)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        with open(os.path.join(self._step_dir(step), "manifest.json")) as f:
            return json.load(f)

    def saved_run(self, step: Optional[int] = None) -> dict:
        """The ``run_meta`` stamped into the saved manifest ({} if none)."""
        return self.manifest(step).get("run") or {}

    # -- save --------------------------------------------------------------
    def _write(self, step: int, arrays: List[Tuple[np.ndarray, str]]):
        d = self._step_dir(step)
        tmp = d + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        meta = {"step": step, "leaves": []}
        if self.run_meta is not None:
            meta["run"] = self.run_meta
        for i, (arr, name) in enumerate(arrays):
            with open(os.path.join(tmp, f"arr_{i:06d}.bin"), "wb") as f:
                f.write(np.ascontiguousarray(arr).tobytes())
            meta["leaves"].append({"shape": list(arr.shape), "dtype": name})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(tmp, "COMMITTED"), "w") as f:
            f.write("ok")
        shutil.rmtree(d, ignore_errors=True)
        os.rename(tmp, d)
        self._gc()

    def _gc(self):
        for s in self.committed_steps()[:-self.gc_keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def save(self, step: int, tree: Any, *, blocking: bool = False,
             gather: Optional[Callable[[str, torch.Tensor],
                                       torch.Tensor]] = None,
             write: bool = True):
        """Write ``tree`` (a dict tree of tensors) as step ``step``.  The
        previous asynchronous save is joined first.  Every leaf is copied
        to the host here, in the caller's thread; only the file writes run
        in the background unless ``blocking``.

        ``gather(path, leaf) -> whole leaf`` (a collective: every rank of
        a placed layout calls ``save`` with it) is applied leaf by leaf in
        flatten order, each whole leaf dying after its host copy;
        ``write=False`` takes part in the gathers and writes nothing."""
        self.wait()
        arrays = []
        for path, t in zip(*flatten_with_paths(tree)):
            whole = t if gather is None else gather(path, t)
            if write:
                arrays.append(to_numpy(whole))
            del whole
        if not write:
            return
        if blocking:
            self._write(step, arrays)
            return
        self._thread = threading.Thread(target=self._write,
                                        args=(step, arrays), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- restore -----------------------------------------------------------
    def restore(self, step: Optional[int], like: Any, device=None,
                place: Optional[Callable[[str, torch.Tensor],
                                         torch.Tensor]] = None):
        """Restore step ``step`` (default: the latest) into the structure
        of ``like``, a dict tree of tensors (``meta`` tensors will do).
        Each leaf takes its ``like`` leaf's dtype, and goes to ``device``,
        or to the ``like`` leaf's device when ``device`` is None.  Raises
        :class:`StructureMismatch` when leaf counts or shapes differ.
        ``place(path, whole leaf) -> leaf`` (a run's placement: this rank's
        shard) is applied to each leaf as it is read.  Returns ``(tree,
        step)``."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        d = self._step_dir(step)
        meta = self.manifest(step)
        paths, leaves = flatten_with_paths(like)
        if len(leaves) != len(meta["leaves"]):
            raise StructureMismatch(
                f"checkpoint step {step} has {len(meta['leaves'])} leaves, "
                f"'like' tree has {len(leaves)}")
        for path, leaf, lm in zip(paths, leaves, meta["leaves"]):
            if tuple(leaf.shape) != tuple(lm["shape"]):
                raise StructureMismatch(
                    f"{path}: checkpoint shape {tuple(lm['shape'])} != "
                    f"requested {tuple(leaf.shape)}")
        return unflatten(paths, self._read(d, 0, leaves, meta["leaves"],
                                           device, paths, place)), step

    @staticmethod
    def _read(d: str, offset: int, leaves, metas, device, paths=None,
              place=None) -> List[Any]:
        """Leaves ``offset ..`` of step directory ``d``, each in its
        ``like`` leaf's dtype, on ``device`` or the ``like`` leaf's, each
        through ``place(path, leaf)`` if given."""
        out = []
        for i, (leaf, lm) in enumerate(zip(leaves, metas)):
            with open(os.path.join(d, f"arr_{offset + i:06d}.bin"),
                      "rb") as f:
                arr = np.frombuffer(f.read(), dtype=_np_dtype(lm["dtype"])) \
                    .reshape(lm["shape"])
            t = from_numpy(arr, lm["dtype"], leaf.dtype,
                           leaf.device if device is None else device)
            out.append(t if place is None else place(paths[i], t))
            del t
        return out

    def restore_params(self, step: Optional[int], like_params: Any,
                       device=None):
        """Restore ONLY the model parameters of a training checkpoint, the
        serving load path (``serve.engine.Engine.from_checkpoint``).

        Training saves ``{"opt": ..., "params": ...}``, and dict keys
        flatten sorted (``"opt" < "params"``), so the parameters are the
        manifest's TRAILING leaves: they are read by that offset and the
        optimizer state is never read.  A checkpoint of a bare params tree
        loads the same way, at offset 0.  Each trailing leaf's shape is
        checked against ``like_params`` (``meta`` tensors will do; then
        pass ``device``); a disagreement raises :class:`StructureMismatch`
        instead of serving wrong weights.  Returns ``(params, step)``."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        meta = self.manifest(step)
        paths, leaves = flatten_with_paths(like_params)
        offset = len(meta["leaves"]) - len(leaves)
        if offset < 0:
            raise StructureMismatch(
                f"checkpoint step {step} has {len(meta['leaves'])} leaves "
                f"but the params tree alone has {len(leaves)}")
        metas = meta["leaves"][offset:]
        for i, (path, leaf, lm) in enumerate(zip(paths, leaves, metas)):
            if tuple(leaf.shape) != tuple(lm["shape"]):
                raise StructureMismatch(
                    f"{path} (manifest leaf {offset + i}): "
                    f"checkpoint shape {tuple(lm['shape'])} != requested "
                    f"{tuple(leaf.shape)}: is this checkpoint from the same "
                    f"arch config?")
        return unflatten(paths, self._read(self._step_dir(step), offset,
                                           leaves, metas, device)), step
