"""Streaming held-out evaluation: perplexity over a fixed eval stream
(counterpart of ``repro/data/eval.py``).

``Evaluator`` wraps a per-batch loss and a batch source (usually the
corpus eval split via ``make_source(..., split='eval')`` — sequential
windows, no shuffle) and reduces the mean of the per-batch mean token
losses over a FIXED number of batches, so successive evaluations along a
run are comparable points on one curve.  It only *reads* the parameters,
under ``torch.no_grad()``: calling it between train chunks cannot perturb
training numerics.

This is the one module of ``repro_torch.data`` that imports torch (the
worker-process modules must stay numpy-only).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch


class Evaluator:
    """Callable ``(params, step) -> {'loss', 'ppl', 'n_batches'}``;
    appends every result to ``history`` as ``(step, loss)``."""

    def __init__(self, loss_fn: Callable, source, n_batches: int = 8,
                 device="cpu", name: str = "eval"):
        """``loss_fn(params, batch) -> scalar mean token loss`` (a tensor
        on ``device``); ``source`` follows the ``batch(i)`` contract;
        batches ``0..n_batches-1`` form the eval set."""
        if n_batches < 1:
            raise ValueError(f"n_batches must be >= 1, got {n_batches}")
        self.source = source
        self.n_batches = n_batches
        self.device = torch.device(device)
        self.name = name
        self.history: List[Tuple[int, float]] = []
        self._loss_fn = loss_fn

    @torch.no_grad()
    def __call__(self, params, step: Optional[int] = None) -> dict:
        per_batch = []
        for i in range(self.n_batches):
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.source.batch(i).items()}
            per_batch.append(self._loss_fn(params, batch).float())
        # one fetch; the python sum adds in batch order, as the reference's
        # running ``total += float(loss)`` does
        loss = sum(torch.stack(per_batch).tolist()) / self.n_batches
        ppl = math.exp(min(loss, 30.0))   # overflow guard for random init
        if step is not None:
            self.history.append((step, loss))
        return {"loss": loss, "ppl": ppl, "n_batches": self.n_batches}


def make_lm_evaluator(cfg, mod, source, n_batches: int = 8,
                      device="cpu") -> Evaluator:
    """Evaluator over a model module's ``loss_fn(cfg, params, batch)``
    (``models.lm``).

    When the source is a window-counted corpus split (it exposes
    ``n_windows``/``local_batch``, i.e. ``CorpusLM``), ``n_batches`` is
    CAPPED so the eval set never wraps past the unique held-out windows
    — "perplexity over N batches" must not silently re-score the same
    few windows on a small eval split."""
    n_windows = getattr(source, "n_windows", None)
    rows = getattr(source, "local_batch", None)
    if n_windows and rows:
        unique_batches = max(n_windows // rows, 1)
        if n_batches > unique_batches:
            print(f"[eval] capping eval batches {n_batches} -> "
                  f"{unique_batches}: the held-out split has only "
                  f"{n_windows} windows of {rows} rows")
            n_batches = unique_batches

    def loss(params, batch):
        return mod.loss_fn(cfg, params, batch)
    return Evaluator(loss, source, n_batches=n_batches, device=device)
