"""The checked steps of a training cell, computed by the reference: from
the benchmark's weights and batches, each step's loss, the first
gradient's norm per leaf as the moments see it, and each leaf's change
over the steps.  ``precision="fp8"`` puts the control in the program's
place."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from gpubench.reference import model, optim


def readings(spec: model.Spec, rule: optim.Rule,
             weights: Dict[str, torch.Tensor], batches: List[dict],
             accum: int, start_of, precision: str = "f32",
             seed: int = 0) -> dict:
    """Runs ``len(batches)`` steps in place on ``weights`` (the model
    dtype; ``start_of(leaf)`` gives a leaf's starting value again) and
    returns ``{"losses": [...], "grad": {leaf: |band(g1)|},
    "grad_full": {leaf: |g1|}, "delta": {leaf: |w_end - w_start|}}``."""
    allow = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        opt = optim.Optimizer(rule, weights, seed=seed)
        dev = next(iter(weights.values())).device
        out = {"losses": []}
        for i, b in enumerate(batches):
            tokens = torch.from_numpy(np.asarray(b["tokens"])).to(dev)
            labels = torch.from_numpy(np.asarray(b["labels"])).to(dev)
            loss, grads = model.batch_loss_and_grads(
                spec, weights, tokens, labels, accum, precision)
            out["losses"].append(float(loss))
            if i == 0:
                out["grad"] = opt.band_norms(grads)
                out["grad_full"] = {k: optim.norm(g)
                                    for k, g in grads.items()}
            opt.update(weights, grads)
            del grads
        out["delta"] = {k: optim.norm(w.float() - start_of(k).float())
                        for k, w in weights.items()}
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = allow
