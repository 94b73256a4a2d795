"""Full-tree standard optimizers: Adam, Adam-mini, MUON, SGD-momentum
(counterpart of ``repro/optim/standard.py``).

These are the paper's full-rank baselines (full-rank Adam, MUON) and the
hosts of its optimizer-agnostic comparison.  Each is a rule declaration
over the engine (``optim/engine.py``): same-shaped leaves form a bucket
whose leaves run the rule's ``update`` in flatten order; ``bucketed=False``
gives the unrolled reference, ``state_codec`` the moment storage.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.optim import engine, hosts as hosts_lib
from repro_torch.optim.base import Optimizer, default_eligible
from repro_torch.optim.schedules import Schedule, constant


def _norm_lr(lr):
    return constant(lr) if isinstance(lr, (int, float)) else lr


def host_rule(kind: str, host: hosts_lib.Host, lr: Schedule,
              weight_decay: float = 0.0) -> engine.LeafRule:
    """The host's update on the full tensor: ``p -= lr·lr_mult·precond``."""

    def update(g, p, state, step):
        lr_t = lr(step)
        precond, _, lr_mult, state = host.update(g, state, step)
        q = p.float() - (lr_t * lr_mult) * precond.float()
        if weight_decay:
            q = q - lr_t * weight_decay * p.float()
        return q.to(p.dtype), state

    return engine.LeafRule(kind=kind,
                           init=lambda p: host.init(p.shape, p.device),
                           update=update, slots=host.slots)


def from_host(lr: Schedule | float, host: hosts_lib.Host,
              weight_decay: float = 0.0, bucketed: bool = True,
              state_codec="f32") -> Optimizer:
    rule = host_rule(host.name, host, _norm_lr(lr), weight_decay)
    return engine.build(lambda path, leaf: rule, bucketed=bucketed,
                        codec=state_codec)


def adam(lr, b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.0,
         bucketed: bool = True, state_codec="f32") -> Optimizer:
    return from_host(lr, hosts_lib.adam(b1, b2, eps), weight_decay,
                     bucketed, state_codec)


def adam_mini(lr, b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.0,
              bucketed: bool = True, state_codec="f32") -> Optimizer:
    return from_host(lr, hosts_lib.adam_mini(b1, b2, eps), weight_decay,
                     bucketed, state_codec)


def sgd(lr, momentum: float = 0.9, bucketed: bool = True,
        state_codec="f32") -> Optimizer:
    """SGD with momentum; a leaf's state is its momentum tensor itself."""
    lr = _norm_lr(lr)

    def update(g, p, m, step):
        lr_t = lr(step)
        m = momentum * m.float() + g.float()
        return (p.float() - lr_t * m).to(p.dtype), m

    rule = engine.LeafRule(
        kind="sgd",
        init=lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device),
        update=update, slots=True)
    return engine.build(lambda path, leaf: rule, bucketed=bucketed,
                        codec=state_codec)


def muon(lr, beta=0.95, ns_steps=5, adam_lr: Optional[float] = None,
         bucketed: bool = True, state_codec="f32") -> Optimizer:
    """MUON on the eligible matmul weights of two or more dims whose last
    two are both longer than 1, Adam on the rest (embeddings, heads and
    norms excluded, as is standard: orthogonalizing the embedding
    diverges)."""
    lr = _norm_lr(lr)
    adam_sched = _norm_lr(adam_lr) if adam_lr is not None else lr
    muon_r = host_rule("muon", hosts_lib.muon(beta, ns_steps), lr)
    adam_r = host_rule("plain", hosts_lib.adam(), adam_sched)

    def is_muon(path, p):
        return (p.ndim >= 2 and min(p.shape[-2:]) > 1
                and default_eligible(path, p))

    return engine.build(
        lambda path, leaf: muon_r if is_muon(path, leaf) else adam_r,
        bucketed=bucketed, codec=state_codec)
