"""LoRA fine-tuning (counterpart of ``repro/models/lora.py``): a frozen base
and adapter leaves, for every model the port builds.

The parameter tree becomes::

    {"base": <the model's params>,          # bitwise frozen
     "lora": <mirror subtree of {"a", "b"} pairs for the target projections>}

and the forward runs on ``merge(tree)``, the base plus the ``a @ b * α/r``
deltas, so no model's forward knows about adapters.

The frozen base goes through the engine's leaf plan: :func:`wrap_optimizer`
gives every ``base/...`` leaf the zero-state ``optim.engine.FROZEN`` rule
and keeps the inner optimizer's own rule for ``lora/...`` leaves, so
``engine.state_bytes`` counts the adapters' state only, and GWT keeps the
adapters' moments on the approximation band (``--state-codec int8``:
blocked int8).

Where the JAX package computes base gradients and the frozen rule drops
them, the port's step gives the base leaves ``requires_grad=False``: the
adapters' gradients are the same (the merged weight's gradient is formed
either way), and no base gradient is stored.
"""

from __future__ import annotations

import zlib
from types import SimpleNamespace

from repro_torch.core import prng
from repro_torch.models.layers import lora_delta, lora_pair_init
from repro_torch.optim import engine
from repro_torch.optim.base import flatten_with_paths

# Last path segments that receive adapters: the attention and MLP
# projections.  Stacked-layer (n_periods, m, n) and per-expert (E, m, n)
# leaves batch through lora_pair_init unchanged.
LORA_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

# the zero-state rule of the base leaves
FROZEN = engine.FROZEN


def _is_target(name: str, leaf) -> bool:
    return name in LORA_TARGETS and leaf.ndim >= 2


def inject(params, rank: int, key: prng.Key):
    """Wrap ``params`` into a ``{"base", "lora"}`` tree.

    ``merge(inject(p, r, k)) == p`` bitwise at init (``b`` starts at zero).
    Leaf ``path``'s key is ``fold_in(key, crc32(path))``, so the same key
    gives the JAX package's adapters (within ``core.prng``'s normals), in
    any dict order.  Adapters live on their weight's device; on ``meta``
    nothing is drawn."""

    def mirror(tree, prefix):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, dict):
                sub = mirror(v, path)
                if sub:
                    out[k] = sub
            elif _is_target(str(k), v):
                kk = prng.fold_in(key, zlib.crc32(path.encode()))
                out[k] = lora_pair_init(kk, tuple(v.shape), rank, v.device)
        return out

    return {"base": params, "lora": mirror(params, "")}


def merge(tree, alpha: float, rank: int):
    """Plain params: each target is ``base + delta``, added in f32 and
    cast back to the base dtype; the other leaves are the base's own."""

    def walk(base, lora):
        out = {}
        for k, v in base.items():
            sub = lora.get(k) if isinstance(lora, dict) else None
            if isinstance(v, dict):
                out[k] = walk(v, sub or {})
            elif sub is not None:
                d = lora_delta(sub, alpha, rank)
                out[k] = (v.float() + d.float()).to(v.dtype)
            else:
                out[k] = v
        return out

    return walk(tree["base"], tree["lora"])


def split_base(tree):
    """The frozen base subtree (for bitwise-frozen assertions)."""
    return tree["base"]


def wrap_optimizer(inner) -> engine.Optimizer:
    """Route ``base/...`` leaves to ``FROZEN``; every other leaf (the
    adapters' ``a``/``b``) keeps the inner optimizer's own rule, codec and
    codec seed, so ``--state-codec int8`` quantizes the adapters' moments as
    it would a whole model's."""
    eng = inner.engine
    if eng is None:
        raise ValueError("LoRA wrapping needs an engine-built optimizer")

    def assign(path, leaf):
        if path == "base" or path.startswith("base/"):
            return FROZEN
        return eng.assign(path, leaf)

    return engine.build(assign, bucketed=eng.bucketed, codec=eng.codec,
                        codec_seed=eng.codec_seed)


def loss_module(mod, alpha: float, rank: int):
    """A ``loss_fn``-shaped shim over ``mod`` that merges before the
    forward: for ``data.eval.make_lm_evaluator`` and the train step's
    ``loss=``."""

    def loss_fn(cfg, tree, batch):
        return mod.loss_fn(cfg, merge(tree, alpha, rank), batch)

    return SimpleNamespace(loss_fn=loss_fn)


def freeze(tree) -> None:
    """Base leaves ``requires_grad=False``, adapters ``True``, in place
    (the train step computes gradients of the adapters only)."""
    for part, flag in (("base", False), ("lora", True)):
        for t in flatten_with_paths(tree[part])[1]:
            if t.requires_grad != flag:
                t.requires_grad_(flag)


def make_train_step(mod, cfg, optimizer, *, rank: int, alpha: float,
                    accum_steps: int = 1):
    """``mod.make_train_step`` over the merged forward.  Only the adapters
    get gradients; the ``FROZEN`` rule leaves the base bitwise as it
    was."""
    shim = loss_module(mod, alpha, rank)
    inner = mod.make_train_step(cfg, optimizer, accum_steps=accum_steps,
                                loss=shim.loss_fn)

    def train_step(tree, opt_state, batch):
        freeze(tree)
        return inner(tree, opt_state, batch)

    return train_step
