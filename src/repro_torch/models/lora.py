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
from repro_torch.distributed import sharding
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


def merge(tree, alpha: float, rank: int, tp=None, shardings=None):
    """Plain params: each target is ``base + delta``, added in f32 and
    cast back to the base dtype; the other leaves are the base's own.

    Under ``tp`` (the tensor-parallel step along ``model``; ``shardings``
    the ``"lora"`` placements of ``sharding.lora_shardings``) ``tree``
    holds this rank's shards, and each target is the rank's base shard
    plus ``a_local @ b_local * α/r``, its own slice of the delta.  The
    factor a split weight keeps whole (``a`` of a column-parallel weight,
    ``b`` of a row-parallel one) goes through ``tp.copy_in`` first: each
    rank's product gives it only its own columns' (rows') share of the
    gradient, which the all-reduce backward sums.  A weight left whole
    needs no collective here (its model code sums its gradient, or every
    rank computes the whole of it)."""
    if tp is not None and shardings is None:
        raise ValueError("a tensor-parallel merge needs the adapters' "
                         "shardings (sharding.lora_shardings)")

    def pair(sub, sh):
        if tp is None:
            return sub
        nd = sub["a"].ndim
        a, b = sub["a"], sub["b"]
        if nd - 1 in sharding.split_dims(sh["b"]):
            a = tp.copy_in(a)
        if nd - 2 in sharding.split_dims(sh["a"]):
            b = tp.copy_in(b)
        return {"a": a, "b": b}

    def walk(base, lora, sh):
        out = {}
        for k, v in base.items():
            sub = lora.get(k) if isinstance(lora, dict) else None
            ssh = sh.get(k) if isinstance(sh, dict) else None
            if isinstance(v, dict):
                out[k] = walk(v, sub or {}, ssh or {})
            elif sub is not None:
                d = lora_delta(pair(sub, ssh), alpha, rank)
                out[k] = (v.float() + d.float()).to(v.dtype)
            else:
                out[k] = v
        return out

    return walk(tree["base"], tree["lora"], shardings or {})


def split_base(tree):
    """The frozen base subtree (for bitwise-frozen assertions)."""
    return tree["base"]


def wrap_optimizer(inner, state_shardings=None) -> engine.Optimizer:
    """Route ``base/...`` leaves to ``FROZEN``; every other leaf (the
    adapters' ``a``/``b``) keeps the inner optimizer's own rule, codec and
    codec seed, so ``--state-codec int8`` quantizes the adapters' moments as
    it would a whole model's.  ``state_shardings`` (the ``"buckets"`` of
    ``sharding.lora_state_shardings``) keeps the adapter buckets' state
    placed, as ``engine.build`` does."""
    eng = inner.engine
    if eng is None:
        raise ValueError("LoRA wrapping needs an engine-built optimizer")

    def assign(path, leaf):
        if path == "base" or path.startswith("base/"):
            return FROZEN
        return eng.assign(path, leaf)

    return engine.build(assign, bucketed=eng.bucketed, codec=eng.codec,
                        codec_seed=eng.codec_seed,
                        state_shardings=state_shardings)


def loss_module(mod, alpha: float, rank: int, shardings=None):
    """A ``loss_fn``-shaped shim over ``mod`` that merges before the
    forward: for ``data.eval.make_lm_evaluator`` and the train step's
    ``loss=``.  Its ``tp=`` (the tensor-parallel step binds it) merges
    each rank's shards under ``shardings`` (the adapters' placements) and
    runs ``mod``'s tensor-parallel loss."""

    def loss_fn(cfg, tree, batch, tp=None):
        if tp is None:
            return mod.loss_fn(cfg, merge(tree, alpha, rank), batch)
        return mod.loss_fn(cfg, merge(tree, alpha, rank, tp, shardings),
                           batch, tp=tp)

    return SimpleNamespace(loss_fn=loss_fn)


def freeze(tree) -> None:
    """Base leaves ``requires_grad=False``, adapters ``True``, in place
    (the train step computes gradients of the adapters only)."""
    for part, flag in (("base", False), ("lora", True)):
        for t in flatten_with_paths(tree[part])[1]:
            if t.requires_grad != flag:
                t.requires_grad_(flag)


def make_train_step(mod, cfg, optimizer, *, rank: int, alpha: float,
                    accum_steps: int = 1, dp=None, dp_reduce=None,
                    shardings=None, tp=None):
    """``mod.make_train_step`` over the merged forward.  Only the adapters
    get gradients; the ``FROZEN`` rule leaves the base bitwise as it
    was.

    ``dp``, ``dp_reduce``, ``shardings`` and ``tp`` are the sharded
    step's (``models.lm.make_sharded_train_step``): over several data
    ranks the adapters' gradients take the exact mean, and with ``tp``
    (``shardings`` from ``sharding.tp_step_shardings(...,
    lora_rank=)``) each rank holds its shards of the base and the
    adapters, merges them (:func:`merge`) and runs the model's
    tensor-parallel loss; the update gathers each adapter bucket whole
    over ``model``.  The numbers are the replicated step's within
    rounding, the base bitwise."""
    lora_sh = None if shardings is None else shardings.params["lora"]
    shim = loss_module(mod, alpha, rank, lora_sh)
    inner = mod.make_train_step(cfg, optimizer, accum_steps=accum_steps,
                                dp_reduce=dp_reduce, dp=dp,
                                loss=shim.loss_fn, shardings=shardings,
                                tp=tp)

    def train_step(tree, opt_state, batch):
        freeze(tree)
        return inner(tree, opt_state, batch)

    return train_step
