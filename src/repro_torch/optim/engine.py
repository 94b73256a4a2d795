"""Leaf plan + bucketed execution (counterpart of ``repro/optim/engine.py``,
f32 state only).

1. **LeafPlan** — every '/'-joined leaf path gets a :class:`LeafRule` from
   the optimizer's ``assign`` function.
2. **Buckets** — leaves with identical ``(rule.kind, rule.sig, shape,
   dtype)`` are grouped and named ``"<kind>__<first path, / → .>"``, so the
   names equal the JAX package's.
3. **Execution** — one ``vector_update`` call over the stacked ``(L, ...)``
   bucket when the rule has one (the fused GWT-Adam kernel), else the
   rule's per-leaf ``update`` in flatten order.

State layout::

    {"step": int32 scalar tensor,
     "buckets": {"<kind>__<path>": <per-leaf state stacked on a leading axis>}}

``update`` writes the new parameter values into the parameter tensors in
place.  Stacking a bucket copies its gradients and parameters into one
contiguous ``(L, ...)`` tensor per call.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.optim.base import Optimizer, flatten_with_paths, tree_map


class LeafRule(NamedTuple):
    """How one leaf updates.

    * ``kind`` — rule family name; the bucket-name prefix.
    * ``init(leaf) -> state`` — per-leaf state (a dict of tensors) from a
      tensor (a ``meta`` tensor gives a ``meta`` state).
    * ``update(g, p, state, step) -> (new_p, new_state)`` — one leaf.
    * ``sig`` — extra static signature that must also match to bucket.
    * ``vector_update(g_stk, p_stk, state_stk, step) -> (new_p_stk,
      new_state_stk)`` — optional, over the whole stacked bucket.
    """

    kind: str
    init: Callable[[torch.Tensor], Any]
    update: Callable[..., Tuple[torch.Tensor, Any]]
    sig: Tuple = ()
    vector_update: Optional[Callable[..., Tuple[torch.Tensor, Any]]] = None


class Bucket(NamedTuple):
    name: str
    rule: LeafRule
    indices: Tuple[int, ...]   # positions in flatten order
    paths: Tuple[str, ...]


class LeafPlan(NamedTuple):
    buckets: Tuple[Bucket, ...]


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` (the JAX dtype spelling)."""
    return str(dtype).replace("torch.", "")


def build_plan(assign: Callable[[str, Any], LeafRule], params) -> LeafPlan:
    """Group leaves into buckets of identical ``(kind, sig, shape, dtype)``;
    buckets are ordered by their first leaf."""
    paths, leaves = flatten_with_paths(params)
    groups: dict = {}
    for i, (path, leaf) in enumerate(zip(paths, leaves)):
        rule = assign(path, leaf)
        key = (rule.kind, rule.sig, tuple(leaf.shape), dtype_name(leaf.dtype))
        if key in groups:
            groups[key][1].append(i)
        else:
            groups[key] = (rule, [i])
    buckets = [Bucket(name=f"{rule.kind}__{paths[idxs[0]].replace('/', '.')}",
                      rule=rule, indices=tuple(idxs),
                      paths=tuple(paths[i] for i in idxs))
               for rule, idxs in sorted(groups.values(),
                                        key=lambda g: g[1][0])]
    return LeafPlan(tuple(buckets))


def _stack_states(per_leaf: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    return tree_map(lambda *xs: torch.stack(xs), *per_leaf)


def _slice_state(state: Dict[str, Any], j: int) -> Dict[str, Any]:
    return tree_map(lambda a: a[j], state)


class Engine:
    """Plan companion of an engine-built :class:`Optimizer`.  The plan
    depends only on paths, shapes and dtypes, so it is cached per
    structure."""

    def __init__(self, assign: Callable[[str, Any], LeafRule]):
        self.assign = assign
        self._plans: Dict[tuple, LeafPlan] = {}

    def plan(self, params) -> LeafPlan:
        paths, leaves = flatten_with_paths(params)
        key = tuple((p, tuple(l.shape), l.dtype)
                    for p, l in zip(paths, leaves))
        if key not in self._plans:
            self._plans[key] = build_plan(self.assign, params)
        return self._plans[key]


def build(assign: Callable[[str, Any], LeafRule]) -> Optimizer:
    """Build an :class:`Optimizer` from a leaf-rule assignment."""
    eng = Engine(assign)

    def init(params):
        plan = eng.plan(params)
        _, leaves = flatten_with_paths(params)
        buckets = {b.name: _stack_states([b.rule.init(leaves[i])
                                          for i in b.indices])
                   for b in plan.buckets}
        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=leaves[0].device),
                "buckets": buckets}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"]
        plan = eng.plan(params)
        _, gleaves = flatten_with_paths(grads)
        _, pleaves = flatten_with_paths(params)
        new_buckets = {}
        for b in plan.buckets:
            st = state["buckets"][b.name]
            if b.rule.vector_update is not None:
                g_stk = torch.stack([gleaves[i] for i in b.indices])
                p_stk = torch.stack([pleaves[i] for i in b.indices])
                np_stk, ns = b.rule.vector_update(g_stk, p_stk, st, step)
                for j, i in enumerate(b.indices):
                    pleaves[i].copy_(np_stk[j])
            else:
                per_leaf = []
                for j, i in enumerate(b.indices):
                    new_p, ns_j = b.rule.update(gleaves[i], pleaves[i],
                                                _slice_state(st, j), step)
                    pleaves[i].copy_(new_p)
                    per_leaf.append(ns_j)
                ns = _stack_states(per_leaf)
            new_buckets[b.name] = ns
        return params, {"step": step + 1, "buckets": new_buckets}

    return Optimizer(init, update, engine=eng)


def state_bytes(state) -> int:
    """Exact optimizer-state bytes: the sum over every state tensor."""
    return sum(t.numel() * t.element_size()
               for t in flatten_with_paths(state)[1])
