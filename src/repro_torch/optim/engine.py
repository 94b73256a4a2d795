"""Leaf plan + bucketed execution (counterpart of ``repro/optim/engine.py``).

1. **LeafPlan** — every '/'-joined leaf path gets a :class:`LeafRule` from
   the optimizer's ``assign`` function.
2. **Buckets** — leaves with identical ``(rule.kind, rule.sig, shape,
   dtype)`` are grouped and named ``"<kind>__<first path, / → .>"``, so the
   names equal the JAX package's.
3. **Execution** — one ``vector_update`` call over the stacked ``(L, ...)``
   bucket when the rule has one (the fused GWT-Adam kernels), else the
   rule's per-leaf ``update`` in flatten order.  ``build(bucketed=False)``
   is the unrolled per-leaf reference: every leaf runs ``update``, even
   where the rule has a ``vector_update``, and the state keeps the
   bucketed layout.

State layout::

    {"step": int32 scalar tensor,
     ["codec_key": uint32 scalar tensor,]      # quantizing codecs only
     "buckets": {"<kind>__<path>": <per-leaf state stacked on a leading axis>}}

**State codec** (``optim/codec.py``): rules mark their moment slots
(``LeafRule.slots``) and :func:`build` takes a ``codec``.  With ``int8`` the
slots are stored encoded: a ``codec_native`` rule's ``vector_update`` gets
the encoded bucket whole (the fused q8 kernel requantizes inside its
launch); any other rule runs decode -> ``update`` -> encode per leaf.  The
rounding salts of a step, ``slot_salt(key, step, slot, leaf)`` for every
slot and flatten-order leaf index, are one ``(slots, leaves)`` table made
in one vector op from index tensors cached per plan, so the update creates
no tensor from host data.  A codec-native rule gets its bucket's columns,
a per-leaf encode its leaf's column.  The ``f32`` codec skips all of it.
:func:`transcode` re-encodes a state between codecs.

``update`` writes the new parameter values into the parameter tensors in
place.  Stacking a bucket copies its gradients and parameters into one
contiguous ``(L, ...)`` tensor per call.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.optim import codec as codec_lib
from repro_torch.optim.base import Optimizer, flatten_with_paths, tree_map


class LeafRule(NamedTuple):
    """How one leaf updates.

    * ``kind`` — rule family name; the bucket-name prefix.
    * ``init(leaf) -> state`` — per-leaf state (a dict of tensors) from a
      tensor (a ``meta`` tensor gives a ``meta`` state).
    * ``update(g, p, state, step) -> (new_p, new_state)`` — one leaf; the
      only path of an unrolled engine (``build(bucketed=False)``) and of
      a rule without ``vector_update``.
    * ``sig`` — extra static signature that must also match to bucket.
    * ``vector_update(g_stk, p_stk, state_stk, step[, salts])
      -> (new_p_stk, new_state_stk)`` — optional, over the whole stacked
      bucket, used by a bucketed engine; ``salts`` (int64 ``(slots, L)``, uint32 values: the bucket's
      columns of the step's salt table) is passed when the rule is
      ``codec_native``.
    * ``slots`` — bool tree mirroring the per-leaf state: True marks a
      moment slot the codec stores encoded; ``None``: no slots.
    * ``codec_native`` — ``vector_update`` takes the encoded slots itself.
    """

    kind: str
    init: Callable[[torch.Tensor], Any]
    update: Callable[..., Tuple[torch.Tensor, Any]]
    sig: Tuple = ()
    vector_update: Optional[Callable[..., Tuple[torch.Tensor, Any]]] = None
    slots: Any = None
    codec_native: bool = False


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


def _recode_stacked(fn, st, b: Bucket):
    """Apply ``fn(leaf_state, leaf_index)`` to each leaf of a stacked bucket
    state and stack the results again."""
    return _stack_states([fn(_slice_state(st, j), i)
                          for j, i in enumerate(b.indices)])


class Engine:
    """Plan companion of an engine-built :class:`Optimizer`.  The plan
    depends only on paths, shapes and dtypes, so it is cached per
    structure."""

    def __init__(self, assign: Callable[[str, Any], LeafRule],
                 bucketed: bool = True, codec="f32", codec_seed: int = 0):
        self.assign = assign
        self.bucketed = bucketed
        self.codec = codec_lib.get_codec(codec)
        self.codec_seed = codec_seed
        self._plans: Dict[tuple, LeafPlan] = {}
        self._salt_ids: Dict[tuple, tuple] = {}

    def plan(self, params) -> LeafPlan:
        paths, leaves = flatten_with_paths(params)
        key = tuple((p, tuple(l.shape), l.dtype)
                    for p, l in zip(paths, leaves))
        if key not in self._plans:
            self._plans[key] = build_plan(self.assign, params)
        return self._plans[key]

    def codec_key(self, device=None) -> Optional[torch.Tensor]:
        """The uint32 rounding key ``init`` stores in
        ``opt_state["codec_key"]`` (None for passthrough codecs)."""
        if self.codec.passthrough:
            return None
        return codec_lib.make_key(self.codec_seed, device)

    def salts(self, plan: LeafPlan, key: torch.Tensor, step: torch.Tensor):
        """The step's salt table ``(slots, leaves)`` and each bucket's leaf
        columns (device index tensors).  The index tensors are built on a
        plan's first step on a device and reused, so later steps only
        launch the hash."""
        ck = (id(plan), str(step.device))   # plans live in self._plans
        if ck not in self._salt_ids:
            dev = step.device
            n_slots = max((codec_lib.num_slots(b.rule.slots)
                           for b in plan.buckets), default=0)
            n_leaves = 1 + max(i for b in plan.buckets for i in b.indices)
            cols = {b.name: torch.tensor(b.indices, dtype=torch.int64,
                                         device=dev) for b in plan.buckets}
            self._salt_ids[ck] = (torch.arange(n_slots, device=dev)[:, None],
                                  torch.arange(n_leaves, device=dev), cols)
        slot_ids, leaf_ids, cols = self._salt_ids[ck]
        return codec_lib.slot_salt(key, step, slot_ids, leaf_ids), cols

    # -- legacy per-leaf layout interop -------------------------------------
    # The pre-engine layout ``{"step", "leaves": (...,)}`` keeps one state per
    # leaf in flatten order.  A dict tree here has no tuples, so "leaves" is
    # a dict keyed by the zero-padded leaf index: its keys sort in index
    # order, so it flattens (and checkpoints) exactly like the tuple.

    def legacy_like(self, params):
        """Abstract state in the legacy layout, on the ``meta`` device: the
        ``like`` tree when restoring an old checkpoint.  Legacy checkpoints
        predate the codec layer, so states here are raw (f32) whatever this
        engine's codec is; transcode after migrating."""
        paths, leaves = flatten_with_paths(params)
        per_leaf = {_legacy_key(i): self.assign(pa, l).init(
            torch.empty_like(l, device="meta"))
            for i, (pa, l) in enumerate(zip(paths, leaves))}
        return {"step": torch.zeros((), dtype=torch.int32, device="meta"),
                "leaves": per_leaf}

    def migrate_legacy(self, old_state, params):
        """Regroup a legacy ``{"step", "leaves"}`` state into the named
        bucket layout (values are untouched, only stacked)."""
        plan = self.plan(params)
        leaves = old_state["leaves"]
        buckets = {b.name: _stack_states([leaves[_legacy_key(i)]
                                          for i in b.indices])
                   for b in plan.buckets}
        return {"step": old_state["step"], "buckets": buckets}

    def to_legacy(self, state, params):
        """Inverse of :meth:`migrate_legacy` (downgrade path / tests)."""
        plan = self.plan(params)
        per_leaf = {}
        for b in plan.buckets:
            st = state["buckets"][b.name]
            for j, i in enumerate(b.indices):
                per_leaf[_legacy_key(i)] = _slice_state(st, j)
        return {"step": state["step"], "leaves": per_leaf}


def _legacy_key(i: int) -> str:
    return f"{i:06d}"


def build(assign: Callable[[str, Any], LeafRule], bucketed: bool = True,
          codec="f32", codec_seed: int = 0) -> Optimizer:
    """Build an :class:`Optimizer` from a leaf-rule assignment.
    ``bucketed=False`` runs every leaf through its rule's ``update`` (the
    unrolled reference; same state layout).  ``codec`` (name or instance)
    stores the rules' moment slots; ``codec_seed`` derives the
    stochastic-rounding key carried in the state."""
    eng = Engine(assign, bucketed, codec=codec, codec_seed=codec_seed)
    cdc = eng.codec
    quant = not cdc.passthrough

    def init(params):
        plan = eng.plan(params)
        _, leaves = flatten_with_paths(params)

        def leaf_init(rule, leaf):
            st = rule.init(leaf)
            return codec_lib.tree_init(cdc, rule.slots, st) if quant else st

        device = leaves[0].device
        buckets = {b.name: _stack_states([leaf_init(b.rule, leaves[i])
                                          for i in b.indices])
                   for b in plan.buckets}
        out = {"step": torch.zeros((), dtype=torch.int32, device=device),
               "buckets": buckets}
        if quant:
            out["codec_key"] = eng.codec_key(device)
        return out

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"]
        key = state.get("codec_key")
        plan = eng.plan(params)
        _, gleaves = flatten_with_paths(grads)
        _, pleaves = flatten_with_paths(params)
        if quant:
            salts, cols = eng.salts(plan, key, step)
        new_buckets = {}
        for b in plan.buckets:
            st = state["buckets"][b.name]
            rule = b.rule
            coded = quant and rule.slots is not None
            if bucketed and rule.vector_update is not None and (
                    rule.codec_native or not coded):
                g_stk = torch.stack([gleaves[i] for i in b.indices])
                p_stk = torch.stack([pleaves[i] for i in b.indices])
                extra = (salts.index_select(1, cols[b.name]),) \
                    if coded else ()
                np_stk, ns = rule.vector_update(g_stk, p_stk, st, step,
                                                *extra)
                for j, i in enumerate(b.indices):
                    pleaves[i].copy_(np_stk[j])
            else:
                per_leaf = []
                for j, i in enumerate(b.indices):
                    s = _slice_state(st, j)
                    if coded:
                        s = codec_lib.tree_decode(cdc, rule.slots, s)
                    new_p, ns_j = rule.update(gleaves[i], pleaves[i], s,
                                              step)
                    if coded:
                        ns_j = codec_lib.tree_encode(cdc, rule.slots, ns_j,
                                                     salts[:, i])
                    pleaves[i].copy_(new_p)
                    per_leaf.append(ns_j)
                ns = _stack_states(per_leaf)
            new_buckets[b.name] = ns
        out = {"step": step + 1, "buckets": new_buckets}
        if quant:
            out["codec_key"] = key
        return params, out

    return Optimizer(init, update, engine=eng)


@torch.no_grad()
def transcode(state, params, src: Optimizer, dst: Optimizer):
    """Re-encode an optimizer state between codecs (a resume across a
    ``--state-codec`` change): decode every slot with ``src``'s codec and
    encode it with ``dst``'s, salted with the saved step.  Both optimizers
    must share the rule assignment; only the codec differs."""
    eng_s, eng_d = src.engine, dst.engine
    plan = eng_s.plan(params)
    step = state["step"]
    key = eng_d.codec_key(step.device)
    if key is not None:
        salts, _ = eng_d.salts(eng_d.plan(params), key, step)
    new_buckets = {}
    for b in plan.buckets:
        st = state["buckets"][b.name]
        slots = b.rule.slots
        if slots is not None and not eng_s.codec.passthrough:
            st = _recode_stacked(lambda s, i: codec_lib.tree_decode(
                eng_s.codec, slots, s), st, b)
        if slots is not None and not eng_d.codec.passthrough:
            st = _recode_stacked(lambda s, i: codec_lib.tree_encode(
                eng_d.codec, slots, s, salts[:, i]), st, b)
        new_buckets[b.name] = st
    out = {"step": step, "buckets": new_buckets}
    if key is not None:
        out["codec_key"] = key
    return out


def state_bytes(state) -> int:
    """Exact optimizer-state bytes: the sum over every state tensor, each
    at its stored dtype (int8 codes, f32 scales, the uint32 key)."""
    return sum(t.numel() * t.element_size()
               for t in flatten_with_paths(state)[1])
