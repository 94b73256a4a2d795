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

**Grouped calls.**  Rules that share a :class:`Group` (the LAST and FIRST
rules of one GWT optimizer) let several buckets go through one call, one
kernel launch on the card.  The engine hands the group its buckets in
plan order and takes back the sets to call together (``Group.launches``:
on CUDA the card's capacity, elsewhere every bucket alone), once per plan,
device and gradient dtypes (the sets are cached on them); each update it
then walks the plan, and at a set's first bucket gathers and
stacks every member, makes the one call, and does each member's taps,
writes and state as for a bucket alone.  A bucket in no set takes the
per-bucket flow.  The transient peak grows by the other members' stacked
gradients and parameters, which one launch's capacity bounds (about 30 MB
of bf16 gradients on an H100).  Nothing chooses the grouping but the
group: the parameters, state and taps are bitwise the per-bucket flow's.

**Frozen leaves.**  :data:`FROZEN` (the LoRA base, ``models/lora.py``)
keeps an empty state: zero bytes in :func:`state_bytes`, nothing to
encode.  The engine never stacks, copies or writes a frozen leaf, and its
gradient may be ``None`` (the LoRA step computes none).

**Leaf ids.**  A rule's ``update`` gets its leaf's flatten-order index
``leaf_id``, as the JAX package's does (APOLLO and RSO seed their random
projectors with it).

**Taps** (DESIGN.md §12).  A bucketed engine's ``tapped_update`` runs the
same body as ``update`` and adds per-bucket f32 device scalars: the
generic ``grad_ssq`` and ``update_ssq``, the int8 codec's ``q8_sat_rate``
and ``q8_absmax``, and the rule's own (``LeafRule.taps``).  The sums run
over blocks of whole rows (:data:`TAP_BLOCK`), so no f32 copy of a whole
bucket is made; ``update_ssq`` is taken leaf by leaf before the leaf's
parameter is written.  Nothing is read back to the host.

**Placed state** (``build(state_shardings=...)``, the sharded-parameter
layout of ``distributed/sharding.py``).  ``init`` keeps each hinted
bucket's stacked state as this rank's shards.  ``update`` takes whole
parameters and gradients (every rank holds the same reduced gradient) and,
one bucket at a time, gathers the bucket's state whole, runs the rule on
it as on an unplaced bucket (K1/K2 over the whole ``(L, m, n)`` stack, or
the per-leaf path), and keeps this rank's slice of the new state, cut from
what the rule returned (a fused kernel wrote it in place into the gathered
copy).  The transient peak is one bucket's whole state.  Over mesh axes of
size 1 the shards are the whole tensors and nothing is copied.

**Placed parameters** (``update(..., param_shardings=...)``, the
tensor-parallel step's layout along ``model``).  ``params`` and ``grads``
are this rank's shards; the plan is the whole tree's.  One bucket at a time
the engine gathers its members' parameters and gradients whole, runs the
rule on them as above (K1/K2 over the whole stack), and writes this rank's
slice of each new parameter back into its shard.  The numbers are those of
the unplaced update on the gathered trees; the transient peak is one
bucket's whole parameters, gradients and state.

**The host step.**  Rules that branch on the step (the low-rank families'
projector refresh every ``update_gap`` steps, a ``lax.cond`` in the JAX
package) declare ``LeafRule.host_step`` and get the step as a Python int.
Reading the device step would block the host every step, so the engine
keeps a host mirror: the ``step + 1`` tensor each update returns is
remembered with its int.  A state whose step tensor the engine did not make
(after ``init``, a checkpoint restore or a transcode that built a new one)
has its device step read once.  An update none of whose rules declares
``host_step`` never reads it.
"""

from __future__ import annotations

import gc
import itertools
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.distributed import sharding
from repro_torch.optim import codec as codec_lib
from repro_torch.optim.base import Optimizer, flatten_with_paths, tree_map


class LeafRule(NamedTuple):
    """How one leaf updates.

    * ``kind`` — rule family name; the bucket-name prefix.
    * ``init(leaf) -> state`` — per-leaf state (a dict of tensors) from a
      tensor (a ``meta`` tensor gives a ``meta`` state).
    * ``update(g, p, state, step, leaf_id) -> (new_p, new_state)`` — one
      leaf (``leaf_id``: its flatten-order index, an int); the only path
      of an unrolled engine (``build(bucketed=False)``) and of a rule
      without ``vector_update``.  A ``host_step`` rule also gets the step
      as an int: ``update(g, p, state, step, leaf_id, host_step)``.
    * ``sig`` — extra static signature that must also match to bucket.
    * ``vector_update(g_stk, p_stk, state_stk, step[, salts])
      -> (new_p_stk, new_state_stk)`` — optional, over the whole stacked
      bucket, used by a bucketed engine; ``salts`` (int64 ``(slots, L)``, uint32 values: the bucket's
      columns of the step's salt table) is passed when the rule is
      ``codec_native``.
    * ``slots`` — bool tree mirroring the per-leaf state: True marks a
      moment slot the codec stores encoded; ``None``: no slots.
    * ``codec_native`` — ``vector_update`` takes the encoded slots itself.
    * ``host_step`` — ``update`` takes the step as an int too (see the
      module doc).
    * ``taps`` — optional ``(gs, old_state, new_state) -> {name: f32
      scalar}``: rule-specific observability scalars (GWT's band energy
      and limiter clips) added to the bucket's generic taps.  ``gs`` are
      the bucket's gradients leaf by leaf, the states stacked in their
      stored (encoded) layout.  On CUDA a fused write has already
      overwritten the old state's moments in place, so a tap reads only
      what the update replaced with new tensors (``prev_norm``).  Runs only
      inside ``Optimizer.tapped_update`` (DESIGN.md §12).
    * ``group`` — optional :class:`Group`, the grouped form of
      ``vector_update`` (one kernel launch over several buckets).  Rules
      that hold the same ``Group`` object may share a call: a bucketed
      engine asks ``group.launches`` which of those buckets go together
      and runs each set of two or more through ``group.update``; a bucket
      alone takes ``vector_update``.  The parameters and state written are
      bitwise the per-bucket calls'.
    """

    kind: str
    init: Callable[[torch.Tensor], Any]
    update: Callable[..., Tuple[torch.Tensor, Any]]
    sig: Tuple = ()
    vector_update: Optional[Callable[..., Tuple[torch.Tensor, Any]]] = None
    slots: Any = None
    codec_native: bool = False
    host_step: bool = False
    taps: Optional[Callable[..., Dict[str, torch.Tensor]]] = None
    group: Optional["Group"] = None


class Group(NamedTuple):
    """The grouped form of the ``vector_update`` of the rules that hold it.

    * ``launches(members, device) -> [[index, ...], ...]`` — which buckets
      share a call, in the order they are updated: the one place that
      decides it (``update`` takes each set as it is given).  ``members``: per bucket
      ``(kind, shape, g dtype, p dtype, state)``, ``shape`` the stacked
      ``(L, ...)`` whole parameter, ``state`` the stored one, in plan order;
      ``device`` the gradients'.
    * ``update(members, step) -> [(new_p_stk, new_state_stk), ...]`` —
      ``vector_update`` of every bucket of one set in one call: per bucket
      ``(kind, g_stk, p_stk, state_stk[, salts])`` as ``vector_update``
      takes them (``salts`` where the rule is ``codec_native``).
    """

    launches: Callable[..., list]
    update: Callable[..., list]


# Zero-state rule of a frozen leaf (the JAX package's ``lora.FROZEN``): an
# empty state, and the parameter is left as it is, bitwise
FROZEN = LeafRule(kind="frozen", init=lambda p: {},
                  update=lambda g, p, s, step, lid: (p, s))


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


def _restack(per_leaf: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """The new states of a bucket's leaves, stacked; a one-leaf bucket's as
    a view (an untied head's moments are GiBs: a stacked copy would
    double them for the rest of the update)."""
    if len(per_leaf) == 1:
        return tree_map(lambda x: x.unsqueeze(0), per_leaf[0])
    return _stack_states(per_leaf)


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
        # the host mirror of the step: id(step tensor) -> (tensor, int) for
        # the step tensors the last few updates returned (the tensor is
        # kept so that its id is not reused)
        self._host_steps: Dict[int, Tuple[torch.Tensor, int]] = {}

    def plan(self, params) -> LeafPlan:
        paths, leaves = flatten_with_paths(params)
        key = tuple((p, tuple(l.shape), l.dtype)
                    for p, l in zip(paths, leaves))
        if key not in self._plans:
            self._plans[key] = build_plan(self.assign, params)
        return self._plans[key]

    def host_step(self, step: torch.Tensor) -> int:
        """The int value of the state's ``step`` tensor: from the mirror if
        an update of this engine returned it, else read from the device
        (once: a state from ``init``, a restore or a transcode)."""
        hit = self._host_steps.get(id(step))
        if hit is not None and hit[0] is step:
            return hit[1]
        return int(step)

    def returned_step(self, step: torch.Tensor, value: int) -> None:
        """Remember ``step`` (a tensor an update returns) as ``value``."""
        if len(self._host_steps) >= _HOST_STEPS_KEPT:
            self._host_steps.pop(next(iter(self._host_steps)))
        self._host_steps[id(step)] = (step, value)

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


# step tensors the host mirror keeps: one per optimizer state a caller
# alternates between
_HOST_STEPS_KEPT = 8


# The largest f32 temporary of a tap's sums, in elements.  A tap reduces a
# tensor over blocks of whole rows (its last axis) of at most this many
# elements and adds the blocks' f32 sums in order, so a multi-GB bucket's
# taps hold a few hundred MiB at most, where the JAX package casts the
# whole bucket to f32.
TAP_BLOCK = 1 << 26


def row_blocks(*xs: torch.Tensor):
    """Blocks of whole rows of the last axis of the same-shaped ``xs``, in
    order, as tuples of views, each block of at most :data:`TAP_BLOCK`
    elements (one row where a row is longer).  Contiguous tensors are cut
    across their merged rows; otherwise (a transposed leaf) each matrix of
    the leading axes is cut alone."""
    xs = tuple(x.reshape(1, -1) if x.ndim < 2 else x for x in xs)
    n = xs[0].shape[-1]
    rows = max(1, TAP_BLOCK // max(n, 1))
    if all(x.is_contiguous() for x in xs):
        mats = [tuple(x.reshape(-1, n) for x in xs)]
    else:
        mats = (tuple(x[idx] for x in xs) for idx in
                itertools.product(*map(range, xs[0].shape[:-2])))
    for ms in mats:
        for r in range(0, ms[0].shape[0], rows):
            yield tuple(m[r:r + rows] for m in ms)


def block_ssq(b: torch.Tensor) -> torch.Tensor:
    """Σ b² of one block with an f32 accumulator, as the square of its f32
    2-norm: on CUDA a bf16 block is read as it is, with no f32 copy; the
    root and the square add two f32 roundings to the sum's own."""
    return torch.square(torch.linalg.vector_norm(b, dtype=torch.float32))


def tap_ssq(x: torch.Tensor, minus: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """Σ x² (with ``minus``: Σ (x - minus)², the difference taken in f32)
    in f32 over :func:`row_blocks`, as an f32 device scalar."""
    if minus is None:
        return sum_in_order(block_ssq(blk) for (blk,) in row_blocks(x))
    return sum_in_order(block_ssq(blk.to(torch.float32, copy=True,
                                 memory_format=torch.contiguous_format)
                          .sub_(sub))
                for blk, sub in row_blocks(x, minus))


def sum_in_order(xs) -> torch.Tensor:
    """The tensors ``xs`` added in order."""
    it = iter(xs)
    total = next(it)
    for x in it:
        total = total + x
    return total


def _codec_taps(ns) -> Dict[str, torch.Tensor]:
    """The int8 substrate's taps, read off an encoded stacked bucket state:
    the share of codes on the ±127 rails (a block's scale pinned by an
    outlier keeps its codes there) and the largest block absmax
    (``scale · 127``).  Empty for a state with no codes."""
    hits, total, absmax = None, 0, None
    for path, leaf in zip(*flatten_with_paths(ns)):
        tail = path.rsplit("/", 1)[-1]
        if tail == "q" and leaf.dtype == torch.int8:
            for (blk,) in row_blocks(leaf):
                n = torch.count_nonzero(blk >= 127) \
                    + torch.count_nonzero(blk <= -127)
                hits = n if hits is None else hits + n
            total += leaf.numel()
        elif tail == "scale" and leaf.dtype == torch.float32:
            mx = torch.amax(leaf)
            absmax = mx if absmax is None else torch.maximum(absmax, mx)
    if total == 0:
        return {}
    out = {"q8_sat_rate": hits.to(torch.float32) / float(total)}
    if absmax is not None:
        out["q8_absmax"] = absmax * 127.0
    return out


def _hint(hints, b: Bucket, st):
    """The bucket's placement tree, checked against its state's structure
    (a hint for another level, host or codec raises)."""
    hint = hints.get(b.name)
    if hint is not None:
        got = flatten_with_paths(hint)[0]
        want = flatten_with_paths(st)[0]
        if got != want:
            raise ValueError(
                f"state_shardings hint of bucket {b.name} has leaves {got}, "
                f"its state {want}: pass gwt_state_shardings(...)"
                f"['buckets'] of the SAME level/host/codec/eligible "
                f"configuration")
    return hint


def build(assign: Callable[[str, Any], LeafRule], bucketed: bool = True,
          codec="f32", codec_seed: int = 0,
          state_shardings=None) -> Optimizer:
    """Build an :class:`Optimizer` from a leaf-rule assignment.
    ``bucketed=False`` runs every leaf through its rule's ``update`` (the
    unrolled reference; same state layout).  ``codec`` (name or instance)
    stores the rules' moment slots; ``codec_seed`` derives the
    stochastic-rounding key carried in the state.  ``state_shardings``
    (``{bucket name: NamedSharding tree}``, the ``"buckets"`` of
    ``distributed.sharding.gwt_state_shardings``) keeps those buckets'
    state placed (the module doc's "Placed state")."""
    eng = Engine(assign, bucketed, codec=codec, codec_seed=codec_seed)
    cdc = eng.codec
    quant = not cdc.passthrough
    hints = dict(state_shardings or {})
    # (id(plan), device, the grouped buckets' gradient dtypes) -> {bucket
    # name: the buckets of its grouped call}; plans live in eng._plans
    sets_cache: Dict[tuple, Dict[str, list]] = {}

    def coded(rule):
        return quant and rule.slots is not None

    def vector(rule):
        return bucketed and rule.vector_update is not None and (
            rule.codec_native or not coded(rule))

    def group_sets(plan, gleaves, mleaves, state, device):
        # the buckets each group's grouped calls take, two or more a call:
        # they depend only on the plan, the device and the dtypes
        grouped = [b for b in plan.buckets
                   if b.rule.group is not None and vector(b.rule)]
        ck = (id(plan), str(device),
              tuple(gleaves[b.indices[0]].dtype for b in grouped))
        if ck in sets_cache:
            return sets_cache[ck]
        sets: Dict[str, list] = {}
        for grp in {id(b.rule.group): b.rule.group
                    for b in grouped}.values():
            bs = [b for b in grouped if b.rule.group is grp]
            for launch in grp.launches(
                    [(b.rule.kind, (len(b.indices),)
                      + tuple(mleaves[b.indices[0]].shape),
                      gleaves[b.indices[0]].dtype,
                      mleaves[b.indices[0]].dtype,
                      state["buckets"][b.name]) for b in bs], device):
                if len(launch) > 1:
                    for k in launch:
                        sets[bs[k].name] = [bs[j] for j in launch]
        sets_cache[ck] = sets
        return sets

    def init(params):
        plan = eng.plan(params)
        _, leaves = flatten_with_paths(params)

        def leaf_init(rule, leaf):
            st = rule.init(leaf)
            return codec_lib.tree_init(cdc, rule.slots, st) if quant else st

        device = leaves[0].device
        buckets = {}
        for b in plan.buckets:
            if b.rule is FROZEN:
                buckets[b.name] = {}
                continue
            st = _stack_states([leaf_init(b.rule, leaves[i])
                                for i in b.indices])
            buckets[b.name] = sharding.shard_tree(st, _hint(hints, b, st))
            del st
        out = {"step": torch.zeros((), dtype=torch.int32, device=device),
               "buckets": buckets}
        if quant:
            out["codec_key"] = eng.codec_key(device)
        return out

    @torch.no_grad()
    def run(grads, state, params, with_taps: bool, param_shardings=None):
        # ``with_taps`` only adds reads: the parameters and state written
        # are the same with it as without, and without it no tap is made
        step = state["step"]
        key = state.get("codec_key")
        _, gleaves = flatten_with_paths(grads)
        ppaths, pleaves = flatten_with_paths(params)
        psh = sharding.flat_shardings(param_shardings) \
            if param_shardings is not None else {}
        meta = sharding.full_meta(params, param_shardings) if psh \
            else params
        plan = eng.plan(meta)
        # the whole parameters' shapes and dtypes (meta where placed)
        _, mleaves = flatten_with_paths(meta)

        def whole(leaves, i):
            return sharding.gather(leaves[i], psh.get(ppaths[i]))

        def write(i, new_p):
            sh = psh.get(ppaths[i])
            pleaves[i].copy_(new_p if sh is None else sharding.shard(new_p,
                                                                     sh))
        if quant:
            salts, cols = eng.salts(plan, key, step)
        hstep = eng.host_step(step) if any(
            b.rule.host_step for b in plan.buckets) else None
        new_buckets: Dict[str, Any] = {}
        bucket_taps: Dict[str, Dict[str, torch.Tensor]] = {}

        def gathered(b):
            # a placed bucket's state, gathered whole for the rule, and its
            # members' whole gradients and parameters (the leaves
            # themselves where nothing is placed)
            hint = _hint(hints, b, state["buckets"][b.name])
            return (hint, sharding.gather_tree(state["buckets"][b.name],
                                               hint),
                    {i: whole(gleaves, i) for i in b.indices},
                    {i: whole(pleaves, i) for i in b.indices})

        def stacked(b, gb, pb):
            extra = (salts.index_select(1, cols[b.name]),) \
                if coded(b.rule) else ()
            return (torch.stack([gb[i] for i in b.indices]),
                    torch.stack([pb[i] for i in b.indices])) + extra

        def written(b, np_stk, pb):
            # Σ (new p - old p)², leaf by leaf before the write: on CUDA a
            # fused rule has already written the stacked p in place
            upd = []
            for j, i in enumerate(b.indices):
                if with_taps:
                    upd.append(tap_ssq(np_stk[j], pb[i]))
                write(i, np_stk[j])
            return upd

        def finish(b, hint, st, ns, gb, upd):
            if with_taps:
                gs = [gb[i] for i in b.indices]
                tp = {"grad_ssq": sum_in_order(tap_ssq(g) for g in gs),
                      "update_ssq": sum_in_order(upd)}
                if coded(b.rule):
                    tp.update(_codec_taps(ns))
                if b.rule.taps is not None:
                    tp.update(b.rule.taps(gs, st, ns))
                bucket_taps[b.name] = tp
            # this rank's slice of what the rule wrote; the gathered copy
            # dies with the caller's references
            new_buckets[b.name] = sharding.shard_tree(ns, hint)

        def one(b):
            hint, st, gb, pb = gathered(b)
            rule = b.rule
            if vector(rule):
                g_stk, p_stk, *extra = stacked(b, gb, pb)
                np_stk, ns = rule.vector_update(g_stk, p_stk, st, step,
                                                *extra)
                upd = written(b, np_stk, pb)
            else:
                per_leaf, upd = [], []
                for j, i in enumerate(b.indices):
                    s = _slice_state(st, j)
                    if coded(rule):
                        s = codec_lib.tree_decode(cdc, rule.slots, s)
                    extra = (hstep,) if rule.host_step else ()
                    new_p, ns_j = rule.update(gb[i], pb[i], s, step, i,
                                              *extra)
                    if coded(rule):
                        ns_j = codec_lib.tree_encode(cdc, rule.slots, ns_j,
                                                     salts[:, i])
                    if with_taps:
                        upd.append(tap_ssq(new_p, pb[i]))
                    write(i, new_p)
                    per_leaf.append(ns_j)
                    del new_p, ns_j
                ns = _restack(per_leaf)
                del per_leaf
            finish(b, hint, st, ns, gb, upd)

        def together(bs):
            # one grouped call over the buckets bs; then, bucket by bucket,
            # the taps, the writes and the state as one() does them
            got = [gathered(b) for b in bs]
            members = []
            for b, (_, st, gb, pb) in zip(bs, got):
                g_stk, p_stk, *extra = stacked(b, gb, pb)
                members.append((b.rule.kind, g_stk, p_stk, st, *extra))
            outs = bs[0].rule.group.update(members, step)
            del members
            for b, (hint, st, gb, pb), (np_stk, ns) in zip(bs, got, outs):
                finish(b, hint, st, ns, gb, written(b, np_stk, pb))

        sets = group_sets(plan, gleaves, mleaves, state, step.device)
        for b in plan.buckets:
            if b.name in new_buckets:
                continue
            if b.rule is FROZEN:
                new_buckets[b.name] = {}
            elif b.name in sets:
                together(sets[b.name])
            else:
                one(b)
        # the state and the taps in plan order, whatever order the grouped
        # calls wrote them in
        new_buckets = {b.name: new_buckets[b.name] for b in plan.buckets}
        taps: Dict[str, torch.Tensor] = {
            f"{b.name}/{k}": v.to(torch.float32)
            for b in plan.buckets for k, v in bucket_taps.get(
                b.name, {}).items()}
        out = {"step": step + 1, "buckets": new_buckets}
        if hstep is not None:
            eng.returned_step(out["step"], hstep + 1)
        if quant:
            out["codec_key"] = key
        return params, out, taps

    def update(grads, state, params, param_shardings=None):
        new_params, out, _ = run(grads, state, params, False,
                                 param_shardings)
        return new_params, out

    def tapped_update(grads, state, params, param_shardings=None):
        """``update`` plus the per-bucket taps (DESIGN.md §12): for every
        bucket but a frozen one ``grad_ssq`` (Σ g²) and ``update_ssq``
        (Σ (p_new - p_old)²), under a quantizing codec ``q8_sat_rate`` and
        ``q8_absmax`` read off the state just written, and the rule's own
        taps; keys ``"<bucket>/<tap>"``, f32 device scalars.  The
        parameters and state are bitwise ``update``'s, with
        ``param_shardings`` as there.

        With ``param_shardings`` the taps are read off each bucket's whole
        gathered gradients, parameters and state, as one rank reads them:
        the plan and its keys are the whole tree's
        (``sharding.full_meta``), and every rank computes the same taps
        from the same whole buckets."""
        return run(grads, state, params, True, param_shardings)

    # the unrolled reference engine has no tapped channel, as the JAX
    # package's (its taps read the stacked buckets)
    return Optimizer(init, update, engine=eng,
                     tapped_update=tapped_update if bucketed else None)


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
        if b.rule is FROZEN:
            new_buckets[b.name] = {}
            continue
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


def live_update_bytes(fn, *args) -> Optional[int]:
    """Peak bytes allocated on the card during one call ``fn(*args)`` (an
    ``optimizer.update``, a train step), with the arguments resident:
    garbage is collected, the peak counter reset, the call made and
    synchronised, and ``torch.cuda.max_memory_allocated`` read.  None where
    the arguments hold no CUDA tensor, as the reference returns None where
    its backend has no memory analysis.

    The reference's figure is XLA's buffer assignment of the compiled
    executable: arguments + outputs - donated aliases + temporaries.  Here
    the allocator is read instead: the arguments, everything else the
    process holds on the card at the call, the outputs and the temporaries
    live at the worst moment.  The port's update writes the parameters and
    states in place, which is the reference's donation."""
    tensors = [t for t in flatten_with_paths({str(i): a for i, a in
                                              enumerate(args)})[1]
               if isinstance(t, torch.Tensor)]
    dev = next((t.device for t in tensors if t.device.type == "cuda"), None)
    if dev is None:
        return None
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn(*args)
    torch.cuda.synchronize(dev)
    return int(torch.cuda.max_memory_allocated(dev))
