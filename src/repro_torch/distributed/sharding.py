"""Logical-axis -> mesh-axis placement rules (counterpart of
``repro/distributed/sharding.py``) and the placement helpers of the
sharded-parameter layout (``--shard-params auto``).

Parameters carry logical axis names (``models.layers.Axes``, from
``lm.param_axes`` / ``encdec.param_axes``).  A rule maps a logical name to
a *preference list* of mesh axes: the first candidate whose mesh axes are
(a) on the mesh, (b) not yet used by another dimension of the same tensor
and (c) divide the dimension is taken; otherwise the dimension is
replicated.  The table is the JAX package's, letter for letter.

The pieces, as pure functions of shapes and names (no process group, no
device; ``meta`` tensors will do):

* :class:`Mesh` — axis names and sizes (``jax.sharding.AbstractMesh``), and
  at run time this process's coordinates and its process group along each
  axis;
* :class:`Spec` — the ``PartitionSpec`` counterpart: per dimension None,
  one mesh axis, or a tuple of them, trailing Nones dropped;
* :class:`NamedSharding` — a mesh and a spec (and the paired-halves
  layout of a leaf whose ``Axes.blocks`` > 1);
* :func:`train_rules`, :func:`decode_rules`, :func:`spec_for`,
  :func:`tree_shardings`, :func:`gwt_state_shardings` (mirrors the port's
  own GWT bucket plan), :func:`batch_shardings`, :func:`replicated_like`,
  :func:`train_step_shardings` and :class:`StepShardings`;
* the ``model`` axis's tensor-parallel placement (:func:`tp_rules`,
  :func:`tp_step_shardings`): the table's model entries, split at head
  granularity, which ``distributed/tensor_parallel.py`` computes on; and
  LoRA's adapters placed from their weights' placements
  (:func:`lora_pair_shardings`, :func:`lora_shardings`,
  :func:`lora_state_shardings`).

Placement.  A placed tensor is stored as the rank's *local shard*, a plain
contiguous tensor, beside its :class:`NamedSharding`; it is not kept as a
``DTensor``.  Every CUDA kernel of the port takes plain tensors (K1/K2 read
``data_ptr()`` through ctypes), the port's trees, checkpoints and state
accounting walk plain tensors, and a shard over mesh axes of size 1 is the
full tensor itself: :func:`shard` and :func:`gather` return their input
there, with no copy and no collective, so at world size 1 the placed layout
holds no byte more than the replicated one.  :func:`gather` builds the
whole tensor with list ``all_gather``s over the process group of each split
mesh axis (the minor axis first), which gloo also takes on CUDA tensors;
:func:`shard` is a local slice (every rank holds the whole tensor when it
shards, so no collective is needed).  A leaf whose last dimension is
paired halves (``NamedSharding.blocks``) is cut and rebuilt block by block,
so that :func:`gather` of it, or of its gradient, gives the whole
tensor's column order: GWT's DWT pairs neighbouring columns, and a
checkpoint holds whole arrays in the reference's order.  The GWT state
keeps the contiguous split (:func:`gwt_state_shardings`): the forward
never reads it.
"""

from __future__ import annotations

import math
from typing import (Any, Callable, Dict, Mapping, NamedTuple, Optional,
                    Sequence, Tuple, Union)

import torch

from repro_torch.models.layers import Axes
from repro_torch.optim.base import flatten_with_paths, unflatten

Candidate = Union[str, Tuple[str, ...]]
Rules = Dict[str, Tuple[Candidate, ...]]


class Mesh:
    """A device mesh's axis names and sizes (``shape``, an ordered dict as
    the JAX mesh's).  At run time it also holds this process's coordinate
    along each axis (``coords``) and, for each axis of size > 1, the
    ``torch.distributed`` group of the ranks that differ from this one only
    along it (``groups``, built by ``launch.mesh.init_mesh``), over which
    placed tensors are gathered; a mesh without them is abstract (the rule
    table's input), or one process."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 coords: Optional[Sequence[int]] = None,
                 groups: Optional[Mapping[str, Any]] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axis names "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.coords = dict(zip(self.axis_names,
                               coords if coords is not None
                               else (0,) * len(self.axis_names)))
        self.groups = dict(groups or {})

    def __repr__(self):
        return f"Mesh({self.shape})"


class Spec(tuple):
    """``PartitionSpec`` counterpart: one entry per leading dimension, each
    None (replicated), a mesh axis name, or a tuple of names (the dimension
    split over their product, the first the major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


class NamedSharding(NamedTuple):
    """A placement: ``spec`` over ``mesh``.  ``blocks`` > 1 (from the
    leaf's ``Axes.blocks``): the last dimension is that many equal
    contiguous blocks, each split over its mesh axes on its own, so that a
    rank's shard is its slice of every block, in block order (mamba's
    ``in_proj`` ``[xm | z]`` gives the rank ``[xm_r | z_r]``, and a
    column-parallel matmul its own channels of both halves).  The shard's
    shape and bytes are the contiguous split's; :func:`gather` returns the
    columns in the whole tensor's order."""

    mesh: Mesh
    spec: Spec
    blocks: int = 1


def _names(entry: Candidate) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The mesh's data-parallel axes: ``("pod", "data")`` or ``("data",)``."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def train_rules(mesh: Mesh) -> Rules:
    """FSDP(data) x TP/EP(model); the batch over (pod x) data.  Parameters
    are not sharded over the pod axis: it carries pure data parallelism."""
    dp = dp_axes(mesh)
    return {
        "vocab": ("model",),
        "embed": ("data",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "mlp": ("model",),
        "expert": ("model",),       # EP when E % model == 0, else falls
        "expert_mlp": ("model",),   # through to TP inside the expert
        "inner": ("model",),
        "layers": (),
        "batch": (dp,),
        "seq": (),
    }


def tp_rules(mesh: Mesh, cfg) -> Rules:
    """The placement of the tensor-parallel step along ``model``: the model
    entries of :func:`train_rules` (``vocab``, ``heads``, ``kv_heads``,
    ``mlp``, ``expert``, ``expert_mlp``) and nothing over the data axes (the
    reference places nothing there without ``--dp-reduce``), and
    ``inner``: mamba's channels, and xLSTM's up-projection, conv, gates
    and sLSTM recurrence (``models/ssm.py``, ``models/xlstm.py``).

    Heads are split whole: ``spec_for`` tests the flat ``H·hd`` dimension,
    which may divide where the head count does not (qwen2.5-3b's two KV
    heads at ``model=4``).  So ``heads`` is split only where ``n_heads``
    divides the axis, and ``kv_heads`` only where both head counts do; a
    K/V projection left whole is computed whole on every rank
    (``models/attention.py``)."""
    m = mesh.shape.get("model", 1)
    heads = cfg.n_heads % m == 0
    kv = heads and cfg.n_kv_heads % m == 0
    model = ("model",)
    return {"vocab": model, "heads": model if heads else (),
            "kv_heads": model if kv else (), "mlp": model,
            "expert": model, "expert_mlp": model, "inner": model}


def decode_rules(mesh: Mesh) -> Rules:
    """Decode: the cache's sequence axis takes the model axis (SP); for
    batch-1 cells the sequence takes model x data."""
    dp = dp_axes(mesh)
    return {
        "vocab": ("model",),
        "embed": ("data",),
        "heads": ("model",),
        "kv_heads": (),             # the cache's sequence owns 'model'
        "mlp": ("model",),
        "expert": ("model",),
        "expert_mlp": ("model",),
        "inner": ("model",),
        "layers": (),
        "batch": (dp,),
        "seq": (("model",) + dp, ("model",) + dp[:1], "model"),
    }


def _axis_size(mesh: Mesh, cand: Candidate) -> int:
    return math.prod(mesh.shape[a] for a in _names(cand))


def spec_for(shape: Sequence[int], axes: Axes, mesh: Mesh,
             rules: Rules) -> Spec:
    """The spec of a tensor of ``shape`` with logical ``axes``."""
    used = set()
    entries = []
    for size, name in zip(shape, axes.names):
        picked = None
        if name is not None:
            for cand in rules.get(name, ()):
                cand_names = _names(cand)
                if not cand_names:
                    continue
                # a rule may name an axis the mesh does not have (the
                # 'model' candidates on a pure-DP mesh): fall through
                if any(a not in mesh.shape for a in cand_names):
                    continue
                if any(a in used for a in cand_names):
                    continue
                if size % _axis_size(mesh, cand) != 0:
                    continue
                picked = cand_names if len(cand_names) > 1 \
                    else cand_names[0]
                used.update(cand_names)
                break
        entries.append(picked)
    while entries and entries[-1] is None:
        entries.pop()
    return Spec(*entries)


def _map2(fn, tree, other, where: str = ""):
    """``fn(leaf, other_leaf)`` over two dict trees of one structure; a
    structure that differs raises."""
    if isinstance(tree, Mapping):
        if not isinstance(other, Mapping) or set(tree) != set(other):
            got = sorted(other) if isinstance(other, Mapping) else other
            raise ValueError(f"{where or 'tree'}: keys {sorted(tree)} do not "
                             f"match {got}")
        return {k: _map2(fn, tree[k], other[k], f"{where}/{k}" if where
                         else str(k)) for k in tree}
    return fn(tree, other)


def tree_shardings(abstract: Any, axes_tree: Any, mesh: Mesh,
                   rules: Rules):
    """``(tensor tree, Axes tree) -> NamedSharding tree``; a None axes leaf
    is replicated."""
    def one(t, ax):
        if ax is None:
            return NamedSharding(mesh, Spec())
        return NamedSharding(mesh, spec_for(t.shape, ax, mesh, rules),
                             ax.blocks)
    return _map2(one, abstract, axes_tree)


def _stacked(mesh: Mesh, spec: Spec) -> NamedSharding:
    """A member's spec -> the ``(L, ...)`` bucket stack's: the stacking
    axis is replicated, like ``layers``."""
    return NamedSharding(mesh, Spec(*((None,) + tuple(spec))))


def gwt_state_shardings(params_abstract, params_axes, mesh: Mesh,
                        rules: Rules, level: int, eligible=None,
                        host: str = "adam", state_codec: str = "f32"):
    """The NamedSharding tree of the GWT optimizer's bucketed state
    ``{"step", ["codec_key",] "buckets": {name: {"host": ..., "prev_norm"?}}}``
    over the port's own bucket plan (``core.gwt``).

    A bucket's host moments take the spec its members' logical axes share
    (a FIRST-mode member's transposed, its A band's last dimension ``>>
    level``); when same-shape members resolve to different specs (``wq``
    ``('embed', 'heads')`` beside ``wo`` ``('heads', 'embed')`` where ``H·hd
    == d``), the bucket stays replicated.  Under a quantizing codec a
    moment is ``{"q", "scale"}``: ``q`` keeps the moment's spec, the block
    ``scale`` vector is replicated, as are ``step``, ``codec_key`` and
    ``prev_norm``.  Adam-mini's ``v`` is replicated; a MUON host keeps only
    ``m`` (its plain leaves run Adam: ``m`` and ``v``)."""
    from repro_torch.core.gwt import _Mode, gwt as gwt_optimizer
    opt = gwt_optimizer(lr=0.0, level=level, host=host, eligible=eligible)
    _, pleaves = flatten_with_paths(params_abstract)
    _, aleaves = flatten_with_paths(params_axes)

    def member_spec(kind: str, i: int) -> Spec:
        shape, ax = tuple(pleaves[i].shape), aleaves[i]
        if kind == _Mode.PLAIN:
            return spec_for(shape, ax, mesh, rules)
        if kind == _Mode.FIRST:
            names = ax.names[:-2] + (ax.names[-1], ax.names[-2])
            shape = shape[:-2] + (shape[-1], shape[-2])
        else:
            names = ax.names
        a_shape = shape[:-1] + (shape[-1] >> level,)
        return spec_for(a_shape, Axes(names), mesh, rules)

    return _bucket_shardings(opt.engine.plan(params_abstract), member_spec,
                             mesh, host, state_codec)


def _bucket_shardings(plan, member_spec, mesh: Mesh, host: str,
                      state_codec: str):
    """The state placements of ``plan``'s buckets, each member's A band
    placed by ``member_spec(kind, leaf index)`` (:func:`gwt_state_shardings`'
    rule); a frozen bucket (no state) gets ``{}``."""
    from repro_torch.core.gwt import _Mode
    from repro_torch.optim import codec as codec_lib
    from repro_torch.optim.engine import FROZEN
    quant = not codec_lib.get_codec(state_codec).passthrough
    rep = NamedSharding(mesh, Spec())

    def slot(sh):
        return {"q": sh, "scale": rep} if quant else sh

    buckets = {}
    for b in plan.buckets:
        if b.rule is FROZEN:
            buckets[b.name] = {}
            continue
        specs = {member_spec(b.rule.kind, i) for i in b.indices}
        sh = _stacked(mesh, specs.pop()) if len(specs) == 1 else rep
        host_sh = {"m": slot(sh), "v": slot(sh)}
        if host == "adam_mini":
            host_sh["v"] = slot(rep)
        if b.rule.kind == _Mode.PLAIN:
            buckets[b.name] = {"host": host_sh}
        else:
            if host == "muon":
                host_sh = {"m": slot(sh)}
            buckets[b.name] = {"host": host_sh, "prev_norm": rep}
    out = {"step": rep, "buckets": buckets}
    if quant:
        out["codec_key"] = rep
    return out


# ---------------------------------------------------------------------------
# LoRA adapters along 'model': each pair placed from its weight's placement
# ---------------------------------------------------------------------------

def lora_pair_shardings(weight: NamedSharding, ndim: int
                        ) -> Dict[str, NamedSharding]:
    """The placements of the adapter pair ``{"a": (..., m, r), "b": (...,
    r, n)}`` of an ``ndim``-d weight ``(..., m, n)`` placed by ``weight``.

    Read off the dimensions the weight's resolved spec split, never off
    axis names the factors would inherit (xLSTM's ``wq`` carries
    ``("inner", "heads")``, both on ``model``: split on both names, ``a_r @
    b_r`` would be a diagonal block, not the rank's rows):

    * a leading dimension (stacked experts under EP): both factors split
      on it;
    * ``m`` (row-parallel: ``wo``, ``w_down``, xLSTM's ``wq``/``wk``/``wv``
      over ``inner``): ``a`` splits on it, ``b`` is replicated;
    * ``n`` (column-parallel: ``wq``, ``w_gate``, an expert's hidden
      columns): ``b`` splits on it, in the weight's ``blocks`` layout, and
      ``a`` is replicated;
    * a weight left whole: both factors whole.

    The rank dimension ``r`` is never split, so a rank's ``a_local @
    b_local`` is its own slice of the whole delta."""
    e = list(weight.spec) + [None] * (ndim - len(weight.spec))

    def place(entries, blocks=1):
        while entries and entries[-1] is None:
            entries.pop()
        return NamedSharding(weight.mesh, Spec(*entries), blocks)

    return {"a": place(e[:-2] + [e[-2], None]),
            "b": place(e[:-2] + [None, e[-1]],
                       weight.blocks if e[-1] is not None else 1)}


def lora_shardings(base_shardings, lora_abstract):
    """The placements of a ``{"base", "lora"}`` tree: the base's own, and
    each adapter pair of ``lora_abstract`` (``models.lora.inject``'s
    mirror tree) by :func:`lora_pair_shardings` of its weight's."""
    def pairs(sh, tree):
        return {k: (lora_pair_shardings(sh[k], v["a"].ndim)
                    if "a" in v and not isinstance(v["a"], Mapping)
                    else pairs(sh[k], v)) for k, v in tree.items()}
    return {"base": base_shardings, "lora": pairs(base_shardings,
                                                  lora_abstract)}


def split_dims(sh: Optional[NamedSharding]) -> Tuple[int, ...]:
    """The dimensions ``sh`` splits over mesh axes of size > 1."""
    return () if sh is None else tuple(d for d, _ in _split(sh))


def _band_spec(shape: Sequence[int], spec: Spec, kind: str, level: int,
               mesh: Mesh) -> Spec:
    """A GWT member's A-band placement from the member's resolved
    ``spec``: transposed for a FIRST-mode member, and the band's last
    dimension (``>> level``) kept split only where the axis still divides
    it."""
    from repro_torch.core.gwt import _Mode
    e = list(spec) + [None] * (len(shape) - len(spec))
    if kind == _Mode.PLAIN:
        return spec
    shape = list(shape)
    if kind == _Mode.FIRST:
        e[-2], e[-1] = e[-1], e[-2]
        shape[-2], shape[-1] = shape[-1], shape[-2]
    if e[-1] is not None and (shape[-1] >> level) % _axis_size(
            mesh, e[-1]):
        e[-1] = None
    while e and e[-1] is None:
        e.pop()
    return Spec(*e)


def lora_state_shardings(tree_abstract, tree_shardings, mesh: Mesh,
                         level: int, host: str = "adam",
                         state_codec: str = "f32"):
    """The GWT state placements of a ``{"base", "lora"}`` tree under
    ``models.lora.wrap_optimizer``: the frozen base's buckets hold nothing
    (``{}``), each adapter bucket's moments take the A-band placement its
    members' resolved specs (``tree_shardings``) share, as
    :func:`gwt_state_shardings` places a whole model's."""
    from repro_torch.core.gwt import gwt as gwt_optimizer
    from repro_torch.models import lora
    opt = lora.wrap_optimizer(gwt_optimizer(lr=0.0, level=level, host=host))
    paths, leaves = flatten_with_paths(tree_abstract)
    flat = flat_shardings(tree_shardings)

    def member_spec(kind: str, i: int) -> Spec:
        return _band_spec(tuple(leaves[i].shape), flat[paths[i]].spec, kind,
                          level, mesh)

    return _bucket_shardings(opt.engine.plan(tree_abstract), member_spec,
                             mesh, host, state_codec)


class StepShardings(NamedTuple):
    """The placements of the sharded train path: parameters, optimizer
    state (None: replicated, as for every optimizer but GWT) and the input
    batch."""

    params: Any
    opt: Any
    batch: Dict[str, Any]


def replicated_like(tree, mesh: Mesh):
    """A replicated NamedSharding tree shaped like ``tree``."""
    rep = NamedSharding(mesh, Spec())
    if not isinstance(tree, Mapping):
        return rep
    return {k: replicated_like(v, mesh) for k, v in tree.items()}


def batch_shardings(batch_abstract: Mapping[str, Any], mesh: Mesh):
    """Input placements: the batch dimension over the DP axes (axis 1 of
    ``mrope_positions``), the rest replicated."""
    dp = dp_axes(mesh)
    dp_size = math.prod(mesh.shape[a] for a in dp)
    out = {}
    for k, v in batch_abstract.items():
        bdim = 1 if k == "mrope_positions" else 0
        spec = [None] * len(v.shape)
        if v.shape[bdim] % dp_size == 0:
            spec[bdim] = dp if len(dp) > 1 else dp[0]
        elif v.shape[bdim] % mesh.shape["data"] == 0:
            spec[bdim] = "data"
        out[k] = NamedSharding(mesh, Spec(*spec))
    return out


def train_step_shardings(cfg, mod, batch_abstract, mesh: Mesh, *,
                         optimizer_name: str = "gwt", level: int = 2,
                         host: str = "adam", eligible=None,
                         shard_params: bool = True,
                         state_codec: str = "f32",
                         rules: Optional[Rules] = None) -> StepShardings:
    """The placements of the sharded train step.  ``shard_params`` applies
    ``rules`` (default :func:`train_rules`) to the parameters and, for GWT,
    the bucket layout to its state; False replicates everything (classic
    DP).  Batches are always split over the DP axes."""
    params_abs = mod.abstract_params(cfg)
    batch_sh = batch_shardings(batch_abstract, mesh)
    if not shard_params:
        return StepShardings(replicated_like(params_abs, mesh), None,
                             batch_sh)
    rules = train_rules(mesh) if rules is None else rules
    params_axes = mod.param_axes(cfg)
    params_sh = tree_shardings(params_abs, params_axes, mesh, rules)
    opt_sh = None
    if optimizer_name == "gwt":
        opt_sh = gwt_state_shardings(params_abs, params_axes, mesh, rules,
                                     level, eligible=eligible, host=host,
                                     state_codec=state_codec)
    return StepShardings(params_sh, opt_sh, batch_sh)


def tp_step_shardings(cfg, mod, batch_abstract, mesh: Mesh,
                      lora_rank: Optional[int] = None,
                      **kw) -> StepShardings:
    """:func:`train_step_shardings` under :func:`tp_rules`: the placements
    of the tensor-parallel step (parameters and GWT's state over
    ``model``).

    ``lora_rank`` (``--finetune lora``): the ``{"base", "lora"}`` form.
    The frozen base is placed as the whole model's parameters are, each
    adapter pair of that rank by :func:`lora_shardings`, and GWT's adapter
    state by :func:`lora_state_shardings` (the base keeps none)."""
    sh = train_step_shardings(cfg, mod, batch_abstract, mesh,
                              rules=tp_rules(mesh, cfg), **kw)
    if lora_rank is None:
        return sh
    from repro_torch.models import lora
    tree = lora.inject(mod.abstract_params(cfg), lora_rank, (0, 0))
    params = lora_shardings(sh.params, tree["lora"])
    opt = None
    if kw.get("optimizer_name", "gwt") == "gwt":
        opt = lora_state_shardings(tree, params, mesh, kw.get("level", 2),
                                   host=kw.get("host", "adam"),
                                   state_codec=kw.get("state_codec", "f32"))
    return StepShardings(params, opt, sh.batch)


# ---------------------------------------------------------------------------
# Placement: a full tensor <-> this rank's shard
# ---------------------------------------------------------------------------

def _split(sh: NamedSharding):
    """``[(dim, axis names)]`` of the dimensions split over axes of size
    > 1."""
    out = []
    for d, entry in enumerate(sh.spec):
        if entry is None:
            continue
        names = _names(entry)
        if _axis_size(sh.mesh, names) > 1:
            out.append((d, names))
    return out


def _blocks(sh: NamedSharding, d: int, ndim: int) -> int:
    """How many blocks dimension ``d`` of an ``ndim``-d tensor splits as
    (``NamedSharding.blocks``: the last dimension only)."""
    return sh.blocks if d == ndim - 1 else 1


def local_shape(shape: Sequence[int], sh: NamedSharding) -> Tuple[int, ...]:
    """The shard shape of a tensor of ``shape``."""
    out = list(shape)
    for d, names in _split(sh):
        n, k = _axis_size(sh.mesh, names), _blocks(sh, d, len(out))
        if out[d] % (n * k):
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"divide over {names} ({n}) x {k} blocks")
        out[d] //= n
    return tuple(out)


def full_shape(shape: Sequence[int], sh: NamedSharding) -> Tuple[int, ...]:
    """The whole tensor's shape of a shard of ``shape``."""
    out = list(shape)
    for d, names in _split(sh):
        out[d] *= _axis_size(sh.mesh, names)
    return tuple(out)


def shard(full: torch.Tensor, sh: Optional[NamedSharding]) -> torch.Tensor:
    """This rank's shard of ``full``: a contiguous copy of its slice (so
    that ``full`` may die), or ``full`` itself where nothing is split.
    Keeps ``requires_grad``."""
    split = [] if sh is None else _split(sh)
    if not split:
        return full
    if full.ndim < len(sh.spec):
        raise ValueError(f"spec {sh.spec} has more entries than the "
                         f"{full.ndim}-d tensor {tuple(full.shape)}")
    with torch.no_grad():
        x = full.detach()
        for d, names in split:
            n = _axis_size(sh.mesh, names)
            k = _blocks(sh, d, x.ndim)
            if x.shape[d] % (n * k):
                raise ValueError(f"dimension {d} of {tuple(full.shape)} "
                                 f"does not divide over {names} ({n}) "
                                 f"x {k} blocks")
            idx = 0
            for a in names:   # the first name is the major
                idx = idx * sh.mesh.shape[a] + sh.mesh.coords[a]
            # this rank's slice of each of the k blocks
            xb = x.unflatten(d, (k, x.shape[d] // k))
            size = xb.shape[d + 1] // n
            x = xb.narrow(d + 1, idx * size, size).flatten(d, d + 1)
        out = x.clone(memory_format=torch.contiguous_format)
    return out.requires_grad_(full.requires_grad)


def gather(local: torch.Tensor, sh: Optional[NamedSharding]
           ) -> torch.Tensor:
    """The whole tensor of which ``local`` is this rank's shard (a
    collective over the split axes' groups: every rank calls it), or
    ``local`` itself where nothing is split.  Keeps ``requires_grad``; the
    result has no autograd history."""
    split = [] if sh is None else _split(sh)
    if not split:
        return local
    import torch.distributed as dist
    x = local.detach().contiguous()
    with torch.no_grad():
        for d, names in split:
            # the first name is the major: gather along the minor first
            for a in reversed(names):
                n = sh.mesh.shape[a]
                if n == 1:
                    continue
                group = sh.mesh.groups.get(a)
                if group is None:
                    raise RuntimeError(
                        f"gathering over {sh.spec} needs the run's process "
                        f"group along {a!r}; {sh.mesh} has none "
                        f"(launch.mesh.init_mesh builds them)")
                parts = [torch.empty_like(x) for _ in range(n)]
                dist.all_gather(parts, x, group=group)
                # block by block: each part holds its slice of every block
                k = _blocks(sh, d, x.ndim)
                x = torch.cat([q.unflatten(d, (k, q.shape[d] // k))
                               for q in parts], d + 1).flatten(d, d + 1)
    return x.requires_grad_(local.requires_grad)


def _tree_apply(fn, tree, shardings):
    if shardings is None:
        return tree
    return _map2(lambda t, s: fn(t, s), tree, shardings)


def shard_tree(tree, shardings):
    """:func:`shard` leaf by leaf (``shardings`` None: ``tree`` as it
    is)."""
    return _tree_apply(shard, tree, shardings)


def gather_tree(tree, shardings):
    """:func:`gather` leaf by leaf, in flatten order on every rank."""
    if shardings is None:
        return tree
    paths, leaves = flatten_with_paths(tree)
    flat = flat_shardings(shardings)
    return unflatten(paths, [gather(t, flat.get(p))
                             for p, t in zip(paths, leaves)])


def flat_shardings(shardings) -> Dict[str, NamedSharding]:
    """``{leaf path: NamedSharding}`` of a sharding tree; a None subtree
    (replicated) contributes nothing."""
    out: Dict[str, NamedSharding] = {}

    def walk(node, prefix):
        if node is None:
            return
        if isinstance(node, NamedSharding):
            out[prefix] = node
            return
        for k, v in node.items():
            walk(v, f"{prefix}/{k}" if prefix else str(k))
    walk(shardings, "")
    return out


def leaf_gather(shardings) -> Callable[[str, torch.Tensor], torch.Tensor]:
    """``(path, tensor) -> whole tensor`` over a sharding tree, for walks
    that go leaf by leaf (a checkpoint's save)."""
    flat = flat_shardings(shardings)
    return lambda path, t: gather(t, flat.get(path))


def leaf_shard(shardings) -> Callable[[str, torch.Tensor], torch.Tensor]:
    """``(path, whole tensor) -> this rank's shard`` over a sharding tree
    (a checkpoint's restore)."""
    flat = flat_shardings(shardings)
    return lambda path, t: shard(t, flat.get(path))


def full_meta(tree, shardings):
    """The whole tensors' shapes and dtypes of a tree of shards, on the
    ``meta`` device."""
    flat = flat_shardings(shardings) if shardings is not None else {}
    paths, leaves = flatten_with_paths(tree)
    return unflatten(paths, [torch.empty(
        full_shape(t.shape, flat[p]) if p in flat else t.shape,
        dtype=t.dtype, device="meta") for p, t in zip(paths, leaves)])


def local_meta(tree, shardings):
    """This rank's shard shapes of a tree of whole tensors (``meta`` will
    do), on the ``meta`` device."""
    flat = flat_shardings(shardings) if shardings is not None else {}
    paths, leaves = flatten_with_paths(tree)
    return unflatten(paths, [torch.empty(
        local_shape(t.shape, flat[p]) if p in flat else t.shape,
        dtype=t.dtype, device="meta") for p, t in zip(paths, leaves)])


def shard_bytes(tree, shardings) -> int:
    """Bytes one rank holds of a tree of whole tensors (``meta`` will do)
    under ``shardings``."""
    flat = flat_shardings(shardings) if shardings is not None else {}
    paths, leaves = flatten_with_paths(tree)
    return sum(math.prod(local_shape(t.shape, flat[p]) if p in flat
                         else t.shape) * t.element_size()
               for p, t in zip(paths, leaves))


def full_bytes(tree, shardings) -> int:
    """Bytes of the whole tensors of a tree of shards: what the tree holds
    across the mesh once, whatever the layout."""
    return sum(t.numel() * t.element_size()
               for t in flatten_with_paths(full_meta(tree, shardings))[1])
