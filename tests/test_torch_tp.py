"""The ``model`` mesh axis in one process (no process group):

* the tensor-parallel placement (``sharding.tp_rules``) of every catalog
  config at ``model=2`` and ``model=4``: each leaf's local shape from the
  sizes (a dimension splits where the axis divides it and no earlier
  dimension took the axis, heads only where the head count does), the
  reference's ``train_rules`` model entries leaf by leaf where heads divide
  (mamba's and xLSTM's ``inner`` and the encoder-decoder stack's entries
  included), the per-rank bytes, and every family's split;
* the paired-halves layout (``NamedSharding.blocks``: mamba's ``in_proj``,
  mLSTM's ``up_proj``): each rank's shard is ``[xm_r | z_r]``, and
  ``gather`` of the shards is bitwise the whole tensor;
* the head-boundary rule: qwen2.5-3b's two KV heads at ``model=4`` keep
  ``wk``/``wv`` whole although their 256 columns divide by 4, and each
  rank's query heads read their KV head by global index;
* the tensor-parallel attention and MLP computed rank by rank in one
  process, their partial outputs summed by hand, against the whole layer
  (f32, within 8 spacings; measured 4);
* the mixers of the recurrent and encoder-decoder families (mamba, mLSTM,
  sLSTM, cross-attention) run by ranks that are threads of this process,
  their collectives exchanged between them (forward values only; the
  gradients are ``test_torch_tp_ranks.py``'s), against the whole mixer;
* the collectives are the identity on a one-rank group: no collective,
  the same tensors, and the tensor-parallel loss and step at one rank
  within a few f32 spacings of the plain ones.

The processes that run the step across ranks are
``test_torch_tp_ranks.py``."""

import inspect
import math
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import pytest
import torch
import torch.distributed as dist

from torch_parity import spacings

from repro import configs as jcfg
from repro.distributed import sharding as jsh
from repro.models import encdec as jencdec, lm as jlm
from repro.models.layers import Axes as JAxes
from repro_torch import configs, optim
from repro_torch.distributed import sharding, tensor_parallel
from repro_torch.distributed.tensor_parallel import TP
from repro_torch.models import (attention, encdec, layers, lm, lora,
                                module_for, ssm, xlstm)
from repro_torch.optim.base import flatten_with_paths

from test_torch_sharding import _amesh
import torch_tp_worker as worker

ALL_IDS = list(configs.ARCH_IDS) + list(configs.LLAMA)
# every family: no config keeps the replicated step along 'model'
SLICE = ALL_IDS
FAMILIES = ["jamba-v0.1-52b", "xlstm-350m", "seamless-m4t-large-v2"]


def _tp_sh(cfg, m, **kw):
    mesh = sharding.Mesh((1, m), ("data", "model"))
    return sharding.tp_step_shardings(
        cfg, module_for(cfg), {"tokens": torch.empty((4, 64),
                                                     device="meta")}, mesh,
        **kw)


def _want_local(cfg, shape, names, m):
    """The local shape from the sizes alone: vocab, mlp, experts and
    ``inner`` channels split where ``m`` divides them and no earlier
    dimension of the leaf took the axis (an expert MLP's columns only where
    the experts do not split; mLSTM's ``(inner, heads)`` projections by
    rows); heads where ``n_heads`` does, KV heads where both head counts
    do."""
    heads = cfg.n_heads % m == 0
    kv = heads and cfg.n_kv_heads % m == 0
    out = list(shape)
    used = False
    for i, (n, name) in enumerate(zip(shape, names)):
        split = {"vocab": True, "mlp": True, "heads": heads, "kv_heads": kv,
                 "expert": True, "expert_mlp": True,
                 "inner": True}.get(name, False)
        if split and not used and n % m == 0:
            out[i] = n // m
            used = True
    return tuple(out)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", SLICE)
def test_local_shapes_and_bytes(arch, m):
    cfg = configs.get_config(arch)
    mod = module_for(cfg)
    sh = _tp_sh(cfg, m)
    abs_p = mod.abstract_params(cfg)
    local = dict(zip(*flatten_with_paths(mod.abstract_params(cfg,
                                                             sh.params))))
    axes = dict(zip(*flatten_with_paths(mod.param_axes(cfg))))
    whole = dict(zip(*flatten_with_paths(abs_p)))
    for path, t in whole.items():
        assert tuple(local[path].shape) == _want_local(
            cfg, tuple(t.shape), axes[path].names, m), path
    rank_bytes = sum(t.numel() * t.element_size() for t in local.values())
    assert rank_bytes == sharding.shard_bytes(abs_p, sh.params)
    assert rank_bytes < sharding.shard_bytes(abs_p, None)
    st = optim.make("gwt", lr=0.0, level=2).init(abs_p)
    assert sharding.shard_bytes(st, sh.opt) < sharding.full_bytes(st, None)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", ["llama-60m", "qwen2.5-3b", "gemma2-9b",
                                  "qwen3-moe-30b-a3b", "qwen2-moe-a2.7b"]
                         + FAMILIES)
def test_model_entries_equal_the_reference_table(arch, m):
    """Leaf by leaf, the reference's ``train_rules`` on an ``AbstractMesh
    (1, m)`` with its ``data`` entries dropped, except where the head
    count does not divide the axis (there the port keeps the leaf whole).
    jamba's mamba and xLSTM's blocks take ``model`` on their ``inner``
    dimension; the encoder-decoder stack's on heads, MLP and vocab (whole
    at ``model=4``: 256206 does not divide)."""
    jc, cfg = jcfg.get_config(arch), configs.get_config(arch)
    jm = _amesh((1, m), ("data", "model"))
    jax_ = (jencdec if cfg.arch_class == "encdec" else jlm).param_axes(jc)
    flat_axes, _ = jax.tree_util.tree_flatten_with_path(
        jax_, is_leaf=lambda x: isinstance(x, JAxes))
    got = {p: tuple(s.spec) for p, s in
           sharding.flat_shardings(_tp_sh(cfg, m).params).items()}
    shapes = dict(zip(*flatten_with_paths(
        module_for(cfg).abstract_params(cfg))))
    heads_whole = cfg.n_heads % m or cfg.n_kv_heads % m
    for kp, ax in flat_axes:
        path = "/".join(str(getattr(k, "key", k)) for k in kp)
        ref = jsh.spec_for(tuple(shapes[path].shape), ax, jm,
                           jsh.train_rules(jm))
        want = [None if e == "data" else e for e in tuple(ref)]
        while want and want[-1] is None:
            want.pop()
        if heads_whole and ("kv_heads" in ax.names or (
                cfg.n_heads % m and "heads" in ax.names)):
            want = []
        assert got[path] == tuple(want), path
    if arch in FAMILIES[:2]:
        assert any("model" in tuple(s.spec) and "inner" in ax.names
                   for p, s in sharding.flat_shardings(
                       _tp_sh(cfg, m).params).items()
                   for ax in [dict(zip(*flatten_with_paths(
                       lm.param_axes(cfg))))[p]])


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", FAMILIES)
def test_recurrent_and_encdec_families_get_a_placement(arch, m):
    """The recurrent and encoder-decoder families split along ``model``
    (they kept the replicated step before): every mixer's and MLP's
    weights a rank holds are a 1/m part, so a rank holds under 1/m of the
    whole's bytes plus the replicated norms, biases and (seamless at
    ``model=4``) vocab."""
    cfg = configs.get_config(arch)
    mod = module_for(cfg)
    sh = _tp_sh(cfg, m).params
    abs_p = mod.abstract_params(cfg)
    flat = sharding.flat_shardings(sh)
    kinds = {"jamba-v0.1-52b": ("mixer/in_proj", "mixer/x_proj",
                                "mixer/out_proj", "mixer/wq"),
             "xlstm-350m": ("mixer/up_proj", "mixer/wq", "mixer/w",
                            "mixer/r", "mixer/up_gate", "mixer/down"),
             "seamless-m4t-large-v2": ("attn/wq", "cross_attn/wk",
                                       "cross_attn/wo", "mlp/w_down")}[arch]
    for kind in kinds:
        hits = [p for p in flat if p.endswith(kind)]
        assert hits and all("model" in tuple(flat[p].spec) for p in hits), \
            kind
    whole = sharding.shard_bytes(abs_p, None)
    rank = sharding.shard_bytes(abs_p, sh)
    vocab = cfg.vocab * cfg.d_model * cfg.torch_dtype.itemsize * (
        1 if cfg.tie_embeddings else 2)
    assert rank < whole / m + (vocab if cfg.vocab % m else whole / 100)
    halves = [p for p in flat if flat[p].blocks == 2]
    assert sorted({p.rsplit("/", 1)[1] for p in halves}) == (
        ["in_proj"] if arch == "jamba-v0.1-52b" else
        ["up_proj"] if arch == "xlstm-350m" else [])


def _fake_gather(shards):
    """``dist.all_gather`` over a group of ranks ``shards`` (this process
    plays each rank in turn): the parts of the rank's ``shards``, in rank
    order."""
    calls = iter(shards)

    def all_gather(parts, x, group=None):
        for part, src in zip(parts, next(calls)):
            part.copy_(src)
    return all_gather


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("leaf", ["jamba in_proj", "xlstm up_proj"])
def test_halves_layout_round_trip(leaf, m, monkeypatch):
    """A paired-halves leaf: rank r holds ``[xm_r | z_r]`` (the table's
    local shape and bytes), a column-parallel matmul of that shard is the
    rank's channels of both halves, and ``gather`` of the ranks' shards is
    the whole tensor bitwise, in the reference's column order; a contiguous
    concatenation of the shards would not be."""
    arch, name = leaf.split()
    cfg = configs.get_smoke(f"{arch}-v0.1-52b" if arch == "jamba"
                            else "xlstm-350m").with_(dtype="float32")
    path = f"layers/b0/mixer/{name}"
    whole = lm.init(cfg, torch.Generator().manual_seed(0), "cpu").tree()
    full = dict(zip(*flatten_with_paths(whole)))[path].detach()
    sh = sharding.flat_shardings(_tp_sh(cfg, m).params)[path]
    assert sh.blocks == 2 and tuple(sh.spec) == (None, None, "model")
    n = full.shape[-1] // 2
    x = torch.randn(3, full.shape[-2], generator=torch.Generator()
                    .manual_seed(1))
    ranks = []
    for r in range(m):
        mesh = sharding.Mesh((1, m), ("data", "model"), coords=(0, r),
                             groups={"model": object()})
        mine = sharding.NamedSharding(mesh, sh.spec, sh.blocks)
        local = sharding.shard(full, mine)
        assert tuple(local.shape) == sharding.local_shape(full.shape, sh)
        assert local.numel() * local.element_size() == \
            full.numel() * full.element_size() // m
        cols = torch.cat([torch.arange(r * n // m, (r + 1) * n // m),
                          n + torch.arange(r * n // m, (r + 1) * n // m)])
        assert torch.equal(local, full[..., cols])
        assert torch.equal(x @ local[0], (x @ full[0])[..., cols])
        ranks.append((mine, local))
    parts = [local for _, local in ranks]
    assert not torch.equal(torch.cat(parts, -1), full)
    monkeypatch.setattr(dist, "all_gather", _fake_gather([parts] * m))
    for mine, local in ranks:
        assert torch.equal(sharding.gather(local, mine), full)


def test_head_boundary_rule_qwen25_3b_at_four():
    cfg = configs.get_config("qwen2.5-3b")   # H 16, KV 2, hd 128
    mesh = sharding.Mesh((1, 4), ("data", "model"))
    flat = sharding.flat_shardings(_tp_sh(cfg, 4).params)
    # the flat KV dimension divides, the head count does not
    assert (cfg.n_kv_heads * cfg.head_dim) % 4 == 0
    assert sharding.spec_for((cfg.d_model, 256), layers.Axes(
        ("embed", "kv_heads")), mesh, sharding.train_rules(mesh)) \
        == sharding.Spec("data", "model")
    for leaf in ("wk", "wv", "bk", "bv"):
        assert flat[f"layers/b0/mixer/{leaf}"].spec == sharding.Spec(), leaf
    assert flat["layers/b0/mixer/wq"].spec == sharding.Spec(None, None,
                                                            "model")
    assert flat["layers/b0/mixer/wo"].spec == sharding.Spec(None, "model")
    # query heads 4r..4r+3 of group size 8 read KV head r // 2
    for r in range(4):
        lo, hi, idx = tensor_parallel.kv_heads_of(TP(None, r, 4), cfg)
        assert (lo, hi) == (r // 2, r // 2 + 1)
        assert idx.tolist() == [0, 0, 0, 0]
    # a group that straddles two ranks' heads: H 6, KV 3 at m=4 does not
    # arise (6 % 4); H 8, KV 2 at m=4 gives group 4 = one rank's heads
    c2 = cfg.with_(n_heads=8, n_kv_heads=2)
    assert [tensor_parallel.kv_heads_of(TP(None, r, 4), c2)[:2]
            for r in range(4)] == [(0, 1), (0, 1), (1, 2), (1, 2)]
    c3 = cfg.with_(n_heads=12, n_kv_heads=3)   # group 4, 3 heads a rank
    got = [tensor_parallel.kv_heads_of(TP(None, r, 4), c3)
           for r in range(4)]
    assert [g[:2] for g in got] == [(0, 1), (0, 2), (1, 3), (2, 3)]
    assert [g[2].tolist() for g in got] == [[0, 0, 0], [0, 1, 1],
                                            [0, 0, 1], [0, 0, 0]]


class _ByHand(TP):
    """A rank of a group whose collectives are left to the test: the
    partial outputs are summed by hand."""

    def copy_in(self, x):
        return x

    def reduce_out(self, x):
        return x


def _ranks_sum(fn, params, sh, m):
    out = None
    for r in range(m):
        mesh = sharding.Mesh((1, m), ("data", "model"), coords=(0, r))
        local = sharding.shard_tree(
            params, {k: sharding.NamedSharding(mesh, s.spec)
                     for k, s in sh.items()})
        y = fn(local, _ByHand(None, r, m))
        out = y if out is None else out + y
    return out


@pytest.mark.parametrize("kv,m", [(2, 2), (2, 4), (4, 4), (1, 2)])
def test_attention_rank_by_rank_sums_to_the_whole(kv, m):
    cfg = configs.get_smoke("qwen2.5-3b").with_(
        n_heads=4, n_kv_heads=kv, dtype="float32", qk_norm=True)
    b = layers.Builder(torch.Generator().manual_seed(0), "cpu",
                       torch.float32)
    p = attention.attn_init(b, cfg)
    g = torch.Generator().manual_seed(1)
    p = {k: v + 0.1 * torch.randn(v.shape, generator=g) for k, v in
         p.items()}   # nonzero biases and norms
    x = torch.randn(2, 8, cfg.d_model, generator=g)
    cos, sin = lm._angles(cfg, torch.arange(8), None, 2, 8)
    want, _ = attention.attn_apply(p, cfg, x, cos, sin)
    full = lm.abstract_params(cfg)["layers"]["b0"]["mixer"]
    sh = {k: s for k, s in sharding.flat_shardings(
        _tp_sh(cfg, m).params).items() if k.startswith("layers/b0/mixer/")}
    # the stacked leaves' specs without their leading 'layers' entry
    sh = {k.rsplit("/", 1)[1]: sharding.NamedSharding(
        s.mesh, sharding.Spec(*s.spec[1:])) for k, s in sh.items()}
    assert set(sh) == set(full)
    got = _ranks_sum(lambda lp, tp: attention.attn_apply(
        lp, cfg, x, cos, sin, tp=tp)[0],
        {k: v for k, v in p.items()}, sh, m)
    assert spacings(got, want) <= 8


def test_mlp_rank_by_rank_sums_to_the_whole():
    g = torch.Generator().manual_seed(2)
    b = layers.Builder(g, "cpu", torch.float32)
    p = layers.mlp_init(b, 16, 64)
    x = torch.randn(3, 16, generator=g)
    mesh = sharding.Mesh((1, 4), ("data", "model"))
    sh = {"w_gate": sharding.NamedSharding(mesh, sharding.Spec(None,
                                                                "model")),
          "w_up": sharding.NamedSharding(mesh, sharding.Spec(None, "model")),
          "w_down": sharding.NamedSharding(mesh, sharding.Spec("model"))}
    got = _ranks_sum(lambda lp, tp: layers.mlp_apply(lp, x, tp), p, sh, 4)
    assert spacings(got, layers.mlp_apply(p, x)) <= 8


class _Threads:
    """The collectives' meeting point of ``m`` ranks that are threads of
    this process: each rank posts its tensor, and once every rank has, each
    reads all of them in rank order."""

    def __init__(self, m):
        self.barrier = threading.Barrier(m, timeout=60)
        self.slots = [None] * m

    def exchange(self, rank, x):
        self.slots[rank] = x
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out


class _ThreadTP(TP):
    """A rank of :class:`_Threads`: the collectives' forward values (sums
    in rank order, gathers by concatenation); no autograd across ranks."""

    def __init__(self, meet, rank, size):
        super().__init__(None, rank, size)
        self.meet = meet

    def copy_in(self, x):
        return x

    def reduce_out(self, x):
        parts = self.meet.exchange(self.rank, x)
        out = parts[0]
        for q in parts[1:]:
            out = out + q
        return out

    def reduce_split(self, x):
        return self.reduce_out(x)

    def gather(self, x, dim):
        return torch.cat(self.meet.exchange(self.rank, x), dim)

    def gather_reduce(self, x, dim):
        return self.gather(x, dim)

    def all_max(self, x):
        return torch.stack(self.meet.exchange(self.rank, x)).amax(0)


def _mixer_shardings(cfg, m, prefix):
    """The placements of one stacked block's leaves under ``prefix``
    without their leading layers entry, keyed by leaf name."""
    flat = sharding.flat_shardings(_tp_sh(cfg, m).params)
    return {k[len(prefix):]: sharding.NamedSharding(
        s.mesh, sharding.Spec(*s.spec[1:]), s.blocks)
        for k, s in flat.items() if k.startswith(prefix)}


def _threads_run(fn, params, sh, m):
    """``fn(local params, tp)`` on ``m`` thread ranks, each holding its
    shards of ``params`` under ``sh``; every rank's output."""
    meet = _Threads(m)

    def rank(r):
        mesh = sharding.Mesh((1, m), ("data", "model"), coords=(0, r))
        local = {k: sharding.shard(v, sharding.NamedSharding(
            mesh, sh[k].spec, sh[k].blocks)) for k, v in params.items()}
        with torch.no_grad():
            return fn(local, _ThreadTP(meet, r, m))

    with ThreadPoolExecutor(m) as pool:
        return list(pool.map(rank, range(m)))


def _perturbed(p, seed):
    """``p`` plus noise: nonzero biases, norms and gates."""
    g = torch.Generator().manual_seed(seed)
    return {k: v + 0.1 * torch.randn(v.shape, generator=g)
            for k, v in p.items()}


# f32 spacings of the whole mixer's largest output, over model=2 and 4
# (measured: mamba 4.5, sLSTM 5, cross-attention 5.5; mLSTM 21.25, and 7-22
# over seven other draws of its weights: the stabilised gates' exponentials
# carry the row-parallel sums' rounding, as they carry the port's distance
# from the reference, ROADMAP Queue 3)
THREAD_SPACINGS = {"mamba": 16, "mlstm": 64, "slstm": 16, "xattn": 16}


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_recurrent_mixers_rank_by_rank(kind, m):
    """mamba (jamba's smoke widths, ``d_inner`` 128), mLSTM and sLSTM
    (xlstm-350m's smoke, 2 heads: at ``model=4`` the axis does not divide
    them, so mLSTM computes every head and keeps its channels, sLSTM runs
    the recurrence replicated), each rank on its shards, the collectives
    exchanged between threads: every rank's output equals the whole
    mixer's within ``THREAD_SPACINGS``."""
    arch = "jamba-v0.1-52b" if kind == "mamba" else "xlstm-350m"
    cfg = configs.get_smoke(arch).with_(dtype="float32")
    b = layers.Builder(torch.Generator().manual_seed(0), "cpu",
                       torch.float32)
    init, apply = {"mamba": (ssm.mamba_init, ssm.mamba_apply),
                   "mlstm": (xlstm.mlstm_init, xlstm.mlstm_apply),
                   "slstm": (xlstm.slstm_init, xlstm.slstm_apply)}[kind]
    p = _perturbed(init(b, cfg), 1)
    if kind == "mamba":
        p["a_log"] = p["a_log"].abs()
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(2))
    with torch.no_grad():
        want, _ = apply(p, cfg, x)
    block = next(i for i, k in enumerate(cfg.pattern) if k.startswith(kind))
    sh = _mixer_shardings(cfg, m, f"layers/b{block}/mixer/")
    assert set(sh) == set(p)
    outs = _threads_run(lambda lp, tp: apply(lp, cfg, x, tp=tp)[0], p, sh,
                        m)
    for out in outs:
        assert torch.equal(out, outs[0])
    assert spacings(outs[0], want) <= THREAD_SPACINGS[kind]


@pytest.mark.parametrize("kv,m", [(4, 2), (4, 4), (2, 4)])
def test_cross_attention_rank_by_rank(kv, m):
    """The decoder's cross-attention (seamless's smoke widths, 4 heads):
    query heads and ``wo`` rows split, the KV heads too where the axis
    divides them, else each rank reads its heads' KV heads from the whole
    ``wk``/``wv``; every rank's output equals the whole layer's."""
    cfg = configs.get_smoke("seamless-m4t-large-v2").with_(
        dtype="float32", n_kv_heads=kv)
    b = layers.Builder(torch.Generator().manual_seed(0), "cpu",
                       torch.float32)
    p = encdec._xattn_init(b, cfg)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, cfg.d_model, generator=g)
    src = torch.randn(2, 6, cfg.d_model, generator=g)
    with torch.no_grad():
        want, _ = encdec._xattn_apply(p, cfg, x, kv_src=src)
    sh = _mixer_shardings(cfg, m, "decoder/cross_attn/")
    assert set(sh) == set(p)
    outs = _threads_run(lambda lp, tp: encdec._xattn_apply(
        lp, cfg, x, kv_src=src, tp=tp)[0], p, sh, m)
    for out in outs:
        assert torch.equal(out, outs[0])
    assert spacings(outs[0], want) <= THREAD_SPACINGS["xattn"]


def test_cached_modes_refuse_a_tp():
    """Only train mode splits: serving's cache layout along ``model`` is
    the next slice's."""
    cfg = configs.get_smoke("jamba-v0.1-52b").with_(dtype="float32")
    b = layers.Builder(torch.Generator().manual_seed(0), "cpu",
                       torch.float32)
    x = torch.zeros(1, 4, cfg.d_model)
    for init, apply in ((ssm.mamba_init, ssm.mamba_apply),
                        (xlstm.mlstm_init, xlstm.mlstm_apply),
                        (xlstm.slstm_init, xlstm.slstm_apply)):
        with pytest.raises(NotImplementedError, match="7.4.5"):
            apply(init(b, cfg), cfg, x, mode="prefill", tp=TP(None, 0, 2))


def test_a_loss_without_tp_keeps_the_replicated_step():
    """The tensor-parallel step calls its loss with ``tp=``: a loss that
    takes none has no tensor-parallel form, and the step refuses it before
    it runs; LoRA's shim takes ``tp=``."""
    cfg = configs.get_smoke("llama-60m").with_(dtype="float32")

    def plain(cfg, params, batch):
        return lm.loss_fn(cfg, params, batch)

    with pytest.raises(ValueError, match="no tensor-parallel form"):
        lm.make_train_step(cfg, optim.make("gwt", lr=1e-2, level=2),
                           tp=TP(), shardings=_tp_sh(cfg, 1), loss=plain)
    assert "tp" in inspect.signature(
        lora.loss_module(lm, 16.0, 4).loss_fn).parameters


def test_collectives_are_the_identity_on_one_rank():
    tp = TP()
    x = torch.randn(3, 4, requires_grad=True)
    assert tp.copy_in(x) is x and tp.reduce_out(x) is x
    assert tp.gather(x, 0) is x and tp.gather(x, -1) is x
    assert tp.reduce_split(x) is x and tp.gather_reduce(x, -1) is x
    assert torch.equal(tp.all_max(x), x)
    assert tensor_parallel.from_dp(None) is None
    assert tensor_parallel.split(None, 8) is None
    assert tensor_parallel.split(TP(None, 0, 2), 9) is None
    assert tensor_parallel.split(tp, 9) is tp


@pytest.mark.parametrize("arch", ["llama-60m", "gemma2-9b",
                                  "qwen3-moe-30b-a3b"])
def test_loss_and_step_at_one_rank(arch):
    """One rank of a ``model`` axis: the vocab-split loss of the whole
    vocab within 2 f32 spacings of ``cross_entropy`` and the gradients
    within 8 (measured 0 and 6); the tensor-parallel step without
    ``dp_reduce`` matches the plain step: the loss within 1e-6, the
    parameters' move within 2e-4 of its norm (measured 3.9e-5; a last-bit
    gradient difference may turn Adam's step on a near-zero gradient)."""
    cfg = configs.get_smoke(arch).with_(dtype="float32")
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu").tree()
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 64), generator=g,
                              dtype=torch.int32)
             for k in ("tokens", "labels")}
    paths, leaves = flatten_with_paths(params)
    want = lm.loss_fn(cfg, params, batch)
    got = lm.loss_fn(cfg, params, batch, tp=TP())
    assert spacings(got, want) <= 2
    for a, b in zip(torch.autograd.grad(got, leaves),
                    torch.autograd.grad(want, leaves)):
        assert spacings(a, b) <= 8
    sh = _tp_sh(cfg, 1)
    steps = {}
    for key, kw in (("plain", {}), ("tp", {"tp": TP(), "shardings": sh})):
        p = {k: v for k, v in lm.init(cfg, torch.Generator().manual_seed(0),
                                      "cpu").tree().items()}
        opt = optim.make("gwt", lr=1e-2, level=2)
        step = lm.make_train_step(cfg, opt, **kw)
        p, st, m = step(p, opt.init(p), batch)
        steps[key] = (dict(zip(*flatten_with_paths(p))), float(m["loss"]))
    assert math.isclose(steps["tp"][1], steps["plain"][1], rel_tol=1e-6)
    init = dict(zip(*flatten_with_paths(lm.init(
        cfg, torch.Generator().manual_seed(0), "cpu").tree())))
    num = den = 0.0
    for path, w in steps["plain"][0].items():
        w = w.detach().double()
        num += float(((steps["tp"][0][path].detach().double() - w) ** 2)
                     .sum())
        den += float(((w - init[path].detach().double()) ** 2).sum())
    assert (num / den) ** 0.5 <= 2e-4


# ---------------------------------------------------------------------------
# LoRA adapters along 'model'
# ---------------------------------------------------------------------------

# every family's smoke config (f32), its adapters' b nonzero: qwen2.5's
# K/V projections split at model=2 and stay whole at 4, llama's attention
# stays whole at 4 (2 heads), qwen3-moe's 8 experts split (EP), the odd
# MoE's 9 keep whole and split inside each expert, xLSTM's wq/wk/wv split
# by rows over inner
LORA_ARCHS = ["llama-60m", "qwen2.5-3b", "qwen3-moe-30b-a3b", worker.ODD_MOE,
              "jamba-v0.1-52b", "xlstm-350m", "seamless-m4t-large-v2"]
# the kinds of split each config's targets show, at model=2 / model=4
LORA_KINDS = {
    "llama-60m": ({"column", "row"}, {"column", "row", "whole"}),
    "qwen2.5-3b": ({"column", "row"}, {"column", "row", "whole"}),
    "qwen3-moe-30b-a3b": ({"column", "row", "leading"},) * 2,
    worker.ODD_MOE: ({"column", "row"},) * 2,
    "jamba-v0.1-52b": ({"column", "row", "leading"},) * 2,
    "xlstm-350m": ({"row"},) * 2,
    "seamless-m4t-large-v2": ({"column", "row"},) * 2,
}


def _lora_case(arch, m):
    cfg = worker.smoke_cfg(arch, dtype="float32")
    return cfg, _tp_sh(cfg, m, lora_rank=worker.LORA_RANK), \
        worker.lora_tree(cfg)


def _splits(sh):
    return {d: names for d, names in sharding._split(sh)}


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", LORA_ARCHS)
def test_lora_adapter_placements(arch, m):
    """Each target's pair is placed from the dimension its weight's spec
    split: a leading one (experts under EP) splits both factors, ``m``
    (row-parallel) splits ``a``, ``n`` (column-parallel) splits ``b``, a
    weight left whole leaves both whole; ``r`` never splits, and no target
    is a paired-halves leaf.  xLSTM's ``wq`` (``("inner", "heads")``, both
    names on ``model``) splits by rows only."""
    cfg, sh, tree = _lora_case(arch, m)
    flat_w = sharding.flat_shardings(sh.params["base"])
    flat_l = sharding.flat_shardings(sh.params["lora"])
    whole = dict(zip(*flatten_with_paths(tree["base"])))
    pairs = [p[:-2] for p in flat_l if p.endswith("/a")]
    assert pairs and len(flat_l) == 2 * len(pairs)
    kinds = {}
    for path in pairs:
        w, a, b = flat_w[path], flat_l[path + "/a"], flat_l[path + "/b"]
        nd = whole[path].ndim
        assert w.blocks == 1 and a.blocks == 1 and b.blocks == 1, path
        ws, as_, bs = _splits(w), _splits(a), _splits(b)
        assert nd - 1 not in as_ and nd - 2 not in bs, path   # r whole
        if not ws:
            kind, want_a, want_b = "whole", {}, {}
        else:
            (d, names), = ws.items()
            if d == nd - 1:
                kind, want_a, want_b = "column", {}, {d: names}
            elif d == nd - 2:
                kind, want_a, want_b = "row", {d: names}, {}
            else:
                kind, want_a, want_b = "leading", {d: names}, {d: names}
        assert (as_, bs) == (want_a, want_b), path
        kinds[path] = kind
    assert set(kinds.values()) >= LORA_KINDS[arch][m // 4], kinds
    if arch == "xlstm-350m":
        assert kinds["layers/b0/mixer/wq"] == "row"
    if arch == "qwen2.5-3b":
        assert kinds["layers/b0/mixer/wk"] == ("whole" if m == 4
                                               else "column")


def _on_rank(tree, mesh):
    """A sharding tree's placements over ``mesh`` (a rank's coords)."""
    if isinstance(tree, sharding.NamedSharding):
        return sharding.NamedSharding(mesh, tree.spec, tree.blocks)
    return {k: _on_rank(v, mesh) for k, v in tree.items()}


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", LORA_ARCHS)
def test_lora_split_merge_is_the_rank_slice(arch, m, monkeypatch):
    """Each rank's ``lora.merge(..., tp=)`` of its shards (base shard plus
    ``a_local @ b_local * α/r``) equals its slice of the whole merge
    within 1 f32 spacing of each leaf's largest magnitude (measured 0 on
    the CPU; the rank-8 products of a column slice may round apart from
    the whole product's), the base leaves that are not targets bitwise; the
    factors gathered from the ranks' shards are world 1's bitwise, and so
    is ``a @ b`` rebuilt from them."""
    cfg, sh, tree = _lora_case(arch, m)
    merged = lora.merge(tree, worker.LORA_ALPHA, worker.LORA_RANK)
    targets = {p[:-2] for p in flatten_with_paths(tree["lora"])[0]}
    locals_ = []
    for r in range(m):
        mesh = sharding.Mesh((1, m), ("data", "model"), coords=(0, r),
                             groups={"model": object()})
        sh_r = _on_rank(sh.params, mesh)
        local = sharding.shard_tree(tree, sh_r)
        got = dict(zip(*flatten_with_paths(lora.merge(
            local, worker.LORA_ALPHA, worker.LORA_RANK,
            tp=_ByHand(None, r, m), shardings=sh_r["lora"]))))
        want = dict(zip(*flatten_with_paths(sharding.shard_tree(
            merged, sh_r["base"]))))
        for p, w in want.items():
            if p in targets:
                assert spacings(got[p], w) <= 1, (r, p)
            else:
                assert torch.equal(got[p], w), (r, p)
        locals_.append((sh_r["lora"], dict(zip(*flatten_with_paths(
            local["lora"])))))
    whole = dict(zip(*flatten_with_paths(tree["lora"])))
    flat_sh = [sharding.flat_shardings(s) for s, _ in locals_]
    rebuilt = {}
    for path, full in whole.items():
        parts = [leaves[path] for _, leaves in locals_]
        monkeypatch.setattr(dist, "all_gather", _fake_gather([parts] * m))
        for r in range(m):
            rebuilt[path] = sharding.gather(parts[r], flat_sh[r][path])
            assert torch.equal(rebuilt[path], full), (r, path)
    for path in targets:
        delta = {}
        for key, src in (("rebuilt", rebuilt), ("whole", whole)):
            delta[key] = layers.lora_delta(
                {k: src[f"{path}/{k}"] for k in ("a", "b")},
                worker.LORA_ALPHA, worker.LORA_RANK)
        assert torch.equal(delta["rebuilt"], delta["whole"]), path
