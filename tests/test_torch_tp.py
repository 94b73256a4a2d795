"""The ``model`` mesh axis in one process (no process group):

* the tensor-parallel placement (``sharding.tp_rules``) of every catalog
  config at ``model=2`` and ``model=4``: each leaf's local shape from the
  sizes (a dimension splits where the axis divides it, heads only where
  the head count does), the reference's ``train_rules`` model entries
  leaf by leaf where heads divide, the per-rank bytes, and the families
  that keep the replicated step;
* the head-boundary rule: qwen2.5-3b's two KV heads at ``model=4`` keep
  ``wk``/``wv`` whole although their 256 columns divide by 4, and each
  rank's query heads read their KV head by global index;
* the tensor-parallel attention and MLP computed rank by rank in one
  process, their partial outputs summed by hand, against the whole layer
  (f32, within 8 spacings; measured 4);
* the collectives are the identity on a one-rank group: no collective,
  the same tensors, and the tensor-parallel loss and step at one rank
  within a few f32 spacings of the plain ones.

The processes that run the step across ranks are
``test_torch_tp_ranks.py``."""

import math

import jax
import pytest
import torch

from torch_parity import spacings

from repro import configs as jcfg
from repro.distributed import sharding as jsh
from repro.models import lm as jlm
from repro.models.layers import Axes as JAxes
from repro_torch import configs, optim
from repro_torch.distributed import sharding, tensor_parallel
from repro_torch.distributed.tensor_parallel import TP
from repro_torch.models import attention, layers, lm, module_for
from repro_torch.optim.base import flatten_with_paths

from test_torch_sharding import _amesh

ALL_IDS = list(configs.ARCH_IDS) + list(configs.LLAMA)
SLICE = [a for a in ALL_IDS
         if tensor_parallel.unsupported(configs.get_config(a)) is None]


def _tp_sh(cfg, m):
    mesh = sharding.Mesh((1, m), ("data", "model"))
    return sharding.tp_step_shardings(
        cfg, module_for(cfg), {"tokens": torch.empty((4, 64),
                                                     device="meta")}, mesh)


def _want_local(cfg, shape, names, m):
    """The local shape from the sizes alone: vocab, mlp, experts split
    where ``m`` divides them (an expert MLP's columns only where the
    experts do not split); heads where ``n_heads`` does, KV heads where
    both head counts do."""
    heads = cfg.n_heads % m == 0
    kv = heads and cfg.n_kv_heads % m == 0
    out = list(shape)
    expert_split = False
    for i, (n, name) in enumerate(zip(shape, names)):
        split = {"vocab": True, "mlp": True, "heads": heads, "kv_heads": kv,
                 "expert": True,
                 "expert_mlp": not expert_split}.get(name, False)
        if split and n % m == 0:
            out[i] = n // m
            expert_split = expert_split or name == "expert"
    return tuple(out)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", SLICE)
def test_local_shapes_and_bytes(arch, m):
    cfg = configs.get_config(arch)
    sh = _tp_sh(cfg, m)
    abs_p = lm.abstract_params(cfg)
    local = dict(zip(*flatten_with_paths(lm.abstract_params(cfg,
                                                            sh.params))))
    axes = dict(zip(*flatten_with_paths(lm.param_axes(cfg))))
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
                                  "qwen3-moe-30b-a3b", "qwen2-moe-a2.7b"])
def test_model_entries_equal_the_reference_table(arch, m):
    """Leaf by leaf, the reference's ``train_rules`` on an ``AbstractMesh
    (1, m)`` with its ``data`` entries dropped, except where the head
    count does not divide the axis (there the port keeps the leaf whole)."""
    jc, cfg = jcfg.get_config(arch), configs.get_config(arch)
    jm = _amesh((1, m), ("data", "model"))
    jax_ = jlm.param_axes(jc)
    flat_axes, _ = jax.tree_util.tree_flatten_with_path(
        jax_, is_leaf=lambda x: isinstance(x, JAxes))
    got = {p: tuple(s.spec) for p, s in
           sharding.flat_shardings(_tp_sh(cfg, m).params).items()}
    shapes = dict(zip(*flatten_with_paths(lm.abstract_params(cfg))))
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


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-350m",
                                  "seamless-m4t-large-v2"])
def test_other_families_keep_the_replicated_step(arch):
    assert tensor_parallel.unsupported(configs.get_config(arch))
    assert tensor_parallel.unsupported(configs.get_smoke(arch))


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


def test_collectives_are_the_identity_on_one_rank():
    tp = TP()
    x = torch.randn(3, 4, requires_grad=True)
    assert tp.copy_in(x) is x and tp.reduce_out(x) is x
    assert tp.gather(x, 0) is x and tp.gather(x, -1) is x
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
