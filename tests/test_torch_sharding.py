"""The port's sharded-parameter layout against the JAX package's rule table,
in one process (no process group): ``models.{lm,encdec}.param_axes`` path by
path, ``distributed/sharding.py``'s ``spec_for``, ``tree_shardings`` and
``gwt_state_shardings`` against the reference's ``PartitionSpec``s on
``AbstractMesh`` shapes ``(8,)``, ``(16, 16)`` and ``(2, 16, 16)``, the
per-rank bytes of the table at ``data=8``, the placement helpers, the
engine's placed state, and the launcher's ``--mesh`` refusals.  The two-rank
runs are ``test_torch_shard_ranks.py``."""

import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro import configs as jcfg
from repro.distributed import sharding as jsh
from repro.models import encdec as jenc, lm as jlm
from repro.models.layers import Axes as JAxes
from repro_torch import configs as tcfg, optim
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import train
from repro_torch.models import lm, module_for
from repro_torch.models.layers import Axes
from repro_torch.optim import engine
from repro_torch.optim.base import flatten_with_paths

ALL_IDS = list(tcfg.ARCH_IDS) + list(tcfg.LLAMA)
STATE_ARCHS = ["qwen2.5-3b", "qwen2-moe-a2.7b", "qwen3-moe-30b-a3b",
               "seamless-m4t-large-v2", "jamba-v0.1-52b"]
MESHES = {"8": ((8,), ("data",)), "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
STATE_CASES = [(h, c, lv) for h in ("adam", "adam_mini", "muon")
               for c in ("f32", "int8") for lv in (2, 3)]


def _amesh(shape, names):
    try:
        return AbstractMesh(shape, names)
    except TypeError:   # the older signature: ((name, size), ...)
        return AbstractMesh(tuple(zip(names, shape)))


def _jflat(tree, leaf):
    paths, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=leaf)
    return {"/".join(str(getattr(k, "key", k)) for k in p): v
            for p, v in paths}


def _ref_specs(tree):
    return {p: tuple(s.spec) for p, s in
            _jflat(tree, lambda x: hasattr(x, "spec")).items()}


def _port_specs(tree):
    return {p: tuple(s.spec) for p, s in tsh.flat_shardings(tree).items()}


_MODELS = {}


def _models(arch):
    """(JAX abstract params, JAX axes, port meta params, port axes)."""
    if arch not in _MODELS:
        jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
        jm = jenc if jc.arch_class == "encdec" else jlm
        tm = module_for(tc)
        _MODELS[arch] = (jm.abstract_params(jc), jm.param_axes(jc),
                         tm.abstract_params(tc), tm.param_axes(tc))
    return _MODELS[arch]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ALL_IDS)
def test_param_axes_equal_reference(arch, smoke):
    jc = jcfg.get_smoke(arch) if smoke else jcfg.get_config(arch)
    tc = tcfg.get_smoke(arch) if smoke else tcfg.get_config(arch)
    jm = jenc if jc.arch_class == "encdec" else jlm
    want = {p: a.names for p, a in _jflat(
        jm.param_axes(jc), lambda x: isinstance(x, JAxes)).items()}
    tm = module_for(tc)
    paths, axes = flatten_with_paths(tm.param_axes(tc))
    assert dict(zip(paths, (a.names for a in axes))) == want
    # the axes tree has the parameters' paths and ranks
    ppaths, leaves = flatten_with_paths(tm.abstract_params(tc))
    assert ppaths == paths
    assert [t.ndim for t in leaves] == [len(a.names) for a in axes]


def test_spec_for_reference_cases():
    """The cases of the JAX package's ``test_distributed.py``: GQA kv
    heads that do not divide, MoE experts falling through to TP, an
    odd vocab, the long-decode cache, and 'model' absent from the mesh."""
    cases = [
        ((2048, 8 * 128), ("embed", "kv_heads"), "16x16", "train"),
        ((2048, 2 * 128), ("embed", "kv_heads"), "16x16", "train"),
        ((2048, 8), ("embed", "kv_heads"), "16x16", "train"),
        ((60, 2048, 1408), ("expert", "embed", "expert_mlp"), "16x16",
         "train"),
        ((128, 2048, 768), ("expert", "embed", "expert_mlp"), "16x16",
         "train"),
        ((256206, 1024), ("vocab", "embed"), "16x16", "train"),
        ((1, 524288, 8, 128), ("batch", "seq", "kv_heads", None), "16x16",
         "decode"),
        ((1, 524288, 8, 128), ("batch", "seq", "kv_heads", None), "2x16x16",
         "decode"),
        ((256, 64), ("vocab", "embed"), "8", "train"),
        ((64, 128), ("embed", "mlp"), "8", "train"),
        ((16, 4096, 8, 128), ("batch", "seq", "kv_heads", None), "2x16x16",
         "decode"),
    ]
    for shape, names, mesh, kind in cases:
        jm, tm = _amesh(*MESHES[mesh]), tsh.Mesh(*MESHES[mesh])
        jr = (jsh.train_rules if kind == "train" else jsh.decode_rules)(jm)
        tr = (tsh.train_rules if kind == "train" else tsh.decode_rules)(tm)
        want = jsh.spec_for(shape, JAxes(names), jm, jr)
        got = tsh.spec_for(shape, Axes(names), tm, tr)
        assert tuple(got) == tuple(want), (shape, names, mesh)
    # the reference's own expectations, spelled out
    tm = tsh.Mesh(*MESHES["16x16"])
    rules = tsh.train_rules(tm)
    assert tsh.spec_for((60, 2048, 1408), Axes(("expert", "embed",
                                                "expert_mlp")), tm, rules) \
        == tsh.Spec(None, "data", "model")
    assert tsh.spec_for((1, 524288, 8, 128),
                        Axes(("batch", "seq", "kv_heads", None)), tm,
                        tsh.decode_rules(tm)) \
        == tsh.Spec(None, ("model", "data"))
    assert tuple(P(None, ("model", "data"))) == (None, ("model", "data"))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_tree_and_state_shardings_equal_reference(arch, mesh):
    """Parameters under ``train_rules`` and GWT's bucketed state for hosts
    adam/adam_mini/muon, codecs f32/int8 and levels 2/3: every leaf's spec
    equals the reference's, and the port's tree has the leaves of the
    port's own optimizer state."""
    jabs, jax_, tabs, tax = _models(arch)
    jm, tm = _amesh(*MESHES[mesh]), tsh.Mesh(*MESHES[mesh])
    jr, tr = jsh.train_rules(jm), tsh.train_rules(tm)
    assert _port_specs(tsh.tree_shardings(tabs, tax, tm, tr)) \
        == _ref_specs(jsh.tree_shardings(jabs, jax_, jm, jr))
    for host, codec, level in STATE_CASES:
        want = _ref_specs(jsh.gwt_state_shardings(
            jabs, jax_, jm, jr, level, host=host, state_codec=codec))
        got = tsh.gwt_state_shardings(tabs, tax, tm, tr, level, host=host,
                                      state_codec=codec)
        assert _port_specs(got) == want, (host, codec, level)
        if mesh == "8" and level == 2:
            state = optim.make("gwt", lr=0.0, level=level, host=host,
                               state_codec=codec).init(tabs)
            assert flatten_with_paths(state)[0] == sorted(want), \
                (host, codec)


@pytest.mark.parametrize("arch,state,state_rank,params,params_rank", [
    ("qwen2.5-3b", 8_039_764_012, 1_534_660_652, 6_171_877_376,
     771_907_584),
    ("llama-60m", 181_735_456, 37_457_952, 83_379_200, 10_437_632),
])
def test_rank_bytes_at_data8(arch, state, state_rank, params, params_rank):
    """What one rank of a ``data=8`` mesh holds under the table: the GWT-2
    f32 state and the parameters, whole and per rank (the reference's
    figures); some buckets stay replicated, so the state is not 1/8."""
    cfg = tcfg.get_config(arch)
    mod = module_for(cfg)
    mesh = tsh.Mesh((8,), ("data",))
    sh = tsh.train_step_shardings(
        cfg, mod, {"tokens": torch.empty((16, 256), device="meta")}, mesh)
    abs_p = mod.abstract_params(cfg)
    st = optim.make("gwt", lr=0.0, level=2).init(abs_p)
    assert engine.state_bytes(st) == state
    assert tsh.shard_bytes(st, sh.opt) == state_rank
    assert tsh.shard_bytes(abs_p, None) == params
    assert tsh.shard_bytes(abs_p, sh.params) == params_rank
    assert tuple(sh.batch["tokens"].spec) == ("data", None)


def test_shard_slices_tile_the_tensor():
    """The shards of every coordinate of a (2, 4) mesh, concatenated in
    coordinate order, are the tensor; tuple entries split major-first."""
    full = torch.arange(8 * 12 * 4, dtype=torch.float32).reshape(8, 12, 4)
    for spec, dim in [(tsh.Spec("data"), 0), (tsh.Spec(None, "model"), 1),
                      (tsh.Spec(("data", "model")), 0)]:
        parts = []
        for d in range(2):
            for m in range(4):
                mesh = tsh.Mesh((2, 4), ("data", "model"), (d, m))
                parts.append((d, m, tsh.shard(full, tsh.NamedSharding(
                    mesh, spec))))
        if spec == tsh.Spec(None, "model"):
            got = torch.cat([p for d, m, p in parts if d == 0], 1)
            assert all(torch.equal(p, parts[m][2]) for d, m, p in parts)
        elif spec == tsh.Spec("data"):
            got = torch.cat([p for d, m, p in parts if m == 0], 0)
        else:
            got = torch.cat([p for _, _, p in parts], 0)
        assert torch.equal(got, full), spec
        sh = tsh.NamedSharding(tsh.Mesh((2, 4), ("data", "model")), spec)
        assert tsh.full_shape(tsh.local_shape(full.shape, sh), sh) \
            == tuple(full.shape)
    with pytest.raises(ValueError, match="divide"):
        tsh.shard(torch.zeros(3, 4), tsh.NamedSharding(
            tsh.Mesh((2,), ("data",)), tsh.Spec("data")))


def test_size_one_axes_are_free():
    """Over mesh axes of size 1 a shard is the tensor itself: no copy and
    no collective (no process group is needed)."""
    x = torch.randn(4, 6, requires_grad=True)
    sh = tsh.NamedSharding(tsh.Mesh((1, 1), ("data", "model")),
                           tsh.Spec("data", "model"))
    assert tsh.shard(x, sh) is x and tsh.gather(x, sh) is x
    split = tsh.NamedSharding(tsh.Mesh((2,), ("data",)), tsh.Spec("data"))
    s = tsh.shard(x, split)
    assert s.requires_grad and s.is_contiguous() and s.shape == (2, 6)
    with pytest.raises(RuntimeError, match="process group"):
        tsh.gather(s, split)


def _step_inputs(cfg, seed=0):
    params = lm.init(cfg, torch.Generator().manual_seed(seed), "cpu").tree()
    g = torch.Generator().manual_seed(seed + 1)
    grads = {p: torch.randn(t.shape, generator=g).to(t.dtype)
             for p, t in zip(*flatten_with_paths(params))}
    from repro_torch.optim.base import unflatten
    return params, unflatten(list(grads), list(grads.values()))


@pytest.mark.parametrize("codec", ["f32", "int8"])
def test_placed_engine_at_one_rank_is_the_unplaced_one(codec):
    """``gwt(state_shardings=...)`` on a ``data=1`` mesh: placing its state
    returns each tensor itself (nothing is copied), and two updates are
    bitwise the unplaced optimizer's."""
    cfg = tcfg.get_smoke("llama-60m")
    mesh = tsh.Mesh((1,), ("data",))
    sh = tsh.train_step_shardings(
        cfg, lm, {"tokens": torch.empty((4, 16), device="meta")}, mesh,
        state_codec=codec)
    outs = []
    for hints in (None, sh.opt["buckets"]):
        opt = optim.make("gwt", lr=0.01, level=2, state_codec=codec,
                         state_shardings=hints)
        params, grads = _step_inputs(cfg)
        st = opt.init(params)
        flat = tsh.flat_shardings(sh.opt)
        for path, t in zip(*flatten_with_paths(st)):
            assert tsh.shard(t, flat[path]) is t, path
        for _ in range(2):
            params, st = opt.update(grads, st, params)
        outs.append({"params": params, "opt": st})
    for a, b in zip(flatten_with_paths(outs[0])[1],
                    flatten_with_paths(outs[1])[1]):
        assert torch.equal(a, b)


def test_state_hint_of_another_configuration_raises():
    cfg = tcfg.get_smoke("llama-60m")
    mesh = tsh.Mesh((1,), ("data",))
    sh = tsh.train_step_shardings(
        cfg, lm, {"tokens": torch.empty((4, 16), device="meta")}, mesh,
        state_codec="int8")
    opt = optim.make("gwt", lr=0.01, level=2, state_codec="f32",
                     state_shardings=sh.opt["buckets"])
    with pytest.raises(ValueError, match="SAME"):
        opt.init(lm.abstract_params(cfg))
    with pytest.raises(ValueError, match="dp_reduce"):
        lm.make_train_step(cfg, opt, shardings=sh)


@pytest.mark.parametrize("argv,msg", [
    (["--mesh", "4y2"], "expected integers joined by 'x'"),
    (["--mesh", "2x2x2x2"], "1-3 axes supported"),
    (["--mesh", "2"], "WORLD_SIZE is 1"),
    (["--mesh", "1x1", "--dp-reduce", "exact"], "needs a pure-DP mesh"),
    (["--mesh", "1x1x1", "--dp-reduce", "compressed"],
     "needs a pure-DP mesh"),
])
def test_launcher_mesh_refusals(argv, msg, capsys, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit):
        train.main(["--smoke", "--steps", "1", "--device", "cpu"] + argv)
    assert msg in capsys.readouterr().err


def test_launcher_auto_is_the_default_and_none_equal(capsys):
    """One rank: ``--shard-params auto`` is the default, logs its per-rank
    bytes (the whole state's at ``data=1``), and its run equals
    ``none``'s bitwise; the memory line logs the whole state either way."""
    base = ["--smoke", "--steps", "3", "--batch", "4", "--seq", "16",
            "--log-every", "1", "--device", "cpu", "--dp-reduce", "exact"]
    auto = train.main(base)
    out = capsys.readouterr().out
    none = train.main(base + ["--shard-params", "none"])
    out_none = capsys.readouterr().out
    assert "shard_params=auto mesh={'data': 1}" in out
    assert "shard_params" not in out_none
    mem = [ln for ln in out.splitlines() if "opt_state=" in ln]
    assert mem == [ln for ln in out_none.splitlines() if "opt_state=" in ln]
    assert auto.losses == none.losses
    for a, b in zip(flatten_with_paths({"p": auto.params,
                                        "o": auto.opt_state})[1],
                    flatten_with_paths({"p": none.params,
                                        "o": none.opt_state})[1]):
        assert torch.equal(a, b)
    shapes = [tuple(t.shape) for t in flatten_with_paths(auto.local)[1]]
    assert shapes == [tuple(t.shape) for t in flatten_with_paths(
        {"params": none.params, "opt": none.opt_state})[1]]
    assert math.isfinite(auto.losses[-1]) and np.isfinite(auto.losses).all()
