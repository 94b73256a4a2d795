"""LoRA fine-tuning of the port (``repro_torch.models.lora``) against the
JAX package's ``repro.models.lora``: the twins of ``tests/test_lora.py``,
then the adapters' draws, the merge, GWT-2 steps with f32 and int8 moments,
the state bytes, checkpoints both ways and serving a fine-tune.

Tolerances.  The adapters' ``a`` is a ``jax.random.normal`` draw divided by
``sqrt(m)``: ``core.prng``'s normals are within 4 f32 spacings of jax's,
so the adapters are too (1 measured).  The merge's delta ``a @ b`` is a
rank-r matmul whose f32 sum XLA orders by shape (Eigen: one FMA chain at
(32, 8, 64), two accumulators at (64, 4, 32), four at (8, 8, 8)), so the
merge is bitwise where the products sum exactly in any order (dyadic
adapters), and within 4 f32 spacings of the merged leaf otherwise.  Two
GWT-2 steps of the adapters through the model (the JAX package on its
staged path, the port on its fused write, both from the same base and
adapters) are held looser than ``tests/test_torch_gwt.py`` holds GWT:
the adapters' Haar approximation coefficients can nearly cancel, which
the detail scaling amplifies (the tests below state the bounds and what
was measured); int8 moments are stochastically rounded, so a moment one
spacing apart may take the next code: codes within 1.  A bf16 model's
adapters (bf16 gradient, f32 parameters) are held against the JAX
package's kernels in interpret mode, whose rounding of G̃ to bf16 the
port's kernels repeat: within one bf16 spacing of the move.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import flat_numpy, port_model, spacings

from repro import configs as jconfigs, optim as joptim
from repro.checkpoint.manager import CheckpointManager as JaxCheckpoints
from repro.core.gwt import gwt as jax_gwt
from repro.models import lm as jlm, lora as jlora
from repro.optim.engine import state_bytes as jax_state_bytes
from repro_torch import configs, interop, optim
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import prng
from repro_torch.core.gwt import gwt
from repro_torch.launch import train
from repro_torch.launch.serve import generate
from repro_torch.models import lm, lora
from repro_torch.optim import engine
from repro_torch.optim.base import Optimizer, flatten_with_paths, unflatten
from repro_torch.serve.engine import Engine, EngineConfig, Request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK, ALPHA = 4, 8.0


def _cfgs(dtype="float32"):
    kw = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
              d_ff=64, vocab=64, dtype=dtype)
    return (jconfigs.LLAMA["llama-60m"].with_(**kw),
            configs.LLAMA["llama-60m"].with_(**kw))


def _batch(seed=0, B=2, S=16, vocab=64):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, (B, S)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _flat(tree):
    return dict(zip(*flatten_with_paths(tree)))


def _pair(rank=RANK, dtype="float32", key=7):
    """The JAX package's and the port's LoRA trees on the same base, each
    injected by its own package from the same key."""
    jcfg, tcfg = _cfgs(dtype)
    jp, model = port_model(jcfg, tcfg, seed=0)
    return (jcfg, tcfg, jlora.inject(jp, rank, jax.random.key(key)),
            lora.inject(model.tree(), rank, prng.key(key)))


def _port_tree(tcfg, jtree, rank):
    """The port holding the JAX tree's values (base and adapters)."""
    return interop.params_from_numpy(tcfg, flat_numpy(jtree), "cpu",
                                     lora_rank=rank).tree()


# ---------------------------------------------------------------------------
# Twins of tests/test_lora.py
# ---------------------------------------------------------------------------

def test_inject_merge_identity_at_init():
    _, tcfg = _cfgs()
    params = lm.init(tcfg, torch.Generator().manual_seed(0), "cpu").tree()
    tree = lora.inject(params, RANK, prng.key(7))
    merged = lora.merge(tree, ALPHA, RANK)
    for path, leaf in _flat(params).items():
        assert torch.equal(_flat(merged)[path], leaf), path
    apaths = list(_flat(tree["lora"]))
    assert apaths
    assert all(p.rsplit("/", 2)[-2] in lora.LORA_TARGETS
               and p.rsplit("/", 1)[-1] in ("a", "b") for p in apaths)


def test_inject_deterministic_in_key():
    _, tcfg = _cfgs()
    params = lm.init(tcfg, torch.Generator().manual_seed(0), "cpu").tree()
    t1 = _flat(lora.inject(params, RANK, prng.key(7)))
    t2 = _flat(lora.inject(params, RANK, prng.key(7)))
    t3 = _flat(lora.inject(params, RANK, prng.key(8)))
    assert all(torch.equal(t1[p], t2[p]) for p in t1)
    assert not torch.equal(t1["lora/layers/b0/mixer/wq/a"],
                           t3["lora/layers/b0/mixer/wq/a"])


def test_training_moves_adapters_only_and_state_is_adapter_sized():
    """Two real-gradient steps: base bitwise frozen (and given no
    gradient), adapters move, and ``state_bytes`` counts exactly the
    adapters' Adam moments plus the step counter."""
    _, tcfg = _cfgs()
    params = lm.init(tcfg, torch.Generator().manual_seed(0), "cpu").tree()
    before = {p: t.clone() for p, t in _flat(params).items()}
    tree = lora.inject(params, RANK, prng.key(7))
    adapters0 = {p: t.clone() for p, t in _flat(tree["lora"]).items()}
    opt = lora.wrap_optimizer(optim.make("adam", lr=0.01))
    st = opt.init(tree)
    n_adapter = sum(t.numel() for t in _flat(tree["lora"]).values())
    assert engine.state_bytes(st) == 2 * n_adapter * 4 + 4
    step = lora.make_train_step(lm, tcfg, opt, rank=RANK, alpha=ALPHA)
    for i in range(2):
        tree, st, m = step(tree, st, _tb(_batch(seed=i)))
    for p, t in _flat(tree["base"]).items():
        assert torch.equal(t, before[p]), p
        assert not t.requires_grad and t.grad is None
    assert any(not torch.equal(t, adapters0[p])
               for p, t in _flat(tree["lora"]).items())
    assert float(m["loss"]) > 0.0


def test_lora_composes_with_gwt_and_int8():
    _, tcfg = _cfgs()
    params = lm.init(tcfg, torch.Generator().manual_seed(0), "cpu").tree()
    tree = lora.inject(params, 8, prng.key(7))
    adam_bytes = engine.state_bytes(lora.wrap_optimizer(
        optim.make("adam", lr=0.01)).init(tree))
    opt = lora.wrap_optimizer(optim.make("gwt", lr=0.01, level=2,
                                         state_codec="int8"))
    st = opt.init(tree)
    assert engine.state_bytes(st) < adam_bytes
    step = lora.make_train_step(lm, tcfg, opt, rank=8, alpha=ALPHA)
    _, _, m = step(tree, st, _tb(_batch()))
    assert np.isfinite(float(m["loss"]))


def test_wrap_optimizer_requires_engine():
    with pytest.raises(ValueError, match="engine"):
        lora.wrap_optimizer(Optimizer(lambda p: {}, lambda g, s, p: (p, s)))


def _launch(args, timeout=300):
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--device", "cpu", *args], cwd=REPO,
                       env=dict(os.environ,
                                PYTHONPATH=os.path.join(REPO, "src")),
                       capture_output=True, text=True, timeout=timeout)
    return r


def test_launcher_pretrain_then_lora_finetune(tmp_path):
    base_dir, ft_dir = str(tmp_path / "base"), str(tmp_path / "ft")
    common = ["--arch", "llama-60m", "--smoke", "--lr", "0.01", "--batch",
              "2", "--seq", "32", "--log-every", "4"]
    train.main([*common, "--device", "cpu", "--optimizer", "adam",
                "--steps", "4", "--ckpt-dir", base_dir, "--ckpt-every", "4"])
    r = _launch([*common, "--optimizer", "gwt", "--level", "2",
                 "--finetune", "lora", "--lora-rank", "8", "--base-ckpt",
                 base_dir, "--steps", "4", "--ckpt-dir", ft_dir,
                 "--ckpt-every", "4", "--seed", "0", "--eval-every", "2",
                 "--eval-batches", "1"])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "restored pre-trained base" in r.stdout
    assert "finetune=lora rank=8 alpha=16.0" in r.stdout
    cfg = configs.get_smoke("llama-60m")
    base, base_step = CheckpointManager(base_dir).restore_params(
        None, lm.abstract_params(cfg), device="cpu")
    assert base_step == 4
    like = lora.inject(base, 8, prng.fold_in(prng.key(0), 777))
    ft, ft_step = CheckpointManager(ft_dir).restore_params(None, like)
    assert ft_step == 4
    assert CheckpointManager(ft_dir).saved_run()["finetune"] == {
        "mode": "lora", "rank": 8, "alpha": 16.0}
    for p, t in _flat(ft["base"]).items():
        assert torch.equal(t, _flat(base)[p]), p
    assert any(not torch.equal(t, _flat(like["lora"])[p])
               for p, t in _flat(ft["lora"]).items())


def test_launcher_rejects_lora_with_dp_reduce():
    r = _launch(["--arch", "llama-60m", "--smoke", "--finetune", "lora",
                 "--dp-reduce", "exact", "--steps", "1"])
    assert r.returncode != 0
    assert "--finetune lora does not compose with --dp-reduce" in r.stderr


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rank", [4, 8])
def test_inject_draws_match_reference(rank):
    """Same paths in the same order, ``b`` zero, ``a`` within 4 f32
    spacings of the JAX package's draw (the launcher's key included)."""
    *_, jtree, ttree = _pair(rank)
    jf, tf = flat_numpy(jtree), _flat(ttree)
    assert list(tf) == list(jf)
    for p in jf:
        assert tf[p].dtype == torch.float32, p
        assert spacings(tf[p], jf[p]) <= 4, p
    jk = jax.random.fold_in(jax.random.key(0), 777)
    tk = prng.fold_in(prng.key(0), 777)
    assert tuple(int(w) for w in jax.random.key_data(jk)) == tk


def _dyadic_adapters(flat, seed=3):
    """Adapters whose products and sums are exact in f32: multiples of
    2^-4 and 2^-6 with small numerators."""
    rng = np.random.RandomState(seed)
    out = dict(flat)
    for p, v in flat.items():
        if p.startswith("lora/"):
            den = 16.0 if p.endswith("/a") else 64.0
            out[p] = (rng.randint(-8, 9, v.shape) / den).astype(np.float32)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_matches_reference(dtype):
    """Bitwise where the delta sums exactly in any order; with the JAX
    package's trained adapters within 4 f32 spacings (f32 base) or 1 bf16
    spacing (bf16 base) of the JAX merge."""
    jcfg, tcfg, jtree, _ = _pair(dtype=dtype)
    flat = _dyadic_adapters(flat_numpy(jtree))
    jt = jax.tree.unflatten(jax.tree.structure(jtree),
                            [jnp.asarray(flat[p]).astype(l.dtype)
                             for p, l in zip(flat, jax.tree.leaves(jtree))])
    tt = interop.params_from_numpy(tcfg, flat, "cpu", lora_rank=RANK).tree()
    jm, tm = flat_numpy(jlora.merge(jt, ALPHA, RANK)), \
        _flat(lora.merge(tt, ALPHA, RANK))
    for p in jm:
        assert tm[p].dtype == getattr(torch, dtype), p
        assert spacings(tm[p], jm[p]) == 0, p
    # trained adapters: three JAX steps move b off zero
    jopt = jlora.wrap_optimizer(joptim.make("adam", lr=0.05))
    step = jax.jit(jlora.make_train_step(jlm, jcfg, jopt, rank=RANK,
                                         alpha=ALPHA))
    st = jopt.init(jtree)
    for i in range(3):
        jtree, st, _ = step(jtree, st, _jb(_batch(seed=i)))
    tt = _port_tree(tcfg, jtree, RANK)
    jm, tm = flat_numpy(jlora.merge(jtree, ALPHA, RANK)), \
        _flat(lora.merge(tt, ALPHA, RANK))
    for p in jm:
        assert spacings(tm[p], jm[p]) <= (4 if dtype == "float32"
                                           else 2.0 ** 16), p


def _steps(codec, steps=2, same_grads=True, dtype="float32", impl="jnp"):
    """``steps`` GWT-2 fine-tune steps in both packages from the same base
    and adapters of a ``dtype`` model, the JAX package's GWT on ``impl``.
    ``same_grads``: each step's adapter gradient is the JAX package's on
    its own trajectory, cast to the model dtype as its train step casts
    it, fed to both optimizers; else each package runs its own train step.
    Returns both trees, both states, the optimizers and the losses (JAX's,
    the port's)."""
    jcfg, tcfg, jtree, _ = _pair(rank=8, dtype=dtype)
    ttree = _port_tree(tcfg, jtree, 8)
    jopt = jlora.wrap_optimizer(jax_gwt(lr=0.01, impl=impl,
                                        state_codec=codec))
    topt = lora.wrap_optimizer(gwt(lr=0.01, state_codec=codec))
    jstep = jax.jit(jlora.make_train_step(jlm, jcfg, jopt, rank=8,
                                          alpha=ALPHA))
    tstep = lora.make_train_step(lm, tcfg, topt, rank=8, alpha=ALPHA)
    grad = jax.jit(jax.value_and_grad(lambda t, b: jlm.loss_fn(
        jcfg, jlora.merge(t, ALPHA, 8), b)))
    js, ts = jopt.init(jtree), topt.init(ttree)
    losses = ([], [])
    for i in range(steps):
        b = _batch(seed=10 + i)
        if same_grads:
            loss, jg = grad(jtree, _jb(b))
            jg = jax.tree.map(lambda g: g.astype(jcfg.dtype), jg)
            gf = flat_numpy(jg)
            tg = unflatten(list(gf), [
                None if p.startswith("base/")
                else torch.from_numpy(gf[p]).to(tcfg.torch_dtype)
                for p in gf])
            jtree, js = jopt.update(jg, js, jtree)
            with torch.no_grad():
                ttree, ts = topt.update(tg, ts, ttree)
            losses[0].append(float(loss))
            continue
        jtree, js, jm = jstep(jtree, js, _jb(b))
        ttree, ts, tm = tstep(ttree, ts, _tb(b))
        losses[0].append(float(jm["loss"]))
        losses[1].append(float(tm["loss"]))
    return jtree, js, ttree, ts, jopt, topt, losses


def _check_state(js, ts, moments, codes=1):
    jsf, tsf = flat_numpy(js), interop.state_to_numpy(ts)
    assert sorted(tsf) == sorted(jsf)
    for p in jsf:
        if p.endswith("/q"):
            assert np.abs(tsf[p].astype(np.int32)
                          - jsf[p].astype(np.int32)).max() <= codes, p
        elif p in ("step", "codec_key"):
            np.testing.assert_array_equal(tsf[p], jsf[p])
        else:
            assert spacings(tsf[p], jsf[p]) <= moments, p


@pytest.mark.parametrize("codec", ["f32", "int8"])
def test_gwt_steps_match_reference(codec):
    """Two same-gradient GWT-2 steps.  The adapters' Haar approximation
    coefficients can nearly cancel (A = (g0+g1+g2+g3)/2 at level 2), and
    D~ = D/(sqrt(v_A)+eps) turns a one-spacing difference in such an A into
    a large one in D~: parameters are held to 256 f32 spacings of each
    leaf's largest magnitude (118 measured, on a ``b`` leaf, as much
    against the JAX package's fused Pallas path in interpret mode as
    against its staged path), moments and norms to 16 (12 measured)."""
    jtree, js, ttree, ts, jopt, topt, _ = _steps(codec)
    jf, tf = flat_numpy(jtree), _flat(ttree)
    base0 = flat_numpy(_pair(rank=8)[2]["base"])
    for p in jf:
        if p.startswith("base/"):
            np.testing.assert_array_equal(tf[p].detach().numpy(), jf[p],
                                          err_msg=p)
            np.testing.assert_array_equal(jf[p], base0[p[5:]], err_msg=p)
        else:
            assert spacings(tf[p], jf[p]) <= 256, p
    assert any(not np.array_equal(jf[p], 0) for p in jf
               if p.endswith("/b"))
    _check_state(js, ts, moments=16)
    # the plans agree, frozen buckets included, and only adapters are GWT
    # leaves
    jplan = [(b.name, b.paths) for b in jopt.engine.plan(jtree).buckets]
    tplan = [(b.name, b.paths) for b in topt.engine.plan(ttree).buckets]
    assert tplan == jplan
    assert all(n.startswith("frozen__") for n, ps in tplan
               if ps[0].startswith("base/"))
    assert all(n.startswith("gwt_last__lora.") for n, ps in tplan
               if ps[0].startswith("lora/"))


@pytest.mark.parametrize("codec", ["f32", "int8"])
def test_train_steps_track_reference(codec):
    """Each package's own two fine-tune steps: losses within 1e-5 relative
    (1.3e-6 measured), the base bitwise frozen.  The first step moves only
    ``b`` (``a``'s gradient is zero while ``b`` is); the second is ``a``'s
    first, with the limiter off (no previous norm) and the near-cancelling
    approximation coefficients above, so the two packages' ``a`` part by
    a few percent of its step there, and a third step's loss by 0.17%
    (measured): the same-gradient test above holds the optimizer."""
    jtree, _, ttree, _, _, _, (jl, tl) = _steps(codec, same_grads=False)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    jf, tf = flat_numpy(jtree), _flat(ttree)
    for p in jf:
        if p.startswith("base/"):
            np.testing.assert_array_equal(tf[p].detach().numpy(), jf[p])
        else:
            assert torch.isfinite(tf[p]).all(), p


# the JAX package's engine.state_bytes of the launcher's LoRA (rank 8) at
# full width: GWT-2 with f32 and int8 moments, and plain Adam
FULL_WIDTH_LORA_BYTES = {
    ("llama-60m", "gwt", "f32"): 1_249_340,
    ("llama-60m", "gwt", "int8"): 331_904,
    ("llama-60m", "adam", "f32"): 4_997_124,
    ("qwen2.5-3b", "gwt", "f32"): 29_933_628,
    ("qwen2.5-3b", "gwt", "int8"): 7_951_168,
}


@pytest.mark.parametrize("key", list(FULL_WIDTH_LORA_BYTES),
                         ids=["-".join(k) for k in FULL_WIDTH_LORA_BYTES])
def test_full_width_state_bytes_match_reference(key):
    """On the ``meta`` device: the adapter plan and the exact state bytes
    (``chip_smoke.LORA_STATE_BYTES``) equal the JAX package's."""
    arch, name, codec = key
    jcfg, tcfg = jconfigs.get_config(arch), configs.get_config(arch)
    jabs = jax.eval_shape(lambda: jlora.inject(
        jlm.abstract_params(jcfg), 8, jax.random.key(0)))
    tabs = lora.inject(lm.abstract_params(tcfg), 8, (0, 0))
    kw = {"state_codec": codec} if name == "gwt" else {}
    jopt = jlora.wrap_optimizer(joptim.make(name, lr=0.01, **kw))
    topt = lora.wrap_optimizer(optim.make(name, lr=0.01, **kw))
    assert [(b.name, b.paths) for b in topt.engine.plan(tabs).buckets] == \
        [(b.name, b.paths) for b in jopt.engine.plan(jabs).buckets]
    got = engine.state_bytes(topt.init(tabs))
    assert got == jax_state_bytes(jopt, jabs) == FULL_WIDTH_LORA_BYTES[key]


def test_small_state_bytes_match_reference():
    for name, kw in (("adam", {}), ("gwt", {}),
                     ("gwt", {"state_codec": "int8"})):
        jcfg, tcfg, jtree, ttree = _pair(rank=8)
        jopt = jlora.wrap_optimizer(joptim.make(name, lr=0.01, **kw))
        topt = lora.wrap_optimizer(optim.make(name, lr=0.01, **kw))
        assert engine.state_bytes(topt.init(ttree)) == \
            jax_state_bytes(jopt, jtree)


def _jax_finetune(tmp_path, meta=True):
    """A JAX pre-train (2 Adam steps) and LoRA fine-tune (3 GWT-2 steps)
    saved by the JAX package's checkpoint manager; returns the tree."""
    jcfg, tcfg = _cfgs()
    params = jlm.init(jcfg, jax.random.key(8))
    opt = joptim.make("adam", lr=1e-2)
    step = jax.jit(jlm.make_train_step(jcfg, opt))
    st = opt.init(params)
    for i in range(2):
        params, st, _ = step(params, st, _jb(_batch(seed=i)))
    tree = jlora.inject(params, RANK, jax.random.key(3))
    fopt = jlora.wrap_optimizer(joptim.make("gwt", lr=1e-2, level=2))
    fst = fopt.init(tree)
    fstep = jax.jit(jlora.make_train_step(jlm, jcfg, fopt, rank=RANK,
                                          alpha=ALPHA))
    for i in range(3):
        tree, fst, _ = fstep(tree, fst, _jb(_batch(seed=10 + i)))
    run = {"finetune": {"mode": "lora", "rank": RANK, "alpha": ALPHA}} \
        if meta else None
    JaxCheckpoints(str(tmp_path), run_meta=run).save(
        3, {"opt": fst, "params": tree}, blocking=True)
    return tcfg, tree


@pytest.mark.parametrize("meta", [True, False],
                         ids=["from-metadata", "merge_lora=True"])
def test_jax_lora_checkpoint_is_served_by_the_port(tmp_path, meta):
    """The twin of tests/test_serving.py::
    test_pretrain_finetune_serve_roundtrip: a JAX-written fine-tune's
    checkpoint, merged at load by the port's engine (detected from the run
    metadata, or asked for), serves the tokens of the port's dense
    generate on ``lora.merge`` of the same adapters."""
    tcfg, jtree = _jax_finetune(tmp_path, meta)
    tree = _port_tree(tcfg, jtree, RANK)
    merged = lora.merge(tree, ALPHA, RANK)
    assert any(not torch.equal(t, _flat(tree["base"])[p])
               for p, t in _flat(merged).items())
    kw = {} if meta else {"merge_lora": True, "lora_rank": RANK,
                          "lora_alpha": ALPHA}
    eng = Engine.from_checkpoint(
        tcfg, str(tmp_path), EngineConfig(num_slots=2, page_size=4,
                                          max_ctx=24, prefill_chunk=8),
        device="cpu", **kw)
    for p, t in _flat(merged).items():
        assert torch.equal(_flat(eng.params)[p], t), p
    prompt = _batch(seed=20)["tokens"][0, :12].tolist()
    req = Request(rid=0, prompt=prompt, max_gen=5)
    eng.run([req])
    assert req.generated == generate(tcfg, merged, torch.tensor([prompt]),
                                     5)[0].tolist()


def test_port_lora_checkpoint_restores_in_jax(tmp_path):
    """The port's fine-tune checkpoint (``{"opt", "params"}``, params a
    ``{"base", "lora"}`` tree) restores in the JAX package bitwise."""
    jcfg, tcfg, jtree, ttree = _pair(rank=8)
    opt = lora.wrap_optimizer(gwt(lr=0.01))
    step = lora.make_train_step(lm, tcfg, opt, rank=8, alpha=ALPHA)
    ttree, st, _ = step(ttree, opt.init(ttree), _tb(_batch()))
    CheckpointManager(str(tmp_path), run_meta={"finetune": {
        "mode": "lora", "rank": 8, "alpha": ALPHA}}).save(
        1, {"opt": st, "params": ttree}, blocking=True)
    got, s = JaxCheckpoints(str(tmp_path)).restore_params(None, jtree)
    assert s == 1
    want = interop.state_to_numpy(ttree)
    for p, a in flat_numpy(got).items():
        np.testing.assert_array_equal(a, want[p], err_msg=p)


def _bf16_spacing(x: float) -> float:
    """One bf16 unit in the last place at magnitude ``x``."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("codec", ["f32", "int8"])
def test_bf16_model_gwt_steps_match_reference_kernel(codec, monkeypatch):
    """A bf16 model's f32 adapters.  The train step casts their gradients
    to bf16, as the JAX package's does, and the fused write (K1; K2 under
    int8) takes that bf16 ``g`` with the f32 ``p``: G~ and the limited step
    are rounded to bf16, p is written in f32, as the JAX package's Pallas
    kernels round them (``_body_fused``: ``gt = out.astype(g.dtype)``).
    Two same-gradient GWT-2 steps against the JAX package on those kernels
    in interpret mode (its ``jnp`` path runs a staged DWT of the bf16
    gradient in bf16, which is not the kernels' arithmetic).  The base
    stays bitwise frozen.  Each adapter's move is held to one bf16 spacing
    of its largest move, since a G~ one f32 spacing apart may round to the
    next bf16 (0.25 measured under int8, 1.5e-5 with f32 moments); with
    f32 moments the parameters to 4 f32 spacings (1 measured); moments and
    norms to 16 f32 spacings (4 measured); int8 codes within 1 (0
    measured)."""
    from repro_torch.kernels.gwt_adam import ref
    name = "gwt_adam_fused" if codec == "f32" else "gwt_adam_fused_q8"
    seen, fused = [], getattr(ref, name)

    def spy(g, p, *args, **kw):
        seen.append((g.dtype, p.dtype))
        return fused(g, p, *args, **kw)

    monkeypatch.setattr(ref, name, spy)
    jtree, js, ttree, ts, _, _, _ = _steps(codec, dtype="bfloat16",
                                          impl="interpret")
    assert seen and set(seen) == {(torch.bfloat16, torch.float32)}
    jf, tf = flat_numpy(jtree), _flat(ttree)
    start = flat_numpy(_pair(rank=8, dtype="bfloat16")[2])
    for p in jf:
        got = tf[p].detach()
        if p.startswith("base/"):
            assert got.dtype == torch.bfloat16, p
            np.testing.assert_array_equal(got.float().numpy(), jf[p],
                                          err_msg=p)
            np.testing.assert_array_equal(jf[p], start[p], err_msg=p)
            continue
        assert got.dtype == torch.float32, p
        move = float(np.abs(jf[p] - start[p]).max())
        assert move > 0, p
        gap = float(np.abs(got.numpy().astype(np.float64) - jf[p]).max())
        assert gap <= _bf16_spacing(move), p
        if codec == "f32":
            assert spacings(got, jf[p]) <= 4, p
    _check_state(js, ts, moments=16)


def test_jax_lora_state_carries_over():
    """The JAX package's LoRA state after a step, through
    ``interop.state_from_numpy``: the values bitwise (the frozen buckets'
    empty states have no arrays), and the port's next step from it moves
    every adapter and no base leaf."""
    jcfg, tcfg, jtree, _ = _pair(rank=8)
    jopt = jlora.wrap_optimizer(jax_gwt(lr=0.01, impl="jnp"))
    topt = lora.wrap_optimizer(gwt(lr=0.01))
    grad = jax.jit(jax.grad(lambda t, b: jlm.loss_fn(
        jcfg, jlora.merge(t, ALPHA, 8), b)))
    js = jopt.init(jtree)
    jg = grad(jtree, _jb(_batch(seed=40)))
    jtree, js = jopt.update(jg, js, jtree)
    ttree = _port_tree(tcfg, jtree, 8)
    ts = interop.state_from_numpy(flat_numpy(js), "cpu")
    back, want = interop.state_to_numpy(ts), flat_numpy(js)
    assert sorted(back) == sorted(want)
    for p in want:
        np.testing.assert_array_equal(back[p], want[p], err_msg=p)
    before = {p: t.clone() for p, t in _flat(ttree).items()}
    gf = flat_numpy(grad(jtree, _jb(_batch(seed=41))))
    tg = unflatten(list(gf), [None if p.startswith("base/") else
                              torch.from_numpy(gf[p]) for p in gf])
    with torch.no_grad():
        ttree, ts = topt.update(tg, ts, ttree)
    assert int(ts["step"]) == 2
    for p, t in _flat(ttree).items():
        assert torch.isfinite(t).all(), p
        assert torch.equal(t, before[p]) == p.startswith("base/"), p
