"""The attention family of the port (qwen2.5-3b, gemma2-9b, gemma3-27b,
deepseek-67b; qwen2-vl-72b with M-RoPE; the MoE qwen2-moe-a2.7b and
qwen3-moe-30b-a3b) against the JAX package: logits, loss and every
gradient from JAX-initialised parameters carried over by
``repro_torch.interop``, the parameter paths, the GWT bucket plan and the
optimizer-state bytes, the remainder layers, ``remat``, a few GWT-2 steps
through the ``TrainLoop``, a checkpoint resume, the launcher, and the
memory the step and the launcher release where the JAX package donates.

Tolerances.  f32, as ``test_torch_lm.py``: matmul sums run in another
order in ATen than in XLA, so logits are held to 8 f32 spacings of their
largest magnitude, the loss to 4 and each gradient to 32 (measured: at
most 4, 1 and 17).  bf16: every matmul output is rounded to bf16, and a
sum that lands near a rounding boundary moves one bf16 spacing, which the
next layers carry: logits 4 bf16 spacings (1.5 measured), the f32 loss of
bf16 logits 8192 f32 spacings (3848 measured), gradients 16 bf16 spacings
(4 measured).  The bf16 MoE models take the JAX package's top-k choices
(:class:`_PinnedRouting`) and are held to the same bounds.  Over 6 GWT-2 steps (JAX on its staged path, the port on
its fused write, f32) the losses stay within 2e-5 of each other, as in
``test_torch_lm.py``.
"""

import gc
import os
import subprocess
import sys
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (bf16_spacings, flat_numpy, jit_light, port_model,
                          spacings)

from repro import configs as jconfigs
from repro.core.gwt import gwt as jax_gwt
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import lm as jlm
from repro.optim import engine as jengine
from repro.optim.base import flatten_with_paths as jax_flatten
from repro.optim.schedules import warmup_cosine as jax_warmup_cosine
from repro.runtime.fault_tolerance import TrainLoop as JaxTrainLoop
from repro_torch import configs, interop
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.gwt import gwt
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train
from repro_torch.models import lm
from repro_torch.optim import engine
from repro_torch.optim.base import flatten_with_paths
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.runtime.fault_tolerance import TrainLoop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["qwen2.5-3b", "gemma2-9b", "gemma3-27b", "deepseek-67b",
         "qwen2-vl-72b", "qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"]
MOE = ("qwen2-moe-a2.7b", "qwen3-moe-30b-a3b")
VOCAB = 512
# longer than the smoke window of 32 and a multiple of it: the local
# layers take the block-local route
SEQ = 64

# the JAX package's engine.state_bytes of GWT-2 (f32 moments) at full
# width; deepseek-67b, gemma2-9b and gemma3-27b cut to 2 layers
FULL_WIDTH_STATE_BYTES = {
    ("qwen2.5-3b", None): 8_039_764_012,
    ("deepseek-67b", 2): 16_190_341_152,
    ("gemma2-9b", 2): 8_132_898_876,
    ("gemma3-27b", 2): 12_926_015_548,
    ("qwen2-vl-72b", 1): 21_686_865_964,
    ("qwen2-moe-a2.7b", 2): 4_911_505_464,
    ("qwen3-moe-30b-a3b", 2): 7_474_335_776,
}
# the same with blocked-int8 moments (--state-codec int8)
FULL_WIDTH_INT8_STATE_BYTES = {
    ("qwen2-vl-72b", 1): 5_760_573_808,
    ("qwen2-moe-a2.7b", 2): 1_304_618_684,
    ("qwen3-moe-30b-a3b", 2): 1_985_370_468,
}


def _cfgs(arch, **kw):
    return (jconfigs.get_smoke(arch).with_(**kw),
            configs.get_smoke(arch).with_(**kw))


def _batch(seed=1, B=2, S=SEQ):
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, VOCAB, (B, S)).astype(np.int32),
            "labels": rng.randint(0, VOCAB, (B, S)).astype(np.int32)}


def _loss_and_grads(tcfg, model, batch):
    tree = model.tree()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = lm.loss_fn(tcfg, tree, tb)
    paths, leaves = flatten_with_paths(tree)
    return loss.detach(), dict(zip(paths, torch.autograd.grad(loss,
                                                              leaves)))


class _PinnedRouting:
    """The JAX package's top-k choices, recorded in its forward, imposed on
    the port's (``moe.top_k`` returns them, with the port's own
    probabilities at them; the renormalization, the slots and the drops
    stay the port's).  A bf16 layer input rounds differently in the two
    packages, so their f32 router probabilities differ by a few thousand
    f32 spacings and a near-tied choice can flip: the smoke batch flips 1
    token of qwen2-moe-a2.7b and 3 of qwen3-moe-30b-a3b (margins -1.8e-4
    and down to -7.9e-6 against differences of 3e-3 and more).  ``flips``
    holds each flipped token's choices and its margin."""

    def __init__(self, monkeypatch, tmoe):
        self.jax, self.flips, self.calls = [], [], 0
        top_k, self.own = jax.lax.top_k, tmoe.top_k

        def record(x, k):
            vals, idx = top_k(x, k)
            jax.debug.callback(
                lambda i, pr: self.jax.append((np.asarray(i),
                                               np.asarray(pr))), idx, x)
            return vals, idx

        monkeypatch.setattr(jax.lax, "top_k", record)
        monkeypatch.setattr(tmoe, "top_k", self._pinned)

    def _pinned(self, probs, k):
        self.calls += 1
        own = self.own(probs, k)[1].numpy()
        p = probs.detach().numpy()
        # the JAX layer of these probabilities (the layers' differ wholly)
        jidx, jprobs = min(self.jax, key=lambda r: np.abs(r[1] - p).max())
        delta = float(np.abs(jprobs - p).max())
        for t in np.nonzero((np.sort(own, -1) != np.sort(jidx, -1))
                            .any(-1))[0]:
            rest = np.delete(p[t], jidx[t])
            # a near tie: the JAX choice is a top-k of the port's
            # probabilities within twice their largest difference
            margin = float(p[t][jidx[t]].min() - rest.max())
            assert margin >= -2 * delta, (t, own[t], jidx[t], margin, delta)
            self.flips.append((int(t), own[t].tolist(), jidx[t].tolist(),
                               margin))
        idx = torch.from_numpy(jidx.astype(np.int64)).to(probs.device)
        return torch.gather(probs, -1, idx), idx


def _check_against_reference(jcfg, tcfg, f32: bool, pin=None,
                             grad_spacings: int = 32,
                             bf16_grad_spacings=16, jit=False):
    """``bf16_grad_spacings`` is one bound for every gradient, or a
    function of the leaf's path that gives its bound.  ``jit`` compiles
    the JAX forward and gradient whole (quicker for the larger smoke
    stacks; XLA then fuses as in the JAX package's own jitted step)."""
    jp, model = port_model(jcfg, tcfg, seed=0)
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tokens = torch.from_numpy(b["tokens"])
    assert list(dict(zip(*flatten_with_paths(model.tree())))) == \
        list(flat_numpy(jp))
    fwd = lambda p, t: jlm.forward(jcfg, p, t)[0]  # noqa: E731
    grad = jax.value_and_grad(lambda p, b: jlm.loss_fn(jcfg, p, b))
    if jit:
        fwd, grad = jit_light(fwd, jp, jb["tokens"]), jit_light(grad, jp, jb)
    jlogits = fwd(jp, jb["tokens"])
    jloss, jgrads = grad(jp, jb)
    with torch.no_grad():
        logits = model(tokens)
    loss, grads = _loss_and_grads(tcfg, model, b)
    jg = flat_numpy(jgrads)
    if pin is not None:
        # every MoE layer of both forwards and of the loss's routed once
        assert pin.calls == 2 * tcfg.n_layers
    if f32:
        assert spacings(logits, jlogits) <= 8
        assert spacings(loss, jloss) <= 4
        for path, g in grads.items():
            assert spacings(g, jg[path]) <= grad_spacings, path
    else:
        assert logits.dtype == torch.bfloat16
        assert bf16_spacings(logits, jlogits) <= 4
        assert spacings(loss, jloss) <= 8192
        bound = bf16_grad_spacings if callable(bf16_grad_spacings) \
            else lambda path: bf16_grad_spacings
        for path, g in grads.items():
            assert bf16_spacings(g, jg[path]) <= bound(path), path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_matches_reference(arch, dtype, monkeypatch):
    """Logits, loss and gradients.  A bf16 MoE model takes the JAX
    package's top-k choices (:class:`_PinnedRouting`; each flip checked to
    be a near tie), so that it is held to the dense bounds; the routing
    itself is held exact on one input in ``tests/test_torch_moe.py``."""
    pin = None
    if arch in MOE and dtype == "bfloat16":
        from repro_torch.models import moe as tmoe
        pin = _PinnedRouting(monkeypatch, tmoe)
    _check_against_reference(*_cfgs(arch, dtype=dtype),
                             f32=dtype == "float32", pin=pin)


@pytest.mark.parametrize("n_layers", [8, 2], ids=["period+rem", "rem-only"])
def test_remainder_layers_match_reference(n_layers):
    """gemma3's period is 6: 8 layers are one stacked period and two
    ``rem`` blocks, 2 layers are ``rem`` blocks only (no ``layers`` key)."""
    jcfg, tcfg = _cfgs("gemma3-27b", n_layers=n_layers, dtype="float32")
    tree = lm.abstract_params(tcfg)
    assert sorted(tree["rem"]) == ["b0", "b1"]
    assert ("layers" in tree) == (n_layers == 8)
    _check_against_reference(jcfg, tcfg, f32=True)


def test_untied_head():
    tcfg = configs.get_smoke("deepseek-67b")
    emb = lm.abstract_params(tcfg)["embed"]
    assert tuple(emb["lm_head"].shape) == (tcfg.d_model, tcfg.vocab)
    assert "lm_head" not in lm.abstract_params(
        configs.get_smoke("qwen2.5-3b"))["embed"]


def test_remat_is_bitwise():
    """Recomputing each block in the backward changes no value."""
    _, tcfg = _cfgs("gemma3-27b", n_layers=8, dtype="float32")
    model = lm.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    b = _batch()
    loss0, g0 = _loss_and_grads(tcfg, model, b)
    loss1, g1 = _loss_and_grads(tcfg.with_(remat=True), model, b)
    assert torch.equal(loss0, loss1)
    for path in g0:
        assert torch.equal(g0[path], g1[path]), path


@pytest.mark.parametrize("arch", ARCHS)
def test_bucket_plan_and_state_bytes_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jopt, topt = jax_gwt(lr=0.01, impl="jnp"), gwt(lr=0.01)
    jp, model = port_model(jcfg, tcfg)
    want = [(b.name, b.paths) for b in jopt.engine.plan(jp).buckets]
    got = [(b.name, b.paths) for b in topt.engine.plan(model.tree()).buckets]
    assert got == want
    assert engine.state_bytes(topt.init(model.tree())) == \
        jengine.state_bytes(jopt, jp)


@pytest.mark.parametrize("arch,n_layers", list(FULL_WIDTH_STATE_BYTES),
                         ids=[a for a, _ in FULL_WIDTH_STATE_BYTES])
def test_full_width_plan_and_state_bytes(arch, n_layers):
    """Full width on the ``meta`` device; the bias leaves ``bq``/``bk``
    stacked to ``(36, dim)`` are GWT leaves in the reference, and in the
    port."""
    jcfg, tcfg = jconfigs.get_config(arch), configs.get_config(arch)
    if n_layers:
        jcfg, tcfg = jcfg.with_(n_layers=n_layers), \
            tcfg.with_(n_layers=n_layers)
    jopt, topt = jax_gwt(lr=0.01, impl="jnp"), gwt(lr=0.01)
    jabs, tabs = jlm.abstract_params(jcfg), lm.abstract_params(tcfg)
    want = [(b.name, b.paths) for b in jopt.engine.plan(jabs).buckets]
    got = [(b.name, b.paths) for b in topt.engine.plan(tabs).buckets]
    assert got == want
    nbytes = engine.state_bytes(topt.init(tabs))
    assert nbytes == jengine.state_bytes(jopt, jabs) == \
        FULL_WIDTH_STATE_BYTES[(arch, n_layers)]
    if arch == "qwen2.5-3b":
        assert "gwt_last__layers.b0.mixer.bq" in [b for b, _ in got]


@pytest.mark.parametrize("arch,n_layers", list(FULL_WIDTH_INT8_STATE_BYTES),
                         ids=[a for a, _ in FULL_WIDTH_INT8_STATE_BYTES])
def test_full_width_int8_state_bytes_of_the_cuts(arch, n_layers):
    """The chip check's qwen2-vl-72b (1 layer) and MoE (2 layers) cuts
    with blocked-int8 moments: the port's exact state bytes equal the JAX
    package's."""
    jcfg = jconfigs.get_config(arch).with_(n_layers=n_layers)
    tcfg = configs.get_config(arch).with_(n_layers=n_layers)
    jopt = jax_gwt(lr=0.01, impl="jnp", state_codec="int8")
    topt = gwt(lr=0.01, state_codec="int8")
    nbytes = engine.state_bytes(topt.init(lm.abstract_params(tcfg)))
    assert nbytes == jengine.state_bytes(jopt, jlm.abstract_params(jcfg)) \
        == FULL_WIDTH_INT8_STATE_BYTES[(arch, n_layers)]


def test_full_width_int8_state_bytes():
    """qwen2.5-3b at full width with blocked-int8 moments (the launcher's
    ``--state-codec int8``; ``chip_smoke.QWEN_STATE_BYTES``): the port's
    exact state bytes equal the JAX package's."""
    jcfg, tcfg = jconfigs.get_config("qwen2.5-3b"), \
        configs.get_config("qwen2.5-3b")
    jopt = jax_gwt(lr=0.01, impl="jnp", state_codec="int8")
    topt = gwt(lr=0.01, state_codec="int8")
    nbytes = engine.state_bytes(topt.init(lm.abstract_params(tcfg)))
    assert nbytes == jengine.state_bytes(jopt, jlm.abstract_params(jcfg)) \
        == 2_135_562_352


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma3-27b",
                                  "deepseek-67b"])
def test_interop_round_trip(arch):
    """The new leaves (``bq``, ``q_norm``, ``rem/...``, ``lm_head``) arrive
    from JAX unchanged and go back bit for bit (bf16, as raw bits)."""
    jcfg, tcfg = _cfgs(arch, n_layers=8) if arch == "gemma3-27b" \
        else _cfgs(arch)
    jparams = jlm.init(jcfg, jax.random.key(3))
    jpaths, jleaves, _ = jax_flatten(jparams)
    paths = list(jpaths)
    leaves = [np.asarray(l).view(np.uint16) for l in jleaves]
    model = interop.params_from_numpy(tcfg, dict(zip(paths, leaves)), "cpu")
    back = interop.state_to_numpy(model.tree())
    assert list(back) == paths
    for p, want in zip(paths, leaves):
        np.testing.assert_array_equal(back[p], want, err_msg=p)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma2-9b"])
def test_train_loop_tracks_reference_losses(arch):
    steps = 6
    jcfg, tcfg = _cfgs(arch, dtype="float32")
    jp, model = port_model(jcfg, tcfg, seed=0)
    jopt = jax_gwt(lr=jax_warmup_cosine(0.01, steps), impl="jnp")
    jloop = JaxTrainLoop(jlm.make_train_step(jcfg, jopt, accum_steps=2),
                         None, JaxSyntheticLM(VOCAB, SEQ, 4, 0),
                         log_every=3, log=lambda s: None)
    _, _, jlosses = jloop.run(jp, jopt.init(jp), num_steps=steps)
    topt = gwt(lr=warmup_cosine(0.01, steps))
    tree = model.tree()
    tloop = TrainLoop(lm.make_train_step(tcfg, topt, accum_steps=2),
                      SyntheticLM(VOCAB, SEQ, 4, 0), device="cpu",
                      log_every=3, log=lambda s: None)
    _, _, tlosses = tloop.run(tree, topt.init(tree), num_steps=steps)
    assert len(tlosses) == len(jlosses) == steps
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=2e-5)


def test_remainder_model_resumes_bitwise(tmp_path):
    """gemma3 with a period and two ``rem`` blocks: 2 steps, a checkpoint,
    2 more after a restore equal 4 straight steps bitwise."""
    _, tcfg = _cfgs("gemma3-27b", n_layers=8, dtype="float32")

    def run(start, num, ckpt=None, restore=False):
        model = lm.init(tcfg, torch.Generator().manual_seed(0), "cpu")
        opt = gwt(lr=warmup_cosine(0.01, 4))
        params = model.tree()
        state = opt.init(params)
        if restore:
            saved, start = ckpt.restore(None, {"params": params,
                                               "opt": state}, device="cpu")
            params = lm.LM(tcfg, saved["params"]).tree()
            state = saved["opt"]
        loop = TrainLoop(lm.make_train_step(tcfg, opt),
                         SyntheticLM(VOCAB, 32, 2, 0), device="cpu",
                         ckpt=ckpt, ckpt_every=2, log_every=2,
                         log=lambda s: None)
        return loop.run(params, state, start_step=start, num_steps=num)

    straight_p, straight_s, straight_l = run(0, 4)
    ckpt = CheckpointManager(str(tmp_path))
    run(0, 2, ckpt)
    ckpt.wait()
    p, s, losses = run(0, 4, ckpt, restore=True)
    assert losses == straight_l[2:]
    for tree_a, tree_b in ((p, straight_p), (s, straight_s)):
        fa, fb = (dict(zip(*flatten_with_paths(t))) for t in (tree_a,
                                                              tree_b))
        assert sorted(fa) == sorted(fb)
        for path in fa:
            assert torch.equal(fa[path], fb[path]), path


def test_launcher_trains_a_dense_smoke_config():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2.5-3b", "--smoke", "--device", "cpu", "--steps", "2",
         "--batch", "2", "--seq", "16", "--log-every", "1"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "arch=qwen2.5-3b" in out.stdout


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "qwen2-moe-a2.7b",
                                  "qwen3-moe-30b-a3b"])
def test_launcher_trains_the_moe_and_mrope_smoke_configs(arch):
    res = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "16",
                      "--log-every", "1"])
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-350m",
                                  "seamless-m4t-large-v2"])
def test_launcher_trains_the_recurrent_and_encdec_smoke_configs(arch):
    """Every assigned id trains: the mamba, xLSTM and encoder-decoder
    smoke configs through the launcher, finite losses."""
    assert arch in jconfigs.ARCH_IDS and arch in configs.ARCH_IDS
    res = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "16",
                      "--log-every", "1"])
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))


def _live_at_each_update(monkeypatch, accum):
    """Three deepseek-67b smoke steps through the launcher at ``accum``
    microbatches; at each update, after a collection, the count of live
    tensors among the raw autograd gradients, among the f32 sums
    ``lm._accumulate`` made and among the first optimizer state.  Returns
    ``(counts a step, raw gradients made, sums made, first state's
    size)``."""
    raw, sums, first, updates = [], [], [], []
    accumulate, grad, zeros = lm._accumulate, torch.autograd.grad, \
        torch.zeros

    def spy_grad(*args, **kw):
        out = grad(*args, **kw)
        raw.extend(weakref.ref(g) for g in out)
        return out

    def spy_zeros(*args, **kw):
        t = zeros(*args, **kw)
        caller = sys._getframe(1)
        if caller.f_code.co_name == "<listcomp>":   # before Python 3.12
            caller = caller.f_back
        if caller.f_code is accumulate.__code__ and t.dim():
            sums.append(weakref.ref(t))     # a sum, not the loss's
        return t

    make = train.make_optimizer

    def spy_make(*args, **kw):
        opt = make(*args, **kw)

        def init(params):
            state = opt.init(params)
            first[:] = [weakref.ref(t)
                        for t in flatten_with_paths(state)[1]]
            return state

        def update(grads, state, params):
            gc.collect()
            updates.append(tuple(sum(r() is not None for r in refs)
                                 for refs in (raw, sums, first)))
            return opt.update(grads, state, params)

        return opt._replace(init=init, update=update)

    monkeypatch.setattr(torch.autograd, "grad", spy_grad)
    monkeypatch.setattr(torch, "zeros", spy_zeros)
    monkeypatch.setattr(train, "make_optimizer", spy_make)
    train.main(["--arch", "deepseek-67b", "--smoke", "--device", "cpu",
                "--steps", "3", "--batch", "2", "--seq", "16",
                "--accum", str(accum), "--log-every", "3"])
    return updates, len(raw), len(sums), len(first)


def test_step_and_launcher_free_what_the_reference_donates(monkeypatch):
    """With two microbatches the f32 gradient sums and every raw autograd
    gradient are dead when the update starts, and the first optimizer
    state is dead once the first update has replaced it: nothing pins
    them (at full width deepseek-67b's embedding and untied head hold 12.5
    GiB of plain-Adam moments, and the sums 11.4 GiB)."""
    updates, n_raw, n_sums, n_first = _live_at_each_update(monkeypatch, 2)
    n_leaves = len(flatten_with_paths(
        lm.abstract_params(configs.get_smoke("deepseek-67b")))[1])
    assert n_first and n_sums == 3 * n_leaves and n_raw == 2 * n_sums
    # (live raw gradients, live f32 sums, live first state) at each update
    assert updates == [(0, 0, n_first), (0, 0, 0), (0, 0, 0)]


def test_single_microbatch_step_casts_without_sums(monkeypatch):
    """With one microbatch (the launcher's default) the step makes no f32
    sums, and each raw autograd gradient is dead when the update starts:
    it dies as its leaf is cast (jamba's 5-layer cut fits the card only
    so)."""
    updates, n_raw, n_sums, n_first = _live_at_each_update(monkeypatch, 1)
    assert n_first and n_raw and n_sums == 0
    assert updates == [(0, 0, n_first), (0, 0, 0), (0, 0, 0)]
