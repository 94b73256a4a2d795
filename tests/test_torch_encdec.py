"""The port's encoder-decoder stack and seamless-m4t-large-v2 against the
JAX package: ``_flash_attn_noncausal`` (chunked and its fallback to the
direct route), bidirectional attention and its dispatch, the smoke
model's logits, loss, gradients, parameter paths, bucket plan and state
bytes, three GWT-2 steps through the ``TrainLoop`` on frame-carrying
batches, decode against teacher forcing (the twin of
``tests/test_models.py::test_encdec_decode_matches_teacher_forcing``) and
against the JAX package's decode, the full-width plan and state bytes on
``meta``, the serving refusals, and a resume through the launcher.

Tolerances: the attention routes 8 f32 spacings of the output's largest
magnitude in f32 (4 measured), 1 bf16 spacing in bf16 (0.25); the model
as ``tests/test_torch_dense.py`` holds the dense configs (f32: logits 8,
loss 4, gradients 32 f32 spacings, measured 2, 1, 18.5; bf16: logits 4
bf16 spacings, loss 8192 f32 spacings, gradients 16 bf16 spacings,
measured 1, 2378, 3.5); three GWT-2 steps' losses within 2e-5; decode
against teacher forcing ``atol = rtol = 0.05`` (the reference test's), the
decode logits against the JAX package's 8 f32 spacings.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import bf16_spacings, flat_numpy, spacings

from repro import configs as jconfigs
from repro.core.gwt import gwt as jax_gwt
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM, \
    WithEncoderFrames as JaxWithEncoderFrames
from repro.launch.serve import pad_cache as jax_pad_cache
from repro.models import attention as jattn, encdec as jencdec
from repro.optim import engine as jengine
from repro.optim.schedules import warmup_cosine as jax_warmup_cosine
from repro.runtime.fault_tolerance import TrainLoop as JaxTrainLoop
from repro_torch import configs, interop
from repro_torch.core.gwt import gwt
from repro_torch.data.pipeline import SyntheticLM, WithEncoderFrames
from repro_torch.launch import serve, train
from repro_torch.launch.serve import pad_cache
from repro_torch.models import attention, encdec, rope
from repro_torch.optim import engine
from repro_torch.optim.base import flatten_with_paths
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.runtime.fault_tolerance import TrainLoop

ARCH = "seamless-m4t-large-v2"
VOCAB = 512
# the JAX package's engine.state_bytes of GWT-2 at full width and depth
# (12 + 12 layers, vocab 256,206)
SEAMLESS_STATE_BYTES = {"f32": 3_609_296_972, "int8": 958_719_568}


def _cfgs(dtype="float32"):
    return (jconfigs.get_smoke(ARCH).with_(dtype=dtype),
            configs.get_smoke(ARCH).with_(dtype=dtype))


def _model(jcfg, tcfg, seed=0):
    jp = jencdec.init(jcfg, jax.random.key(seed))
    return jp, interop.params_from_numpy(tcfg, flat_numpy(jp), "cpu")


def _batch(seed=1, B=2, S=64, frames=16, d=64):
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, VOCAB, (B, S)).astype(np.int32),
            "labels": rng.randint(0, VOCAB, (B, S)).astype(np.int32),
            "enc_embeds": rng.randn(B, frames, d).astype(np.float32)}


def _close(got, want, dtype):
    if dtype == "float32":
        return spacings(got, want) <= 8
    return bf16_spacings(got, want) <= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv,q_chunk,kv_chunk", [
    (32, 48, 8, 16), (32, 48, 8, 32), (16, 16, 512, 2048)],
    ids=["chunked", "fallback", "one-chunk"])
def test_flash_attn_noncausal_matches_reference(Sq, Skv, q_chunk, kv_chunk,
                                                dtype):
    """Chunks that divide the lengths, a kv chunk that does not (the
    direct route), and chunks larger than the lengths (shrunk to them)."""
    rng = np.random.RandomState(Sq + Skv + kv_chunk)
    q = rng.randn(2, Sq, 4, 16).astype(np.float32)
    k, v = (rng.randn(2, Skv, 4, 16).astype(np.float32) for _ in range(2))
    want = jax.jit(lambda q, k, v: jattn._flash_attn_noncausal(
        q, k, v, q_chunk=q_chunk, kv_chunk=kv_chunk))(
            *(jnp.asarray(a).astype(dtype) for a in (q, k, v)))
    got = attention._flash_attn_noncausal(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)),
        q_chunk=q_chunk, kv_chunk=kv_chunk)
    assert got.dtype == getattr(torch, dtype)
    assert _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bidirectional_attention_matches_reference(dtype):
    """The encoder's self-attention (``attn_apply(bidirectional=True)``)
    on the smoke layer's weights: nothing masked."""
    jcfg, tcfg = _cfgs(dtype)
    jp = jax.tree.map(lambda a: a[0], jencdec.init(
        jcfg, jax.random.key(0))["encoder"]["attn"])
    tp = {k: torch.from_numpy(np.array(v)).to(tcfg.torch_dtype)
          for k, v in flat_numpy(jp).items()}
    x = np.random.RandomState(7).randn(2, 24, tcfg.d_model) \
        .astype(np.float32)
    from repro.models import rope as jrope
    jcos, jsin = jrope.rope_angles(jnp.broadcast_to(jnp.arange(24), (2, 24)),
                                   jcfg.head_dim, jcfg.rope_theta)
    want, _ = jattn.attn_apply(jp, jcfg, jnp.asarray(x).astype(dtype), jcos,
                               jsin, bidirectional=True)
    cos, sin = rope.rope_angles(torch.arange(24), tcfg.head_dim,
                                tcfg.rope_theta)
    got, _ = attention.attn_apply(tp, tcfg,
                                  torch.from_numpy(x).to(tcfg.torch_dtype),
                                  cos, sin, bidirectional=True)
    assert _close(got, want, dtype)
    causal, _ = attention.attn_apply(
        tp, tcfg, torch.from_numpy(x).to(tcfg.torch_dtype), cos, sin)
    assert not torch.equal(got[:, :-1], causal[:, :-1])   # it is unmasked


@pytest.mark.parametrize("S,route", [(4096, "_direct_attn"),
                                     (4104, "_flash_attn_noncausal")])
def test_bidirectional_dispatch(monkeypatch, S, route):
    """The reference's: past 4096 positions the chunked non-causal
    route."""
    taken = []
    for name in ("_direct_attn", "_flash_attn_noncausal", "_flash_attn",
                 "_local_block_attn"):
        monkeypatch.setattr(attention, name, lambda q, *a, _n=name, **kw:
                            taken.append(_n) or torch.zeros_like(q))
    tcfg = configs.get_smoke(ARCH).with_(d_model=8, n_heads=1,
                                         n_kv_heads=1, head_dim=8)
    p = {n: torch.zeros(8, 8) for n in ("wq", "wk", "wv", "wo")}
    cos, sin = rope.rope_angles(torch.arange(S), 8, 1e4)
    attention.attn_apply(p, tcfg, torch.zeros(1, S, 8), cos, sin,
                         bidirectional=True)
    assert taken == [route]


def _loss_and_grads(tcfg, model, batch):
    tree = model.tree()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = encdec.loss_fn(tcfg, tree, tb)
    paths, leaves = flatten_with_paths(tree)
    return loss.detach(), dict(zip(paths, torch.autograd.grad(loss,
                                                              leaves)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_matches_reference(dtype):
    """Teacher-forced logits, loss and every gradient; the parameter
    paths (``encoder/...``, ``enc_norm``, ``decoder/...`` stacked on the
    layers axis) in the JAX flatten order."""
    jcfg, tcfg = _cfgs(dtype)
    jp, model = _model(jcfg, tcfg)
    paths = list(dict(zip(*flatten_with_paths(model.tree()))))
    assert paths == list(flat_numpy(jp))
    assert "enc_norm" in paths and "decoder/cross_attn/wk" in paths
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jlogits = jencdec.decode_stack(
        jcfg, jp, jb["tokens"], jencdec.encode(jcfg, jp, jb["enc_embeds"]))[0]
    jloss, jgrads = jax.value_and_grad(
        lambda p: jencdec.loss_fn(jcfg, p, jb))(jp)
    with torch.no_grad():
        logits = model(torch.from_numpy(b["tokens"]),
                       torch.from_numpy(b["enc_embeds"]))
    loss, grads = _loss_and_grads(tcfg, model, b)
    jg = flat_numpy(jgrads)
    if dtype == "float32":
        assert spacings(logits, jlogits) <= 8
        assert spacings(loss, jloss) <= 4
        for path, g in grads.items():
            assert spacings(g, jg[path]) <= 32, path
    else:
        assert logits.dtype == torch.bfloat16
        assert bf16_spacings(logits, jlogits) <= 4
        assert spacings(loss, jloss) <= 8192
        for path, g in grads.items():
            assert bf16_spacings(g, jg[path]) <= 16, path


def test_bucket_plan_and_state_bytes_match_reference():
    jcfg, tcfg = _cfgs("bfloat16")
    jopt, topt = jax_gwt(lr=0.01, impl="jnp"), gwt(lr=0.01)
    jp, model = _model(jcfg, tcfg)
    want = [(b.name, b.paths) for b in jopt.engine.plan(jp).buckets]
    got = [(b.name, b.paths) for b in topt.engine.plan(model.tree()).buckets]
    assert got == want
    assert engine.state_bytes(topt.init(model.tree())) == \
        jengine.state_bytes(jopt, jp)


@pytest.mark.parametrize("codec", ["f32", "int8"])
def test_full_width_plan_and_state_bytes(codec):
    """seamless-m4t-large-v2 at full width and depth on ``meta``."""
    jcfg, tcfg = jconfigs.get_config(ARCH), configs.get_config(ARCH)
    jopt = jax_gwt(lr=0.01, impl="jnp", state_codec=codec)
    topt = gwt(lr=0.01, state_codec=codec)
    jabs, tabs = jencdec.abstract_params(jcfg), encdec.abstract_params(tcfg)
    want = [(b.name, b.paths) for b in jopt.engine.plan(jabs).buckets]
    got = [(b.name, b.paths) for b in topt.engine.plan(tabs).buckets]
    assert got == want
    assert engine.state_bytes(topt.init(tabs)) == \
        jengine.state_bytes(jopt, jabs) == SEAMLESS_STATE_BYTES[codec]


def test_train_loop_tracks_reference_losses():
    """Three GWT-2 steps on ``WithEncoderFrames`` batches (8 frames a
    row), each package's own source."""
    steps = 3
    jcfg, tcfg = _cfgs()
    jp, model = _model(jcfg, tcfg)
    jopt = jax_gwt(lr=jax_warmup_cosine(0.01, steps), impl="jnp")
    jloop = JaxTrainLoop(
        jencdec.make_train_step(jcfg, jopt), None,
        JaxWithEncoderFrames(JaxSyntheticLM(VOCAB, 32, 2, 0), 8, 64),
        log_every=steps, log=lambda s: None)
    _, _, jlosses = jloop.run(jp, jopt.init(jp), num_steps=steps)
    topt = gwt(lr=warmup_cosine(0.01, steps))
    tree = model.tree()
    tloop = TrainLoop(encdec.make_train_step(tcfg, topt),
                      WithEncoderFrames(SyntheticLM(VOCAB, 32, 2, 0), 8, 64),
                      device="cpu", log_every=steps, log=lambda s: None)
    _, _, tlosses = tloop.run(tree, topt.init(tree), num_steps=steps)
    assert len(tlosses) == len(jlosses) == steps
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=2e-5)


def test_decode_matches_teacher_forcing():
    """Prefill S - 3 tokens, then 3 cached decode steps (the self K/V
    padded to S and written in place, the cross K/V kept at the encoder's
    length): against the teacher-forced logits, and against the JAX
    package's prefill and decode."""
    jcfg, tcfg = _cfgs()
    jp, model = _model(jcfg, tcfg)
    params = model.tree()
    S, prefix = 16, 13
    b = _batch(seed=2, S=S, frames=8)
    tokens = torch.from_numpy(b["tokens"])
    frames = torch.from_numpy(b["enc_embeds"])
    with torch.no_grad():
        full = model(tokens, frames).numpy()
    logits, cache = encdec.make_prefill_step(tcfg)(
        params, {"tokens": tokens[:, :prefix], "enc_embeds": frames})
    jlogits, jcache = jencdec.make_prefill_step(jcfg)(
        jp, {"tokens": jnp.asarray(b["tokens"][:, :prefix]),
             "enc_embeds": jnp.asarray(b["enc_embeds"])})
    assert cache["pos"] == prefix
    np.testing.assert_allclose(logits.numpy(), full[:, prefix - 1],
                               atol=0.05, rtol=0.05)
    assert spacings(logits, jlogits) <= 8
    cache = {"dec": {"self": pad_cache(cache["dec"]["self"], S),
                     "cross": cache["dec"]["cross"]}, "pos": cache["pos"]}
    jcache = {"dec": {"self": jax_pad_cache(jcache["dec"]["self"], S),
                      "cross": jcache["dec"]["cross"]},
              "pos": jcache["pos"]}
    assert tuple(cache["dec"]["cross"]["k"].shape[:3]) == (
        tcfg.n_dec_layers, 2, 8)
    self_k = cache["dec"]["self"]["k"]
    decode = encdec.make_decode_step(tcfg)
    jdecode = jencdec.make_decode_step(jcfg)
    for t in range(prefix, S):
        logits, cache = decode(params, cache, {"tokens": tokens[:, t:t + 1]})
        jtok = jnp.asarray(b["tokens"][:, t:t + 1])
        jlogits, jcache = jdecode(jp, jcache, {"tokens": jtok})
        np.testing.assert_allclose(logits.numpy(), full[:, t], atol=0.05,
                                   rtol=0.05, err_msg=f"step {t}")
        assert spacings(logits, jlogits) <= 8, t
    assert cache["dec"]["self"]["k"] is self_k and cache["pos"] == S


def test_init_cache_is_the_prefill_layout():
    tcfg = configs.get_smoke(ARCH)
    params = encdec.abstract_params(tcfg)
    assert tuple(params["encoder"]["attn"]["wq"].shape) == (
        tcfg.n_enc_layers, tcfg.d_model, tcfg.n_heads * tcfg.head_dim)
    cache = encdec.init_cache(tcfg, 2, 16, 8, "cpu")
    assert cache["pos"] == 0
    assert tuple(cache["dec"]["self"]["v"].shape) == (
        tcfg.n_dec_layers, 2, 16, tcfg.n_kv_heads, tcfg.head_dim)
    assert tuple(cache["dec"]["cross"]["k"].shape) == (
        tcfg.n_dec_layers, 2, 8, tcfg.n_kv_heads, tcfg.head_dim)


def test_serving_refuses_the_encoder_decoder():
    """As the reference's: the serve launcher and the engine are
    decoder-only and point to ``decode_stack``."""
    with pytest.raises(SystemExit, match="decode_stack"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    from repro_torch.serve.engine import Engine
    tcfg = configs.get_smoke(ARCH)
    with pytest.raises(NotImplementedError, match="decode_stack"):
        Engine(tcfg, encdec.init(tcfg, torch.Generator().manual_seed(0),
                                 "cpu"))


def test_launcher_resume_is_bitwise(tmp_path):
    """The encoder-decoder tree through the launcher's checkpoints: 4
    steps checkpointed at 2 and 4; with step 4's checkpoint removed, a
    resume from 2 equals the straight run bitwise (losses, parameters,
    optimizer state)."""
    ck = str(tmp_path / "ck")
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--log-every", "1", "--steps", "4",
            "--ckpt-dir", ck, "--ckpt-every", "2"]
    straight = train.main(argv)
    shutil.rmtree(os.path.join(ck, "step_000000004"))
    resumed = train.main(argv + ["--resume"])
    assert resumed.start_step == 2
    assert resumed.losses == straight.losses[2:]
    assert "encoder" in resumed.params and "enc_norm" in resumed.params
    for a, b in ((resumed.params, straight.params),
                 (resumed.opt_state, straight.opt_state)):
        fa, fb = (dict(zip(*flatten_with_paths(t))) for t in (a, b))
        assert sorted(fa) == sorted(fb)
        for path in fa:
            assert torch.equal(fa[path], fb[path]), path
