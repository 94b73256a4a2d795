"""The port's mamba block and jamba-v0.1-52b against the JAX package: the
log-depth scan against ``jax.lax.associative_scan``, the chunked selective
scan (one chunk and several, f32 and bf16), the smoke model's logits,
loss, gradients, bucket plan and state bytes, three GWT-2 steps through
the ``TrainLoop``, prefill + decode against the train forward (the twin of
``tests/test_models.py::test_decode_matches_full_forward``), the dense
``generate`` of a recurrent config, the full-width plan and state bytes of
the 5-layer cut on ``meta``, and a resume through the launcher.

Tolerances.  The scan, run op by op, is bitwise JAX's op-by-op
``associative_scan`` (the same products in the same order); under
``jax.jit`` XLA contracts ``a2*b1 + b2`` into an FMA, so against the jitted
scan 2 f32 spacings (1 measured).  The selective scan against the jitted
reference: f32 8 spacings of the output's largest magnitude (7 measured:
the readout's 16-term sum and ``exp`` in another order); bf16 1 bf16
spacing (0.35 measured: XLA keeps the bf16 elementwise chain in f32 inside
a fusion, the port rounds each op; op by op the two agree within 1 f32
spacing).  The model as ``tests/test_torch_dense.py`` holds the dense
configs (f32: logits 8, loss 4, gradients 32 f32 spacings; bf16: logits 4
bf16 spacings, loss 8192 f32 spacings, gradients 16 bf16 spacings); the
bf16 model takes the JAX package's top-k choices
(``test_torch_dense._PinnedRouting``).  Three GWT-2 steps' losses within
2e-5; decode against the train forward ``atol = rtol = 0.05``, the
reference test's.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import flat_numpy, port_model, spacings, to_numpy
from test_torch_dense import (_PinnedRouting, _check_against_reference,
                              _batch)

from repro import configs as jconfigs
from repro.core.gwt import gwt as jax_gwt
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import lm as jlm, ssm as jssm
from repro.models.layers import Builder as JaxBuilder
from repro.optim import engine as jengine
from repro.optim.schedules import warmup_cosine as jax_warmup_cosine
from repro.runtime.fault_tolerance import TrainLoop as JaxTrainLoop
from repro_torch import configs
from repro_torch.core.gwt import gwt
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import serve, train
from repro_torch.launch.serve import pad_cache
from repro_torch.models import lm, ssm
from repro_torch.optim import engine
from repro_torch.optim.base import flatten_with_paths
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.runtime.fault_tolerance import TrainLoop

ARCH = "jamba-v0.1-52b"
VOCAB = 512
# the JAX package's engine.state_bytes of GWT-2 at full width, cut to the
# first five kinds of jamba's period (mamba, mamba+moe, mamba, mamba+moe,
# attn): f32 and blocked-int8 moments
JAMBA_CUT = 5
JAMBA_STATE_BYTES = {"f32": 17_665_458_288, "int8": 4_692_387_444}


def _combine(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


@pytest.mark.parametrize("T", [1, 2, 7, 32, 37])
def test_associative_scan_is_jax_order(T):
    rng = np.random.RandomState(T)
    a = rng.uniform(0.5, 1.0, (2, T, 3, 4)).astype(np.float32)
    b = rng.randn(2, T, 3, 4).astype(np.float32)
    ta, tb = ssm.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    with jax.disable_jit():
        ja, jb = jax.lax.associative_scan(_combine, (jnp.asarray(a),
                                                     jnp.asarray(b)), axis=1)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    ka, kb = jax.jit(lambda a, b: jax.lax.associative_scan(
        _combine, (a, b), axis=1))(a, b)
    assert spacings(ta, ka) <= 2 and spacings(tb, kb) <= 2


def _mixer(dtype):
    jcfg = jconfigs.get_smoke(ARCH).with_(dtype=dtype)
    tcfg = configs.get_smoke(ARCH).with_(dtype=dtype)
    jp = jssm.mamba_init(JaxBuilder("init", jax.random.key(0),
                                    jnp.dtype(dtype)), jcfg)
    tp = {k: torch.from_numpy(v).to(tcfg.torch_dtype)
          for k, v in flat_numpy(jp).items()}
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,chunk", [(32, 1024), (37, 1024), (32, 8)],
                         ids=["one-chunk", "no-clean-chunk", "chunked"])
def test_selective_scan_matches_reference(T, chunk, dtype, monkeypatch):
    """``_SCAN_CHUNK`` lowered on both sides takes the chunked path (four
    chunks of 8, the state carried); 37 steps take one chunk."""
    monkeypatch.setattr(jssm, "_SCAN_CHUNK", chunk)
    monkeypatch.setattr(ssm, "_SCAN_CHUNK", chunk)
    jcfg, tcfg, jp, tp = _mixer(dtype)
    x = 0.5 * np.random.RandomState(2).randn(2, T, tcfg.d_inner) \
        .astype(np.float32)
    jy, jh = jax.jit(lambda p, x: jssm._selective_scan_chunked(
        p, jcfg, x))(jp, jnp.asarray(x).astype(dtype))
    ty, th = ssm.selective_scan_chunked(
        tp, tcfg, torch.from_numpy(x).to(tcfg.torch_dtype))
    assert ty.dtype == th.dtype == torch.float32
    bound = 8 if dtype == "float32" else 2.0 ** 16
    assert spacings(ty, jy) <= bound and spacings(th, jh) <= bound


def test_mamba_decode_state_matches_reference():
    """One decode step from a prefilled state: the output and the new
    ``{"h", "conv"}``, written in place."""
    jcfg, tcfg, jp, tp = _mixer("float32")
    x = np.random.RandomState(3).randn(2, 9, tcfg.d_model) \
        .astype(np.float32)
    prefill = jax.jit(lambda p, x: jssm.mamba_apply(
        p, jcfg, x, mode="prefill"))
    decode = jax.jit(lambda p, x, c: jssm.mamba_apply(
        p, jcfg, x, mode="decode", cache=c))
    _, jc = prefill(jp, jnp.asarray(x[:, :8]))
    jy, jc2 = decode(jp, jnp.asarray(x[:, 8:]), jc)
    with torch.no_grad():
        _, tc = ssm.mamba_apply(tp, tcfg, torch.from_numpy(x[:, :8]),
                                mode="prefill")
        h_buf = tc["h"]
        ty, tc2 = ssm.mamba_apply(tp, tcfg, torch.from_numpy(x[:, 8:]),
                                  mode="decode", cache=tc)
    assert tc2["h"] is h_buf
    assert spacings(ty, jy) <= 8
    for k in ("h", "conv"):
        assert spacings(tc2[k], jc2[k]) <= 8, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_matches_reference(dtype, monkeypatch):
    """jamba's smoke period (mamba, mamba+moe, ..., attn, ...): logits,
    loss and every gradient."""
    pin = None
    if dtype == "bfloat16":
        from repro_torch.models import moe as tmoe
        pin = _PinnedRouting(monkeypatch, tmoe)
    jcfg = jconfigs.get_smoke(ARCH).with_(dtype=dtype)
    tcfg = configs.get_smoke(ARCH).with_(dtype=dtype)
    if pin is not None:
        # four MoE blocks, routed in both forwards and the loss
        _check_against_reference(jcfg, tcfg, f32=False, jit=True)
        assert pin.calls == 2 * 4
    else:
        _check_against_reference(jcfg, tcfg, f32=True, jit=True)


def test_bucket_plan_and_state_bytes_match_reference():
    jcfg, tcfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    jopt, topt = jax_gwt(lr=0.01, impl="jnp"), gwt(lr=0.01)
    jp, model = port_model(jcfg, tcfg)
    want = [(b.name, b.paths) for b in jopt.engine.plan(jp).buckets]
    got = [(b.name, b.paths) for b in topt.engine.plan(model.tree()).buckets]
    assert got == want
    assert engine.state_bytes(topt.init(model.tree())) == \
        jengine.state_bytes(jopt, jp)


@pytest.mark.parametrize("codec", ["f32", "int8"])
def test_full_width_plan_and_state_bytes(codec):
    """jamba at every published width, cut to the first five kinds of its
    period (no whole period: every block a ``rem`` block), on ``meta``;
    the expert ``w_gate``/``w_up`` leaves of two MoE blocks are one bucket
    of 3.76e9 elements."""
    jcfg = jconfigs.get_config(ARCH).with_(n_layers=JAMBA_CUT)
    tcfg = configs.get_config(ARCH).with_(n_layers=JAMBA_CUT)
    jopt = jax_gwt(lr=0.01, impl="jnp", state_codec=codec)
    topt = gwt(lr=0.01, state_codec=codec)
    jabs, tabs = jlm.abstract_params(jcfg), lm.abstract_params(tcfg)
    assert "layers" not in tabs and sorted(tabs["rem"]) == \
        [f"b{i}" for i in range(JAMBA_CUT)]
    want = [(b.name, b.paths) for b in jopt.engine.plan(jabs).buckets]
    got = [(b.name, b.paths) for b in topt.engine.plan(tabs).buckets]
    assert got == want
    experts = dict(got)["gwt_last__rem.b1.ffn.w_gate"]
    shapes = dict(zip(*flatten_with_paths(tabs)))
    assert [tuple(shapes[p].shape) for p in experts] == \
        [(16, 4096, 14336)] * 4
    assert engine.state_bytes(topt.init(tabs)) == \
        jengine.state_bytes(jopt, jabs) == JAMBA_STATE_BYTES[codec]


def test_train_loop_tracks_reference_losses():
    steps = 3
    jcfg = jconfigs.get_smoke(ARCH).with_(dtype="float32")
    tcfg = configs.get_smoke(ARCH).with_(dtype="float32")
    jp, model = port_model(jcfg, tcfg, seed=0)
    jopt = jax_gwt(lr=jax_warmup_cosine(0.01, steps), impl="jnp")
    jloop = JaxTrainLoop(jlm.make_train_step(jcfg, jopt), None,
                         JaxSyntheticLM(VOCAB, 32, 2, 0), log_every=steps,
                         log=lambda s: None)
    _, _, jlosses = jloop.run(jp, jopt.init(jp), num_steps=steps)
    topt = gwt(lr=warmup_cosine(0.01, steps))
    tree = model.tree()
    tloop = TrainLoop(lm.make_train_step(tcfg, topt),
                      SyntheticLM(VOCAB, 32, 2, 0), device="cpu",
                      log_every=steps, log=lambda s: None)
    _, _, tlosses = tloop.run(tree, topt.init(tree), num_steps=steps)
    assert len(tlosses) == len(jlosses) == steps
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=2e-5)


def test_decode_matches_full_forward():
    """Prefill of S - 4 positions, then 4 decode steps: the mixed caches
    (K/V beside each mamba block's ``{"h", "conv"}``) against the train
    forward."""
    jcfg, tcfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    _, model = port_model(jcfg, tcfg, seed=0)
    params = model.tree()
    S, prefix = 32, 28
    tokens = torch.from_numpy(_batch(seed=4, S=S)["tokens"])
    with torch.no_grad():
        full = model(tokens).float().numpy()
    logits, cache = lm.make_prefill_step(tcfg)(params,
                                               {"tokens": tokens[:, :prefix]})
    assert set(cache["layers"]["b0"]) == {"h", "conv"}
    assert set(cache["layers"]["b4"]) == {"k", "v"}
    np.testing.assert_allclose(logits.float().numpy(), full[:, prefix - 1],
                               atol=0.05, rtol=0.05)
    cache = pad_cache(cache, S)
    h_before = cache["layers"]["b0"]["h"]
    assert tuple(h_before.shape) == (1, 2, tcfg.d_inner, tcfg.ssm_state)
    decode = lm.make_decode_step(tcfg)
    for t in range(prefix, S):
        logits, cache = decode(params, cache, {"tokens": tokens[:, t:t + 1]})
        np.testing.assert_allclose(logits.float().numpy(), full[:, t],
                                   atol=0.05, rtol=0.05, err_msg=f"step {t}")
    assert cache["layers"]["b0"]["h"] is h_before   # written in place


def test_generate_serves_a_recurrent_config_densely():
    """``launch.serve.generate`` (prefill, then decode over the dense
    caches) equals greedy decoding by full forwards; the paged engine
    refuses the recurrent stack, as the reference's does."""
    tcfg = configs.get_smoke(ARCH).with_(dtype="float32")
    model = lm.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    prompt = torch.from_numpy(_batch(seed=5, S=12)["tokens"])
    got = serve.generate(tcfg, model, prompt, 5)
    seq = prompt
    with torch.no_grad():
        for _ in range(5):
            nxt = torch.argmax(model(seq)[:, -1], -1)[:, None]
            seq = torch.cat([seq, nxt], dim=1)
    assert torch.equal(got, seq[:, 12:])
    from repro_torch.serve.engine import Engine
    with pytest.raises(NotImplementedError, match="recurrent"):
        Engine(tcfg, model)


def test_launcher_resume_is_bitwise(tmp_path):
    """jamba's smoke config through the launcher: 4 steps checkpointed at
    2 and 4; with step 4's checkpoint removed, a resume from 2 to 4 equals
    the straight run bitwise (losses, parameters, optimizer state)."""
    ck = str(tmp_path / "ck")
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--log-every", "1", "--steps", "4",
            "--ckpt-dir", ck, "--ckpt-every", "2"]
    straight = train.main(argv)
    shutil.rmtree(os.path.join(ck, "step_000000004"))
    resumed = train.main(argv + ["--resume"])
    assert resumed.start_step == 2
    assert resumed.losses == straight.losses[2:]
    for a, b in ((resumed.params, straight.params),
                 (resumed.opt_state, straight.opt_state)):
        fa, fb = (dict(zip(*flatten_with_paths(t))) for t in (a, b))
        assert sorted(fa) == sorted(fb)
        for path in fa:
            assert torch.equal(fa[path], fb[path]), path
