"""The port's mLSTM and sLSTM blocks and xlstm-350m against the JAX
package: ``mlstm_chunkwise`` with one chunk and several, the parallel form
against it, one mLSTM decode step, ``slstm_step`` and ``slstm_apply``, the
smoke model's logits, loss, gradients, bucket plan and state bytes, three
GWT-2 steps through the ``TrainLoop``, prefill + decode against the train
forward, and the full-width plan and state bytes on ``meta``.

Tolerances (f32 spacings of the largest magnitude of the JAX output, the
reference jitted): ``mlstm_chunkwise`` 16 on h and on the carried ``(C, n,
m)`` (7 measured: the einsums and the cumulative log-gates sum in another
order), the parallel form 16 (8; against the port's chunkwise 5.5); the
decode step 8; ``slstm_step`` 8 on ``h`` and the state (3), ``slstm_apply``
8 in f32 (4) and in bf16 2 bf16 spacings on the output (1) with the f32
state within 8 f32 spacings (2).  The model as ``tests/test_torch_dense.py``
holds the dense configs, but for the gradients: 512 f32 spacings in f32
(``F32_GRAD_SPACINGS``) and, in bf16, the dense 16 bf16 spacings but on
the mLSTM's own leaves, whose bounds ``bf16_grad_bound`` gives by path
(the conditioning of the stabilised gates); three GWT-2 steps' losses
within 2e-5; decode against the train forward ``atol = rtol = 0.05``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import bf16_spacings, flat_numpy, port_model, spacings
from test_torch_dense import _batch, _check_against_reference

from repro import configs as jconfigs
from repro.core.gwt import gwt as jax_gwt
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import lm as jlm, xlstm as jxlstm
from repro.models.layers import Builder as JaxBuilder
from repro.optim import engine as jengine
from repro.optim.schedules import warmup_cosine as jax_warmup_cosine
from repro.runtime.fault_tolerance import TrainLoop as JaxTrainLoop
from repro_torch import configs
from repro_torch.core.gwt import gwt
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.serve import pad_cache
from repro_torch.models import lm, xlstm
from repro_torch.optim import engine
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.runtime.fault_tolerance import TrainLoop

ARCH = "xlstm-350m"
VOCAB = 512
# f32 gradients: the mLSTM's stabiliser m enters every gate weight and
# cancels out of h, so a gradient is a sum of large cancelling terms.  On
# the smoke batch the port sits 162 spacings from JAX at layers/b5 wq
# (measured on the CPU: 139 from an f64 evaluation of the same model,
# where JAX's own f32 gradients sit 29 away; on another batch JAX's sit
# 327 away and the port's 167)
F32_GRAD_SPACINGS = 512
# bf16 gradients, by leaf, in bf16 spacings (the largest of three
# batches measured on the CPU; the test's batch in brackets).  The gate
# biases b_igate/b_fgate: 74.5 (63.6), where an f64 evaluation puts the
# port's up to 77 and JAX's own bf16 gradients up to 111 away; so 128,
# which a gradient off by half its largest element could pass: the f32
# case holds those leaves within 512 f32 spacings, 6e-5 of it.  The gate
# weights w_igate/w_fgate: 32.9 (32.9), so 48.  The mLSTM mixer's other
# leaves (q/k/v, the convolution, the projections, out_norm): 23.5
# (19.5), so 32.  Every other leaf (embedding, block norms, the sLSTM
# block) keeps the dense 16: 16.0 (11.9).  Below 64 a gradient off by
# half its largest element fails.
BF16_GATE_BIAS_SPACINGS = 128
BF16_GATE_WEIGHT_SPACINGS = 48
BF16_MLSTM_SPACINGS = 32
BF16_GRAD_SPACINGS = 16


def bf16_grad_bound(path):
    """The bf16 gradient bound of the smoke model's leaf at ``path``."""
    parts = path.split("/")         # layers/b<i>/mixer/<leaf>
    if parts[0] != "layers" or parts[2] != "mixer" or \
            configs.get_smoke(ARCH).pattern[int(parts[1][1:])] != "mlstm":
        return BF16_GRAD_SPACINGS
    if parts[3] in ("b_igate", "b_fgate"):
        return BF16_GATE_BIAS_SPACINGS
    if parts[3] in ("w_igate", "w_fgate"):
        return BF16_GATE_WEIGHT_SPACINGS
    return BF16_MLSTM_SPACINGS
# the JAX package's engine.state_bytes of GWT-2 at full width and depth
XLSTM_STATE_BYTES = {"f32": 1_286_170_084, "int8": 341_639_144}


def _gates(T, seed=0, B=2, H=2, dh=16):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, T, H, dh).astype(np.float32) for _ in range(3))
    log_i = rng.randn(B, T, H).astype(np.float32)
    log_f = (rng.randn(B, T, H) + 2.0).astype(np.float32)
    return q, k, v, log_i, log_f


@pytest.mark.parametrize("chunk", [32, 8], ids=["one-chunk", "four-chunks"])
def test_mlstm_chunkwise_matches_reference(chunk):
    args = _gates(32)
    jh, jstate = jax.jit(lambda *a: jxlstm._mlstm_chunkwise(
        *a, chunk=chunk))(*args)
    th, tstate = xlstm.mlstm_chunkwise(*map(torch.from_numpy, args),
                                       chunk=chunk)
    assert spacings(th, jh) <= 16
    for name, t, j in zip("Cnm", tstate, jstate):
        assert spacings(t, j) <= 16, name


def test_mlstm_parallel_matches_reference_and_chunkwise():
    """The reference's docstring: the chunkwise form is the parallel one,
    chunked."""
    args = _gates(32, seed=1)
    jh = jax.jit(jxlstm._mlstm_parallel)(*args)
    targs = list(map(torch.from_numpy, args))
    th = xlstm.mlstm_parallel(*targs)
    assert spacings(th, jh) <= 16
    assert spacings(xlstm.mlstm_chunkwise(*targs, chunk=8)[0], th) <= 16


def _mixer(kind, dtype="float32"):
    """A JAX-initialised mixer of ``kind`` at the smoke config's widths
    and its port twin."""
    jcfg = jconfigs.get_smoke(ARCH).with_(dtype=dtype)
    tcfg = configs.get_smoke(ARCH).with_(dtype=dtype)
    init = jxlstm.mlstm_init if kind == "mlstm" else jxlstm.slstm_init
    jp = init(JaxBuilder("init", jax.random.key(0), jnp.dtype(dtype)), jcfg)
    tp = {k: torch.from_numpy(np.array(v)).to(tcfg.torch_dtype)
          for k, v in flat_numpy(jp).items()}
    return jcfg, tcfg, jp, tp


def test_mlstm_decode_step_matches_reference():
    jcfg, tcfg, jp, tp = _mixer("mlstm")
    x = np.random.RandomState(3).randn(2, 9, tcfg.d_model) \
        .astype(np.float32)
    prefill = jax.jit(lambda p, x: jxlstm.mlstm_apply(
        p, jcfg, x, mode="prefill"))
    decode = jax.jit(lambda p, x, c: jxlstm.mlstm_apply(
        p, jcfg, x, mode="decode", cache=c))
    _, jc = prefill(jp, jnp.asarray(x[:, :8]))
    jy, jc2 = decode(jp, jnp.asarray(x[:, 8:]), jc)
    with torch.no_grad():
        _, tc = xlstm.mlstm_apply(tp, tcfg, torch.from_numpy(x[:, :8]),
                                  mode="prefill")
        c_buf = tc["C"]
        ty, tc2 = xlstm.mlstm_apply(tp, tcfg, torch.from_numpy(x[:, 8:]),
                                    mode="decode", cache=tc)
    assert tc2["C"] is c_buf
    assert spacings(ty, jy) <= 8
    for k in ("C", "n", "m", "conv"):
        assert spacings(tc2[k], jc2[k]) <= 8, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_step_matches_reference(dtype):
    """One step from a non-trivial state (the recurrent kernel ``r``
    acts on ``h``)."""
    jcfg, tcfg, jp, tp = _mixer("slstm", dtype)
    x = np.random.RandomState(4).randn(2, tcfg.d_model).astype(np.float32)
    shape = (2, tcfg.n_heads, tcfg.d_model // tcfg.n_heads)
    state = [np.full(shape, v, np.float32) for v in (0.1, 1.0, 0.2, 0.5)]
    jstate, jh = jxlstm._slstm_step(jp, jcfg, jnp.asarray(x).astype(dtype),
                                    tuple(map(jnp.asarray, state)))
    tstate, th = xlstm.slstm_step(
        tp, tcfg, torch.from_numpy(x).to(tcfg.torch_dtype),
        tuple(map(torch.from_numpy, state)))
    assert spacings(th, jh) <= 8
    for name, t, j in zip("cnhm", tstate, jstate):
        assert t.dtype == torch.float32
        assert spacings(t, j) <= 8, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_apply_matches_reference(dtype):
    """Twelve steps from the ``-1e30`` stabiliser, the post-MLP, the final
    state (prefill)."""
    jcfg, tcfg, jp, tp = _mixer("slstm", dtype)
    x = np.random.RandomState(5).randn(2, 12, tcfg.d_model) \
        .astype(np.float32)
    jy, jc = jax.jit(lambda p, x: jxlstm.slstm_apply(
        p, jcfg, x, mode="prefill"))(jp, jnp.asarray(x).astype(dtype))
    ty, tc = xlstm.slstm_apply(tp, tcfg,
                               torch.from_numpy(x).to(tcfg.torch_dtype),
                               mode="prefill")
    if dtype == "float32":
        assert spacings(ty, jy) <= 8
    else:
        assert ty.dtype == torch.bfloat16 and bf16_spacings(ty, jy) <= 2
    for name in "cnhm":
        assert spacings(tc[name], jc[name]) <= 8, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_matches_reference(dtype):
    """xlstm-350m's smoke stack (seven mLSTM blocks and an sLSTM, no FFN):
    logits, loss and every gradient."""
    jcfg = jconfigs.get_smoke(ARCH).with_(dtype=dtype)
    tcfg = configs.get_smoke(ARCH).with_(dtype=dtype)
    assert "ffn" not in lm.abstract_params(tcfg)["layers"]["b0"]
    _check_against_reference(jcfg, tcfg, f32=dtype == "float32",
                             grad_spacings=F32_GRAD_SPACINGS,
                             bf16_grad_spacings=bf16_grad_bound,
                             jit=True)


def test_bucket_plan_and_state_bytes_match_reference():
    """The stacked sLSTM bias ``b`` (``(periods, 4d)``, two axes) is a GWT
    leaf in the reference, and in the port; ``r`` and the gates are
    not."""
    jcfg, tcfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    jopt, topt = jax_gwt(lr=0.01, impl="jnp"), gwt(lr=0.01)
    jp, model = port_model(jcfg, tcfg)
    want = [(b.name, b.paths) for b in jopt.engine.plan(jp).buckets]
    got = [(b.name, b.paths) for b in topt.engine.plan(model.tree()).buckets]
    assert got == want
    assert "gwt_last__layers.b7.mixer.b" in dict(got)
    assert engine.state_bytes(topt.init(model.tree())) == \
        jengine.state_bytes(jopt, jp)


@pytest.mark.parametrize("codec", ["f32", "int8"])
def test_full_width_plan_and_state_bytes(codec):
    """xlstm-350m at full width and depth (24 layers, 3 periods), on
    ``meta``."""
    jcfg, tcfg = jconfigs.get_config(ARCH), configs.get_config(ARCH)
    jopt = jax_gwt(lr=0.01, impl="jnp", state_codec=codec)
    topt = gwt(lr=0.01, state_codec=codec)
    jabs, tabs = jlm.abstract_params(jcfg), lm.abstract_params(tcfg)
    want = [(b.name, b.paths) for b in jopt.engine.plan(jabs).buckets]
    got = [(b.name, b.paths) for b in topt.engine.plan(tabs).buckets]
    assert got == want
    assert engine.state_bytes(topt.init(tabs)) == \
        jengine.state_bytes(jopt, jabs) == XLSTM_STATE_BYTES[codec]


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
    """Prefill of S - 4 positions, then 4 decode steps over the mLSTM and
    sLSTM states, against the train forward; the states written in
    place."""
    jcfg, tcfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    _, model = port_model(jcfg, tcfg, seed=0)
    params = model.tree()
    S, prefix = 32, 28
    tokens = torch.from_numpy(_batch(seed=6, S=S)["tokens"])
    with torch.no_grad():
        full = model(tokens).float().numpy()
    logits, cache = lm.make_prefill_step(tcfg)(params,
                                               {"tokens": tokens[:, :prefix]})
    assert set(cache["layers"]["b0"]) == {"C", "n", "m", "conv"}
    assert set(cache["layers"]["b7"]) == set("cnhm")
    np.testing.assert_allclose(logits.float().numpy(), full[:, prefix - 1],
                               atol=0.05, rtol=0.05)
    cache = pad_cache(cache, S)
    c_before = cache["layers"]["b7"]["c"]
    decode = lm.make_decode_step(tcfg)
    for t in range(prefix, S):
        logits, cache = decode(params, cache, {"tokens": tokens[:, t:t + 1]})
        np.testing.assert_allclose(logits.float().numpy(), full[:, t],
                                   atol=0.05, rtol=0.05, err_msg=f"step {t}")
    assert cache["layers"]["b7"]["c"] is c_before
