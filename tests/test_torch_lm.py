"""The port's model, train step, loop and launcher against the JAX package
on llama-60m-smoke (f32), from parameters initialised by JAX and carried
over with ``repro_torch.interop``.

Tolerances: matmul sums run in another order in ATen than in XLA, so
logits are held to 8 f32 spacings of their largest magnitude, the loss to
4 and each gradient to 32.  Over 6 steps of training (JAX on its staged
GWT path, the port on its fused-write path) the per-step losses stay
within 2e-5 of each other (about 64 f32 spacings at a loss of 30).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import bf16_spacings, flat_numpy, port_model, spacings

from repro import configs as jconfigs
from repro.core.gwt import gwt as jax_gwt
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import lm as jlm
from repro.optim.base import flatten_with_paths as jax_flatten
from repro.optim.schedules import warmup_cosine as jax_warmup_cosine
from repro.runtime.fault_tolerance import TrainLoop as JaxTrainLoop
from repro_torch import configs, interop
from repro_torch.core.gwt import gwt
from repro_torch.data.pipeline import SyntheticLM, make_source
from repro_torch.kernels.gwt_adam import kernel
from repro_torch.launch import train
from repro_torch.models import lm
from repro_torch.optim.base import flatten_with_paths, unflatten
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.runtime.fault_tolerance import TrainLoop

JCFG = jconfigs.get_smoke("llama-60m")
TCFG = configs.get_smoke("llama-60m")


def _batch(seed=0, B=2, S=16):
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, 64, (B, S)).astype(np.int32),
            "labels": rng.randint(0, 64, (B, S)).astype(np.int32)}


def test_forward_loss_and_grads_match_reference():
    jp, model = port_model(JCFG, TCFG, seed=0)
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    assert spacings(model(tb["tokens"]),
                    jlm.forward(JCFG, jp, jb["tokens"])[0]) <= 8
    jloss, jgrads = jax.value_and_grad(
        lambda p: jlm.loss_fn(JCFG, p, jb))(jp)
    tree = model.tree()
    tloss = lm.loss_fn(TCFG, tree, tb)
    paths, leaves = flatten_with_paths(tree)
    assert paths == list(flat_numpy(jp))
    assert spacings(tloss.detach(), jloss) <= 4
    jg = flat_numpy(jgrads)
    for path, g in zip(paths, torch.autograd.grad(tloss, leaves)):
        assert spacings(g, jg[path]) <= 32, path


def test_synthetic_batches_are_the_reference_batches():
    for i in (0, 7):
        want = JaxSyntheticLM(64, 16, 4, seed=3).batch(i)
        got = make_source("synthetic", 64, 16, 4, seed=3).batch(i)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])


def test_train_loop_tracks_reference_losses():
    steps = 6
    jp, model = port_model(JCFG, TCFG, seed=0)
    jopt = jax_gwt(lr=jax_warmup_cosine(0.01, steps), impl="jnp")
    jloop = JaxTrainLoop(jlm.make_train_step(JCFG, jopt, accum_steps=2),
                         None, JaxSyntheticLM(64, 16, 4, 0), log_every=3,
                         log=lambda s: None)
    _, _, jlosses = jloop.run(jp, jopt.init(jp), num_steps=steps)

    topt = gwt(lr=warmup_cosine(0.01, steps))
    tree = model.tree()
    logged = []
    tloop = TrainLoop(lm.make_train_step(TCFG, topt, accum_steps=2),
                      SyntheticLM(64, 16, 4, 0), device="cpu", log_every=3,
                      log=logged.append)
    _, state, tlosses = tloop.run(tree, topt.init(tree), num_steps=steps)
    assert len(tlosses) == len(jlosses) == steps
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=2e-5)
    assert [s.split(":")[0] for s in logged] == ["step 3", "step 6"]
    assert int(state["step"]) == steps
    assert tloop.steady_step_s is not None and tloop.steady_step_s > 0


def test_chunk_grid_matches_reference():
    for log_every, num in [(10, 37), (20, 50), (7, 30), (0, 40)]:
        j = JaxTrainLoop(None, None, None, log_every=log_every)
        t = TrainLoop(None, None, device="cpu", log_every=log_every)
        for step in range(num):
            assert t._chunk_end(step, num) == j._chunk_end(step, num)


def test_interop_bf16_bits_and_state():
    """bf16 leaves arrive as float32 or as raw uint16 bits with equal
    results; an optimizer state exported from JAX continues in the port
    like it does in JAX."""
    jcfg = JCFG.with_(dtype="bfloat16")
    tcfg = TCFG.with_(dtype="bfloat16")
    jp = jlm.init(jcfg, jax.random.key(4))
    as_f32 = flat_numpy(jp)
    paths, leaves, _ = jax_flatten(jp)
    as_bits = {p: np.asarray(l).view(np.uint16)
               for p, l in zip(paths, leaves)}
    m1 = interop.params_from_numpy(tcfg, as_f32, "cpu")
    m2 = interop.params_from_numpy(tcfg, as_bits, "cpu")
    for a, b in zip(m1.parameters(), m2.parameters()):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    with pytest.raises(ValueError, match="paths differ"):
        interop.params_from_numpy(tcfg, {"embed/embedding": as_f32[
            "embed/embedding"]}, "cpu")

    jopt = jax_gwt(lr=0.01, impl="interpret")
    js = jopt.init(jp)
    g = jax.tree.map(lambda p: jnp.ones_like(p) * 0.01, jp)
    jp1, js1 = jopt.update(g, js, jp)
    topt = gwt(lr=0.01)
    tstate = interop.state_from_numpy(flat_numpy(js1), "cpu")
    tmodel = interop.params_from_numpy(tcfg, flat_numpy(jp1), "cpu")
    tree = tmodel.tree()
    want = topt.init(tree)
    assert sorted(flatten_with_paths(tstate)[0]) == \
        sorted(flatten_with_paths(want)[0])
    tg = {k: torch.full_like(v, 0.01) for k, v in
          zip(*flatten_with_paths(tree))}
    tree, _ = topt.update(unflatten(list(tg), list(tg.values())), tstate,
                          tree)
    jp2, _ = jopt.update(g, js1, jp1)
    want2 = flat_numpy(jp2)
    for path, t in zip(*flatten_with_paths(tree)):
        assert bf16_spacings(t, want2[path]) <= 1, path


def test_launcher_runs_on_cpu_when_asked():
    before = kernel.launches
    res = train.main(["--smoke", "--steps", "4", "--batch", "4", "--seq",
                      "16", "--log-every", "2", "--device", "cpu"])
    assert len(res.losses) == 4 and np.all(np.isfinite(res.losses))
    assert kernel.launches == before
    assert int(res.opt_state["step"]) == 4


def test_launcher_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--smoke", "--steps", "1"])
