"""The port's data-parallel train step (``lm.make_sharded_train_step``) and
its error-feedback checkpoints against the JAX package's sharded step on a
one-device ``'data'`` mesh, on llama-60m-smoke (f32) from parameters
initialised by JAX and carried over with ``repro_torch.interop``.

Tolerances.  Fed the same f32 gradients, the port's reduced gradients and
error-feedback residues equal the reference's bitwise (the reference's
reduction run op by op; under ``jit`` XLA contracts FMAs, see
``test_torch_dp.py``).  Losses over 3 steps of training follow the f32 loop
test of ``test_torch_lm.py``: within 2e-5.  A resume inside the port is
bitwise.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import flat_numpy, port_model

from repro import configs as jconfigs
from repro.core.gwt import gwt as jax_gwt
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.distributed import compression as jc
from repro.launch import train as jtrain
from repro.launch.mesh import make_mesh_context
from repro.models import lm as jlm
from repro.optim.schedules import warmup_cosine as jax_warmup_cosine
from repro_torch import configs
from repro_torch.checkpoint import manager
from repro_torch.core.gwt import gwt
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed import compression as tc
from repro_torch.launch import train
from repro_torch.models import lm
from repro_torch.optim.base import flatten_with_paths
from repro_torch.optim.schedules import warmup_cosine

JCFG = jconfigs.get_smoke("llama-60m")
TCFG = configs.get_smoke("llama-60m")
STEPS = 3
SMOKE = ["--arch", "llama-60m", "--smoke", "--batch", "4", "--seq", "16",
         "--log-every", "1"]
EF_ARGS = ["--dp-reduce", "compressed", "--dp-detail-dtype", "float8_e4m3fn",
           "--dp-error-feedback"]


def _data():
    return JaxSyntheticLM(64, 16, 4, 0), SyntheticLM(64, 16, 4, 0)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("wire", ["bfloat16", "float8_e4m3fn"])
def test_sharded_step_tracks_reference_losses(wire, ef, accum):
    jp, model = port_model(JCFG, TCFG, seed=0)
    jspec = jc.DPReduceSpec.parse("compressed", 2, wire, ef)
    tspec = tc.DPReduceSpec.parse("compressed", 2, wire, ef)
    ctx = make_mesh_context((1,), ("data",))
    jopt = jax_gwt(lr=jax_warmup_cosine(0.01, STEPS), impl="jnp")
    jstep = jax.jit(jlm.make_train_step(JCFG, jopt, accum_steps=accum,
                                        ctx=ctx, dp_reduce=jspec))
    jstate = jopt.init(jp)
    topt = gwt(lr=warmup_cosine(0.01, STEPS))
    tstep = lm.make_train_step(TCFG, topt, accum_steps=accum,
                               dp_reduce=tspec)
    tree = model.tree()
    tstate = topt.init(tree)
    if ef:
        jstate = {"opt": jstate, "dp_ef": jc.ef_init(jp, 1)}
        tstate = {"opt": tstate, "dp_ef": tc.ef_init(tree)}
    jdata, tdata = _data()
    jlosses, tlosses = [], []
    for i in range(STEPS):
        jb = {k: jnp.asarray(v) for k, v in jdata.batch(i).items()}
        jp, jstate, jm = jstep(jp, jstate, jb)
        tb = {k: torch.from_numpy(v) for k, v in tdata.batch(i).items()}
        tree, tstate, tm = tstep(tree, tstate, tb)
        jlosses.append(float(jm["loss"]))
        tlosses.append(float(tm["loss"]))
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=2e-5)
    if ef:
        want = flat_numpy(jstate["dp_ef"])
        for path, e in zip(*flatten_with_paths(tstate["dp_ef"])):
            assert tuple(e.shape) == want[path].shape, path
        assert float(np.abs(want["layers/b0/mixer/wq"]).max()) > 0


@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("wire", ["bfloat16", "float8_e4m3fn"])
def test_same_gradients_reduce_bitwise(wire, ef):
    """The reference's gradients of llama-60m-smoke, each leaf reduced by
    ``compressed_psum_mean(_ef)`` over a one-device axis and by the
    port's ``compressed_mean(_ef)`` on one rank: equal bits, residues
    too."""
    jp = jlm.init(JCFG, jax.random.key(0))
    batch = {k: jnp.asarray(v) for k, v in _data()[0].batch(0).items()}
    grads = jax.grad(lambda p: jlm.loss_fn(JCFG, p, batch))(jp)
    rng = np.random.RandomState(1)
    kw = dict(axis_name="data", level=2, detail_dtype=jnp.dtype(wire))

    def jax_reduce(g, e):
        # a one-device 'data' axis, here the mapped axis of a vmap
        if not ef:
            return jax.vmap(functools.partial(jc.compressed_psum_mean,
                                              **kw),
                            axis_name="data")(g[None])[0], None
        mean, err = jax.vmap(functools.partial(jc.compressed_psum_mean_ef,
                                               **kw),
                             axis_name="data")(g[None], e[None])
        return mean[0], err[0]

    n_compressed = 0
    for path, g in flat_numpy(grads).items():
        e = (rng.randn(*g.shape) * 1e-4).astype(np.float32)
        with jax.disable_jit():
            want, want_err = jax_reduce(jnp.asarray(g), jnp.asarray(e))
        tg, te = torch.from_numpy(g.copy()), torch.from_numpy(e)
        if ef:
            got, got_err = tc.compressed_mean_ef(tg, te, None, 2,
                                                 getattr(torch, wire))
            np.testing.assert_array_equal(
                got_err.numpy().view(np.uint32),
                np.asarray(want_err).view(np.uint32), err_msg=path)
        else:
            got = tc.compressed_mean(tg, None, 2, getattr(torch, wire))
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want).view(np.uint32),
                                      err_msg=path)
        n_compressed += tc.compressible(g.shape, 2)
        if not tc.compressible(g.shape, 2):
            np.testing.assert_array_equal(got.numpy(), g, err_msg=path)
    assert n_compressed == len(flat_numpy(grads)) - 1   # all but final_norm


def _jax(argv):
    return jtrain.main(SMOKE + ["--kernel-impl", "jnp", "--shard-params",
                                "none"] + argv)


def _port(argv):
    return train.main(SMOKE + argv + ["--device", "cpu"])


def _manifest_layout(d, step):
    return [(m["shape"], m["dtype"]) for m in
            manager.CheckpointManager(d).manifest(step)["leaves"]]


def test_jax_error_feedback_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX launcher trains 4 steps of fp8 error feedback, checkpointing
    at 2 and 4; the port resumes its step 2 and tracks its steps 3-4; the
    port's own step-4 checkpoint has the JAX one's leaves."""
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    _, _, jlosses = _jax(["--steps", "4", "--ckpt-dir", jd, "--ckpt-every",
                          "2"] + EF_ARGS)
    _port(["--steps", "4", "--ckpt-dir", td, "--ckpt-every", "2"] + EF_ARGS)
    assert _manifest_layout(td, 4) == _manifest_layout(jd, 4)
    embed = list(lm.abstract_params(TCFG)["embed"]["embedding"].shape)
    assert _manifest_layout(jd, 4)[0] == ([1, *embed], "float32")  # dp_ef
    os.rename(os.path.join(jd, "step_000000004"), str(tmp_path / "later"))
    res = _port(["--steps", "4", "--ckpt-dir", jd, "--resume"] + EF_ARGS)
    assert res.start_step == 2 and len(res.losses) == 2
    assert int(res.opt_state["opt"]["step"]) == 4
    np.testing.assert_allclose(res.losses, jlosses[2:], rtol=0, atol=2e-5)


def test_port_error_feedback_checkpoint_resumes_in_jax(tmp_path):
    """The port trains 2 steps and checkpoints; the JAX launcher resumes it
    and its steps 3-4 track the port's straight 4 steps."""
    d = str(tmp_path / "ck")
    _port(["--steps", "2", "--ckpt-dir", d] + EF_ARGS)
    straight = _port(["--steps", "4"] + EF_ARGS)
    _, jstate, jlosses = _jax(["--steps", "4", "--ckpt-dir", d, "--resume"]
                              + EF_ARGS)
    assert int(jstate["opt"]["step"]) == 4
    np.testing.assert_allclose(jlosses, straight.losses[2:], rtol=0,
                               atol=2e-5)


def test_error_feedback_resume_inside_the_port_is_bitwise(tmp_path):
    d = str(tmp_path / "ck")
    straight = _port(["--steps", "4"] + EF_ARGS)
    first = _port(["--steps", "2", "--ckpt-dir", d] + EF_ARGS)
    resumed = _port(["--steps", "4", "--ckpt-dir", d, "--resume"] + EF_ARGS)
    assert resumed.start_step == 2
    assert first.losses + resumed.losses == straight.losses
    for a, b in ((resumed.params, straight.params),
                 (resumed.opt_state, straight.opt_state)):
        pa, la = flatten_with_paths(a)
        pb, lb = flatten_with_paths(b)
        assert pa == pb
        for path, x, y in zip(pa, la, lb):
            assert x.dtype == y.dtype and torch.equal(x, y), path
