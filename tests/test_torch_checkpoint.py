"""Checkpoints, resume and SIGTERM in the port (``repro_torch.checkpoint``,
``repro_torch.runtime.fault_tolerance``, ``repro_torch.launch.train``),
held against the JAX package's checkpoint format and resume path on
llama-60m-smoke with int8 state.

Tolerances: inside the port a resume is bitwise.  Across the packages a
checkpoint's bytes carry over exactly, and a transcode of equal f32 moments
gives equal codes and scales (the quantizer is exact arithmetic).  Losses
after a JAX checkpoint is resumed in the port follow the rule of
``test_torch_gwt_q8.py``: 2e-5 for the first 3 steps from equal state.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import flat_numpy

from repro import configs as jconfigs
from repro.checkpoint import manager as jmanager
from repro.core.gwt import gwt as jax_gwt
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro.optim import engine as jengine
from repro_torch import configs, interop
from repro_torch.checkpoint import manager
from repro_torch.core.gwt import gwt
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train
from repro_torch.models import lm
from repro_torch.optim.base import flatten_with_paths
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.runtime.fault_tolerance import TrainLoop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = ["--arch", "llama-60m", "--smoke", "--batch", "4", "--seq", "16",
         "--log-every", "2"]


def _port(argv):
    return train.main(SMOKE + argv + ["--device", "cpu"])


def _flat(tree):
    return dict(zip(*flatten_with_paths(tree)))


def _assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for path in fa:
        assert fa[path].dtype == fb[path].dtype, path
        assert torch.equal(fa[path], fb[path]), path


def test_dtypes_round_trip_between_packages(tmp_path):
    """Every leaf dtype of a training checkpoint (bf16 parameters, f32,
    int8 codes, the uint32 key, the int32 step) written by one package
    is read by the other with the same bits."""
    rng = np.random.RandomState(0)
    tree = {"opt": {"codec_key": torch.tensor(2**32 - 3,
                                              dtype=torch.uint32),
                    "q": torch.from_numpy(rng.randint(-127, 128, (3, 70))
                                          .astype(np.int8)),
                    "scale": torch.from_numpy(rng.rand(2).astype(
                        np.float32)),
                    "step": torch.tensor(7, dtype=torch.int32)},
            "params": {"w": torch.from_numpy(rng.randn(4, 6).astype(
                np.float32)).to(torch.bfloat16)}}
    ours = manager.CheckpointManager(str(tmp_path / "port"))
    ours.save(7, tree)
    ours.wait()
    like = jax.tree.map(
        lambda t: jax.ShapeDtypeStruct(
            tuple(t.shape), jnp.dtype(manager.to_numpy(t)[1])), tree)
    got, step = jmanager.CheckpointManager(str(tmp_path / "port")).restore(
        None, like)
    assert step == 7
    for path, t in _flat(tree).items():
        want = manager.to_numpy(t)[0]
        leaf = got
        for k in path.split("/"):
            leaf = leaf[k]
        assert str(leaf.dtype) == manager.to_numpy(t)[1], path
        np.testing.assert_array_equal(
            np.asarray(leaf).view(want.dtype), want, err_msg=path)

    theirs = jmanager.CheckpointManager(str(tmp_path / "jax"))
    theirs.save(9, jax.tree.map(
        lambda t: jnp.asarray(manager.to_numpy(t)[0]).view(
            manager.to_numpy(t)[1]) if t.dtype == torch.bfloat16
        else jnp.asarray(manager.to_numpy(t)[0]), tree), blocking=True)
    back, step = manager.CheckpointManager(str(tmp_path / "jax")).restore(
        None, tree)
    assert step == 9
    _assert_trees_equal(back, tree)


def test_restore_refuses_another_layout(tmp_path):
    ck = manager.CheckpointManager(str(tmp_path))
    ck.save(1, {"a": torch.zeros(3), "b": torch.zeros(2)}, blocking=True)
    with pytest.raises(manager.StructureMismatch, match="leaves"):
        ck.restore(None, {"a": torch.zeros(3)})
    with pytest.raises(manager.StructureMismatch, match="shape"):
        ck.restore(None, {"a": torch.zeros(4), "b": torch.zeros(2)})


def test_save_copies_before_returning(tmp_path):
    """An asynchronous save holds a host copy: writing the tensors in place
    right after ``save`` returns does not reach the checkpoint."""
    ck = manager.CheckpointManager(str(tmp_path), gc_keep=2)
    t = torch.arange(6, dtype=torch.float32)
    for step in (1, 2, 3):
        ck.save(step, {"t": t})
        t.add_(100.0)
    ck.wait()
    assert ck.committed_steps() == [2, 3]
    got, _ = ck.restore(2, {"t": t})
    np.testing.assert_array_equal(got["t"].numpy(), np.arange(6) + 100.0)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX launcher trains 8 int8 steps, checkpointing at 4 and 8; the
    port's launcher resumes from its step-4 checkpoint and its steps 5-8
    track the JAX run's."""
    d = str(tmp_path / "ck")
    _, _, jlosses = jtrain.main(SMOKE + [
        "--steps", "8", "--state-codec", "int8", "--ckpt-dir", d,
        "--ckpt-every", "4", "--kernel-impl", "jnp"])
    ck = manager.CheckpointManager(d)
    assert ck.committed_steps() == [4, 8]
    assert ck.saved_run()["state_codec"] == "int8"
    os.rename(os.path.join(d, "step_000000008"), str(tmp_path / "later"))
    res = _port(["--steps", "8", "--state-codec", "int8", "--ckpt-dir", d,
                 "--resume"])
    assert res.start_step == 4 and len(res.losses) == 4
    assert int(res.opt_state["step"]) == 8
    np.testing.assert_allclose(res.losses[:3], jlosses[4:7], rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(res.losses, jlosses[4:], rtol=0, atol=1e-3)


def test_port_checkpoint_restores_in_jax(tmp_path):
    """A checkpoint the port's launcher writes is read by the JAX
    package's ``CheckpointManager.restore`` with the same values."""
    d = str(tmp_path / "ck")
    res = _port(["--steps", "4", "--state-codec", "int8", "--ckpt-dir", d])
    jcfg = jconfigs.get_smoke("llama-60m")
    jparams = jax.eval_shape(lambda: jlm.init(jcfg, jax.random.key(0)))
    jopt = jax_gwt(lr=0.01, impl="jnp", state_codec="int8")
    like = {"params": jparams, "opt": jax.eval_shape(jopt.init, jparams)}
    got, step = jmanager.CheckpointManager(d).restore(None, like)
    assert step == 4
    want = {**{f"params/{k}": v for k, v in _flat(res.params).items()},
            **{f"opt/{k}": v for k, v in _flat(res.opt_state).items()}}
    gflat = flat_numpy(got)
    assert sorted(gflat) == sorted(want)
    for path, t in want.items():
        np.testing.assert_array_equal(gflat[path], t.detach().numpy(),
                                      err_msg=path)


def _loop_run(params, state, opt, start, stop, ckpt=None):
    cfg = configs.get_smoke("llama-60m")
    loop = TrainLoop(lm.make_train_step(cfg, opt),
                     SyntheticLM(cfg.vocab, 16, 4, 0), device="cpu",
                     ckpt=ckpt, ckpt_every=4, log_every=2,
                     log=lambda s: None)
    return loop.run(params, state, start_step=start, num_steps=stop)


def test_resume_inside_the_port_is_bitwise(tmp_path):
    """8 straight int8 steps equal 4 steps + checkpoint + a fresh restore +
    4 steps, bitwise: parameters, codes, scales, norms, key and step."""
    cfg = configs.get_smoke("llama-60m")

    def fresh():
        model = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
        opt = gwt(warmup_cosine(0.01, 8), state_codec="int8")
        tree = model.tree()
        return tree, opt.init(tree), opt

    tree, state, opt = fresh()
    p8, s8, l8 = _loop_run(tree, state, opt, 0, 8)

    ck = manager.CheckpointManager(str(tmp_path))
    tree, state, opt = fresh()
    _, _, l4 = _loop_run(tree, state, opt, 0, 4, ckpt=ck)
    assert ck.committed_steps() == [4]

    tree, state, opt = fresh()
    restored, step = ck.restore(None, {"params": tree, "opt": state})
    assert step == 4
    params = lm.LM(cfg, restored["params"]).tree()
    p, s, l_rest = _loop_run(params, restored["opt"], opt, 4, 8)
    assert l4 + l_rest == l8
    _assert_trees_equal(p, p8)
    _assert_trees_equal(s, s8)


def test_f32_checkpoint_transcodes_like_reference(tmp_path):
    """Resuming an f32 checkpoint with ``--state-codec int8`` transcodes
    the state to exactly what the JAX package's ``engine.transcode`` makes
    of the same checkpoint."""
    d = str(tmp_path / "ck")
    _port(["--steps", "4", "--ckpt-dir", d])
    jcfg = jconfigs.get_smoke("llama-60m")
    jparams = jax.eval_shape(lambda: jlm.init(jcfg, jax.random.key(0)))
    f32_opt = jax_gwt(lr=0.01, impl="jnp")
    int8_opt = jax_gwt(lr=0.01, impl="jnp", state_codec="int8")
    like = {"params": jparams, "opt": jax.eval_shape(f32_opt.init, jparams)}
    state, _ = jmanager.CheckpointManager(d).restore(4, like)
    want = flat_numpy(jengine.transcode(state["opt"], state["params"],
                                        f32_opt, int8_opt))
    # with nothing left to train, the resumed run only transcodes (and
    # saves its final step in the int8 layout)
    res = _port(["--steps", "4", "--state-codec", "int8", "--ckpt-dir", d,
                 "--resume"])
    assert res.start_step == 4 and res.losses == []
    got = interop.state_to_numpy(res.opt_state)
    assert sorted(got) == sorted(want)
    assert any(p.endswith("/q") for p in got)
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)


def test_resume_refuses_another_data_stream(tmp_path):
    """The manifest records the data source and its order seed; resuming
    with another ``--seed`` would train on another stream and stops."""
    d = str(tmp_path / "ck")
    _port(["--steps", "2", "--ckpt-dir", d])
    with pytest.raises(SystemExit, match="provenance"):
        _port(["--steps", "4", "--ckpt-dir", d, "--resume", "--seed", "1"])


def test_legacy_checkpoint_is_refused(tmp_path):
    """A JAX checkpoint in the legacy per-leaf optimizer layout is not
    migrated by the port: resuming it raises and says why."""
    jparams = jlm.init(jconfigs.get_smoke("llama-60m"), jax.random.key(0))
    jopt = jax_gwt(lr=0.01, impl="jnp")
    legacy = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype),
                          jopt.engine.legacy_like(jparams))
    d = str(tmp_path / "ck")
    jmanager.CheckpointManager(d, run_meta={
        "data": {"kind": "synthetic", "order_seed": 0},
        "state_codec": "f32"}).save(2, {"params": jparams, "opt": legacy},
                                    blocking=True)
    with pytest.raises(manager.StructureMismatch, match="legacy"):
        _port(["--steps", "4", "--ckpt-dir", d, "--resume"])


_SIGTERM_CHILD = """
import json, os, signal, sys
sys.path.insert(0, "src")
import torch
torch.set_num_threads(2)
from repro_torch.launch import train
from repro_torch.models import lm

make_step = lm.make_train_step

def make_train_step(*args, **kw):
    step, calls = make_step(*args, **kw), [0]

    def wrapped(params, opt_state, batch):
        calls[0] += 1
        if calls[0] == 3:     # SIGTERM while the third step runs
            os.kill(os.getpid(), signal.SIGTERM)
        return step(params, opt_state, batch)
    return wrapped

lm.make_train_step = make_train_step
res = train.main(sys.argv[1:])
print("LOSSES " + json.dumps(res.losses))
"""


def test_sigterm_saves_at_the_chunk_boundary_and_resumes_bitwise(tmp_path):
    """SIGTERM during step 3 of an 8-step run (chunks of 2): the launcher
    finishes the chunk, saves step 4 blocking and exits cleanly; a resume
    to step 8 then equals a straight 8-step run bitwise."""
    d = str(tmp_path / "ck")
    argv = SMOKE + ["--steps", "8", "--state-codec", "int8", "--device",
                    "cpu", "--ckpt-dir", d, "--ckpt-every", "100"]
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(
        _SIGTERM_CHILD), *argv], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[preempt] checkpoint@4" in r.stdout
    first = json.loads(r.stdout.split("LOSSES ")[1])
    assert len(first) == 4
    ck = manager.CheckpointManager(d)
    assert ck.committed_steps() == [4]

    resumed = train.main(argv + ["--resume"])
    straight = train.main(SMOKE + ["--steps", "8", "--state-codec", "int8",
                                   "--device", "cpu"])
    assert first + resumed.losses == straight.losses
    _assert_trees_equal(resumed.params, straight.params)
    _assert_trees_equal(resumed.opt_state, straight.opt_state)
