"""The port's four example drivers (``repro_torch.examples``) against the
repository's ``examples/*.py`` on the CPU, at a few steps and a tiny batch:

* ``compare_optimizers``: the constants and methods are the reference's;
  each method's state-MiB column equals the reference's
  ``state_memory_bytes``; Adam, GWT-2 and GaLore, started from the JAX
  package's parameters, give the reference loop's losses;
* ``quickstart``: the exact state MiB equal the JAX package's
  ``engine.state_bytes``;
* ``serve_batched``: the greedy tokens over the caches equal the full
  forward's argmax, the prompt as long as the window included; an
  encoder-decoder arch is refused;
* ``pretrain``: the launcher gets the reference's arguments, and
  ``--device``.

Tolerance of the losses: 3 steps (the first at the warmup's lr of 0) of
the examples' bf16 model, the port on its fused paths and the reference on
its own.  The bf16 forward alone puts the first loss (about 247) 0.0245
apart (about 800 f32 spacings; ``test_torch_dense.py`` allows 8192 for a
bf16 model's loss), and after an update the bf16 parameters round apart
where a move lands near a rounding boundary: within 1e-3 relative
(measured 5.2e-4, GWT-2's third loss).
"""

import importlib.util
import os
import sys

import jax
import numpy as np
import pytest
import torch

from torch_parity import flat_numpy, jax_params

from repro import optim as jax_optim
from repro.data.pipeline import make_source as jax_make_source
from repro.models import lm as jlm
from repro.optim.engine import state_bytes as jax_state_bytes
from repro.optim.schedules import warmup_cosine as jax_warmup_cosine
from repro.runtime.fault_tolerance import TrainLoop as JaxTrainLoop
from repro_torch import configs, interop
from repro_torch.examples import (compare_optimizers, pretrain, quickstart,
                                  serve_batched)
from repro_torch.launch import train as train_cli
from repro_torch.models import lm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, BATCH, SEQ = 3, 2, 32
LOSS_RTOL = 1e-3


def _reference(name):
    """The reference's ``examples/<name>.py`` as a module (not run)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", os.path.join(REPO, "examples",
                                                  f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_COMPARE = _reference("compare_optimizers")
REF_QUICK = _reference("quickstart")
REF_PRETRAIN = _reference("pretrain")


def _cfg_fields(cfg):
    return {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}


def test_constants_are_the_reference_ones():
    assert _cfg_fields(quickstart.CFG) == _cfg_fields(REF_QUICK.CFG)
    assert _cfg_fields(compare_optimizers.CFG) \
        == _cfg_fields(REF_COMPARE.CFG)
    assert quickstart.STEPS == REF_QUICK.STEPS
    assert compare_optimizers.METHODS == REF_COMPARE.METHODS


def test_state_column_equals_reference_for_every_method():
    jparams = jlm.abstract_params(REF_COMPARE.CFG)
    params = quickstart.init_params("cpu")
    tags = []
    for name, kw in compare_optimizers.METHODS:
        row = compare_optimizers.run_method(name, kw, 1, "cpu",
                                            params=params, batch=BATCH,
                                            seq=SEQ)
        level = kw.get("level", 0) if name == "gwt" else 0
        host = kw.get("host", "adam") if name == "gwt" else "adam"
        assert row.state_bytes == REF_COMPARE.state_memory_bytes(
            jparams, level, host=host)["total_bytes"], row.tag
        assert len(row.losses) == 1 and np.isfinite(row.final_loss)
        tags.append(row.tag)
    assert len(set(tags)) == len(compare_optimizers.METHODS)


def _jax_losses(name, kw, steps):
    kw = dict(kw)
    lr = 0.01 * kw.pop("lr_scale", 1.0)
    jp = jax_params(REF_COMPARE.CFG)
    opt = jax_optim.make(name, lr=jax_warmup_cosine(lr, steps), **kw)
    data = jax_make_source("synthetic", REF_COMPARE.CFG.vocab, SEQ, BATCH)
    loop = JaxTrainLoop(jax.jit(jlm.make_train_step(REF_COMPARE.CFG, opt)),
                        None, data, log_every=10**9, log=lambda s: None)
    return loop.run(jp, opt.init(jp), num_steps=steps)[2]


@pytest.mark.parametrize("method", [0, 2, 5], ids=["adam", "galore",
                                                   "gwt-2"])
def test_losses_track_the_reference_loop(method):
    name, kw = compare_optimizers.METHODS[method]
    want = _jax_losses(name, kw, STEPS)
    params = interop.params_from_numpy(
        quickstart.CFG, flat_numpy(jax_params(REF_COMPARE.CFG)),
        "cpu").tree()
    row = compare_optimizers.run_method(name, kw, STEPS, "cpu",
                                        params=params, batch=BATCH, seq=SEQ)
    assert len(row.losses) == len(want) == STEPS
    np.testing.assert_allclose(row.losses, want, rtol=LOSS_RTOL, atol=0)
    assert row.losses[2] != row.losses[1]


@pytest.mark.parametrize("name,kw", quickstart.METHODS)
def test_quickstart_state_bytes_equal_reference(name, kw):
    loss, mib = quickstart.run(name, "cpu", steps=1, batch=BATCH, seq=SEQ,
                               log=lambda s: None, **kw)
    jparams = jlm.abstract_params(REF_QUICK.CFG)
    jopt = jax_optim.make(name, lr=0.01, **kw)
    assert mib == REF_QUICK.state_bytes(jopt, jparams) / 2**20
    assert mib == jax_state_bytes(jopt, jparams) / 2**20
    assert np.isfinite(loss)


def test_serve_batched_cross_check(capsys):
    """The default arch (gemma2-9b's smoke config, window 32) at the default
    prompt of 32: the full-attention blocks' prompt caches are as deep as
    the ring buffers, and ``launch.serve.generate`` grows them anyway."""
    match = serve_batched.main(["--device", "cpu"])
    assert match == 1.0
    assert "OK" in capsys.readouterr().out
    cfg = configs.get_smoke("llama-60m")
    gen = torch.Generator().manual_seed(1)
    params = lm.init(cfg, gen, "cpu").tree()
    tokens = torch.randint(0, cfg.vocab, (2, 12), generator=gen,
                           dtype=torch.int32)
    out, match = serve_batched.run(cfg, params, tokens, 5)
    assert out.shape == (2, 5) and match == 1.0


def test_serve_batched_refuses_encoder_decoder():
    with pytest.raises(SystemExit, match="decoder-only"):
        serve_batched.main(["--arch", "seamless-m4t-large-v2",
                            "--device", "cpu"])


def test_pretrain_forwards_the_reference_arguments(monkeypatch, tmp_path):
    got, want = [], []
    monkeypatch.setattr(train_cli, "main", got.append)
    monkeypatch.setattr(REF_PRETRAIN.train_cli, "main", want.append)
    flags = ["--model", "llama-60m", "--steps", "7", "--batch", "4",
             "--seq", "64", "--level", "3", "--ckpt-dir", str(tmp_path)]
    monkeypatch.setattr(sys, "argv", ["pretrain.py", *flags])
    REF_PRETRAIN.main()
    pretrain.main(flags + ["--device", "cpu"])
    assert got == [want[0] + ["--device", "cpu"]]
    # the defaults: llama-130m, 300 steps of 16 x 256, a checkpoint every
    # 100 steps under the temporary directory, on the card
    argv = pretrain.launcher_argv([])
    assert argv[argv.index("--arch") + 1] == "llama-130m"
    assert argv[argv.index("--device") + 1] == "cuda"
    assert argv[argv.index("--ckpt-every") + 1] == "100"

