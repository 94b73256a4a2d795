"""Resume paths of the port's launcher beyond its own checkpoints: a JAX
checkpoint in the legacy per-leaf optimizer layout is migrated (and
transcoded) exactly as the reference does it, and a ``--data corpus`` run
resumes bitwise on its own corpus, with another worker count, and refuses
a corpus of another content hash.

No tolerance: migration only regroups values, and the f32 -> int8
transcode of equal moments gives equal codes and scales.
"""

import os

import jax
import numpy as np
import pytest
import torch

from torch_parity import flat_numpy, jax_legacy_checkpoint

from repro.checkpoint import manager as jmanager
from repro.core.gwt import gwt as jax_gwt
from repro.optim import engine as jengine
from repro_torch import configs, interop
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.gwt import gwt
from repro_torch.data import build_corpus
from repro_torch.launch import train
from repro_torch.models import lm
from repro_torch.optim.base import flatten_with_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_GLOB = os.path.join(REPO, "tests", "fixtures", "corpus", "*.txt")
SMOKE = ["--arch", "llama-60m", "--smoke", "--batch", "4", "--seq", "32",
         "--log-every", "2", "--device", "cpu"]


def _assert_numpy_equal(got, want):
    assert sorted(got) == sorted(want)
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)


@pytest.mark.parametrize("codec", ["f32", "int8"])
def test_legacy_checkpoint_migrates_like_reference(tmp_path, codec):
    """The launcher's ``--resume`` of a JAX legacy checkpoint: the state is
    the reference's ``migrate_legacy`` (then ``transcode`` f32 -> int8
    under ``--state-codec int8``) bitwise, the parameters are the saved
    ones, and the run trains on and saves in the bucketed layout, which a
    second resume reads as an ordinary checkpoint."""
    d = str(tmp_path / "ck")
    jparams, jopt, _ = jax_legacy_checkpoint(d)
    like = {"params": jparams, "opt": jopt.engine.legacy_like(jparams)}
    saved, _ = jmanager.CheckpointManager(d).restore(2, like)
    want = jopt.engine.migrate_legacy(saved["opt"], jparams)
    if codec == "int8":
        want = jengine.transcode(want, jparams, jopt,
                                 jax_gwt(lr=0.01, impl="jnp",
                                         state_codec="int8"))
    argv = SMOKE + ["--ckpt-dir", d, "--resume", "--state-codec", codec]
    res = train.main(argv + ["--steps", "2"])
    assert res.start_step == 2 and res.losses == []
    _assert_numpy_equal(interop.state_to_numpy(res.opt_state),
                        flat_numpy(want))
    _assert_numpy_equal(interop.state_to_numpy(res.params),
                        flat_numpy(saved["params"]))
    more = train.main(argv + ["--steps", "4"])
    assert more.start_step == 2 and len(more.losses) == 2
    assert np.all(np.isfinite(more.losses))
    again = train.main(argv + ["--steps", "4"])
    assert again.start_step == 4 and again.losses == []


def test_engine_legacy_layout_round_trips_like_reference(tmp_path):
    """The port's ``to_legacy`` flattens to the reference's legacy leaves
    in the same order; saved by the port's manager and restored into
    ``legacy_like``, ``migrate_legacy`` gives back the state bitwise."""
    jparams, jopt, jstate = jax_legacy_checkpoint(str(tmp_path / "j"))
    cfg = configs.get_smoke("llama-60m")
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu").tree()
    opt = gwt(lr=0.01)
    state = interop.state_from_numpy(flat_numpy(jstate), "cpu")
    legacy = opt.engine.to_legacy(state, params)
    got = flatten_with_paths(legacy)[1]
    want = jax.tree.leaves(jopt.engine.to_legacy(jstate, jparams))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    like = opt.engine.legacy_like(params)
    assert [tuple(t.shape) for t in flatten_with_paths(like)[1]] == \
        [tuple(t.shape) for t in got]
    assert {t.device.type for t in flatten_with_paths(like)[1]} == {"meta"}
    ck = CheckpointManager(str(tmp_path / "p"))
    ck.save(2, {"params": params, "opt": legacy}, blocking=True)
    restored, _ = ck.restore(None, {"params": params, "opt": like},
                             device="cpu")
    back = opt.engine.migrate_legacy(restored["opt"], params)
    _assert_numpy_equal(interop.state_to_numpy(back),
                        interop.state_to_numpy(state))


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Two BPE-512 builds of the fixture text with other eval tails: the
    same vocab, other content hashes."""
    out = []
    for frac in (0.05, 0.1):
        d = tmp_path_factory.mktemp("corpus")
        build_corpus.build(FIXTURE_GLOB, str(d), tokenizer_kind="bpe",
                           vocab_size=512, eval_fraction=frac)
        out.append(str(d))
    return out


def test_corpus_resume_is_bitwise_and_refuses_another_corpus(tmp_path,
                                                             corpora):
    """4 straight steps on a corpus equal 2 steps + checkpoint + a resume
    to 4 with another worker count, bitwise; the manifest records the
    corpus hash, and a resume on the other corpus stops."""
    a, b = corpora
    base = SMOKE + ["--data", "corpus", "--eval-every", "2",
                    "--eval-batches", "1"]
    straight = train.main(base + ["--corpus-dir", a, "--steps", "4"])
    d = str(tmp_path / "ck")
    ck = ["--ckpt-dir", d, "--ckpt-every", "2"]
    first = train.main(base + ck + ["--corpus-dir", a, "--steps", "2"])
    run = CheckpointManager(d).saved_run()
    assert run["data"]["corpus_hash"] == \
        build_corpus.store_lib.TokenStore(a).corpus_hash
    with pytest.raises(SystemExit, match="corpus_hash"):
        train.main(base + ck + ["--corpus-dir", b, "--steps", "4",
                                "--resume"])
    resumed = train.main(base + ck + ["--corpus-dir", a, "--steps", "4",
                                      "--resume", "--workers", "2"])
    assert resumed.start_step == 2
    assert first.losses + resumed.losses == straight.losses
    assert list(first.evals) + list(resumed.evals) == list(straight.evals)
    for x, y in zip(flatten_with_paths(resumed.params)[1],
                    flatten_with_paths(straight.params)[1]):
        assert torch.equal(x, y)
