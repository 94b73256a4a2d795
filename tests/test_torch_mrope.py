"""M-RoPE of the port (``repro_torch.models.rope.mrope_angles``, the
``mrope_positions`` batch key through ``lm``) against the JAX package, with
distinct temporal, height and width position rows: with broadcast rows
M-RoPE equals RoPE, so a test that fed them would prove nothing.

Tolerances.  The angles are one f32 product per band in both packages, so
they are equal; cos/sin go through each library's f32 ``cos``/``sin``, held
to 2 f32 spacings of the largest magnitude (1 measured).  Logits, loss and
gradients of the qwen2-vl-72b smoke are held as ``tests/test_torch_dense.py``
holds the dense family: f32 8 / 4 / 32 spacings, bf16 logits 4 bf16
spacings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import bf16_spacings, flat_numpy, port_model, spacings

from repro import configs as jconfigs
from repro.models import lm as jlm, rope as jrope
from repro.optim import make as jax_make
from repro_torch import configs, optim
from repro_torch.launch.serve import pad_cache
from repro_torch.models import lm, rope
from repro_torch.optim.base import flatten_with_paths

ARCH = "qwen2-vl-72b"


def _positions(B, S, seed=0, hi=200):
    """Three distinct position rows (t, h, w), as a vision frontend would
    give them: none equals another or the text positions."""
    rng = np.random.RandomState(seed)
    pos = np.stack([np.sort(rng.randint(0, hi, (B, S)), axis=-1)
                    for _ in range(3)]).astype(np.int32)
    assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
    return pos


@pytest.mark.parametrize("sections,hd", [((2, 3, 3), 16),
                                         ((16, 24, 24), 128)])
def test_mrope_angles_match_reference(sections, hd):
    pos = _positions(2, 48)
    jc, js = jrope.mrope_angles(jnp.asarray(pos), hd, 1e6, sections)
    tc, ts = rope.mrope_angles(torch.from_numpy(pos), hd, 1e6, sections)
    assert tuple(tc.shape) == (2, 48, hd // 2)
    assert spacings(tc, jc) <= 2 and spacings(ts, js) <= 2
    # each section takes its own row: row 0 alone moves section 0 only
    moved = pos.copy()
    moved[0] += 7
    c2, _ = rope.mrope_angles(torch.from_numpy(moved), hd, 1e6, sections)
    diff = (c2 != tc).any(0).any(0)
    assert diff[:sections[0]].all() and not diff[sections[0]:].any()


def test_mrope_sections_must_cover_half_the_head():
    with pytest.raises(ValueError, match="sum to head_dim/2"):
        rope.mrope_angles(torch.zeros(3, 1, 4, dtype=torch.int32), 16, 1e4,
                          (2, 3, 2))


def _batch(seed=1, B=2, S=32):
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, 512, (B, S)).astype(np.int32),
            "labels": rng.randint(0, 512, (B, S)).astype(np.int32),
            "mrope_positions": _positions(B, S, seed)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_logits_loss_grads_match_reference(dtype):
    jcfg = jconfigs.get_smoke(ARCH).with_(dtype=dtype)
    tcfg = configs.get_smoke(ARCH).with_(dtype=dtype)
    jp, model = port_model(jcfg, tcfg)
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    jlogits = jlm.forward(jcfg, jp, jb["tokens"],
                          mrope_positions=jb["mrope_positions"])[0]
    with torch.no_grad():
        logits = model(tb["tokens"], tb["mrope_positions"])
    if dtype == "bfloat16":
        assert bf16_spacings(logits, jlogits) <= 4
        return
    assert spacings(logits, jlogits) <= 8
    jloss, jg = jax.value_and_grad(lambda p: jlm.loss_fn(jcfg, p, jb))(jp)
    tree = model.tree()
    loss = lm.loss_fn(tcfg, tree, tb)
    paths, leaves = flatten_with_paths(tree)
    grads = torch.autograd.grad(loss, leaves)
    assert spacings(loss, jloss) <= 4
    jgf = flat_numpy(jg)
    for path, g in zip(paths, grads):
        assert spacings(g, jgf[path]) <= 32, path
    # the positions matter: text positions give other logits, and the
    # broadcast text positions are what no positions give
    with torch.no_grad():
        text = model(tb["tokens"])
        bcast = model(tb["tokens"], torch.arange(32).expand(3, 2, 32))
    assert not torch.allclose(text, logits)
    assert torch.equal(text, bcast)


def test_microbatch_splits_match_reference():
    """``mrope_positions`` (3, B, S) splits on its batch axis 1, strided
    (the train step) and contiguous (the data-parallel step), as the JAX
    package's does; the other keys on axis 0."""
    b = _batch(B=4, S=8)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    for jfn, tfn in ((jlm.microbatch_split, lm.microbatch_split),
                     (jlm._contiguous_microbatches,
                      lm.contiguous_microbatches)):
        got, want = tfn(tb, 2), jfn(jb, 2)
        for k in b:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
    assert tuple(got["mrope_positions"].shape) == (2, 3, 2, 8)


def test_train_step_with_positions_matches_reference():
    """Two Adam steps with accum 2 over a batch carrying distinct
    positions: the losses within 2e-5, as the dense slice's loops."""
    jcfg = jconfigs.get_smoke(ARCH).with_(dtype="float32")
    tcfg = configs.get_smoke(ARCH).with_(dtype="float32")
    jp, model = port_model(jcfg, tcfg)
    jopt, topt = jax_make("adam", lr=1e-3), optim.make("adam", lr=1e-3)
    jstep = jax.jit(jlm.make_train_step(jcfg, jopt, accum_steps=2))
    tstep = lm.make_train_step(tcfg, topt, accum_steps=2)
    js, tree = jopt.init(jp), model.tree()
    ts = topt.init(tree)
    for i in range(2):
        b = _batch(seed=i, B=4, S=16)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tree, ts, tm = tstep(tree, ts,
                             {k: torch.from_numpy(v) for k, v in b.items()})
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 2e-5


def test_decode_matches_full_forward_with_positions():
    """Dense prefill and decode carry the positions: prefill of S-4
    tokens and 4 decode steps, each given its column of the (3, B, S)
    rows, against the train forward; f32, within 1e-4."""
    tcfg = configs.get_smoke(ARCH).with_(dtype="float32")
    params = lm.init(tcfg, torch.Generator().manual_seed(0), "cpu").tree()
    b = _batch(B=2, S=32)
    tokens = torch.from_numpy(b["tokens"])
    pos = torch.from_numpy(b["mrope_positions"])
    with torch.no_grad():
        full = lm.forward(tcfg, params, tokens, mrope_positions=pos)
    prefix = 28
    logits, cache = lm.make_prefill_step(tcfg)(
        params, {"tokens": tokens[:, :prefix],
                 "mrope_positions": pos[:, :, :prefix]})
    cache = pad_cache(cache, 32)
    np.testing.assert_allclose(logits.numpy(), full[:, prefix - 1].numpy(),
                               atol=1e-4, rtol=1e-4)
    step = lm.make_decode_step(tcfg)
    for t in range(prefix, 32):
        logits, cache = step(params, cache, {
            "tokens": tokens[:, t:t + 1],
            "mrope_positions": pos[:, :, t:t + 1]})
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=str(t))
