"""The port's twin of the diagonal of ``tests/test_scenario_matrix.py``
for the recurrent and encoder-decoder substrates: the recurrent-leaf
eligibility cases, the recurrent leaves taking the plain rule end to end
through ``gwt``, and one GWT-2 cell per substrate (``ssm``, ``xlstm``,
``encdec`` at the reference's ``SUBSTRATE_ARCH`` sizes, the JAX package's
parameters) per codec: one update from a real gradient of the port's
loss, bucketed equal to unrolled, a checkpoint save/restore continuing
bitwise, and the f32 update against the JAX package's on the same
gradient.

Tolerances.  Inside the port bucketed and unrolled give bitwise the same
parameters and moments; the limiter's stored norm ``prev_norm`` is held
within 4 f32 spacings (measured 3: the unrolled rule sums ``‖G̃‖²`` in
``torch.linalg.vector_norm``'s order, the fused write in the kernels'
chunk order), as the reference holds its own GWT-2 cell with a
tolerance.  A resume is bitwise.  Against the JAX package's fused path
(its Pallas kernels in interpret mode, jitted), f32 moments: the
parameters within 4 f32 spacings of their largest magnitude, the
reference's own rule for its terminal write (DESIGN.md §11; measured 0.5,
on an f32 leaf; the bf16 leaves bitwise).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import flat_numpy, spacings, to_numpy
from test_scenario_matrix import SUBSTRATE_ARCH

from repro import configs as jconfigs, optim as joptim
from repro.models import encdec as jencdec, lm as jlm
from repro.optim.base import flatten_with_paths as jax_flatten
from repro_torch import configs, interop, optim
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.models import encdec, lm
from repro_torch.optim.base import (default_eligible, flatten_with_paths,
                                    unflatten)

SUBSTRATES = ("ssm", "xlstm", "encdec")


@pytest.mark.parametrize("path,shape,eligible", [
    ("layers/b0/mixer/x_proj", (32, 20), False),
    ("layers/b0/mixer/dt_proj", (4, 32), False),
    ("layers/b0/mixer/w_igate", (32, 2), False),
    ("layers/b0/mixer/w_fgate", (32, 2), False),
    ("layers/b0/cell/r", (2, 16, 64), False),
    ("layers/b0/mixer/wq", (32, 32), True),
    ("layers/b0/ffn/w_gate", (32, 64), True),  # 'gate' != 'igate'/'fgate'
    ("layers/b0/moe/w_up", (4, 32, 64), True),
])
def test_recurrent_leaf_eligibility(path, shape, eligible):
    assert default_eligible(path, torch.empty(shape, device="meta")) \
        is eligible


@functools.lru_cache(maxsize=None)
def _port(name):
    """A substrate at the reference's ``SUBSTRATE_ARCH`` size: the JAX
    package's parameters, the port's model holding them, and two real
    gradients of the port's loss on numpy batches (B 2, S 16; the
    encoder-decoder's with 4 frames a row)."""
    arch, kw = SUBSTRATE_ARCH[name]
    jcfg = jconfigs.get_smoke(arch).with_(**kw)
    tcfg = configs.get_smoke(arch).with_(**kw)
    enc = tcfg.arch_class == "encdec"
    jparams = (jencdec if enc else jlm).init(jcfg, jax.random.key(0))
    model = interop.params_from_numpy(tcfg, flat_numpy(jparams), "cpu")
    paths, leaves = flatten_with_paths(model.tree())
    grads = []
    for seed in (0, 1):
        rng = np.random.RandomState(100 + seed)
        toks = rng.randint(0, tcfg.vocab, (2, 16))
        batch = {"tokens": torch.from_numpy(toks),
                 "labels": torch.from_numpy(np.roll(toks, -1, axis=1))}
        if enc:
            batch["enc_embeds"] = torch.from_numpy(
                (0.1 * rng.randn(2, 4, tcfg.d_model)).astype(np.float32))
        loss = (encdec if enc else lm).loss_fn(tcfg, model.tree(), batch)
        grads.append(unflatten(paths, list(torch.autograd.grad(loss,
                                                               leaves))))
    return tcfg, jparams, model, grads


def _jax_tree(like, tree):
    """The port's tree as a JAX tree shaped and typed like ``like``."""
    flat = dict(zip(*flatten_with_paths(tree)))
    jpaths, jleaves, treedef = jax_flatten(like)
    return jax.tree.unflatten(treedef, [
        jnp.asarray(to_numpy(flat[p])).astype(l.dtype)
        for p, l in zip(jpaths, jleaves)])


@pytest.mark.parametrize("substrate", ["ssm", "xlstm"])
def test_recurrent_leaves_get_plain_rule_end_to_end(substrate):
    """Every denied recurrent leaf (``x_proj``, ``dt_proj``, the gates,
    sLSTM's ``r``) lands in a plain bucket, and a wavelet bucket
    exists."""
    _, _, model, _ = _port(substrate)
    plan = optim.make("gwt", lr=0.01, level=2).engine.plan(model.tree())
    kinds = {p: b.rule.kind for b in plan.buckets for p in b.paths}
    denied = [p for p in kinds
              if any(s in p for s in ("x_proj", "dt_proj", "igate", "fgate"))
              or p.rsplit("/", 1)[-1] == "r"]
    assert denied
    for p in denied:
        assert kinds[p] == "plain", f"{p} routed to {kinds[p]}"
    assert any(k.startswith("gwt_") for k in kinds.values())


def _clone(tree):
    paths, leaves = flatten_with_paths(tree)
    return unflatten(paths, [l.detach().clone() for l in leaves])


def _assert_equal(a, b, what):
    pa, la = flatten_with_paths(a)
    pb, lb = flatten_with_paths(b)
    assert pa == pb, what
    for p, x, y in zip(pa, la, lb):
        assert torch.equal(x, y), f"{what}: {p}"


@pytest.mark.parametrize("codec", ["f32", "int8"])
@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_gwt2_cell(substrate, codec, tmp_path):
    tcfg, jparams, model, (g1, g2) = _port(substrate)
    make = lambda bucketed: optim.make(  # noqa: E731
        "gwt", lr=0.01, level=2, state_codec=codec, bucketed=bucketed)
    ob, ou = make(True), make(False)
    params = model.tree()

    # bucketed == unrolled on one real-gradient update
    pb1, sb1 = ob.update(g1, ob.init(_clone(params)), _clone(params))
    pu1, su1 = ou.update(g1, ou.init(_clone(params)), _clone(params))
    _assert_equal(pu1, pb1, f"{substrate}/{codec} params")
    paths, ub = flatten_with_paths(su1)
    assert paths == flatten_with_paths(sb1)[0]
    for p, x, y in zip(paths, ub, flatten_with_paths(sb1)[1]):
        if p.endswith("/prev_norm"):
            assert spacings(x, y) <= 4, p
        else:
            assert torch.equal(x, y), p

    if codec == "f32":
        jopt = joptim.make("gwt", lr=0.01, level=2, impl="interpret")
        jp1, _ = jax.jit(jopt.update)(_jax_tree(jparams, g1),
                                      jopt.init(jparams), jparams)
        want = flat_numpy(jp1)
        for p, t in zip(*flatten_with_paths(pb1)):
            assert spacings(t, want[p]) <= 4, p

    # resume bitwise: save/restore mid-run, continue == continuous
    pb2, sb2 = ob.update(g2, _clone(sb1), _clone(pb1))
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"params": pb1, "opt": sb1}, blocking=True)
    restored, step = cm.restore(None, {"params": pb1, "opt": sb1})
    assert step == 1
    pr2, sr2 = ob.update(g2, restored["opt"], restored["params"])
    _assert_equal(pr2, pb2, f"{substrate}/{codec} resume params")
    _assert_equal(sr2, sb2, f"{substrate}/{codec} resume state")


def _raw(a) -> np.ndarray:
    """A JAX leaf as stored: bf16 as its uint16 bits."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("arch,leaves", [
    ("jamba-v0.1-52b", ("layers/b0/mixer/a_log", "layers/b0/mixer/d_skip",
                        "layers/b0/mixer/conv_w", "layers/b1/ffn/router")),
    ("xlstm-350m", ("layers/b7/mixer/r", "layers/b0/mixer/b_fgate",
                    "layers/b0/mixer/out_norm")),
    ("seamless-m4t-large-v2", ("encoder/attn/wq", "enc_norm",
                               "decoder/cross_attn/wv", "decoder/norm_x")),
])
def test_jax_trees_carry_over(arch, leaves, tmp_path):
    """The new leaves of the three substrates: the JAX package's smoke
    parameters arrive through ``interop`` unchanged and go back bit for
    bit (bf16 as raw bits, the f32 router as f32), and a checkpoint the
    JAX package wrote restores into the port's tree bitwise
    (``CheckpointManager.restore_params``)."""
    from repro.checkpoint import manager as jmanager
    jcfg, tcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    enc = tcfg.arch_class == "encdec"
    jparams = (jencdec if enc else jlm).init(jcfg, jax.random.key(3))
    jpaths, jleaves, _ = jax_flatten(jparams)
    arrays = dict(zip(jpaths, map(_raw, jleaves)))
    assert set(leaves) <= set(arrays)
    model = interop.params_from_numpy(tcfg, arrays, "cpu")
    back = interop.state_to_numpy(model.tree())
    assert list(back) == list(jpaths)
    for p in jpaths:
        np.testing.assert_array_equal(back[p], arrays[p], err_msg=p)
    jmanager.CheckpointManager(str(tmp_path)).save(
        1, {"params": jparams}, blocking=True)
    got, step = CheckpointManager(str(tmp_path)).restore_params(
        None, (encdec if enc else lm).abstract_params(tcfg), device="cpu")
    assert step == 1
    _assert_equal(got, model.tree(), f"{arch} checkpoint")
