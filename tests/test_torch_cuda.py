"""Card-only tests of the port's CUDA kernels (marker ``cuda``).  They skip
without an NVIDIA card.  The file imports neither JAX nor the JAX package,
so it also runs where those are not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

Against the plain version on the card every output is bitwise equal:
both round at the same points, neither contracts FMAs, and the plain
version adds the per-leaf ‖G̃‖² in the kernels' order (``ref.chunk_ssq``,
``ref.leaf_norm``), so K1's p, m, v and norm, K2's p, codes, scales and
norm, and K4's and K5's outputs and ‖G̃‖² partials are held bitwise, at
three seeds where a seed could matter; K1 and K4 with bf16 moments too.
K1's and K2's one-pass design must equal their two-pass kernels bitwise on
every output, and the two-pass design the plain version at leaves of 1, 31,
33 and 1100 chunks.  The Haar DWT
kernels (K3, K6, K7) round where their plain versions round: bitwise, NaN
codes of the fp8 wire included; K3's and K6's grouped entries too, leaf by
leaf (unaligned leaves, ragged last tiles, groups of two launches), and
the grouped data-parallel reduction equals the per-leaf one.
"""

import pytest
import torch

from repro_torch.kernels.gwt_adam import kernel, ops, ref
from repro_torch.kernels.haar_dwt import kernel as haar_kernel
from repro_torch.kernels.haar_dwt import ops as haar_ops
from repro_torch.kernels.haar_dwt import ref as haar_ref
from repro_torch.optim import codec


def _bitwise(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert torch.equal(a, b), (i, int((a != b).sum()), a.numel())


# three input seeds for the checks whose old tolerance hid a sum order
SEEDS = (9, 1009, 2000009)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _inputs(dev, L=3, m=64, n=344, dtype=torch.bfloat16, seed=9):
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    return ((r(L, m, n) * 0.01).to(dtype), (r(L, m, n) * 0.02).to(dtype),
            r(L, m, n >> 2) * 1e-3,
            torch.rand(L, m, n >> 2, generator=gen, device=dev) * 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_plain_version(dtype):
    dev = _card()
    args = dict(level=2, gamma=1.01, use_limiter=True, weight_decay=True)
    # per-leaf histories: clipping, first step, not clipping
    scalars = (torch.tensor([1e-3, 0.0, 1e9], device=dev),
               torch.tensor(0.01, device=dev), torch.tensor(1e-4, device=dev))
    for seed in SEEDS:
        g, p, m, v = _inputs(dev, dtype=dtype, seed=seed)
        want = ref.gwt_adam_fused(g, p, m, v, *scalars, **args)
        outs = [kernel.gwt_adam_fused(g.clone(), p.clone(), m.clone(),
                                      v.clone(), *scalars, **args)
                for _ in range(2)]
        torch.cuda.synchronize()
        _bitwise(outs[1], outs[0])
        _bitwise(outs[0], want)


@pytest.mark.cuda
def test_entry_point_launches_the_kernel_in_place():
    dev = _card()
    g, p, m, v = _inputs(dev)
    p0 = p.clone()
    before = kernel.launches
    new_p, new_norm, st = ops.fused_write_update(
        g, p, {"m": m, "v": v}, torch.tensor(0, dtype=torch.int32,
                                             device=dev),
        torch.zeros(3, device=dev), lr_t=torch.tensor(0.01, device=dev),
        alpha=0.25, weight_decay=0.0, gamma=1.01, use_limiter=True, level=2)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert new_p.data_ptr() == p.data_ptr() and st["m"].data_ptr() == \
        m.data_ptr()
    assert not torch.equal(p, p0) and torch.isfinite(new_norm).all()


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take():
    dev = _card()
    g, p, m, v = _inputs(dev)
    scalars = (torch.zeros(3, device=dev), torch.tensor(0.01, device=dev),
               torch.tensor(0.0, device=dev))
    kw = dict(level=2, gamma=1.01, use_limiter=True, weight_decay=False)
    before = kernel.launches
    with pytest.raises(ValueError, match="contiguous"):
        kernel.gwt_adam_fused(g.transpose(1, 2).contiguous().transpose(1, 2),
                              p, m, v, *scalars, **kw)
    # f32 p is taken under a bf16 g (a LoRA adapter's, dtype code 2); f16
    # is not
    with pytest.raises(ValueError, match="dtype"):
        kernel.gwt_adam_fused(g, p.half(), m, v, *scalars, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_write_update(
            g, p.transpose(1, 2).contiguous().transpose(1, 2),
            {"m": m, "v": v}, torch.tensor(0, device=dev), scalars[0],
            lr_t=scalars[1], alpha=0.25, weight_decay=0.0, gamma=1.01,
            use_limiter=True, level=2)
    assert kernel.launches == before


def _q8_inputs(dev, L=3, m=40, n=344, dtype=torch.bfloat16, seed=5):
    """A bucket whose leaves end in a partial quantization block
    (40 * 86 = 3440 coefficients = 53.75 blocks of 64)."""
    g, p, mm, vv = _inputs(dev, L, m, n, dtype, seed)
    enc = [codec.quant_blocks(a.reshape(L, -1), torch.arange(L, device=dev)
                              + salt) for a, salt in ((mm, 1), (vv, 2))]
    (qm, sm), (qv, sv) = enc
    return (g, p, qm.reshape(mm.shape), sm, qv.reshape(vv.shape), sv)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_q8_kernel_matches_plain_version(dtype):
    dev = _card()
    key = codec.make_key(0, dev)
    step = torch.tensor(4, dtype=torch.int32, device=dev)
    ids = torch.arange(3, device=dev)
    salts = [codec.slot_salt(key, step, s, ids) for s in (0, 1)]
    scalars = (torch.tensor([1e-3, 0.0, 1e9], device=dev),
               torch.tensor(0.01, device=dev), torch.tensor(1e-4, device=dev))
    args = dict(level=2, block=64, gamma=1.01, use_limiter=True,
                weight_decay=True)
    for seed in SEEDS:
        g, p, qm, sm, qv, sv = _q8_inputs(dev, dtype=dtype, seed=seed)
        want = ref.gwt_adam_fused_q8(g, p, qm, sm, qv, sv, *salts, *scalars,
                                     **args)
        outs = [kernel.gwt_adam_fused_q8(
            g.clone(), p.clone(), qm.clone(), sm.clone(), qv.clone(),
            sv.clone(), *(s.to(torch.uint32) for s in salts), *scalars,
            **args) for _ in range(2)]
        torch.cuda.synchronize()
        _bitwise(outs[1], outs[0])
        _bitwise(outs[0], want)


@pytest.mark.cuda
def test_q8_entry_point_launches_the_kernel_in_place():
    dev = _card()
    g, p, qm, sm, qv, sv = _q8_inputs(dev)
    state = {"m": {"q": qm, "scale": sm}, "v": {"q": qv, "scale": sv}}
    q0 = qm.clone()
    before, before_f32 = kernel.launches_q8, kernel.launches
    step = torch.tensor(0, dtype=torch.int32, device=dev)
    salts = codec.slot_salt(codec.make_key(0, dev), step,
                            torch.arange(2, device=dev)[:, None],
                            torch.arange(3, device=dev))
    new_p, new_norm, st = ops.fused_write_update_q8(
        g, p, state, step, salts,
        torch.zeros(3, device=dev), lr_t=torch.tensor(0.01, device=dev),
        alpha=0.25, weight_decay=0.0, gamma=1.01, use_limiter=True, level=2)
    torch.cuda.synchronize()
    assert kernel.launches_q8 == before + 1 and kernel.launches == before_f32
    assert new_p.data_ptr() == p.data_ptr()
    assert st["m"]["q"].data_ptr() == qm.data_ptr()
    assert st["v"]["scale"].data_ptr() == sv.data_ptr()
    assert not torch.equal(qm, q0) and torch.isfinite(new_norm).all()


@pytest.mark.cuda
def test_q8_kernel_refuses_what_it_does_not_take():
    dev = _card()
    g, p, qm, sm, qv, sv = _q8_inputs(dev)
    salts = (torch.zeros(3, dtype=torch.uint32, device=dev),) * 2
    scalars = (torch.zeros(3, device=dev), torch.tensor(0.01, device=dev),
               torch.tensor(0.0, device=dev))
    kw = dict(level=2, gamma=1.01, use_limiter=True, weight_decay=False)
    before = kernel.launches_q8
    with pytest.raises(ValueError, match="blocks of 64"):
        kernel.gwt_adam_fused_q8(g, p, qm, sm, qv, sv, *salts, *scalars,
                                 block=32, **kw)
    with pytest.raises(ValueError, match="shape"):
        kernel.gwt_adam_fused_q8(g, p, qm, sm[:, :-1].contiguous(), qv, sv,
                                 *salts, *scalars, block=64, **kw)
    with pytest.raises(ValueError, match="dtype"):
        kernel.gwt_adam_fused_q8(g, p, qm, sm, qv, sv,
                                 *(s.to(torch.int32) for s in salts),
                                 *scalars, block=64, **kw)
    assert kernel.launches_q8 == before


# K1's and K2's one-pass design against their two-pass kernels and their
# plain versions (all bitwise), at small shapes: a
# ragged last chunk (37 rows of 344 >> l coefficients: 3182 at level 2,
# chunks of 2048), and leaves whose bases break 16-byte alignment (5 rows
# of 9 coefficients: 45 a leaf, so leaf 1's g starts 45 * 2^l * 2 bytes
# in, and its m, p and codes at odd coefficient offsets).
def _design_shape(kind, level):
    return (3, 37, 344) if kind == "ragged" else (3, 5, 9 << level)


def _design_inputs(dev, shape, level, dtype, seed=11):
    L, m, n = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    return ((r(L, m, n) * 0.01).to(dtype), (r(L, m, n) * 0.02).to(dtype),
            r(L, m, n >> level) * 1e-3,
            torch.rand(L, m, n >> level, generator=gen, device=dev) * 1e-6)


def _design_scalars(dev):
    # per-leaf histories: clipping, first step, not clipping
    return (torch.tensor([1e-3, 0.0, 1e9], device=dev),
            torch.tensor(0.01, device=dev), torch.tensor(1e-4, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("use_limiter", [True, False])
@pytest.mark.parametrize("kind", ["ragged", "unaligned"])
@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_one_pass_matches_two_pass_and_plain(dtype, level, kind,
                                             use_limiter):
    dev = _card()
    shape = _design_shape(kind, level)
    L, m, n = shape
    g, p, mm, vv = _design_inputs(dev, shape, level, dtype)
    scalars = _design_scalars(dev)
    args = dict(level=level, gamma=1.01, use_limiter=use_limiter,
                weight_decay=True)
    want = ref.gwt_adam_fused(g, p, mm, vv, *scalars, **args)
    fresh = lambda: (g.clone(), p.clone(), mm.clone(), vv.clone(), *scalars)
    before = (kernel.launches_one_pass, kernel.launches_two_pass)
    one = [kernel.gwt_adam_fused(*fresh(), **args) for _ in range(2)]
    assert (kernel.launches_one_pass - before[0],
            kernel.launches_two_pass - before[1]) == (2, 0)
    two = kernel.gwt_adam_fused_two_pass(*fresh(), **args)
    torch.cuda.synchronize()
    for a, b, c in zip(*one, two):
        assert torch.equal(a, b) and torch.equal(a, c)
    _bitwise(one[0], want)


@pytest.mark.cuda
@pytest.mark.parametrize("use_limiter", [True, False])
@pytest.mark.parametrize("kind", ["ragged", "unaligned"])
@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_q8_one_pass_matches_two_pass_and_plain(dtype, level, kind,
                                                use_limiter):
    """K2: p, codes, scales and the norm bitwise to the plain version."""
    dev = _card()
    shape = _design_shape(kind, level)
    L, m, n = shape
    g, p, mm, vv = _design_inputs(dev, shape, level, dtype)
    (qm, sm), (qv, sv) = (
        codec.quant_blocks(a.reshape(L, -1), torch.arange(L, device=dev)
                           + salt) for a, salt in ((mm, 1), (vv, 2)))
    inputs = (g, p, qm.reshape(mm.shape), sm, qv.reshape(vv.shape), sv)
    key = codec.make_key(0, dev)
    step = torch.tensor(4, dtype=torch.int32, device=dev)
    salts = [codec.slot_salt(key, step, s, torch.arange(L, device=dev))
             for s in (0, 1)]
    scalars = _design_scalars(dev)
    args = dict(level=level, block=64, gamma=1.01, use_limiter=use_limiter,
                weight_decay=True)
    want = ref.gwt_adam_fused_q8(*inputs, *salts, *scalars, **args)
    fresh = lambda: (*(t.clone() for t in inputs),
                     *(s.to(torch.uint32) for s in salts), *scalars)
    before = (kernel.launches_q8_one_pass, kernel.launches_q8_two_pass)
    one = [kernel.gwt_adam_fused_q8(*fresh(), **args) for _ in range(2)]
    assert (kernel.launches_q8_one_pass - before[0],
            kernel.launches_q8_two_pass - before[1]) == (2, 0)
    two = kernel.gwt_adam_fused_q8_two_pass(*fresh(), **args)
    torch.cuda.synchronize()
    for a, b, c in zip(*one, two):
        assert torch.equal(a, b) and torch.equal(a, c)
    _bitwise(one[0], want)


# K1's and K2's two-pass design (norm pass, scale pass, streaming write
# pass) on multi-leaf buckets whose leaves have S = 1, 31, 33 and 1100
# chunks of 2048 coefficients (1100: more than 1024 partials a leaf, not a
# multiple of 32, so the scale pass's lane-strided sum has ragged lanes),
# the last chunk ragged; every output bitwise to the plain version, the
# limiter on (per-leaf histories: clipping, 0, not clipping) and off; the
# design counter moves by one a call whatever the design launches.
TWO_PASS_CHUNKS = (1, 31, 33, 1100)


def _two_pass_shape(S):
    na = 1500 if S == 1 else (S - 1) * 2048 + 5
    return (3, 1, na << 2)


@pytest.mark.cuda
@pytest.mark.parametrize("use_limiter", [True, False])
@pytest.mark.parametrize("S", TWO_PASS_CHUNKS)
@pytest.mark.parametrize("mdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_two_pass_matches_plain_at_odd_chunk_counts(dtype, mdtype, S,
                                                    use_limiter):
    dev = _card()
    shape = _two_pass_shape(S)
    g, p, mm, vv = _design_inputs(dev, shape, 2, dtype)
    mm, vv = mm.to(mdtype), vv.to(mdtype)
    scalars = _design_scalars(dev)
    args = dict(level=2, gamma=1.01, use_limiter=use_limiter,
                weight_decay=True)
    want = ref.gwt_adam_fused(g, p, mm, vv, *scalars, **args)
    before = (kernel.launches, kernel.launches_two_pass)
    got = kernel.gwt_adam_fused_two_pass(g, p.clone(), mm.clone(),
                                         vv.clone(), *scalars, **args)
    torch.cuda.synchronize()
    assert (kernel.launches - before[0],
            kernel.launches_two_pass - before[1]) == (1, 1)
    _bitwise(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("use_limiter", [True, False])
@pytest.mark.parametrize("S", TWO_PASS_CHUNKS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_q8_two_pass_matches_plain_at_odd_chunk_counts(dtype, S,
                                                       use_limiter):
    dev = _card()
    shape = _two_pass_shape(S)
    L = shape[0]
    g, p, mm, vv = _design_inputs(dev, shape, 2, dtype)
    (qm, sm), (qv, sv) = (
        codec.quant_blocks(a.reshape(L, -1), torch.arange(L, device=dev)
                           + salt) for a, salt in ((mm, 1), (vv, 2)))
    inputs = (g, p, qm.reshape(mm.shape), sm, qv.reshape(vv.shape), sv)
    key = codec.make_key(0, dev)
    step = torch.tensor(4, dtype=torch.int32, device=dev)
    salts = [codec.slot_salt(key, step, s, torch.arange(L, device=dev))
             for s in (0, 1)]
    scalars = _design_scalars(dev)
    args = dict(level=2, block=64, gamma=1.01, use_limiter=use_limiter,
                weight_decay=True)
    want = ref.gwt_adam_fused_q8(*inputs, *salts, *scalars, **args)
    before = (kernel.launches_q8, kernel.launches_q8_two_pass)
    got = kernel.gwt_adam_fused_q8_two_pass(
        *(t.clone() for t in inputs), *(s.to(torch.uint32) for s in salts),
        *scalars, **args)
    torch.cuda.synchronize()
    assert (kernel.launches_q8 - before[0],
            kernel.launches_q8_two_pass - before[1]) == (1, 1)
    _bitwise(got, want)


@pytest.mark.cuda
def test_bucket_beyond_capacity_takes_two_passes():
    """f32 parameters of the (2, 4096, 1376) bucket do not fit the one-pass
    design: the entry launches the two-pass kernel, the one-pass entry
    refuses, and the card's plan agrees with the rule."""
    dev = _card()
    shape = (2, 4096, 1376)
    plan = kernel.one_pass_plan("gwt_adam_fused", shape, torch.float32, 2)
    assert plan["grid"] == 0 and not kernel.one_pass_fits(
        shape, torch.float32, 2, plan["sms"], plan["max_dyn_smem"])
    assert kernel.one_pass_plan("gwt_adam_fused", shape, torch.bfloat16,
                                2)["grid"] > 0
    g, p, mm, vv = _design_inputs(dev, shape, 2, torch.float32)
    scalars = (torch.zeros(2, device=dev), torch.tensor(0.01, device=dev),
               torch.tensor(0.0, device=dev))
    args = dict(level=2, gamma=1.01, use_limiter=True, weight_decay=False)
    before = (kernel.launches_one_pass, kernel.launches_two_pass)
    kernel.gwt_adam_fused(g, p, mm, vv, *scalars, **args)
    torch.cuda.synchronize()
    assert (kernel.launches_one_pass - before[0],
            kernel.launches_two_pass - before[1]) == (0, 1)
    with pytest.raises(ValueError, match="does not fit"):
        kernel.gwt_adam_fused_one_pass(g, p, mm, vv, *scalars, **args)


def _tile_inputs(dev, level=2, L=3, m=40, n=344, dtype=torch.bfloat16,
                 seed=7):
    gen = torch.Generator(device=dev).manual_seed(seed)
    na = n >> level
    return ((torch.randn(L, m, n, generator=gen, device=dev) * 0.01)
            .to(dtype),
            torch.randn(L, m, na, generator=gen, device=dev) * 1e-3,
            torch.rand(L, m, na, generator=gen, device=dev) * 1e-6)


def _check_tile_kernels(dev, g, mm, vv, level):
    """K4 and K5 on one input: G̃, m', v' (K5: G̃, codes, scales) and the
    ‖G̃‖² partials (``ref.chunk_ssq`` of the plain G̃) bitwise, two runs
    bitwise."""
    L = g.shape[0]
    want = ref.gwt_adam_tile(g, mm, vv, level=level)
    outs = [kernel.gwt_adam_tile(g, mm, vv, level=level) for _ in range(2)]
    torch.cuda.synchronize()
    _bitwise(outs[1], outs[0])
    _bitwise(outs[0], want[:3] + (ref.chunk_ssq(want[0], level),))
    enc = [codec.quant_blocks(a.reshape(L, -1), torch.arange(L, device=dev)
                              + salt) for a, salt in ((mm, 1), (vv, 2))]
    args = (g, enc[0][0].reshape(mm.shape), enc[0][1],
            enc[1][0].reshape(vv.shape), enc[1][1])
    key = codec.make_key(0, dev)
    step = torch.tensor(4, dtype=torch.int32, device=dev)
    salts = [codec.slot_salt(key, step, s, torch.arange(L, device=dev))
             for s in (0, 1)]
    want = ref.gwt_adam_tile_q8(*args, *salts, level=level, block=64)
    outs = [kernel.gwt_adam_tile_q8(*args, *(s.to(torch.uint32)
                                             for s in salts),
                                    level=level, block=64)
            for _ in range(2)]
    torch.cuda.synchronize()
    _bitwise(outs[1], outs[0])
    _bitwise(outs[0], want[:5] + (ref.chunk_ssq(want[0], level),))


@pytest.mark.cuda
@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tile_kernels_match_plain_versions(dtype, level):
    """K4 and K5 at (3, 40, 344), three seeds: every output bitwise."""
    dev = _card()
    for seed in SEEDS:
        _check_tile_kernels(dev, *_tile_inputs(dev, level, dtype=dtype,
                                               seed=seed), level)


@pytest.mark.cuda
@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tile_kernels_on_odd_leaves(dtype, level):
    """K4 and K5 on an L = 3 stack of 37 x 43 = 1591 coefficients a leaf:
    odd, so leaves 1 and 2 start unaligned (g, G̃, m, v and codes), one
    ragged chunk, a partial quantization block of 55; every output
    bitwise."""
    dev = _card()
    _check_tile_kernels(dev, *_tile_inputs(dev, level, m=37, n=43 << level,
                                           dtype=dtype), level)


# K1 and K4 with bf16 moments (gwt(state_dtype=torch.bfloat16)): read as
# f32, written back rounded to nearest even; every output bitwise to the
# plain version, at a ragged-chunk and an unaligned-leaf shape (leaf 1's
# moments start at an odd coefficient: 2-byte accesses there), levels 1-3.
@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ragged", "unaligned"])
@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bf16_moments_match_plain_versions(dtype, level, kind):
    dev = _card()
    shape = _design_shape(kind, level)
    g, p, mm, vv = _design_inputs(dev, shape, level, dtype)
    mm, vv = mm.to(torch.bfloat16), vv.to(torch.bfloat16)
    scalars = _design_scalars(dev)
    for use_limiter in (True, False):
        args = dict(level=level, gamma=1.01, use_limiter=use_limiter,
                    weight_decay=True)
        want = ref.gwt_adam_fused(g, p, mm, vv, *scalars, **args)
        fresh = lambda: (g.clone(), p.clone(), mm.clone(), vv.clone(),
                         *scalars)
        one = [kernel.gwt_adam_fused(*fresh(), **args) for _ in range(2)]
        two = kernel.gwt_adam_fused_two_pass(*fresh(), **args)
        torch.cuda.synchronize()
        assert one[0][1].dtype == torch.bfloat16
        for a, b, c in zip(*one, two):
            assert torch.equal(a, b) and torch.equal(a, c)
        _bitwise(one[0], want)
    want = ref.gwt_adam_tile(g, mm, vv, level=level)
    outs = [kernel.gwt_adam_tile(g, mm, vv, level=level) for _ in range(2)]
    torch.cuda.synchronize()
    _bitwise(outs[1], outs[0])
    _bitwise(outs[0], want[:3] + (ref.chunk_ssq(want[0], level),))


@pytest.mark.cuda
def test_mixed_moment_dtypes_are_refused():
    dev = _card()
    g, p, m, v = _inputs(dev)
    scalars = (torch.zeros(3, device=dev), torch.tensor(0.01, device=dev),
               torch.tensor(0.0, device=dev))
    kw = dict(level=2, gamma=1.01, use_limiter=True, weight_decay=False)
    with pytest.raises(ValueError, match="dtype"):
        kernel.gwt_adam_fused(g, p, m.bfloat16(), v, *scalars, **kw)
    with pytest.raises(ValueError, match="dtype"):
        kernel.gwt_adam_tile(g, m, v.bfloat16(), level=2)


@pytest.mark.cuda
def test_staged_entry_points_launch_the_tile_kernels():
    """``ops.fused_update`` launches K4 once and returns new tensors, a
    FIRST-mode (transposed) gradient included; ``ops.fused_update_q8``
    launches K5 once; the staged optimizer launches K4 once per GWT leaf
    and neither fused-write kernel."""
    dev = _card()
    g, mm, vv = _tile_inputs(dev)
    step = torch.tensor(0, dtype=torch.int32, device=dev)
    before = kernel.launches_tile
    gt, _, st = ops.fused_update(g, {"m": mm, "v": vv}, step, level=2)
    gt_t, _, _ = ops.fused_update(g.transpose(-1, -2).contiguous()
                                  .transpose(-1, -2), {"m": mm, "v": vv},
                                  step, level=2)
    torch.cuda.synchronize()
    assert kernel.launches_tile == before + 2
    assert torch.equal(gt, gt_t) and st["m"].data_ptr() != mm.data_ptr()
    q, sc = codec.quant_blocks(mm.reshape(3, -1), 0)
    enc = {"q": q.reshape(mm.shape), "scale": sc}
    salts = torch.zeros((2, 3), dtype=torch.int64, device=dev)
    before = kernel.launches_tile_q8
    ops.fused_update_q8(g, {"m": enc, "v": enc}, step, salts, level=2)
    torch.cuda.synchronize()
    assert kernel.launches_tile_q8 == before + 1

    from repro_torch.core.gwt import gwt
    params = {"a": {"w1": torch.randn(2, 64, 32, device=dev),
                    "w2": torch.randn(64, 32, device=dev)},
              "norm": torch.ones(32, device=dev)}
    grads = {"a": {k: v * 0.1 for k, v in params["a"].items()},
             "norm": torch.ones(32, device=dev)}
    for kw in ({"fused_write": False}, {"bucketed": False}):
        opt = gwt(lr=0.01, **kw)
        counts = (kernel.launches, kernel.launches_tile)
        opt.update(grads, opt.init(params), params)
        torch.cuda.synchronize()
        assert (kernel.launches, kernel.launches_tile) == \
            (counts[0], counts[1] + 2), kw


@pytest.mark.cuda
def test_tile_kernels_refuse_what_they_do_not_take():
    dev = _card()
    g, mm, vv = _tile_inputs(dev)
    before = (kernel.launches_tile, kernel.launches_tile_q8)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.gwt_adam_tile(g.transpose(1, 2).contiguous().transpose(1, 2),
                             mm, vv, level=2)
    with pytest.raises(ValueError, match="dtype"):
        kernel.gwt_adam_tile(g, mm.half(), vv, level=2)
    with pytest.raises(ValueError, match="level"):
        kernel.gwt_adam_tile(g, mm, vv, level=5)
    q, sc = codec.quant_blocks(mm.reshape(3, -1), 0)
    q = q.reshape(mm.shape)
    salt = torch.zeros(3, dtype=torch.uint32, device=dev)
    with pytest.raises(ValueError, match="blocks of 64"):
        kernel.gwt_adam_tile_q8(g, q, sc, q, sc, salt, salt, level=2,
                                block=32)
    with pytest.raises(ValueError, match="shape"):
        kernel.gwt_adam_tile_q8(g, q, sc[:, :-1].contiguous(), q, sc, salt,
                                salt, level=2, block=64)
    assert (kernel.launches_tile, kernel.launches_tile_q8) == before


def _bits(t):
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


@pytest.mark.cuda
@pytest.mark.parametrize("wire", [torch.bfloat16, torch.float16,
                                  torch.float8_e4m3fn])
@pytest.mark.parametrize("level", [1, 2, 3])
def test_dwt_wire_kernel_matches_plain_version(level, wire):
    """K3 bitwise, fp8 details past 464 and +-inf included; an unaligned
    input (a row offset of 4 bytes) takes the scalar loads."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(level)
    g = torch.randn(38, 344, generator=gen, device=dev) * 300
    g[1, [0, 8, 16]] = torch.tensor([1e30, float("inf"), -float("inf")],
                                    device=dev)
    for x in (g[1:], g.reshape(-1)[1:1 + 37 * 344].reshape(37, 344)):
        want = haar_ref.haar_dwt_fwd_q(x, level, wire)
        got = haar_kernel.haar_dwt_fwd_q(x, level, wire)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dwt_and_inverse_kernels_match_plain_versions(dtype):
    dev = _card()
    g = torch.randn(37, 344, device=dev).to(dtype)
    for level in (1, 2, 3):
        bands = haar_kernel.haar_dwt_fwd(g, level)
        for a, b in zip(bands, haar_ref.haar_dwt_fwd(g, level)):
            assert torch.equal(_bits(a), _bits(b))
        inv = haar_kernel.haar_dwt_inv(bands[0], bands[1:])
        assert torch.equal(_bits(inv),
                           _bits(haar_ref.haar_dwt_inv(bands[0], bands[1:])))


@pytest.mark.cuda
def test_dwt_entry_points_count_launches_and_refuse():
    dev = _card()
    g = torch.randn(8, 64, device=dev)
    before = (haar_kernel.launches_fwd, haar_kernel.launches_fwd_q,
              haar_kernel.launches_inv)
    a, *ds = haar_ops.dwt_wire(g, 2, torch.bfloat16)
    haar_ops.idwt(a, [d.float() for d in ds])
    haar_ops.dwt(g, 2)
    assert (haar_kernel.launches_fwd, haar_kernel.launches_fwd_q,
            haar_kernel.launches_inv) == tuple(b + 1 for b in before)
    with pytest.raises(ValueError, match="contiguous"):
        haar_ops.dwt(g.t(), 2)
    with pytest.raises(ValueError, match="divisible"):
        haar_ops.dwt_wire(g[:, :62].contiguous(), 2, torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        haar_ops.dwt_wire(g.half(), 2, torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        haar_ops.dwt(g.half(), 2)
    with pytest.raises(ValueError, match="level"):
        haar_ops.dwt(g, 7)
    with pytest.raises(ValueError, match="detail 0"):
        haar_ops.idwt(a, [d for d in ds])
    assert haar_kernel.launches_fwd_q == before[1] + 1


def _group_leaves(dev, level, seed, scale=300.0):
    """Mixed f32 leaves: odd rows, an odd coefficient count over several
    tiles (a ragged last tile), the same unaligned (one element past a
    16-byte boundary), a one-row leaf, and 36 small leaves (40 in all: two
    launches); the first carries 1e30 and +-inf."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = [(37, 344), (101, 43 << level), (101, 43 << level), (1, 64)]
    shapes += [(1 + i % 5, 8 * (3 + i % 11)) for i in range(36)]
    gs = [torch.randn(*s, generator=gen, device=dev) * scale for s in shapes]
    gs[0][1, [0, 8, 16]] = torch.tensor([1e30, float("inf"),
                                         -float("inf")], device=dev)
    buf = torch.empty(gs[2].numel() + 1, device=dev)
    buf[1:].copy_(gs[2].reshape(-1))
    gs[2] = buf[1:].view(gs[2].shape)
    return gs


@pytest.mark.cuda
@pytest.mark.parametrize("level", [1, 2, 3])
def test_grouped_dwt_kernels_match_plain_versions(level):
    """K3 (every wire dtype) and K6 (f32, bf16) over one group: every band
    of every leaf bitwise to the per-leaf plain version, in two launches
    (40 leaves), counted as such."""
    dev = _card()
    gs = _group_leaves(dev, level, level)
    for wire in (torch.bfloat16, torch.float16, torch.float8_e4m3fn):
        before = (haar_kernel.launches_fwd_q, haar_kernel.leaves_fwd_q)
        got = haar_kernel.haar_dwt_fwd_q_group(gs, level, wire)
        torch.cuda.synchronize()
        assert (haar_kernel.launches_fwd_q, haar_kernel.leaves_fwd_q) == \
            (before[0] + 2, before[1] + 40)
        for g, bands in zip(gs, got):
            for a, b in zip(bands, haar_ref.haar_dwt_fwd_q(g, level, wire)):
                assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    for dtype in (torch.float32, torch.bfloat16):
        xs = [(g / 300).to(dtype) for g in gs]
        before = (haar_kernel.launches_fwd, haar_kernel.leaves_fwd)
        got = haar_kernel.haar_dwt_fwd_group(xs, level)
        torch.cuda.synchronize()
        assert (haar_kernel.launches_fwd, haar_kernel.leaves_fwd) == \
            (before[0] + 2, before[1] + 40)
        for x, bands in zip(xs, got):
            for a, b in zip(bands, haar_ref.haar_dwt_fwd(x, level)):
                assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("ef", [False, True])
def test_grouped_reduction_matches_per_leaf(ef):
    """``compressed_means(_ef)`` (one K3 launch for the compressible leaves)
    bitwise equal to the per-leaf ``compressed_mean(_ef)`` on one rank."""
    from repro_torch.distributed import compression
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(4)
    shapes = [(64, 32), (2, 32, 88), (32,), (2, 88, 32), (64, 32)]
    gs = [torch.randn(*s, generator=gen, device=dev) for s in shapes]
    errs = [torch.randn(*s, generator=gen, device=dev) * 1e-3
            for s in shapes]
    wire = torch.float8_e4m3fn if ef else torch.bfloat16
    before = (haar_kernel.launches_fwd_q, haar_kernel.leaves_fwd_q)
    if ef:
        got = compression.compressed_means_ef(gs, errs, None, 2, wire)
        want = list(zip(*[compression.compressed_mean_ef(g, e, None, 2, wire)
                          for g, e in zip(gs, errs)]))
        pairs = list(zip(got[0] + got[1], list(want[0]) + list(want[1])))
    else:
        got = compression.compressed_means(gs, None, 2, wire)
        pairs = list(zip(got, [compression.compressed_mean(g, None, 2, wire)
                               for g in gs]))
    assert (haar_kernel.launches_fwd_q, haar_kernel.leaves_fwd_q) == \
        (before[0] + 1 + 4, before[1] + 4 + 4)
    for a, b in pairs:
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
def test_group_entries_refuse_cpu_tensors():
    dev = _card()
    g = torch.randn(8, 64, device=dev)
    before = (haar_kernel.launches_fwd_q, haar_kernel.launches_fwd)
    with pytest.raises(ValueError, match="CUDA tensors"):
        haar_kernel.haar_dwt_fwd_q_group([g, g.cpu()], 2, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        haar_kernel.haar_dwt_fwd_group([g.cpu()], 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        haar_ops.dwt_wire_group([g.cpu(), g], 2, torch.bfloat16)
    assert (haar_kernel.launches_fwd_q, haar_kernel.launches_fwd) == before


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [None, "int8"])
def test_engine_on_the_card_serves_the_dense_tokens(quant):
    """The serving engine on the card (llama-60m-smoke, f32): its arena
    lives on the card and stays in place, launches none of K1-K7, and each
    request's greedy tokens equal the dense ``generate`` path's; int8
    pages agree on at least 0.9 of the tokens (the reference's gate)."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.launch.serve import build_workload, generate
    from repro_torch.models import lm
    from repro_torch.optim.base import flatten_with_paths
    from repro_torch.serve.engine import Engine, EngineConfig
    dev = _card()
    cfg = configs.get_smoke("llama-60m")
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0),
                     dev).tree()
    eng = Engine(cfg, params, EngineConfig(num_slots=3, page_size=4,
                                           max_ctx=40, prefill_chunk=8,
                                           kv_quant=quant))
    leaves = flatten_with_paths(eng.pools)[1]
    ptrs = [t.data_ptr() for t in leaves]
    assert all(t.device.type == "cuda" for t in leaves)
    before = (kernel.launches, kernel.launches_q8, haar_kernel.launches_fwd_q)
    reqs = build_workload(8, cfg.vocab, 24, 16, 0.0, seed=2)
    eng.run(reqs)
    assert (kernel.launches, kernel.launches_q8,
            haar_kernel.launches_fwd_q) == before
    assert [t.data_ptr() for t in flatten_with_paths(eng.pools)[1]] == ptrs
    match = total = 0
    for r in reqs:
        ref = generate(cfg, params, torch.tensor([r.prompt], device=dev),
                       r.max_gen)[0].tolist()
        if quant is None:
            assert r.generated == ref, r.rid
        match += int(np.sum(np.array(r.generated) == np.array(ref)))
        total += len(ref)
    assert match / total >= 0.9


# LoRA adapter buckets (f32 p; g f32 under an f32 model, bf16 under a
# bf16 one, G~ then rounded to bf16): rank 4 at level 2 leaves one
# approximation coefficient a row, so with an odd row count a leaf's
# coefficients start on a 16-byte boundary only by accident; and the
# adapter buckets of full-width llama-60m and qwen2.5-3b.  One MoE expert
# bucket of bf16 weights, cut in rows from qwen3-moe-30b-a3b's (2, 524288,
# 768).  Every output bitwise to the plain version, K1 (f32 and bf16
# moments) and K2, the limiter on and off.
ADAPTER_SHAPES = [(3, 37, 4), (5, 8, 12), (1, 11008, 8), (5, 64, 512),
                  (6, 4096, 8), (2, 64, 1376), (6, 73728, 8),
                  (3, 288, 2048)]
EXPERT_SHAPE = (2, 8192, 768)


def _cycled_scalars(dev, L):
    hist = torch.tensor([1e-3, 0.0, 1e9], device=dev)
    return (hist.repeat(-(-L // 3))[:L].contiguous(),
            torch.tensor(0.01, device=dev), torch.tensor(1e-4, device=dev))


def _narrow_cases():
    """(shape, g's dtype, p's dtype)."""
    cases = [(s, gd, torch.float32) for s in ADAPTER_SHAPES
             for gd in (torch.float32, torch.bfloat16)]
    return cases + [(EXPERT_SHAPE, torch.bfloat16, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("use_limiter", [True, False])
@pytest.mark.parametrize("mdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,dtype,pdtype", _narrow_cases(),
                         ids=lambda c: str(c))
def test_adapter_and_expert_buckets_match_plain(shape, dtype, pdtype,
                                                mdtype, use_limiter):
    dev = _card()
    g, p, mm, vv = _design_inputs(dev, shape, 2, dtype)
    p, mm, vv = p.to(pdtype), mm.to(mdtype), vv.to(mdtype)
    scalars = _cycled_scalars(dev, shape[0])
    args = dict(level=2, gamma=1.01, use_limiter=use_limiter,
                weight_decay=True)
    want = ref.gwt_adam_fused(g, p, mm, vv, *scalars, **args)
    before = kernel.launches
    got = kernel.gwt_adam_fused(g, p.clone(), mm.clone(), vv.clone(),
                                *scalars, **args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _bitwise(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("use_limiter", [True, False])
@pytest.mark.parametrize("shape,dtype,pdtype", _narrow_cases(),
                         ids=lambda c: str(c))
def test_q8_adapter_and_expert_buckets_match_plain(shape, dtype, pdtype,
                                                   use_limiter):
    dev = _card()
    L = shape[0]
    g, p, mm, vv = _design_inputs(dev, shape, 2, dtype)
    p = p.to(pdtype)
    (qm, sm), (qv, sv) = (
        codec.quant_blocks(a.reshape(L, -1), torch.arange(L, device=dev)
                           + salt) for a, salt in ((mm, 1), (vv, 2)))
    inputs = (g, p, qm.reshape(mm.shape), sm, qv.reshape(vv.shape), sv)
    key = codec.make_key(0, dev)
    step = torch.tensor(4, dtype=torch.int32, device=dev)
    salts = [codec.slot_salt(key, step, s, torch.arange(L, device=dev))
             for s in (0, 1)]
    scalars = _cycled_scalars(dev, L)
    args = dict(level=2, block=64, gamma=1.01, use_limiter=use_limiter,
                weight_decay=True)
    want = ref.gwt_adam_fused_q8(*inputs, *salts, *scalars, **args)
    before = kernel.launches_q8
    got = kernel.gwt_adam_fused_q8(
        *(t.clone() for t in inputs), *(s.to(torch.uint32) for s in salts),
        *scalars, **args)
    torch.cuda.synchronize()
    assert kernel.launches_q8 == before + 1
    _bitwise(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("q8", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("design", ["one", "two"])
@pytest.mark.parametrize("shape", [(3, 37, 4), (3, 37, 344), (2, 64, 1376)])
def test_bf16_gradient_of_f32_parameters_in_both_designs(shape, design, q8):
    """bf16 g with f32 p through each design explicitly (the one-pass
    kernel's p rounds, the write pass's g and p slots of two widths):
    bitwise to the plain version, which rounds G~ and the limited step to
    bf16 and writes p in f32."""
    dev = _card()
    L = shape[0]
    g, p, mm, vv = _design_inputs(dev, shape, 2, torch.bfloat16)
    p = p.float()
    scalars = _cycled_scalars(dev, L)
    args = dict(level=2, gamma=1.01, use_limiter=True, weight_decay=True)
    if q8:
        (qm, sm), (qv, sv) = (
            codec.quant_blocks(a.reshape(L, -1), torch.arange(L, device=dev)
                               + salt) for a, salt in ((mm, 1), (vv, 2)))
        inputs = (g, p, qm.reshape(mm.shape), sm, qv.reshape(vv.shape), sv)
        key = codec.make_key(0, dev)
        step = torch.tensor(4, dtype=torch.int32, device=dev)
        salts = [codec.slot_salt(key, step, s, torch.arange(L, device=dev))
                 for s in (0, 1)]
        want = ref.gwt_adam_fused_q8(*inputs, *salts, *scalars, block=64,
                                     **args)
        got = getattr(kernel, f"gwt_adam_fused_q8_{design}_pass")(
            *(t.clone() for t in inputs),
            *(s.to(torch.uint32) for s in salts), *scalars, block=64, **args)
    else:
        want = ref.gwt_adam_fused(g, p, mm, vv, *scalars, **args)
        got = getattr(kernel, f"gwt_adam_fused_{design}_pass")(
            g, p.clone(), mm.clone(), vv.clone(), *scalars, **args)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.float32
    _bitwise(got, want)
