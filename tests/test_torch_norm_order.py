"""The plain versions add the per-leaf ``‖G̃‖²`` in the CUDA kernels' order.

``ref.chunk_ssq`` and ``ref.leaf_ssq``/``ref.leaf_norm`` are held bitwise
to a scalar numpy-f32 loop written straight from the order in the CUDA
sources: per chunk of 2048 coefficients, thread t adds coefficients
t + 256k (k = 0..7), each one's 2^l squares in order
(``gwt_adam_common.cuh``: ``sum_sq``); each warp adds its lanes by
``__shfl_down_sync`` at offsets 16..1 and the 8 warp sums are added in
order (``block_sum``); a leaf's partials are added lane-strided, then by
the same shuffle tree, and the root is ``__fsqrt_rn`` (``leaf_limit``).
The shapes have ragged last chunks and odd coefficient counts per leaf,
so leaf bases are unaligned on the card.  The fused plain versions, which
take their limiter norm from this order, are held to the JAX oracle at
such a shape within the spacings ``test_torch_gwt_adam.py`` and
``test_torch_gwt_q8.py`` state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import bf16_spacings, spacings, to_torch

from repro.kernels.gwt_adam import ops as jops
from repro.optim import codec as jcodec
from repro_torch.kernels.gwt_adam import ops, ref
from repro_torch.optim import codec

# (shape, level): (3, 37, 344) has 6364 / 3182 / 1591 coefficients per leaf
# at levels 1 / 2 / 3 (4 / 2 / 1 chunks, the last ragged; odd at level 3);
# (2, 45, 86) has 1935 at level 1
SHAPES = [((3, 37, 344), 1), ((3, 37, 344), 2), ((3, 37, 344), 3),
          ((2, 45, 86), 1)]
# a sum of squares whose f32 root torch's vectorised CPU sqrt rounds one
# spacing low (26.107634 instead of 26.107635)
PINNED_SSQ_BITS = 1143629555    # 681.60858...


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _gt(shape, level, dtype, seed):
    """A rounded G̃ stack: heavy-tailed values, as G̃ is at a first step."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape) * np.exp(rng.randn(*shape))
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def _shfl_down_lane0(vals):
    """Lane 0 after ``v += __shfl_down_sync(v, off)`` for off = 16..1: every
    lane adds lane i + off, or its own value where i + off >= 32."""
    v = list(vals)
    for off in (16, 8, 4, 2, 1):
        v = [np.float32(v[i] + (v[i + off] if i + off < 32 else v[i]))
             for i in range(32)]
    return v[0]


def _scalar_chunk_ssq(gt, level):
    L, B = gt.shape[0], 1 << level
    x = gt.float().numpy().reshape(L, -1)
    na = x.shape[1] // B
    S = -(-na // 2048)
    out = np.zeros((L, S), np.float32)
    for leaf in range(L):
        for s in range(S):
            lanes = []
            for t in range(256):
                acc = np.float32(0.0)
                for k in range(8):
                    j = 2048 * s + t + 256 * k
                    if j >= na:
                        break
                    for e in range(B):
                        r = x[leaf, j * B + e]
                        acc = np.float32(acc + np.float32(r * r))
                lanes.append(acc)
            total = np.float32(0.0)
            for w in range(8):
                total = np.float32(total + _shfl_down_lane0(
                    lanes[32 * w:32 * w + 32]))
            out[leaf, s] = total
    return out


def _scalar_leaf_ssq(partials):
    out = []
    for row in partials:
        lanes = []
        for lane in range(32):
            acc = np.float32(0.0)
            for i in range(lane, len(row), 32):
                acc = np.float32(acc + row[i])
            lanes.append(acc)
        out.append(_shfl_down_lane0(lanes))
    return np.array(out, np.float32)


def _correctly_rounded_root(x: np.float32, r: np.float32) -> bool:
    """``r`` is the f32 nearest to sqrt(x): the midpoints between r and its
    neighbours, squared, bracket x.  Exact in f64: the midpoints have 25
    significant bits, their squares 50."""
    r = np.float32(r)
    lo = (float(r) + float(np.nextafter(r, np.float32(0)))) / 2
    hi = (float(r) + float(np.nextafter(r, np.float32(np.inf)))) / 2
    return lo * lo <= float(x) <= hi * hi


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,level", SHAPES)
def test_chunk_ssq_is_the_kernels_order(shape, level, dtype):
    gt = _gt(shape, level, dtype, seed=level + shape[-1])
    got = ref.chunk_ssq(gt, level)
    want = _scalar_chunk_ssq(gt, level)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ref.leaf_ssq(got).numpy(),
                                  _scalar_leaf_ssq(want))


@pytest.mark.parametrize("S", [1, 5, 32, 33, 77])
def test_leaf_ssq_is_leaf_scale_at_order(S):
    """Lane-strided partials (fewer than 32, a multiple, ragged), then the
    shuffle tree; the root correctly rounded."""
    rng = np.random.RandomState(S)
    parts = (rng.rand(3, S) * np.exp(4 * rng.randn(3, S))).astype(
        np.float32)
    got = ref.leaf_ssq(torch.from_numpy(parts))
    want = _scalar_leaf_ssq(parts)
    np.testing.assert_array_equal(got.numpy(), want)
    norm = ref.leaf_norm(torch.from_numpy(parts)).numpy()
    for x, r in zip(want, norm):
        assert _correctly_rounded_root(x, r)


def test_leaf_norm_root_is_correctly_rounded():
    """At the pinned sum, f32 ``torch.sqrt`` over a vector on the CPU is one
    spacing low where ``leaf_norm`` (``__fsqrt_rn`` on the card) is not."""
    x = np.array([PINNED_SSQ_BITS], np.uint32).view(np.float32)
    norm = ref.leaf_norm(torch.from_numpy(x.reshape(1, 1)))
    assert norm.item() == np.float32(26.107635498046875)
    assert _correctly_rounded_root(x[0], norm.item())
    assert not _correctly_rounded_root(x[0], np.float32(26.107633590698242))
    rng = np.random.RandomState(0)
    many = (rng.rand(4096) * 1000).astype(np.float32)
    roots = ref.leaf_norm(torch.from_numpy(many[:, None])).numpy()
    assert all(_correctly_rounded_root(a, b) for a, b in zip(many, roots))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tile_ssq_is_chunk_ssq(dtype):
    """The staged plain versions return the leaf sums of the kernels'
    partials, without the root."""
    shape, level = (3, 37, 344), 3
    rng = np.random.RandomState(4)
    g = to_torch(rng.randn(*shape).astype(np.float32), dtype)
    m = to_torch((rng.randn(3, 37, 43) * 0.1).astype(np.float32))
    v = to_torch((rng.rand(3, 37, 43) * 0.01).astype(np.float32))
    gt, _, _, ssq = ref.gwt_adam_tile(g, m, v, level=level)
    assert torch.equal(ssq, ref.leaf_ssq(ref.chunk_ssq(gt, level)))
    np.testing.assert_array_equal(
        ssq.numpy(), _scalar_leaf_ssq(_scalar_chunk_ssq(gt, level)))


def _fused_inputs(shape, level, seed):
    rng = np.random.RandomState(seed)
    L, m, n = shape
    return (rng.randn(L, m, n).astype(np.float32),
            rng.randn(L, m, n).astype(np.float32),
            (rng.randn(L, m, n >> level) * 0.1).astype(np.float32),
            (rng.rand(L, m, n >> level) * 0.01).astype(np.float32))


# (limiter on, prev_norm, weight decay): first step; clipping; not clipping
FUSED_CASES = [(True, 0.0, 0.1), (True, 1e-3, 0.0), (True, 1e3, 0.1)]


@pytest.mark.parametrize("case", FUSED_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_write_odd_leaves_matches_jax(dtype, case):
    """f32 moments at (3, 37, 344), level 3 (1591 coefficients per leaf),
    against ``fused_write_update(impl="jnp")`` within
    ``test_torch_gwt_adam.py``'s spacings."""
    use_limiter, prev, wd = case
    shape, level = (3, 37, 344), 3
    g, p, mm, vv = _fused_inputs(shape, level, seed=16)
    pn = np.full((3,), prev, np.float32)
    kw = dict(alpha=0.25, weight_decay=wd, gamma=1.01,
              use_limiter=use_limiter, level=level)
    jp, jn, _ = jops.fused_write_update(
        jnp.asarray(g).astype(dtype), jnp.asarray(p).astype(dtype),
        {"m": jnp.asarray(mm), "v": jnp.asarray(vv)}, jnp.int32(3),
        jnp.asarray(pn), lr_t=0.01, impl="jnp", **kw)
    tdt = getattr(torch, dtype)
    tp, tn, _ = ops.fused_write_update(
        to_torch(g, tdt), to_torch(p, tdt),
        {"m": to_torch(mm), "v": to_torch(vv)},
        torch.tensor(3, dtype=torch.int32), to_torch(pn),
        lr_t=torch.tensor(0.01), **kw)
    if dtype == "float32":
        assert spacings(tp, jp) <= 4
        assert spacings(tn, jn) <= 4
    else:
        assert bf16_spacings(tp, jp) <= 1
        assert spacings(tn, jn) <= 64


def _q8_state(mm, vv):
    """Moments encoded by the JAX codec, so both packages start from the
    same codes."""
    enc = jax.vmap(lambda x, s: jcodec.blocked_quant(x, s))
    st = {}
    for name, a, salt in (("m", mm, 11), ("v", vv, 12)):
        q, s = enc(jnp.asarray(a),
                   jnp.arange(a.shape[0], dtype=jnp.uint32) + salt)
        st[name] = {"q": np.asarray(q), "scale": np.asarray(s)}
    return st


# 37 * 43 = 1591 coefficients per leaf (odd: unaligned leaf bases on the
# card; 24.9 quantization blocks; one ragged chunk)
Q8_ODD = [((3, 37, 86), 1), ((3, 37, 172), 2)]


@pytest.mark.parametrize("case", FUSED_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,level", Q8_ODD)
def test_fused_write_q8_odd_leaves_matches_jax(shape, level, dtype, case):
    """int8 moments with 1591 coefficients per leaf against
    ``fused_write_update_q8(impl="jnp")`` within ``test_torch_gwt_q8.py``'s
    spacings (codes off by one at no more than 8 places).  At level 3
    ((3, 37, 344)) the JAX oracle is no yardstick for the norm: see
    :func:`test_fused_write_q8_norm_is_near_exact`."""
    use_limiter, prev, wd = case
    g, p, mm, vv = _fused_inputs(shape, level, seed=17)
    st = _q8_state(mm, vv)
    pn = np.full((3,), prev, np.float32)
    lids = np.arange(3, 6, dtype=np.int32)
    kw = dict(alpha=0.25, weight_decay=wd, gamma=1.01,
              use_limiter=use_limiter, level=level)
    jp, jn, js = jops.fused_write_update_q8(
        jnp.asarray(g).astype(dtype), jnp.asarray(p).astype(dtype),
        {k: {kk: jnp.asarray(vv) for kk, vv in d.items()}
         for k, d in st.items()},
        jnp.int32(5), jcodec.make_key(0), jnp.asarray(lids),
        jnp.asarray(pn), lr_t=0.01, impl="jnp", **kw)
    tdt = getattr(torch, dtype)
    step = torch.tensor(5, dtype=torch.int32)
    salts = codec.slot_salt(codec.make_key(0), step,
                            torch.arange(2)[:, None], torch.from_numpy(lids))
    tp, tn, ts = ops.fused_write_update_q8(
        to_torch(g, tdt), to_torch(p, tdt),
        {k: {kk: to_torch(vv) for kk, vv in d.items()}
         for k, d in st.items()},
        step, salts, to_torch(pn), lr_t=torch.tensor(0.01), **kw)
    for name in ("m", "v"):
        d = ts[name]["q"].numpy().astype(np.int32) - \
            np.asarray(js[name]["q"]).astype(np.int32)
        assert np.abs(d).max(initial=0) <= 1 and int((d != 0).sum()) <= 8
        assert spacings(ts[name]["scale"], js[name]["scale"]) <= 2
    if dtype == "float32":
        assert spacings(tp, jp) <= 4
        assert spacings(tn, jn) <= 4
    else:
        assert bf16_spacings(tp, jp) <= 1
        assert spacings(tn, jn) <= 64


def test_fused_write_q8_norm_is_near_exact():
    """At (3, 37, 344), level 3, int8 moments, first step: a dequantized
    v of 0 makes one leaf's G̃ heavy (details times 1/eps).  The JAX
    oracle, which sums that shape's norm over all rows at once, reads 117
    f32 spacings below the f64 norm there; the port's norm, summed in the
    kernels' order, is within one spacing of the f64 norm of its own G̃."""
    shape, level = (3, 37, 344), 3
    g, _, mm, vv = _fused_inputs(shape, level, seed=17)
    st = {k: {kk: to_torch(vv) for kk, vv in d.items()}
          for k, d in _q8_state(mm, vv).items()}
    salts = codec.slot_salt(codec.make_key(0),
                            torch.tensor(5, dtype=torch.int32),
                            torch.arange(2)[:, None], torch.arange(3, 6))
    gt = ref.gwt_adam_tile_q8(
        to_torch(g), st["m"]["q"], st["m"]["scale"], st["v"]["q"],
        st["v"]["scale"], salts[0], salts[1], level=level, block=64)[0]
    exact = torch.sqrt((gt.double() ** 2).sum((1, 2)))
    assert spacings(ref.leaf_norm(ref.chunk_ssq(gt, level)), exact) <= 1
