"""The port's share of the paper's public API against the JAX package, on
seeded numpy inputs: ``core.haar``'s packed transforms, the Haar matrix of
Eq. (3) and the low-pass operator of Theorem 1; ``core.gwt.
state_memory_bytes`` (the paper's Table I accounting); ``configs``'
``SHAPES``, ``input_specs`` and ``skip_reason``; ``models``' parameter
counts, abstract caches and cache axes; ``optim.base``'s ``path_str``,
``map_with_path`` and ``global_norm``; ``optim.engine.live_update_bytes``
off the card; ``distributed.compression``'s tree reducer and residue
shardings; and the packages' ``__all__``.

Tolerances: the packed transforms and the matrix are bitwise (the same
f32 operations, and one rounding of the same f64 matrix); ``lowpass`` is a
block mean, whose f32 sum ATen and XLA may add in another order: within 1
f32 spacing of the largest magnitude (measured 1.0); ``global_norm``
within 2 f32 spacings (the same reason, over every leaf; measured 1.0);
integers (bytes, counts, shapes) exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import flat_numpy, spacings, to_numpy, to_torch

from repro import configs as jcfg, core as jcore, optim as jax_optim
from repro.core import haar as jhaar
from repro.distributed import compression as jcomp
from repro.models import encdec as jenc, lm as jlm
from repro.models.layers import Axes as JAxes
from repro.optim import base as jbase
from repro_torch import configs as tcfg, core, optim
from repro_torch.core import haar
from repro_torch.core.gwt import state_memory_bytes
from repro_torch.distributed import compression, sharding
from repro_torch.models import encdec, lm, module_for
from repro_torch.optim import base, engine

jgwt = __import__("importlib").import_module("repro.core.gwt")

ALL_IDS = list(tcfg.ARCH_IDS) + list(tcfg.LLAMA)
STATE_IDS = list(tcfg.ARCH_IDS) + ["llama-60m"]


def _rand(seed, shape, dtype=np.float32):
    return np.random.RandomState(seed).standard_normal(shape).astype(dtype)


def _jflat(tree, leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=leaf)
    return {jbase.path_str(p): v for p, v in flat}


def _tflat(tree):
    return dict(zip(*base.flatten_with_paths(tree)))


def _dtype(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.dtype(x.dtype))


def _specs(flat):
    return {p: (tuple(x.shape), _dtype(x)) for p, x in flat.items()}


# ---------------------------------------------------------------------------
# core.haar
# ---------------------------------------------------------------------------

HAAR_CASES = [((4, 8), 1), ((8, 64), 2), ((3, 2, 128), 3), ((5, 256), 5),
              ((2, 16), 4), ((6, 32), 0)]


@pytest.mark.parametrize("shape,level", HAAR_CASES)
def test_packed_transforms_bitwise(shape, level):
    g = _rand(level, shape)
    want = jhaar.haar_forward_packed(jnp.asarray(g), level)
    got = haar.haar_forward_packed(to_torch(g), level)
    np.testing.assert_array_equal(to_numpy(got), to_numpy(want))
    a, ds = haar.unpack(got, level)
    ja, jds = jhaar.unpack(want, level)
    assert [t.shape[-1] for t in [a, *ds]] == [t.shape[-1] for t in [ja, *jds]]
    np.testing.assert_array_equal(to_numpy(haar.pack(a, ds)),
                                  to_numpy(jhaar.pack(ja, jds)))
    packed = _rand(100 + level, shape)
    np.testing.assert_array_equal(
        to_numpy(haar.haar_inverse_packed(to_torch(packed), level)),
        to_numpy(jhaar.haar_inverse_packed(jnp.asarray(packed), level)))


@pytest.mark.parametrize("n,level", [(8, 1), (8, 2), (64, 3), (32, 5),
                                     (16, 0)])
def test_haar_matrix_bitwise_and_orthonormal(n, level):
    h = haar.haar_matrix(n, level)
    assert h.dtype == torch.float32
    np.testing.assert_array_equal(h.numpy(),
                                  np.asarray(jhaar.haar_matrix(n, level)))
    assert haar.haar_matrix(n, level, torch.float64).numpy().tobytes() \
        == jhaar._haar_matrix_np(n, level).tobytes()
    hd = haar.haar_matrix(n, level, torch.float64)
    np.testing.assert_allclose((hd @ hd.T).numpy(), np.eye(n), atol=1e-12)
    hd.zero_()   # each call's tensor is its own: the cache stays whole
    assert haar.haar_matrix(n, level, torch.float64).numpy().tobytes() \
        == jhaar._haar_matrix_np(n, level).tobytes()


@pytest.mark.parametrize("n,level", [(8, 1), (64, 3), (32, 5)])
def test_packed_transform_is_the_matrix(n, level):
    """G @ H is the packed forward and packed @ Hᵀ the inverse (Eq. 2/3),
    in f64 at f64's rounding."""
    g = torch.from_numpy(_rand(1, (5, n)).astype(np.float64))
    h = haar.haar_matrix(n, level, torch.float64)
    np.testing.assert_allclose(haar.haar_forward_packed(g, level).numpy(),
                               (g @ h).numpy(), rtol=0, atol=1e-13)
    np.testing.assert_allclose(
        haar.haar_inverse_packed(g @ h, level).numpy(), g.numpy(), rtol=0,
        atol=1e-13)


@pytest.mark.parametrize("shape,level", [((6, 32), 3), ((4, 3, 64), 2),
                                         ((2, 1024), 5), ((7, 8), 1)])
def test_lowpass_within_one_spacing(shape, level):
    g = _rand(3 + level, shape)
    got = haar.lowpass(to_torch(g), level)
    assert got.shape == g.shape and got.dtype == torch.float32
    assert spacings(got, jhaar.lowpass(jnp.asarray(g), level)) <= 1
    b = 1 << level
    blocks = g.astype(np.float64).reshape(*shape[:-1], shape[-1] // b, b)
    want = np.repeat(blocks.mean(-1, keepdims=True), b, -1).reshape(shape)
    assert spacings(got, want) <= 1


def test_approx_band_is_scaled_lowpass():
    """A_l is the block mean times 2^(l/2): Algorithm 1's band and §III-C's
    operator agree."""
    g = to_torch(_rand(4, (3, 64)))
    level = 3
    a, _ = haar.haar_forward(g, level)
    means = haar.lowpass(g, level)[..., ::1 << level]
    np.testing.assert_allclose(a.numpy(), (means * 2 ** (level / 2)).numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("level,seed", [(1, 0), (2, 7), (3, 11), (2, 42)])
def test_theorem1_lowpass_dominance(level, seed):
    """Theorem 1 as the reference's property test states it: on a
    column-smooth G meeting Assumption 1, ``||G - P_l(G)||_F`` is below
    the best rank-``n/4`` error.  The reference's construction of G meets
    the assumption for no seed of 0-499 (checked at levels 1-3), so there,
    as in the reference, the inequality binds only where it holds.  On
    every draw: ``P_l(G)`` is the inverse transform of ``[A_l | 0]``, and
    ``||G - P_l(G)||_F^2`` is the detail bands' energy (Parseval), in f64
    at f64's rounding."""
    m = n = 64
    rng = np.random.RandomState(seed)
    base_ = rng.randn(m, 8) @ rng.randn(8, n)
    t = np.linspace(0, 1, n)
    smooth = np.stack([np.sin(2 * np.pi * (f + 1) * t + rng.rand())
                       for f in range(m)])
    G = base_ * 0.1 + smooth + 0.5 * rng.randn(m, 1)
    pl = haar.lowpass(torch.from_numpy(G), level)
    a, ds = haar.haar_forward(torch.from_numpy(G), level)
    np.testing.assert_allclose(
        pl.numpy(), haar.haar_inverse(a, [torch.zeros_like(d)
                                          for d in ds]).numpy(),
        rtol=0, atol=1e-12)
    err_haar = np.linalg.norm(G - pl.numpy())
    np.testing.assert_allclose(
        err_haar ** 2, sum(float((d ** 2).sum()) for d in ds), rtol=1e-12)
    r = n // 4
    sv = np.linalg.svd(G, compute_uv=False)
    if np.linalg.norm(np.diff(G, axis=1)) \
            < np.sin(np.pi / (1 << level)) * np.sqrt(r) * sv[r]:
        assert err_haar < np.sqrt((sv[r:] ** 2).sum())


def test_core_exports_the_reference_names():
    assert core.__all__ == jcore.__all__
    for name in core.__all__:
        assert callable(getattr(core, name)), name


# ---------------------------------------------------------------------------
# state_memory_bytes, param_count
# ---------------------------------------------------------------------------

def _models(arch):
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    jm = jenc if jc.arch_class == "encdec" else jlm
    return jm.abstract_params(jc), module_for(tc).abstract_params(tc)


@pytest.mark.parametrize("arch", STATE_IDS)
def test_state_memory_bytes_equal_reference(arch):
    jp, tp = _models(arch)
    for host in ("adam", "adam_mini", "muon"):
        for level in (1, 2, 3):
            assert state_memory_bytes(tp, level, host=host) \
                == jgwt.state_memory_bytes(jp, level, host=host), \
                (host, level)
    # level 0 is the host on every leaf; bytes_per_el scales every count
    assert state_memory_bytes(tp, 0, bytes_per_el=4) \
        == jgwt.state_memory_bytes(jp, 0, bytes_per_el=4)


def test_state_memory_bytes_counts_qkv_biases_as_gwt_leaves():
    """The reference's deny-list matches ``bias``, not ``bq``/``bk``/``bv``
    (``repro/optim/base.py:82``): the stacked QKV biases are GWT leaves."""
    cfg = tcfg.get_smoke("qwen2.5-3b")
    tp = lm.abstract_params(cfg)
    with_bias = state_memory_bytes(tp, 2)
    paths, leaves = base.flatten_with_paths(tp)
    kept = {p: t for p, t in zip(paths, leaves)
            if p.rsplit("/", 1)[-1] not in ("bq", "bk", "bv")}
    assert any(p.endswith("/bq") for p in paths)
    n = sum(t.numel() for p, t in zip(paths, leaves)
            if p.rsplit("/", 1)[-1] in ("bq", "bk", "bv"))
    assert with_bias["gwt_params"] \
        - state_memory_bytes(base.unflatten(list(kept),
                                            list(kept.values())),
                             2)["gwt_params"] == n


def test_state_memory_bytes_custom_eligible():
    jp, tp = _models("llama-60m")

    def only_mlp(path, leaf):
        return "ffn" in path and leaf.ndim >= 2

    assert state_memory_bytes(tp, 2, eligible=only_mlp) \
        == jgwt.state_memory_bytes(jp, 2, eligible=only_mlp)


@pytest.mark.parametrize("arch", ALL_IDS)
def test_param_count_equal_reference(arch):
    """The count of the reference's parameter shapes, in Python ints.  The
    reference's ``lm.param_count`` takes each leaf's size as a
    ``jnp.prod`` of int32 and wraps past 2^31 elements (deepseek-67b,
    qwen2-vl-72b, the MoE and jamba stacks): the port equals it exactly
    where no leaf is that large."""
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    jm = jenc if jc.arch_class == "encdec" else jlm
    sizes = [int(np.prod(s.shape, dtype=np.int64))
             for s in jax.tree.leaves(jm.abstract_params(jc))]
    got = sum(t.numel() for t in base.flatten_with_paths(
        module_for(tc).abstract_params(tc))[1])
    assert got == sum(sizes)
    if jc.arch_class != "encdec":
        assert lm.param_count(tc) == got
        if max(sizes) < 2**31:
            assert got == jlm.param_count(jc)
        else:
            assert jlm.param_count(jc) != got   # the int32 wrap


# ---------------------------------------------------------------------------
# SHAPES, input_specs, skip_reason
# ---------------------------------------------------------------------------

def test_shapes_equal_reference():
    assert list(tcfg.SHAPES) == list(jcfg.SHAPES)
    for name, s in tcfg.SHAPES.items():
        j = jcfg.SHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind, s.accum_steps) \
            == (j.name, j.seq_len, j.global_batch, j.kind, j.accum_steps)
    assert set(jcfg.__all__) <= set(tcfg.__all__)


@pytest.mark.parametrize("arch", ALL_IDS)
def test_input_specs_and_skip_reason_equal_reference(arch):
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    for name, shape in tcfg.SHAPES.items():
        got = tcfg.input_specs(tc, shape)
        want = jcfg.input_specs(jc, jcfg.SHAPES[name])
        assert list(got) == list(want), name
        assert _specs(got) == _specs(want), name
        assert all(t.device.type == "meta" for t in got.values())
        assert tcfg.skip_reason(tc, shape) \
            == jcfg.skip_reason(jc, jcfg.SHAPES[name])


# ---------------------------------------------------------------------------
# abstract caches and their axes
# ---------------------------------------------------------------------------

DECODER_IDS = [a for a in ALL_IDS
               if jcfg.get_config(a).arch_class != "encdec"]


def _axes(flat):
    return {p: a.names for p, a in flat.items()}


@pytest.mark.parametrize("arch", DECODER_IDS)
def test_abstract_cache_and_axes_equal_reference(arch):
    """Full width: a 4k cache (gemma's and jamba's windowed blocks cut to
    a ring) and the decode_32k shape's; the axes at the defaults."""
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    for B, max_len in ((2, 4096), (128, 32768), (1, 3)):
        got = _tflat(lm.abstract_cache(tc, B, max_len))
        want = _jflat(jlm.abstract_cache(jc, B, max_len))
        assert _specs(got) == _specs(want), (B, max_len)
        assert all(t.device.type == "meta" for t in got.values())
    assert _axes(_tflat(lm.cache_axes(tc))) \
        == _axes(_jflat(jlm.cache_axes(jc), lambda x: isinstance(x, JAxes)))


@pytest.mark.parametrize("arch", DECODER_IDS)
def test_abstract_paged_caches_equal_reference(arch):
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    for quant in (None, "int8"):
        try:
            want = _jflat(jlm.abstract_paged_caches(jc, 33, 16, quant))
        except NotImplementedError:
            with pytest.raises(NotImplementedError):
                lm.abstract_paged_caches(tc, 33, 16, quant)
            continue
        got = _tflat(lm.abstract_paged_caches(tc, 33, 16, quant))
        assert _specs(got) == _specs(want), quant


def test_abstract_caches_are_the_real_caches():
    """The abstract trees are the zeroed caches' shapes and dtypes: one
    builder makes both."""
    for arch in ("jamba-v0.1-52b", "xlstm-350m", "gemma2-9b"):
        cfg = tcfg.get_smoke(arch)
        real = _tflat(lm.init_cache(cfg, 2, 40, "cpu"))
        assert real.pop("pos") == 0
        abst = _tflat(lm.abstract_cache(cfg, 2, 40))
        assert tuple(abst.pop("pos").shape) == ()
        assert _specs(real) == _specs(abst)
        assert all(not t.any() for t in real.values())
    cfg = tcfg.get_smoke("qwen2.5-3b")
    for quant in (None, "int8"):
        assert _specs(_tflat(lm.init_paged_caches(cfg, 5, 4, quant,
                                                  "cpu"))) \
            == _specs(_tflat(lm.abstract_paged_caches(cfg, 5, 4, quant)))


def test_encdec_abstract_cache_and_axes_equal_reference():
    for arch in ("seamless-m4t-large-v2",):
        jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
        for B, max_len, enc_len in ((2, 64, 16), (32, 4096, 8192)):
            got = _tflat(encdec.abstract_cache(tc, B, max_len, enc_len))
            want = _jflat(jenc.abstract_cache(jc, B, max_len, enc_len))
            assert _specs(got) == _specs(want)
        assert _axes(_tflat(encdec.cache_axes(tc))) == _axes(
            _jflat(jenc.cache_axes(jc), lambda x: isinstance(x, JAxes)))
        real = _tflat(encdec.init_cache(tcfg.get_smoke(arch), 2, 8, 4,
                                        "cpu"))
        real.pop("pos")
        abst = _tflat(encdec.abstract_cache(tcfg.get_smoke(arch), 2, 8, 4))
        abst.pop("pos")
        assert _specs(real) == _specs(abst)


# ---------------------------------------------------------------------------
# optim.base, optim.engine
# ---------------------------------------------------------------------------

def test_map_with_path_and_path_str_equal_reference():
    jp = jlm.abstract_params(jcfg.get_smoke("jamba-v0.1-52b"))
    tp = lm.abstract_params(tcfg.get_smoke("jamba-v0.1-52b"))
    want = _jflat(jbase.map_with_path(lambda p, s: (p, s.shape), jp),
                  lambda x: isinstance(x, tuple))
    got = _tflat(base.map_with_path(lambda p, t: (p, tuple(t.shape)), tp))
    assert got == want
    assert base.path_str(("layers", "b0", "mixer")) == "layers/b0/mixer"
    sums = base.map_with_path(lambda p, a, b: a + b, {"x": 1, "y": {"z": 2}},
                              {"x": 10, "y": {"z": 20}})
    assert sums == {"x": 11, "y": {"z": 22}}


@pytest.mark.parametrize("seed", [0, 1])
def test_global_norm_within_two_spacings(seed):
    tree = {"a": _rand(seed, (64, 48)) * 3,
            "b": {"c": _rand(seed + 10, (7,)),
                  "d": _rand(seed + 20, (2, 32, 16))}}
    jtree = {"a": jnp.asarray(tree["a"]),
             "b": {"c": jnp.asarray(tree["b"]["c"]),
                   "d": jnp.asarray(tree["b"]["d"], jnp.bfloat16)}}
    ttree = {"a": to_torch(tree["a"]),
             "b": {"c": to_torch(tree["b"]["c"]),
                   "d": to_torch(tree["b"]["d"], torch.bfloat16)}}
    got = optim.global_norm(ttree)
    assert got.dtype == torch.float32 and got.shape == ()
    assert spacings(got, jax_optim.global_norm(jtree)) <= 2
    assert float(optim.global_norm({})) == 0.0


def test_optim_exports_the_reference_names():
    assert set(jax_optim.__all__) <= set(optim.__all__)
    assert {"REGISTRY", "LOWRANK"} <= set(optim.__all__)
    for name in optim.__all__:
        assert getattr(optim, name) is not None, name


def test_live_update_bytes_is_none_off_the_card():
    calls = []
    p = {"w": torch.ones(4, 8)}
    assert engine.live_update_bytes(lambda *a: calls.append(a), p, p) \
        is None
    assert len(calls) == 0


# ---------------------------------------------------------------------------
# distributed.compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("detail", [torch.bfloat16, torch.float8_e4m3fn,
                                    None])
def test_grad_reducer_one_rank_bitwise(detail):
    tree = {"w": to_torch(_rand(0, (3, 16, 64))),
            "b": {"bias": to_torch(_rand(1, (64,))),
                  "odd": to_torch(_rand(2, (8, 6)))},
            "h": to_torch(_rand(3, (32, 128)), torch.bfloat16)}
    reducer = compression.make_compressed_grad_reducer(None, level=2,
                                                       detail_dtype=detail)
    got = reducer(tree)
    paths, leaves = base.flatten_with_paths(tree)
    want = compression.compressed_means(leaves, None, 2, detail)
    assert list(_tflat(got)) == paths
    for path, a, b in zip(paths, _tflat(got).values(), want):
        assert a.dtype == torch.float32 and torch.equal(a, b), path
    # one worker's mean is the reference's emulated mean of one row, op by
    # op (under jit XLA's CPU contraction moves it by an f32 spacing)
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float8_e4m3fn:
           jnp.float8_e4m3fn, None: None}[detail]
    with jax.disable_jit():
        want_w = jcomp.emulated_mean(jnp.asarray(to_numpy(tree["w"]))[None],
                                     2, jdt)
    np.testing.assert_array_equal(to_numpy(got["w"]), to_numpy(want_w))


@pytest.mark.parametrize("shape,names", [((1,), ("data",)),
                                         ((1, 1), ("data", "model")),
                                         ((1, 1, 1), ("pod", "data",
                                                      "model"))])
def test_ef_state_shardings_equal_reference(shape, names):
    tree = {"w": torch.zeros(1, 16, 64), "b": {"c": torch.zeros(1, 8)}}
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(shape),
                              names)
    dp = ("pod", "data") if "pod" in names else ("data",)
    want = _jflat(jcomp.ef_state_shardings(
        {"w": jnp.zeros((1, 16, 64)), "b": {"c": jnp.zeros((1, 8))}},
        jmesh, dp), lambda x: hasattr(x, "spec"))
    got = sharding.flat_shardings(compression.ef_state_shardings(
        tree, sharding.Mesh(shape, names)))
    assert {p: tuple(s.spec) for p, s in got.items()} \
        == {p: tuple(s.spec) for p, s in want.items()}


def test_ef_init_rows_match_reference_layout():
    tree = {"w": torch.zeros(16, 64), "b": torch.zeros(8)}
    ef = compression.ef_init(tree)
    want = jcomp.ef_init({"w": jnp.zeros((16, 64)), "b": jnp.zeros((8,))})
    assert _specs(_tflat(ef)) == _specs(_jflat(want))
    assert flat_numpy(want).keys() == _tflat(ef).keys()
