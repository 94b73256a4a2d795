"""The grouped forward DWT of the port (K3 ``haar_dwt_fwd_q_group``, K6
``haar_dwt_fwd_group``) and the grouped data-parallel reduction
(``compression.compressed_means(_ef)``), on the CPU.

* ``ops.dwt_wire_group`` on CPU tensors is the plain version leaf by leaf:
  bitwise equal to the JAX package's oracle run op by op
  (``jax.disable_jit()``; inside ``jit`` XLA contracts FMAs, see
  ``test_torch_dp.py``), details crossing the fp8 boundary included.
* ``compressed_means(_ef)`` on a llama-60m-smoke gradient tree is bitwise
  equal to the per-leaf ``compressed_mean(_ef)`` and to the JAX package's
  ``emulated_mean(_ef)``.
* The wrapper's layout (one buffer, bands at 16-byte offsets, the first-tile
  column, the split of a group larger than a launch takes) is checked as
  plain Python, and the whole wrapper against a stand-in for the CUDA
  library that reads the leaf table the wrapper fills and writes the bands
  with the plain version.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (caps torch's threads)

from repro.distributed import compression as jc
from repro.kernels.haar_dwt import ref as jref
from repro_torch import configs
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed import compression as tc
from repro_torch.kernels.haar_dwt import kernel, ops, ref
from repro_torch.models import lm
from repro_torch.optim.base import flatten_with_paths

WIRES = ["bfloat16", "float16", "float8_e4m3fn"]


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().view({1: torch.uint8, 2: torch.int16,
                             4: torch.int32}[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _bitwise(got, want, what=""):
    g, w = _bits(got), _bits(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert int((g != w).sum()) == 0, f"{what}: {int((g != w).sum())} differ"


def _leaves(level, seed=0, scale=300.0):
    """Mixed (m, n) f32 leaves: odd rows, an odd coefficient count, one
    row; row 0 of the first carries values past the fp8 range and +-inf,
    each in its own level-3 group of 8 columns."""
    rng = np.random.RandomState(seed)
    shapes = [(37, 344), (101, 43 << level), (1, 64), (8, 512)]
    xs = [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]
    xs[0][0, [0, 8, 16, 24, 32]] = [464, 465, -1e30, np.inf, -np.inf]
    return xs


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("level", [1, 2, 3])
def test_dwt_wire_group_matches_reference(level, wire):
    xs = _leaves(level, seed=level)
    got = ops.dwt_wire_group([torch.from_numpy(x) for x in xs], level,
                             getattr(torch, wire))
    assert len(got) == len(xs)
    for i, (x, bands) in enumerate(zip(xs, got)):
        with jax.disable_jit():
            want = jref.haar_dwt_fwd_q(jnp.asarray(x), level,
                                       jnp.dtype(wire))
        assert len(bands) == len(want) == level + 1
        for k, (g, w) in enumerate(zip(bands, want)):
            _bitwise(g, w, f"leaf {i} band {k}")


TCFG = configs.get_smoke("llama-60m")


def _smoke_grads():
    model = lm.init(TCFG, torch.Generator().manual_seed(0), "cpu")
    params = model.tree()
    batch = {k: torch.from_numpy(v)
             for k, v in SyntheticLM(64, 16, 4, 0).batch(0).items()}
    paths, leaves = flatten_with_paths(params)
    grads, _ = lm._accumulate(TCFG, params, leaves,
                              lm.contiguous_microbatches(batch, 1), 1)
    return paths, [g.detach() for g in grads]


@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("wire", ["bfloat16", "float8_e4m3fn", None])
def test_compressed_means_match_per_leaf_and_reference(wire, ef):
    paths, grads = _smoke_grads()
    rng = np.random.RandomState(1)
    errs = [torch.from_numpy((rng.randn(*g.shape) * 1e-4)
                             .astype(np.float32)) for g in grads]
    tw = None if wire is None else getattr(torch, wire)
    jw = None if wire is None else jnp.dtype(wire)
    if ef:
        means, new_errs = tc.compressed_means_ef(grads, errs, None, 2, tw)
        per_leaf = [tc.compressed_mean_ef(g, e, None, 2, tw)
                    for g, e in zip(grads, errs)]
        for i, (m, e) in enumerate(per_leaf):
            _bitwise(means[i], m, paths[i])
            _bitwise(new_errs[i], e, paths[i])
    else:
        means = tc.compressed_means(grads, None, 2, tw)
        for i, g in enumerate(grads):
            _bitwise(means[i], tc.compressed_mean(g, None, 2, tw), paths[i])
    n_compressed = 0
    for i, g in enumerate(grads):
        if wire is None or not tc.compressible(g.shape, 2):
            _bitwise(means[i], g, paths[i])   # one rank: the exact mean
            if ef:
                assert not new_errs[i].any()
            continue
        n_compressed += 1
        stack = jnp.asarray(g.numpy()[None])
        with jax.disable_jit():
            if ef:
                want, want_err = jc.emulated_mean_ef(
                    stack, jnp.asarray(errs[i].numpy()[None]), 2, jw)
                _bitwise(new_errs[i], want_err[0], paths[i])
            else:
                want = jc.emulated_mean(stack, 2, jw)
        _bitwise(means[i], want, paths[i])
    assert n_compressed == (0 if wire is None else len(grads) - 1)


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("sizes", [(4, 1, 2), (4, 4, 1), (4, 2, 1)])
def test_group_layout(sizes, level):
    """Every band at a 16-byte offset, in order, without overlap; the total
    byte count; first tiles; 40 leaves split 32 + 8 (and 4 a launch)."""
    a_size, d_size, _ = sizes
    shapes = [(1 + i % 5, 8 * (3 + i % 11)) for i in range(40)]
    tile = 64
    for capacity in (kernel.GROUP_LEAVES, 4):
        lay = kernel.group_layout(shapes, level, a_size, d_size, tile,
                                  capacity)
        end = 0
        for (m, n), bands in zip(shapes, lay.bands):
            assert [s for _, s in bands] == [(m, n >> level)] + [
                (m, n >> k) for k in range(level, 0, -1)]
            for j, (at, (r, w)) in enumerate(bands):
                assert at % 16 == 0 and at >= end
                end = at + r * w * (a_size if j == 0 else d_size)
        assert lay.nbytes == -(-end // 16) * 16
        want_launches = [list(range(lo, min(lo + capacity, 40)))
                         for lo in range(0, 40, capacity)]
        assert [[i for i, _ in rows] for rows in lay.launches] == \
            want_launches
        for rows, tiles in zip(lay.launches, lay.tiles):
            first = 0
            for i, f in rows:
                assert f == first
                m, n = shapes[i]
                first += -(-(m * (n >> level)) // tile)
            assert tiles == first


_CODES = {0: torch.float32, 1: torch.bfloat16, 2: torch.float16,
          3: torch.float8_e4m3fn}
TILE, PER_SM, SMS = 64, 2, 3


def _at(ptr, numel, dtype):
    raw = (ctypes.c_char * (numel * dtype.itemsize)).from_address(ptr)
    return torch.frombuffer(raw, dtype=dtype)


class FakeLib:
    """The grouped forward of csrc/haar_dwt.cu on the CPU: reads the leaf
    table as the kernel does and writes each leaf's bands with the plain
    version (a leaf's flat input as (count, 2^l) rows: the same bands),
    checking the first tiles, the alignment flags and the grid."""

    _name = "fake"

    def __init__(self, err=0):
        self.err, self.launches = err, []

    def haar_dwt_fwd_group(self, cin, ca, cd, level, table, n, grid, stream):
        raw = (ctypes.c_char * (n * kernel.LEAF.itemsize)).from_address(table)
        first = 0
        for e in np.frombuffer(raw, kernel.LEAF):
            g_ptr, count = int(e["g"]), int(e["count"])
            assert e["first_tile"] == first
            assert e["vec"] == int(g_ptr % 16 == 0)
            assert not e["d"][level:].any()
            first += -(-count // TILE)
            if self.err:
                continue
            g = _at(g_ptr, count << level, _CODES[cin]).view(count, -1)
            if ca == cd:
                bands = ref.haar_dwt_fwd(g, level)
            else:
                bands = ref.haar_dwt_fwd_q(g, level, _CODES[cd])
            ptrs = [int(e["a"])] + [int(p) for p in e["d"][:level]]
            for ptr, band in zip(ptrs, bands):
                assert ptr % 16 == 0
                _at(ptr, band.numel(), band.dtype).copy_(band.reshape(-1))
        assert grid == min(first, PER_SM * SMS) and stream == 0
        self.launches.append(n)
        return self.err


@pytest.fixture
def fake(monkeypatch):
    lib = FakeLib()
    monkeypatch.setattr(kernel, "_lib", lambda: lib)
    monkeypatch.setattr(kernel, "_require_cuda", lambda name, x: None)
    monkeypatch.setattr(kernel, "_stream", lambda device: 0)
    monkeypatch.setattr(kernel, "fwd_plan", lambda codes, level, device: {
        "tile": TILE, "group_leaves": kernel.GROUP_LEAVES,
        "blocks_per_sm": PER_SM, "sms": SMS, "smem": 0})
    return lib


def _unaligned(x):
    buf = torch.empty(x.numel() + 1, dtype=x.dtype)
    buf[1:].copy_(x.reshape(-1))
    return buf[1:].view(x.shape)


@pytest.mark.parametrize("kind", ["K3 bf16", "K3 fp8", "K6 f32",
                                  "K6 bf16"])
@pytest.mark.parametrize("level", [1, 2, 3])
def test_group_wrapper_fills_the_table(fake, level, kind):
    """40 leaves (two launches), some unaligned: every band bitwise to the
    per-leaf plain version, views of one buffer, counters exact."""
    rng = np.random.RandomState(level)
    gs = [torch.from_numpy((rng.randn(1 + i % 5, 8 * (3 + i % 11)) * 300)
                           .astype(np.float32)) for i in range(40)]
    if kind.startswith("K6"):
        gs = [g.to(getattr(torch, {"f32": "float32", "bf16": "bfloat16"}[
            kind.split()[1]])) for g in gs]
    gs = [_unaligned(g) if i % 3 == 1 else g for i, g in enumerate(gs)]
    before = (kernel.launches_fwd_q, kernel.leaves_fwd_q,
              kernel.launches_fwd, kernel.leaves_fwd)
    if kind.startswith("K3"):
        wire = torch.bfloat16 if kind.endswith("bf16") \
            else torch.float8_e4m3fn
        got = kernel.haar_dwt_fwd_q_group(gs, level, wire)
        wants = [ref.haar_dwt_fwd_q(g, level, wire) for g in gs]
        rise = (2, 40, 0, 0)
    else:
        got = kernel.haar_dwt_fwd_group(gs, level)
        wants = [ref.haar_dwt_fwd(g, level) for g in gs]
        rise = (0, 0, 2, 40)
    after = (kernel.launches_fwd_q, kernel.leaves_fwd_q,
             kernel.launches_fwd, kernel.leaves_fwd)
    assert tuple(a - b for a, b in zip(after, before)) == rise
    assert fake.launches == [kernel.GROUP_LEAVES, 40 - kernel.GROUP_LEAVES]
    base = got[0][0].untyped_storage().data_ptr()
    for i, (bands, want) in enumerate(zip(got, wants)):
        assert len(bands) == level + 1
        for k, (b, w) in enumerate(zip(bands, want)):
            assert b.dtype == w.dtype and b.shape == w.shape
            assert b.untyped_storage().data_ptr() == base
            assert b.data_ptr() % 16 == 0 and b.is_contiguous()
            _bitwise(b, w, f"leaf {i} band {k}")
    # a group of one is the single-leaf entry
    one = kernel.haar_dwt_fwd(gs[1].float(), level)
    for b, w in zip(one, ref.haar_dwt_fwd(gs[1].float(), level)):
        _bitwise(b, w)


def test_a_failed_group_launch_raises_and_counts_nothing(fake):
    fake.err = 1
    before = (kernel.launches_fwd_q, kernel.leaves_fwd_q)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        kernel.haar_dwt_fwd_q_group([torch.randn(4, 64)], 2, torch.bfloat16)
    assert (kernel.launches_fwd_q, kernel.leaves_fwd_q) == before


def test_group_entries_refuse_what_they_do_not_take(fake):
    g = torch.randn(8, 64)
    for fn, match in [
            (lambda: kernel.haar_dwt_fwd_q_group([g, g.half()], 2,
                                                 torch.bfloat16), "float32"),
            (lambda: kernel.haar_dwt_fwd_q_group([g], 2, torch.float32),
             "wire dtype"),
            (lambda: kernel.haar_dwt_fwd_group([g, g.bfloat16()], 2),
             "dtype"),
            (lambda: kernel.haar_dwt_fwd_group([g, g.t()], 2), "contiguous"),
            (lambda: kernel.haar_dwt_fwd_group([g[:, :62].contiguous()], 2),
             "divisible"),
            (lambda: kernel.haar_dwt_fwd_group([g], 7), "level"),
            (lambda: kernel.haar_dwt_fwd_group([g.reshape(-1)], 2), "2-D"),
            (lambda: kernel.haar_dwt_fwd_group([g[:0]], 2), "empty")]:
        with pytest.raises(ValueError, match=match):
            fn()
    assert fake.launches == []


def test_group_entries_refuse_cpu_tensors():
    g = torch.randn(8, 64)
    before = (kernel.launches_fwd_q, kernel.launches_fwd)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.haar_dwt_fwd_q_group([g], 2, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.haar_dwt_fwd_group([g], 2)
    assert (kernel.launches_fwd_q, kernel.launches_fwd) == before
    # the entry point takes the plain version for CPU tensors
    assert ops.dwt_wire_group([], 2, torch.bfloat16) == []
