"""The grouped K1 and K2 (one launch over several one-pass buckets) on the
CPU: ``kernel.group_plan`` at the H100's figures, the grouped wrappers'
tables, counters and refusals through a fake library, the grouped plain
versions against the per-bucket ones and the JAX package's per-bucket
``fused_write_update(_q8)``, and the engine's grouped flow against the
per-bucket flow over LoRA steps of a tiny llama.

The card's figures are those of ``tests/test_torch_fused_design.py``: 132
SMs, 14 chunk slots of 16 KB a block for K1 and 13 for K2 (bf16 at level
2).  Tolerances against the JAX package are those of
``tests/test_torch_gwt_adam.py`` and ``tests/test_torch_gwt_q8.py``: the
moments 4 f32 spacings (XLA contracts FMAs), p 4 f32 spacings or one bf16
spacing, the norm 4 f32 spacings or 64 (bf16), int8 codes within 1 on at
most 8 codes, scales 2 spacings.  The kernels themselves run only on the
card (the ``cuda`` test below, ``chip_smoke.py`` phase 40).
"""

import ctypes

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import prng
from repro_torch.core.gwt import gwt
from repro_torch.kernels.gwt_adam import kernel, ops, ref
from repro_torch.models import lm, lora
from repro_torch.optim import codec
from repro_torch.optim.base import flatten_with_paths, tree_map

H100_SMS = 132
K1_SMEM = 232_448 - 48
K2_SMEM = 232_448 - 48 - 2 * 4416
BF16, F32 = torch.bfloat16, torch.float32

# the LoRA adapter buckets of the launcher (rank 8, rows merged, plan
# order; chip_smoke.LORA_BUCKETS) and llama-60m's GWT buckets in plan order
# (w_down, w_gate/w_up, wq/wk/wv/wo)
LLAMA_ADAPTERS = [(1, 11008, 8), (5, 64, 512), (6, 4096, 8), (2, 64, 1376)]
QWEN_ADAPTERS = [(1, 396288, 8), (3, 288, 2048), (6, 73728, 8),
                 (2, 288, 11008), (2, 288, 256)]
MAIN = [(1, 11008, 512), (2, 4096, 1376), (4, 4096, 512)]


def _plan(shapes, smem, dtype=BF16, levels=None, keys=None):
    levels = levels or [2] * len(shapes)
    keys = keys or [None] * len(shapes)
    return kernel.group_plan(list(zip(shapes, [dtype] * len(shapes), levels,
                                      keys)), H100_SMS, smem)


@pytest.mark.parametrize("shapes,smem,kw,want", [
    # 77 chunks: one launch for K1 and for K2
    (LLAMA_ADAPTERS, K1_SMEM, {}, [[0, 1, 2, 3]]),
    (LLAMA_ADAPTERS, K2_SMEM, {}, [[0, 1, 2, 3]]),
    # 1827 chunks: within K1's 14 x 132 = 1848; K2's 13 x 132 = 1716 takes
    # 387 + 216 + 432, then 774 + 18
    (QWEN_ADAPTERS, K1_SMEM, {}, [[0, 1, 2, 3, 4]]),
    (QWEN_ADAPTERS, K2_SMEM, {}, [[0, 1, 2], [3, 4]]),
    # 688, 1376, 1024 chunks: no two neighbours fit together
    (MAIN, K1_SMEM, {}, [[0], [1], [2]]),
    (MAIN, K2_SMEM, {}, [[0], [1], [2]]),
    # a two-pass bucket (42 slots a block) alone, ending the group before it
    ([(2, 36, 256), (1, 36, 2048), (8, 4096, 1376), (2, 36, 256)], K1_SMEM,
     {}, [[0, 1], [2], [3]]),
    # the table's cap of 16 buckets
    ([(1, 64, 512)] * 20, K1_SMEM, {}, [list(range(16)), [16, 17, 18, 19]]),
    # another level, another key, another dtype: never in one launch
    ([(1, 4112, 1376), (2, 36, 256)], K1_SMEM, {"levels": [2, 3]},
     [[0], [1]]),
    ([(2, 36, 256), (1, 36, 2048)], K1_SMEM, {"keys": ["a", "b"]},
     [[0], [1]]),
    # an empty bucket takes the two-pass design, alone
    ([(2, 36, 256), (0, 36, 256), (1, 36, 2048)], K1_SMEM, {},
     [[0], [1], [2]]),
], ids=["llama-60m adapters K1", "llama-60m adapters K2",
        "qwen2.5-3b adapters K1", "qwen2.5-3b adapters K2", "MAIN K1",
        "MAIN K2", "two-pass alone", "table cap", "levels", "keys",
        "empty"])
def test_group_plan_at_h100_figures(shapes, smem, kw, want):
    assert _plan(shapes, smem, **kw) == want
    # every launch fits: the capacity rule summed over it
    for launch in want:
        chunks = sum(kernel._chunks(shapes[i], 2) for i in launch)
        if len(launch) > 1:
            assert -(-chunks // H100_SMS) * 16384 <= smem


def test_group_plan_mixed_dtypes_split():
    """f32 buckets (32 KB slots) never join bf16 ones."""
    assert kernel.group_plan([((2, 36, 256), BF16, 2, None),
                              ((2, 36, 256), F32, 2, None)],
                             H100_SMS, K1_SMEM) == [[0], [1]]


def test_group_layout_and_write_groups(monkeypatch):
    lay = kernel.group_layout([(2, 100), (1, 4097), (3, 2048)])
    assert lay.norms == (0, 2, 3)
    assert lay.partials == (6, 8, 11)
    assert lay.first == (0, 2, 5)
    assert lay.floats == 14
    buckets = [((2, 36, 256), BF16, F32, F32), ((1, 36, 2048), BF16, F32,
                                                 F32),
               ((2, 36, 256), BF16, F32, BF16)]
    # the CPU has no capacity: every bucket alone
    assert ops.fused_write_groups(buckets, q8=False, level=2,
                                  device="cpu") == [[0], [1], [2]]
    seen = []

    def capacity(name, dtype, level, mdtype=F32, pdtype=None):
        seen.append((name, dtype, mdtype, pdtype))
        return H100_SMS, K1_SMEM
    monkeypatch.setattr(kernel, "capacity", capacity)
    # on CUDA the card's launches, a change of moment dtype ending one
    assert ops.fused_write_groups(buckets, q8=False, level=2,
                                  device="cuda") == [[0, 1], [2]]
    assert seen == [("gwt_adam_fused", BF16, F32, F32),
                    ("gwt_adam_fused", BF16, BF16, F32)]
    # K2 ignores the moments' dtype
    seen.clear()
    assert ops.fused_write_groups(
        [(s, g, p, None) for s, g, p, _ in buckets], q8=True, level=2,
        device="cuda") == [[0, 1, 2]]
    assert seen == [("gwt_adam_fused_q8", BF16, F32, F32)]


# ---------------------------------------------------------------------------
# The grouped wrappers with a fake library.


class _FakeLib:
    """Records each entry called and, for the grouped entries, the table
    as it is at the call."""

    def __init__(self, err=0):
        self.called, self.tables, self.err = [], [], err

    def __getattr__(self, name):
        def fn(*args):
            self.called.append(name)
            if name.endswith("_group"):
                fields = len(kernel.RECORDS[name[:-len("_group")]])
                n_codes = 1 if "q8" in name else 2
                addr, n = args[n_codes + 1], args[n_codes + 2]
                table = np.ctypeslib.as_array(
                    (ctypes.c_longlong * (n * fields)).from_address(addr))
                self.tables.append((args[:n_codes + 1],
                                    table.reshape(n, fields).copy(),
                                    args[n_codes + 3:]))
            return self.err
        return fn


COUNTERS = ("launches", "launches_one_pass", "launches_two_pass",
            "launches_group", "buckets_group", "launches_q8",
            "launches_q8_one_pass", "launches_q8_two_pass",
            "launches_q8_group", "buckets_q8_group")


def _counts():
    return {n: getattr(kernel, n) for n in COUNTERS}


@pytest.fixture
def faked(monkeypatch):
    """The wrappers with a fake library, the H100's capacity and plan, and
    CPU tensors let through."""
    lib = _FakeLib()
    monkeypatch.setattr(kernel, "_load", lambda name: lib)
    monkeypatch.setattr(kernel, "_require_cuda", lambda g: None)
    monkeypatch.setattr(kernel, "_stream", lambda device: 0)

    def capacity(name, dtype, level, mdtype=F32, pdtype=None):
        return H100_SMS, K2_SMEM if name.endswith("q8") else K1_SMEM

    def plan(name, shape, dtype, level, mdtype=F32, pdtype=None):
        return {"grid": int(kernel.one_pass_fits(
            shape, dtype, level, *capacity(name, dtype, level)))}
    monkeypatch.setattr(kernel, "capacity", capacity)
    monkeypatch.setattr(kernel, "one_pass_plan", plan)
    for name in COUNTERS:
        monkeypatch.setattr(kernel, name, 0)
    return lib


_KW = dict(level=2, gamma=1.01, use_limiter=True, weight_decay=True)


def _k1_calls(shapes, dtype=BF16, pdtype=F32, mdtype=F32, device="cpu",
              level=2, **kw):
    e = lambda *s, dt=F32: torch.zeros(s, dtype=dt, device=device)
    return [((e(L, m, n, dt=dtype), e(L, m, n, dt=pdtype),
              e(L, m, n >> level, dt=mdtype), e(L, m, n >> level, dt=mdtype),
              e(L), e(), e()), dict(_KW, level=level, **kw))
            for L, m, n in shapes]


def _k2_calls(shapes, dtype=BF16, pdtype=F32, device="cpu", level=2, **kw):
    e = lambda *s, dt=F32: torch.zeros(s, dtype=dt, device=device)
    out = []
    for L, m, n in shapes:
        nb = -(-m * (n >> level) // 64)
        q = lambda: e(L, m, n >> level, dt=torch.int8)
        out.append(((e(L, m, n, dt=dtype), e(L, m, n, dt=pdtype), q(),
                     e(L, nb), q(), e(L, nb), e(L, dt=torch.uint32),
                     e(L, dt=torch.uint32), e(L), e(), e()),
                    dict(_KW, level=level, block=64, **kw)))
    return out


SMALL = [(1, 40, 8), (3, 8, 64), (2, 130, 8), (2, 8, 172)]


@pytest.mark.parametrize("q8", [False, True], ids=["K1", "K2"])
def test_grouped_table_pointers_sizes_and_first_chunks(faked, q8):
    calls = (_k2_calls if q8 else _k1_calls)(SMALL)
    fn = kernel.gwt_adam_fused_q8_group if q8 else kernel.gwt_adam_fused_group
    out = fn(calls)
    name = "gwt_adam_fused_q8" if q8 else "gwt_adam_fused"
    assert faked.called == [name + "_group"]
    head, table, tail = faked.tables[0]
    assert head == ((2, 2) if q8 else (2, 0, 2))   # codes, then the level
    gamma, b1, c1, b2, c2, eps, lim, wd, stream = tail
    assert (gamma, b1, b2, eps, lim, wd, stream) == (1.01, 0.9, 0.999, 1e-6,
                                                     1, 1, 0)
    assert c1 == pytest.approx(0.1) and c2 == pytest.approx(0.001)
    fields = {f: i for i, f in enumerate(kernel.RECORDS[name])}
    nas = [m * (n >> 2) for _, m, n in SMALL]
    chunks = [L * -(-na // kernel.CHUNK) for (L, _, _), na in zip(SMALL, nas)]
    assert list(table[:, fields["L"]]) == [L for L, _, _ in SMALL]
    assert list(table[:, fields["na"]]) == nas
    assert list(table[:, fields["first"]]) == list(np.cumsum([0] + chunks[:-1]))
    n_t = 8 if q8 else 4
    for row, (args, _), res in zip(table, calls, out):
        tensors = args[:n_t]
        pn, ss, wd_coef = args[n_t:]
        assert list(row[:n_t]) == [t.data_ptr() for t in tensors]
        assert row[fields["prev_norm"]] == pn.data_ptr()
        assert row[fields["step_size"]] == ss.data_ptr()
        assert row[fields["wd_coef"]] == wd_coef.data_ptr()
        # p and the moments come back in place, the norm where the table
        # put it
        assert all(a is b for a, b in zip(res[:-1], tensors[1:n_t - 2 * q8]))
        assert res[-1].shape == (args[0].shape[0],)
        assert row[fields["new_norm"]] == res[-1].data_ptr()
    # one buffer: every bucket's norms, then every bucket's partials
    base = out[0][-1].data_ptr()
    norms = list(np.cumsum([0] + [L for L, _, _ in SMALL[:-1]]))
    assert list(table[:, fields["new_norm"]]) == [base + 4 * o for o in norms]
    parts = list(np.cumsum([sum(L for L, _, _ in SMALL)] + chunks[:-1]))
    assert list(table[:, fields["partials"]]) == [base + 4 * o for o in parts]
    k = "q8_" if q8 else ""
    assert getattr(kernel, f"launches_{k}group") == 1
    assert getattr(kernel, f"buckets_{k}group") == 4
    assert getattr(kernel, "launches_q8" if q8 else "launches") == 1
    assert getattr(kernel, f"launches_{k}one_pass") == 1


@pytest.mark.parametrize("q8", [False, True], ids=["K1", "K2"])
def test_grouped_launches_counted_by_launch_and_bucket(faked, q8):
    """qwen2.5-3b's adapters in ``group_plan``'s launches (K1 one launch of
    5 buckets, K2 two: 3 + 2), each set one grouped call, counted once by
    launch and by its buckets; a set of one is a grouped launch too."""
    mk = _k2_calls if q8 else _k1_calls
    fn = kernel.gwt_adam_fused_q8_group if q8 else kernel.gwt_adam_fused_group
    name = "gwt_adam_fused_q8" if q8 else "gwt_adam_fused"
    fn(mk([(2, 36, 256)], device="meta"))
    before = _counts()
    launches = _plan(QWEN_ADAPTERS, K2_SMEM if q8 else K1_SMEM)
    groups = [3, 2] if q8 else [5]
    assert [len(x) for x in launches] == groups
    out = [r for launch in launches
           for r in fn(mk([QWEN_ADAPTERS[i] for i in launch], device="meta"))]
    assert len(out) == 5
    k = "q8_" if q8 else ""
    got = {n: v - before[n] for n, v in _counts().items()}
    assert got[f"launches_{k}group"] == len(groups)
    assert got[f"buckets_{k}group"] == 5
    assert got["launches_q8" if q8 else "launches"] == len(groups)
    assert got[f"launches_{k}one_pass"] == len(groups)
    assert got[f"launches_{k}two_pass"] == 0
    assert faked.called == [name + "_group"] * (1 + len(groups))
    assert [len(t) for _, t, _ in faked.tables] == [1] + groups


# sets that are not one launch of group_plan at the H100's figures
BEYOND_ONE_LAUNCH = {
    "over capacity": QWEN_ADAPTERS + [(2, 288, 11008)],
    "two-pass bucket": [(2, 36, 256), (8, 4096, 1376)],
    "table cap": [(1, 64, 512)] * 17,
    "empty bucket": [(2, 36, 256), (0, 36, 256)],
}


@pytest.mark.parametrize("q8", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("case", list(BEYOND_ONE_LAUNCH))
def test_grouped_wrappers_refuse_sets_beyond_one_launch(faked, q8, case):
    """The wrappers launch the set they are given or nothing: a set that
    ``group_plan`` would split is refused, and nothing is launched or
    counted."""
    shapes = BEYOND_ONE_LAUNCH[case]
    assert len(_plan(shapes, K2_SMEM if q8 else K1_SMEM)) > 1
    fn = kernel.gwt_adam_fused_q8_group if q8 else kernel.gwt_adam_fused_group
    with pytest.raises(ValueError, match="one launch|at most|one-pass"):
        fn((_k2_calls if q8 else _k1_calls)(shapes, device="meta"))
    assert faked.called == [] and not any(_counts().values())


def _refusals(q8):
    mk = _k2_calls if q8 else _k1_calls
    two = [(2, 36, 256), (1, 36, 2048)]
    cases = [
        ("codes", mk(two[:1]) + mk(two[1:], pdtype=BF16), "codes"),
        ("level", mk(two[:1]) + mk(two[1:], level=3), "level"),
        ("gamma", mk(two[:1]) + mk(two[1:], gamma=1.02), "hyperparameters"),
        ("limiter", mk(two[:1]) + mk(two[1:], use_limiter=False),
         "hyperparameters"),
        ("eps", mk(two[:1]) + mk(two[1:], eps=1e-8), "hyperparameters"),
        ("p shape", [((a[0], a[1][:, :-1].contiguous()) + a[2:], kw)
                     for a, kw in mk(two)], "shape"),
    ]
    if not q8:
        cases.append(("moment dtype", mk(two[:1]) + mk(two[1:], mdtype=BF16),
                      "codes"))
    return cases


@pytest.mark.parametrize("q8,case", [
    (q8, i) for q8 in (False, True) for i in range(len(_refusals(q8)))],
    ids=[f"{'K2' if q8 else 'K1'} {c[0]}" for q8 in (False, True)
         for c in _refusals(q8)])
def test_grouped_wrappers_refuse_mixed_groups(faked, q8, case):
    _, calls, match = _refusals(q8)[case]
    fn = kernel.gwt_adam_fused_q8_group if q8 else kernel.gwt_adam_fused_group
    with pytest.raises(ValueError, match=match):
        fn(calls)
    assert faked.called == [] and not any(_counts().values())


@pytest.mark.parametrize("q8", [False, True], ids=["K1", "K2"])
def test_grouped_wrappers_refuse_cpu_tensors(q8):
    before = _counts()
    calls = (_k2_calls if q8 else _k1_calls)([(2, 36, 256), (1, 36, 2048)])
    fn = kernel.gwt_adam_fused_q8_group if q8 else kernel.gwt_adam_fused_group
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(calls)
    assert _counts() == before
    assert fn([]) == []


@pytest.mark.parametrize("q8", [False, True], ids=["K1", "K2"])
def test_a_failed_grouped_launch_raises_and_counts_nothing(faked, q8,
                                                           monkeypatch):
    failing = _FakeLib(err=720)    # cudaErrorCooperativeLaunchTooLarge
    monkeypatch.setattr(kernel, "_load", lambda name: failing)
    calls = (_k2_calls if q8 else _k1_calls)(SMALL)
    fn = kernel.gwt_adam_fused_q8_group if q8 else kernel.gwt_adam_fused_group
    with pytest.raises(RuntimeError, match="grouped launch of 4 buckets.*"
                                           "CUDA error 720"):
        fn(calls)
    assert not any(_counts().values())


# ---------------------------------------------------------------------------
# The grouped plain versions.

ADAPTERS = [(1, 40, 8), (3, 8, 64)]


def _inputs(shape, seed):
    L, m, n = shape
    rng = np.random.RandomState(seed)
    return (rng.randn(L, m, n).astype(np.float32),
            rng.randn(L, m, n).astype(np.float32),
            (rng.randn(L, m, n >> 2) * 0.1).astype(np.float32),
            (rng.rand(L, m, n >> 2) * 0.01).astype(np.float32))


def _quant(a, salt):
    """The JAX codec's blocked-int8 encoding of ``a``, leaf by leaf."""
    import jax
    import jax.numpy as jnp
    from repro.optim import codec as jcodec
    L = a.shape[0]
    enc = jax.vmap(lambda x, s: jcodec.blocked_quant(x, s))
    q, s = enc(jnp.asarray(a.reshape(L, -1)),
               jnp.arange(L, dtype=jnp.uint32) + salt)
    return np.asarray(q).reshape(a.shape), np.asarray(s)


@pytest.mark.parametrize("q8", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("dtype,case", [
    ("float32", (True, 1e-3, 0.1)), ("bfloat16", (False, 1.0, 0.0))],
    ids=["f32, clipping, weight decay", "bf16, limiter off"])
def test_grouped_plain_versions_match_per_bucket_and_reference(q8, dtype,
                                                              case):
    """Each bucket of a grouped plain call bitwise its own per-bucket call,
    and within the existing parity tests' tolerances of the JAX package's
    per-bucket ``fused_write_update(_q8)`` (impl jnp)."""
    # the JAX package here, not at the top: the card's machine, which runs
    # the cuda test below, has no JAX
    import jax.numpy as jnp
    from torch_parity import bf16_spacings, spacings, to_torch
    from repro.kernels.gwt_adam import ops as jops
    from repro.optim import codec as jcodec
    use_limiter, prev, wd = case
    tdt = getattr(torch, dtype)
    kw = dict(alpha=0.25, weight_decay=wd, gamma=1.01,
              use_limiter=use_limiter, level=2)
    step = torch.tensor(5, dtype=torch.int32)
    lr = torch.tensor(0.01)
    calls, wants = [], []
    for k, shape in enumerate(ADAPTERS):
        L = shape[0]
        g, p, mm, vv = _inputs(shape, 17 * k + 3)
        pn = np.full((L,), prev, np.float32)
        jg, jp = (jnp.asarray(x).astype(dtype) for x in (g, p))
        if q8:
            (qm, sm), (qv, sv) = _quant(mm, 11), _quant(vv, 12)
            lids = np.arange(3 + k, 3 + k + L, dtype=np.int32)
            wants.append(jops.fused_write_update_q8(
                jg, jp, {"m": {"q": jnp.asarray(qm), "scale": jnp.asarray(sm)},
                         "v": {"q": jnp.asarray(qv), "scale": jnp.asarray(sv)}},
                jnp.int32(5), jcodec.make_key(0), jnp.asarray(lids),
                jnp.asarray(pn), lr_t=0.01, impl="jnp", **kw))
            salts = codec.slot_salt(codec.make_key(0), step,
                                    torch.arange(2)[:, None],
                                    torch.from_numpy(lids))
            st = {"m": {"q": to_torch(qm), "scale": to_torch(sm)},
                  "v": {"q": to_torch(qv), "scale": to_torch(sv)}}
            calls.append(((to_torch(g, tdt), to_torch(p, tdt), st, step,
                           salts, to_torch(pn)), dict(lr_t=lr, **kw)))
        else:
            wants.append(jops.fused_write_update(
                jg, jp, {"m": jnp.asarray(mm), "v": jnp.asarray(vv)},
                jnp.int32(5), jnp.asarray(pn), lr_t=0.01, impl="jnp", **kw))
            calls.append(((to_torch(g, tdt), to_torch(p, tdt),
                           {"m": to_torch(mm), "v": to_torch(vv)}, step,
                           to_torch(pn)), dict(lr_t=lr, **kw)))
    single = ops.fused_write_update_q8 if q8 else ops.fused_write_update
    grouped = ops.fused_write_update_q8_group if q8 \
        else ops.fused_write_update_group
    got = grouped(calls)
    for (args, kwargs), (tp, tn, ts), (jp, jn, js) in zip(calls, got, wants):
        sp, sn, ss = single(*args, **kwargs)
        assert torch.equal(tp, sp) and torch.equal(tn, sn)
        flat = lambda t: flatten_with_paths(t)[1]
        assert all(torch.equal(a, b) for a, b in zip(flat(ts), flat(ss)))
        if q8:
            for name in ("m", "v"):
                d = ts[name]["q"].numpy().astype(np.int32) \
                    - np.asarray(js[name]["q"]).astype(np.int32)
                assert np.abs(d).max(initial=0) <= 1
                assert int((d != 0).sum()) <= 8
                assert spacings(ts[name]["scale"], js[name]["scale"]) <= 2
        else:
            assert spacings(ts["m"], js["m"]) <= 4
            assert spacings(ts["v"], js["v"]) <= 4
        if dtype == "float32":
            assert spacings(tp, jp) <= 4 and spacings(tn, jn) <= 4
        else:
            assert bf16_spacings(tp, jp) <= 1 and spacings(tn, jn) <= 64


# ---------------------------------------------------------------------------
# The engine's grouped flow on the CPU.


def _h100_groups(buckets, *, q8, level, device):
    del device
    smem = K2_SMEM if q8 else K1_SMEM
    return kernel.group_plan([(s, g, level, (g, p, m))
                              for s, g, p, m in buckets], H100_SMS, smem)


def _lora_run(codec_name, dtype, monkeypatch, grouped, steps=3,
              tapped=True):
    """``steps`` updates (``tapped``: tapped updates) of a tiny llama's
    LoRA adapters from the same start and gradients; the grouped calls
    made."""
    cfg = configs.get_config("llama-60m").with_(
        n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab=64, dtype=dtype)
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu").tree()
    tree = lora.inject(params, 4, prng.key(7))
    opt = lora.wrap_optimizer(gwt(lr=0.01, level=2, state_codec=codec_name,
                                  weight_decay=0.1))
    made = []
    with monkeypatch.context() as mp:
        if grouped:
            mp.setattr(ops, "fused_write_groups", _h100_groups)
        for name in ("fused_write_update_group",
                     "fused_write_update_q8_group"):
            real = getattr(ops, name)
            mp.setattr(ops, name, lambda calls, real=real: made.append(
                len(calls)) or real(calls))
        st = opt.init(tree)
        gen = torch.Generator().manual_seed(1)
        taps = []
        for _ in range(steps):
            # the step's gradients: bf16 under a bf16 model, as the LoRA
            # step casts them; none reach the frozen base
            grads = {"base": tree_map(lambda t: None, tree["base"]),
                     "lora": tree_map(lambda t: (torch.randn(
                         t.shape, generator=gen) * 0.1).to(cfg.torch_dtype),
                         tree["lora"])}
            if tapped:
                tree, st, tp = opt.tapped_update(grads, st, tree)
                taps.append(tp)
            else:
                tree, st = opt.update(grads, st, tree)
    return tree, st, taps, made


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("codec_name", ["f32", "int8"])
def test_engine_grouped_equals_every_bucket_alone(codec_name, dtype,
                                                  monkeypatch):
    alone = _lora_run(codec_name, dtype, monkeypatch, grouped=False)
    together = _lora_run(codec_name, dtype, monkeypatch, grouped=True)
    untapped = _lora_run(codec_name, dtype, monkeypatch, grouped=True,
                         tapped=False)
    assert alone[3] == []
    # every adapter bucket in one grouped call a step
    assert len(together[3]) == 3 and together[3][0] >= 2
    assert untapped[3] == together[3]
    # grouped == alone, and the grouped update == the grouped tapped one
    trees = [flatten_with_paths({"params": run[0], "state": run[1]})
             for run in (alone, together, untapped)]
    for other in trees[1:]:
        assert other[0] == trees[0][0]
        for a, b in zip(trees[0][1], other[1]):
            assert a.dtype == b.dtype and torch.equal(a, b)
    for ta, tb in zip(alone[2], together[2]):
        assert list(ta) == list(tb)
        assert all(torch.equal(ta[k], tb[k]) for k in ta)


# ---------------------------------------------------------------------------
# On the card.


@pytest.mark.cuda
@pytest.mark.parametrize("q8", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("use_limiter", [True, False])
def test_grouped_kernels_match_per_bucket_kernels(q8, use_limiter):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    shapes = [(1, 1100, 8), (5, 64, 512), (6, 300, 8), (2, 64, 1376)]
    calls = []
    for k, (L, m, n) in enumerate(shapes):
        r = lambda *s: torch.randn(*s, generator=gen, device=dev)
        g = (r(L, m, n) * 0.01).to(BF16)
        p = r(L, m, n) * 0.02
        mm, vv = r(L, m, n >> 2) * 1e-3, r(L, m, n >> 2).abs() * 1e-6
        scal = (torch.full((L,), 1e-3 * k, device=dev),
                torch.tensor(1e-3 * (k + 1), device=dev),
                torch.tensor(1e-4 * k, device=dev))
        kw = dict(_KW, use_limiter=use_limiter)
        if q8:
            ids = torch.arange(L, device=dev)
            (qm, sm), (qv, sv) = (codec.quant_blocks(a.reshape(L, -1),
                                                     ids + s)
                                  for a, s in ((mm, 1), (vv, 2)))
            salts = [codec.slot_salt(codec.make_key(0), torch.tensor(
                4 + k, device=dev), s, ids).to(torch.uint32) for s in (0, 1)]
            calls.append(((g, p, qm.reshape(mm.shape), sm,
                           qv.reshape(vv.shape), sv, *salts, *scal),
                          dict(kw, block=64)))
        else:
            calls.append(((g, p, mm, vv, *scal), kw))
    fresh = lambda: [((a[0], *(t.clone() for t in a[1:])), kw)
                     for a, kw in calls]
    single = kernel.gwt_adam_fused_q8 if q8 else kernel.gwt_adam_fused
    plain = ref.gwt_adam_fused_q8_group if q8 else ref.gwt_adam_fused_group
    want = [single(*a, **kw) for a, kw in fresh()]
    before = kernel.launches_q8_group if q8 else kernel.launches_group
    got = (kernel.gwt_adam_fused_q8_group if q8
           else kernel.gwt_adam_fused_group)(fresh())
    torch.cuda.synchronize()
    after = kernel.launches_q8_group if q8 else kernel.launches_group
    assert after == before + 1
    for a, b, c in zip(got, want, plain(fresh())):
        for x, y, z in zip(a, b, c):
            assert torch.equal(x, y) and torch.equal(x, z)
