"""K1's and K2's two designs on the CPU: the capacity rule that picks the
one-pass design (the whole bucket's rounded G̃ held in shared memory across
a grid barrier) or the two-pass one, the wrappers' routing by that rule,
and every refusal of the wrappers, all without a card.

The card's figures are an H100 SXM's: 132 SMs, and the 227 KB (232,448
bytes) of shared memory a block may opt into less the one-pass kernels'
48 bytes of static shared memory and, for K2, its ring of two staged
chunks of codes and scales (2 x 4416 bytes), as the card reports them
(``kernel.one_pass_plan``): 14 slots of 16 KB per SM for K1, 13 for K2.  The kernels themselves run only on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import pytest
import torch

from repro_torch.kernels.gwt_adam import kernel

H100_SMS = 132
H100_SMEM = {"gwt_adam_fused": 232_448 - 48,
             "gwt_adam_fused_q8": 232_448 - 48 - 2 * 4416}
K1, K2 = H100_SMEM

BF16, F32 = torch.bfloat16, torch.float32

# llama-60m's three GWT buckets after row merging, the FIRST-mode leaf (an
# (8, 1376, 514) weight arrives transposed as (8, 514, 1376)), and the
# chunks of 2048 coefficients per SM each needs at level 2
MAIN = [((4, 4096, 512), 8), ((2, 4096, 1376), 11), ((1, 11008, 512), 6)]
FIRST = ((1, 4112, 1376), 6)


def fits(shape, dtype=BF16, level=2, name=K1):
    return kernel.one_pass_fits(shape, dtype, level, H100_SMS,
                                H100_SMEM[name])


def chunks_per_sm(shape, level=2):
    L, rows, n = shape
    return -(-L * -(-(rows * (n >> level)) // kernel.CHUNK) // H100_SMS)


@pytest.mark.parametrize("name", [K1, K2])
@pytest.mark.parametrize("shape,per_sm", MAIN + [FIRST])
def test_llama_60m_bf16_buckets_take_one_pass(shape, per_sm, name):
    assert chunks_per_sm(shape) == per_sm
    assert per_sm * kernel.CHUNK * 4 * 2 <= H100_SMEM[name]
    assert fits(shape, name=name)


@pytest.mark.parametrize("name", [K1, K2])
@pytest.mark.parametrize("shape,dtype,level", [
    ((2, 4096, 1376), F32, 2),        # 11 slots of 32 KB: 45 MB of G̃
    ((4, 4096, 512), F32, 2),         # 8 slots of 32 KB
    ((8, 4096, 1376), BF16, 2),       # 42 slots of 16 KB
    ((8, 4096, 512), BF16, 1),        # 32 slots of 8 KB
    ((4, 4096, 512), F32, 3),         # 4 slots of 64 KB
])
def test_buckets_beyond_capacity_take_two_passes(shape, dtype, level,
                                                name):
    assert not fits(shape, dtype, level, name)


@pytest.mark.parametrize("name,edge", [(K1, 14), (K2, 13)])
def test_capacity_edge(name, edge):
    """``edge`` slots of 16 KB fit one block of an SM; one more does not."""
    rows = 132 * edge * kernel.CHUNK // 128    # n=512 at level 2: 128 a row
    assert chunks_per_sm((1, rows, 512)) == edge
    assert fits((1, rows, 512), name=name)
    assert chunks_per_sm((1, rows + 1, 512)) == edge + 1
    assert not fits((1, rows + 1, 512), name=name)


def test_empty_bucket_takes_two_passes():
    assert not fits((0, 4096, 512)) and not fits((2, 0, 512))


# ---------------------------------------------------------------------------
# The wrappers' routing, with the library and the card's plan replaced by
# fakes that record which entry the wrapper called.


class _FakeLib:
    def __init__(self):
        self.called = []

    def __getattr__(self, name):
        if name.endswith("_qblock"):
            return lambda: kernel.QBLOCK

        def fn(*args):
            self.called.append(name)
            return 0
        return fn


@pytest.fixture
def routed(monkeypatch):
    """The wrappers with a fake library, the plan from the rule at the
    H100's figures, and CPU tensors let through."""
    lib = _FakeLib()
    monkeypatch.setattr(kernel, "_load", lambda name: lib)
    monkeypatch.setattr(kernel, "_require_cuda", lambda g: None)
    monkeypatch.setattr(kernel, "_stream", lambda device: 0)

    def plan(name, shape, dtype, level):
        return {"grid": 1 if fits(shape, dtype, level, name) else 0}
    monkeypatch.setattr(kernel, "one_pass_plan", plan)
    for name in ("launches", "launches_one_pass", "launches_two_pass",
                 "launches_q8", "launches_q8_one_pass",
                 "launches_q8_two_pass"):
        monkeypatch.setattr(kernel, name, 0)
    return lib


def _f32_args(shape, dtype, level=2):
    L, rows, n = shape
    e = lambda *s, dt=F32: torch.empty(s, dtype=dt, device="meta")
    return (e(L, rows, n, dt=dtype), e(L, rows, n, dt=dtype),
            e(L, rows, n >> level), e(L, rows, n >> level), e(L), e(), e())


def _q8_args(shape, dtype, level=2):
    L, rows, n = shape
    nb = -(-rows * (n >> level) // kernel.QBLOCK)
    e = lambda *s, dt=F32: torch.empty(s, dtype=dt, device="meta")
    q = lambda: e(L, rows, n >> level, dt=torch.int8)
    return (e(L, rows, n, dt=dtype), e(L, rows, n, dt=dtype), q(), e(L, nb),
            q(), e(L, nb), e(L, dt=torch.uint32), e(L, dt=torch.uint32),
            e(L), e(), e())


_KW = dict(level=2, gamma=1.01, weight_decay=False)


@pytest.mark.parametrize("use_limiter", [True, False])
@pytest.mark.parametrize("shape,dtype,one", [
    ((4, 4096, 512), BF16, True), ((2, 4096, 1376), BF16, True),
    ((1, 11008, 512), BF16, True), ((1, 4112, 1376), BF16, True),
    ((2, 4096, 1376), F32, False), ((8, 4096, 1376), BF16, False)])
def test_wrappers_route_by_the_rule(routed, shape, dtype, one, use_limiter):
    """Both wrappers launch the design the rule names, with and without the
    limiter, and count the launch once overall and once by design."""
    kernel.gwt_adam_fused(*_f32_args(shape, dtype),
                          use_limiter=use_limiter, **_KW)
    kernel.gwt_adam_fused_q8(*_q8_args(shape, dtype), block=64,
                             use_limiter=use_limiter, **_KW)
    suffix = "_one_pass" if one else ""
    assert routed.called == ["gwt_adam_fused" + suffix,
                             "gwt_adam_fused_q8" + suffix]
    assert (kernel.launches, kernel.launches_q8) == (1, 1)
    assert (kernel.launches_one_pass, kernel.launches_two_pass) == \
        ((1, 0) if one else (0, 1))
    assert (kernel.launches_q8_one_pass, kernel.launches_q8_two_pass) == \
        ((1, 0) if one else (0, 1))


def test_explicit_designs(routed):
    """The two-pass entries always launch the two-pass kernels; the one-pass
    entries refuse a bucket beyond capacity before any launch."""
    small, big = (3, 37, 344), (2, 4096, 1376)
    kernel.gwt_adam_fused_two_pass(*_f32_args(small, BF16),
                                   use_limiter=True, **_KW)
    kernel.gwt_adam_fused_q8_two_pass(*_q8_args(small, BF16), block=64,
                                      use_limiter=True, **_KW)
    kernel.gwt_adam_fused_one_pass(*_f32_args(small, F32),
                                   use_limiter=True, **_KW)
    kernel.gwt_adam_fused_q8_one_pass(*_q8_args(small, F32), block=64,
                                      use_limiter=True, **_KW)
    with pytest.raises(ValueError, match="does not fit"):
        kernel.gwt_adam_fused_one_pass(*_f32_args(big, F32),
                                       use_limiter=True, **_KW)
    with pytest.raises(ValueError, match="does not fit"):
        kernel.gwt_adam_fused_q8_one_pass(*_q8_args(big, F32), block=64,
                                          use_limiter=True, **_KW)
    assert routed.called == ["gwt_adam_fused", "gwt_adam_fused_q8",
                             "gwt_adam_fused_one_pass",
                             "gwt_adam_fused_q8_one_pass"]
    assert (kernel.launches_one_pass, kernel.launches_two_pass,
            kernel.launches_q8_one_pass, kernel.launches_q8_two_pass) == \
        (1, 1, 1, 1)


def test_a_failed_launch_raises_and_counts_nothing(routed, monkeypatch):
    """A nonzero CUDA error from the library (a refused cooperative launch)
    raises; the counters stay where they were."""
    class Failing:
        def __getattr__(self, name):
            return lambda *args: 720   # cudaErrorCooperativeLaunchTooLarge
    monkeypatch.setattr(kernel, "_load", lambda name: Failing())
    with pytest.raises(RuntimeError, match="one-pass.*CUDA error 720"):
        kernel.gwt_adam_fused(*_f32_args((3, 37, 344), BF16),
                              use_limiter=True, **_KW)
    assert (kernel.launches, kernel.launches_one_pass) == (0, 0)


# ---------------------------------------------------------------------------
# Refusals, on CPU tensors: every check runs before the device check.

def _cpu(args):
    return tuple(torch.zeros(a.shape, dtype=a.dtype) for a in args)


def _refusals_f32():
    shape = (3, 37, 344)
    good = _cpu(_f32_args(shape, BF16))
    g, p, m, v, pn, ss, wd = good
    nc = lambda t: t.transpose(1, 2).contiguous().transpose(1, 2)
    return [
        ("ndim", (g[0], p[0], m[0], v[0], pn, ss, wd), {}, "must be"),
        ("level 0", good, {"level": 0}, "outside"),
        ("level 5", good, {"level": 5}, "outside"),
        ("n % 2^l", good, {"level": 4}, "divisible"),
        ("f16", (g.half(), p.half(), m, v, pn, ss, wd), {}, "unsupported"),
        ("p dtype", (g, p.float(), m, v, pn, ss, wd), {}, "dtype"),
        ("m dtype", (g, p, m.double(), v, pn, ss, wd), {}, "dtype"),
        ("v shape", (g, p, m, v[:, :-1], pn, ss, wd), {}, "shape"),
        ("g layout", (nc(g), p, m, v, pn, ss, wd), {}, "contiguous"),
        ("prev_norm", (g, p, m, v, pn[:2], ss, wd), {}, "shape"),
        ("step_size", (g, p, m, v, pn, ss[None], wd), {}, "shape"),
        ("wd dtype", (g, p, m, v, pn, ss, wd.double()), {}, "dtype"),
        ("meta", _f32_args(shape, BF16), {}, "CUDA tensors"),
        ("cpu", good, {}, "CUDA tensors"),
    ]


def _refusals_q8():
    shape = (3, 37, 344)
    good = _cpu(_q8_args(shape, BF16))
    g, p, qm, sm, qv, sv, s1, s2, pn, ss, wd = good
    return [
        ("block", good, {"block": 32}, "blocks of 64"),
        ("codes dtype", (g, p, qm.to(torch.uint8), sm, qv, sv, s1, s2, pn,
                         ss, wd), {}, "dtype"),
        ("scales shape", (g, p, qm, sm[:, :-1], qv, sv, s1, s2, pn, ss, wd),
         {}, "shape"),
        ("salt dtype", (g, p, qm, sm, qv, sv, s1.to(torch.int32), s2, pn,
                        ss, wd), {}, "dtype"),
        ("level 0", good, {"level": 0}, "outside"),
        ("cpu", good, {}, "CUDA tensors"),
    ]


@pytest.mark.parametrize("design", ["", "_one_pass", "_two_pass"])
@pytest.mark.parametrize("case", _refusals_f32(), ids=lambda c: c[0])
def test_k1_wrappers_refuse_without_a_card(case, design):
    _, args, extra, match = case
    before = (kernel.launches, kernel.launches_one_pass,
              kernel.launches_two_pass)
    fn = getattr(kernel, "gwt_adam_fused" + design)
    with pytest.raises(ValueError, match=match):
        fn(*args, **{**_KW, "use_limiter": True, **extra})
    assert (kernel.launches, kernel.launches_one_pass,
            kernel.launches_two_pass) == before


@pytest.mark.parametrize("design", ["", "_one_pass", "_two_pass"])
@pytest.mark.parametrize("case", _refusals_q8(), ids=lambda c: c[0])
def test_k2_wrappers_refuse_without_a_card(case, design):
    _, args, extra, match = case
    before = (kernel.launches_q8, kernel.launches_q8_one_pass,
              kernel.launches_q8_two_pass)
    fn = getattr(kernel, "gwt_adam_fused_q8" + design)
    with pytest.raises(ValueError, match=match):
        fn(*args, **{**_KW, "block": 64, "use_limiter": True, **extra})
    assert (kernel.launches_q8, kernel.launches_q8_one_pass,
            kernel.launches_q8_two_pass) == before

