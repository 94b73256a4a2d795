"""Card-only tests of the port's CUDA kernels (marker ``cuda``).  They skip
without an NVIDIA card.  The file imports neither JAX nor the JAX package,
so it also runs where those are not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

Tolerances against the plain version on the card: both round at the same
points and neither contracts FMAs, so m and v must agree within 2 f32
spacings (bitwise in practice); the per-leaf norm is summed in another
order (64 f32 spacings allowed), which can move a written p element by one
bf16 spacing through ``bf16(scale)`` (2 f32 spacings with f32 parameters).
The q8 kernel rounds like its plain version at every step (codes and scales
are exact functions of bitwise-equal f32 moments), so its codes, scales
and parameters must be bitwise equal, the norm again within 64 spacings.
The Haar DWT kernels (K3, K6, K7) round where their plain versions round:
bitwise, NaN codes of the fp8 wire included.
"""

import math

import pytest
import torch

from repro_torch.kernels.gwt_adam import kernel, ops, ref
from repro_torch.kernels.haar_dwt import kernel as haar_kernel
from repro_torch.kernels.haar_dwt import ops as haar_ops
from repro_torch.kernels.haar_dwt import ref as haar_ref
from repro_torch.optim import codec


def _spacings(got, want, mant_bits):
    diff = (got.double() - want.double()).abs().max().item()
    top = want.double().abs().max().item()
    return diff / 2.0 ** (math.floor(math.log2(top)) - mant_bits)


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
    g, p, m, v = _inputs(dev, dtype=dtype)
    want = ref.gwt_adam_fused(g, p, m, v, *scalars,
                              bm=ops.fused_row_block(64, 344, 2), **args)
    outs = [kernel.gwt_adam_fused(g.clone(), p.clone(), m.clone(),
                                  v.clone(), *scalars, **args)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    got = outs[0]
    if dtype == torch.bfloat16:
        assert _spacings(got[0], want[0], 7) <= 1
    else:
        assert _spacings(got[0], want[0], 23) <= 2
    assert _spacings(got[1], want[1], 23) <= 2
    assert _spacings(got[2], want[2], 23) <= 2
    assert _spacings(got[3], want[3], 23) <= 64


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
    with pytest.raises(ValueError, match="dtype"):
        kernel.gwt_adam_fused(g, p.float(), m, v, *scalars, **kw)
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
    g, p, qm, sm, qv, sv = _q8_inputs(dev, dtype=dtype)
    key = codec.make_key(0, dev)
    step = torch.tensor(4, dtype=torch.int32, device=dev)
    ids = torch.arange(3, device=dev)
    salts = [codec.slot_salt(key, step, s, ids) for s in (0, 1)]
    scalars = (torch.tensor([1e-3, 0.0, 1e9], device=dev),
               torch.tensor(0.01, device=dev), torch.tensor(1e-4, device=dev))
    args = dict(level=2, block=64, gamma=1.01, use_limiter=True,
                weight_decay=True)
    want = ref.gwt_adam_fused_q8(g, p, qm, sm, qv, sv, *salts, *scalars,
                                 bm=40, **args)
    outs = [kernel.gwt_adam_fused_q8(
        g.clone(), p.clone(), qm.clone(), sm.clone(), qv.clone(),
        sv.clone(), *(s.to(torch.uint32) for s in salts), *scalars, **args)
        for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    for a, b in zip(outs[0][:5], want[:5]):
        assert torch.equal(a, b)
    assert _spacings(outs[0][5], want[5], 23) <= 64


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
