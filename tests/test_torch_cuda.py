"""Card-only tests of the port's CUDA kernel (marker ``cuda``).  They skip
without an NVIDIA card.  The file imports neither JAX nor the JAX package,
so it also runs where those are not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

Tolerances against the plain version on the card: both round at the same
points and neither contracts FMAs, so m and v must agree within 2 f32
spacings (bitwise in practice); the per-leaf norm is summed in another
order (64 f32 spacings allowed), which can move a written p element by one
bf16 spacing through ``bf16(scale)`` (2 f32 spacings with f32 parameters).
"""

import math

import pytest
import torch

from repro_torch.kernels.gwt_adam import kernel, ops, ref


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
