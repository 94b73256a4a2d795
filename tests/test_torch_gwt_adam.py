"""The port's fused-write update (``repro_torch.kernels.gwt_adam``) against
the JAX package's tiled oracle ``fused_write_update(impl="jnp")``, which the
Pallas interpret backend matches bitwise; plus the device dispatch rule.

Tolerances, in spacings at each output's largest magnitude: XLA contracts
``b1*m + (1-b1)*a`` and its kin into FMAs and PyTorch's op-by-op arithmetic
does not, so m and v differ by up to 2.5 f32 spacings (4 allowed).  The
port sums the norm in the CUDA kernels' order (``ref.chunk_ssq``), the
oracle per row stripe.  With f32 parameters p reads 1 and the norm 2 f32
spacings (4 allowed).  With bf16 parameters a one-ulp change in a G̃ element
can cross a bf16 rounding boundary: p is then held to one bf16 spacing
(measured 0.5) and the norm, whose sum such a flip moves, to 64 f32
spacings (measured 12).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_parity import bf16_spacings, spacings, to_torch

from repro.kernels.gwt_adam import ops as jops
from repro_torch.kernels.gwt_adam import kernel, ops, ref

# (limiter on, prev_norm, weight decay): off; first step; clipping; not
# clipping — each with and without weight decay across the sweep
CASES = [(False, 1.0, 0.0), (True, 0.0, 0.1), (True, 1e-3, 0.0),
         (True, 1e3, 0.1)]


def _inputs(L, m, n, level, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(L, m, n).astype(np.float32),
            rng.randn(L, m, n).astype(np.float32),
            (rng.randn(L, m, n >> level) * 0.1).astype(np.float32),
            (rng.rand(L, m, n >> level) * 0.01).astype(np.float32))


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("shape", [(2, 16, 64), (3, 24, 344)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_fused_write_matches_reference(level, shape, dtype, case):
    use_limiter, prev, wd = case
    L, m, n = shape
    g, p, mm, vv = _inputs(L, m, n, level, seed=level * 7 + n)
    pn = np.full((L,), prev, np.float32)
    kw = dict(alpha=0.25, weight_decay=wd, gamma=1.01,
              use_limiter=use_limiter, level=level)
    jp, jn, js = jops.fused_write_update(
        jnp.asarray(g).astype(dtype), jnp.asarray(p).astype(dtype),
        {"m": jnp.asarray(mm), "v": jnp.asarray(vv)}, jnp.int32(3),
        jnp.asarray(pn), lr_t=0.01, impl="jnp", **kw)
    tdt = getattr(torch, dtype)
    tp, tn, ts = ops.fused_write_update(
        to_torch(g, tdt), to_torch(p, tdt),
        {"m": to_torch(mm), "v": to_torch(vv)},
        torch.tensor(3, dtype=torch.int32), to_torch(pn),
        lr_t=torch.tensor(0.01), **kw)
    assert tp.dtype == tdt and tn.shape == (L,)
    assert spacings(ts["m"], js["m"]) <= 4
    assert spacings(ts["v"], js["v"]) <= 4
    if dtype == "float32":
        assert spacings(tp, jp) <= 4
        assert spacings(tn, jn) <= 4
    else:
        assert bf16_spacings(tp, jp) <= 1
        assert spacings(tn, jn) <= 64
    if not use_limiter:
        np.testing.assert_array_equal(tn.numpy(), pn)


def test_clipping_case_clips():
    """The clipping case of the sweep really limits: new norm = γ·prev."""
    g, p, mm, vv = _inputs(2, 16, 64, 2, seed=0)
    pn = torch.full((2,), 1e-3)
    _, new_norm, _ = ops.fused_write_update(
        to_torch(g), to_torch(p), {"m": to_torch(mm), "v": to_torch(vv)},
        torch.tensor(0, dtype=torch.int32), pn, lr_t=torch.tensor(0.01),
        alpha=0.25, weight_decay=0.0, gamma=1.01, use_limiter=True, level=2)
    np.testing.assert_allclose(new_norm.numpy(), 1.01e-3, rtol=1e-6)


def test_norm_covers_whole_stacked_leaf():
    """A stacked (L, layers, m, n) bucket takes ONE limiter norm per leaf
    over all its layers, not one per layer."""
    g, p, mm, vv = _inputs(2, 4 * 8, 64, 2, seed=3)
    four = lambda a: to_torch(a).reshape(2, 4, 8, a.shape[-1])
    args = dict(lr_t=torch.tensor(0.01), alpha=0.25, weight_decay=0.0,
                gamma=1.01, use_limiter=True, level=2)
    step = torch.tensor(2, dtype=torch.int32)
    p4, n4, _ = ops.fused_write_update(
        four(g), four(p), {"m": four(mm), "v": four(vv)}, step,
        torch.zeros(2), **args)
    p3, n3, _ = ops.fused_write_update(
        to_torch(g), to_torch(p), {"m": to_torch(mm), "v": to_torch(vv)},
        step, torch.zeros(2), **args)
    assert n4.shape == (2,)
    assert torch.equal(n4, n3) and torch.equal(p4.reshape(p3.shape), p3)


def test_cpu_tensors_never_reach_the_kernel():
    """On CPU tensors the entry point takes the plain version and the
    kernel's launch counter stays where it was; the kernel wrapper itself
    refuses CPU tensors."""
    before = kernel.launches
    g, p, mm, vv = _inputs(1, 8, 64, 2, seed=5)
    step, lr = torch.tensor(0, dtype=torch.int32), torch.tensor(0.04)
    want = ref.gwt_adam_fused(
        to_torch(g), to_torch(p), to_torch(mm), to_torch(vv),
        torch.zeros(1), *ops._step_scalars(step, lr, 0.25, 0.0, 0.9, 0.999),
        level=2, gamma=1.01, use_limiter=True, weight_decay=False)
    got_p, got_n, got_s = ops.fused_write_update(
        to_torch(g), to_torch(p), {"m": to_torch(mm), "v": to_torch(vv)},
        step, torch.zeros(1), lr_t=lr, alpha=0.25, weight_decay=0.0,
        gamma=1.01, use_limiter=True, level=2)
    assert kernel.launches == before
    assert torch.equal(got_p, want[0]) and torch.equal(got_n, want[3])
    assert torch.equal(got_s["m"], want[1]) and torch.equal(got_s["v"],
                                                            want[2])
    with pytest.raises(ValueError, match="CUDA"):
        kernel.gwt_adam_fused(
            to_torch(g), to_torch(p), to_torch(mm), to_torch(vv),
            torch.zeros(1), torch.tensor(0.01), torch.tensor(0.0), level=2,
            gamma=1.01, use_limiter=True, weight_decay=False)
    assert kernel.launches == before

