"""Port core math against the JAX package on equal numpy inputs: the Haar
transform, the norm-growth limiter and the LR schedules.

Tolerances: the Haar butterfly is the same sequence of rounded adds and
multiplies in both packages, so its bands must match bitwise in f32 and in
bf16.  The limiter's norm is a sum whose order differs (XLA vs ATen), so it
is held to 4 f32 spacings; the schedules to 2 (``cos``/``pow`` are
different libm implementations)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import spacings, to_numpy, to_torch

from repro.core import haar as jhaar, limiter as jlimiter
from repro.optim import schedules as jsched
from repro_torch.core import haar, limiter
from repro_torch.optim import schedules


@pytest.mark.parametrize("level", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_haar_matches_reference(level, dtype):
    rng = np.random.RandomState(level)
    g = rng.randn(3, 5, 48).astype(np.float32)
    jg = jnp.asarray(g).astype(dtype)
    tg = to_torch(g).to(getattr(torch, dtype))
    ja, jd = jhaar.haar_forward(jg, level)
    ta, td = haar.haar_forward(tg, level)
    assert spacings(ta, ja) == 0
    assert len(td) == len(jd) == level
    for t, j in zip(td, jd):
        assert spacings(t, j) == 0
    assert spacings(haar.haar_approx(tg, level),
                    jhaar.haar_approx(jg, level)) == 0
    assert spacings(haar.haar_inverse(ta, td),
                    jhaar.haar_inverse(ja, jd)) == 0
    scale = rng.rand(3, 5, 48 >> level).astype(np.float32)
    for band in range(1, level + 1):
        assert spacings(
            haar.detail_scale_upsample(to_torch(scale), level, band),
            jhaar.detail_scale_upsample(jnp.asarray(scale), level, band)) == 0


@pytest.mark.parametrize("prev", [0.0, 0.5, 100.0])
def test_limiter_matches_reference(prev):
    rng = np.random.RandomState(1)
    u = rng.randn(4, 64).astype(np.float32)
    jl, jn = jlimiter.limit(jnp.asarray(u), jnp.float32(prev))
    tl, tn = limiter.limit(to_torch(u), torch.tensor(prev))
    assert spacings(tn, jn) <= 4
    assert spacings(tl, jl) <= 4
    old = np.array([0.0, 1.0, 2.0, 3.0], np.float32)
    new = np.array([5.0, 1.01, 1.0, 3.03], np.float32)
    np.testing.assert_array_equal(
        to_numpy(limiter.clip_flags(to_torch(old), to_torch(new))),
        np.asarray(jlimiter.clip_flags(jnp.asarray(old), jnp.asarray(new))))


def test_limiter_zero_update_keeps_history():
    lim, new = limiter.limit(torch.zeros(3, 4), torch.tensor(2.5))
    assert float(new) == 2.5 and float(lim.abs().sum()) == 0


def test_schedules_match_reference():
    steps = np.arange(0, 40, dtype=np.int32)
    js = jsched.warmup_cosine(0.01, 37)(jnp.asarray(steps))
    ts = schedules.warmup_cosine(0.01, 37)(torch.from_numpy(steps))
    assert ts.dtype == torch.float32
    assert spacings(ts, js) <= 2
    assert float(schedules.constant(0.3)(torch.tensor(5))) == \
        float(jsched.constant(0.3)(jnp.int32(5)))
