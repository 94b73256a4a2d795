"""``repro_torch.core.prng`` against the installed ``jax.random`` (jax
0.9.0: threefry2x32, ``jax_threefry_partitionable`` True) on the CPU.

* ``key``, ``fold_in``, ``random_bits`` and ``uniform`` equal
  ``jax.random``'s bit for bit, for several seeds, ``fold_in`` values and
  shapes (odd sizes; one, two and three axes; ``uniform`` on its default
  and on shifted ranges).
* ``normal`` is within ``NORMAL_SPACINGS`` = 4 f32 spacings of
  ``jax.random.normal`` (the spacing at jax's value) over 2^20 draws:
  measured at most 3, with 99.05% of the draws bitwise (key 3, fold_in 2).
  The bits and the uniforms are exact; the difference is ``torch.log1p``
  against XLA's own ``log1p`` inside ``erf_inv``.
* ``lowrank.draw_normal`` equals the JAX package's APOLLO/RSO draw
  (``test_torch_lowrank.jax_draw``) within the same tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.optim import lowrank

NORMAL_SPACINGS = 4

torch.set_num_threads(2)

CASES = [(0, 0, (7,)), (3, 2, (1000,)), (123, 5, (3, 5, 7)),
         (-4, 9, (33, 17)), (2 ** 31 - 1, 2 ** 32 - 1, (2, 3, 1)),
         (42, 7, (1,))]


def _jkey(seed, data):
    return jax.random.fold_in(jax.random.key(seed), data)


def _spacings(got: np.ndarray, want: np.ndarray) -> float:
    """Largest |got - want| in f32 spacings at ``want``."""
    sp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    return float((np.abs(got.astype(np.float64) - want) / sp).max())


@pytest.mark.parametrize("seed,data,shape", CASES)
def test_keys_and_bits_match_jax(seed, data, shape):
    jk = _jkey(seed, data)
    k = prng.fold_in(prng.key(seed), data)
    assert k == tuple(int(w) for w in np.asarray(jax.random.key_data(jk)))
    assert prng.key(seed) == tuple(
        int(w) for w in np.asarray(jax.random.key_data(jax.random.key(seed))))
    want = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
    got = prng.random_bits(k, shape)
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.5, 3.7), (0.3, 0.9),
                                   (-1e-3, 5.0)])
@pytest.mark.parametrize("seed,data,shape", CASES[:4])
def test_uniform_matches_jax_bitwise(seed, data, shape, lo, hi):
    want = np.asarray(jax.random.uniform(_jkey(seed, data), shape,
                                         jnp.float32, lo, hi))
    got = prng.uniform(prng.fold_in(prng.key(seed), data), shape, lo, hi)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def test_normal_within_four_spacings_over_a_million_draws():
    shape = (1 << 20,)
    want = np.asarray(jax.random.normal(_jkey(3, 2), shape, jnp.float32))
    got = prng.normal(prng.fold_in(prng.key(3), 2), shape).numpy()
    assert got.dtype == np.float32 and np.all(np.isfinite(got))
    assert _spacings(got, want) <= NORMAL_SPACINGS
    assert (got == want).mean() >= 0.98


@pytest.mark.parametrize("seed,data,shape", CASES)
def test_normal_shapes_match_jax(seed, data, shape):
    want = np.asarray(jax.random.normal(_jkey(seed, data), shape,
                                        jnp.float32))
    got = prng.normal(prng.fold_in(prng.key(seed), data), shape)
    assert tuple(got.shape) == shape
    assert _spacings(got.numpy(), want) <= NORMAL_SPACINGS


def test_erf_inv_edges():
    u = torch.tensor([-1.0, 1.0, 0.0, -0.0])
    got = prng.erf_inv(u)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(u.numpy())))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [2 ** 31, 2 ** 32 - 1, 2 ** 32, 2 ** 32 + 5,
                                  -2 ** 31 - 1, 2 ** 40, -5])
def test_seeds_past_32_bits_wrap_as_in_jax(seed):
    assert prng.key(seed) == tuple(
        int(w) for w in np.asarray(jax.random.key_data(jax.random.key(seed))))


@pytest.mark.parametrize("shape,seed,leaf,epoch", [
    ((2, 16, 4), 0, 3, 1), ((64, 8), 7, 0, 0), ((3, 32, 5), 1, 11, 4)])
def test_draw_normal_matches_the_jax_packages_draw(shape, seed, leaf,
                                                   epoch):
    from test_torch_lowrank import jax_draw
    want = jax_draw(shape, seed, leaf, epoch, "cpu")
    got = lowrank.draw_normal(shape, seed, leaf, epoch, "cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _spacings(got.numpy(), want.numpy()) <= NORMAL_SPACINGS
