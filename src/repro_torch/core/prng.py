"""The ``jax.random`` draws the JAX package makes, in PyTorch: the
threefry2x32 key, ``fold_in``, raw bits, uniforms and normals.

It follows jax 0.9.0 with its defaults: the PRNG implementation is
``threefry2x32`` and ``jax_threefry_partitionable`` is True (jax 0.4.37 had
it False, which gives other bits), with 64-bit types off.  From
``jax/_src/prng.py`` and ``jax/_src/random.py`` of that version:

* :func:`key` is ``threefry_seed``: the seed as its high and low 32-bit
  words.  With 64-bit types off jax keeps the seed's low 32 bits, so the
  high word is 0.
* :func:`threefry2x32` is ``_threefry2x32_lowering``: 20 rounds in five
  groups of four, rotations (13, 15, 26, 6) and (17, 29, 16, 24), the key
  schedule with the parity word ``k0 ^ k1 ^ 0x1BD11BDA``.
* :func:`fold_in` is ``threefry_fold_in``: the hash of the counter pair
  ``(0, data)`` under the key gives the new key's two words.
* :func:`random_bits` is ``_threefry_random_bits_partitionable`` at 32 bits:
  element ``i`` (row-major) hashes the counter pair ``(i >> 32, i & M)``
  and takes the xor of the two output words.
* :func:`uniform` is ``_uniform`` in f32: the top 23 bits as the mantissa
  of a float in [1, 2), minus 1, times ``maxval - minval`` plus ``minval``
  as one fused multiply-add (XLA contracts the two on the CPU), then
  ``max(minval, .)``.
* :func:`normal` is ``_normal_real``: ``sqrt(2) * erf_inv(u)`` with ``u``
  uniform on ``[nextafter(-1, 0), 1)``.  ``erf_inv`` is XLA's f32 formula
  as jax compiles it on the CPU (the HLO of ``jax.jit(lax.erf_inv)``):
  ``w = -log1p(-u*u)``; ``w - 2.5`` where ``w < 5``, else ``sqrt(w) - 3``;
  one of two nine-term polynomials in Horner form, each step a fused
  multiply-add; times ``u``; ``+-inf`` at ``|u| = 1``.

The integer work is exact, so bits and uniforms equal jax's bit for bit.
The normals differ where ``torch.log1p`` and the fused steps (taken in f64
and rounded to f32) differ from XLA's: within 4 f32 spacings
(``tests/test_torch_prng.py`` states what it measured).

Words are held in int64 tensors masked to 32 bits (PyTorch has few uint32
operations); a key is a pair of Python ints, so the draws on the card make
no copy from the host and no synchronizing call.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Key = Tuple[int, int]
Word = Union[int, torch.Tensor]

# XLA's f32 erf_inv: the coefficients of the polynomial in w - 2.5 (w < 5)
# and in sqrt(w) - 3, highest power first
_ERFINV_LO = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_HI = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0: int, k1: int, x0: Word, x1: Word) -> Tuple[Word, Word]:
    """The threefry2x32 hash of the counter words ``(x0, x1)`` (ints or
    int64 tensors holding 32-bit words) under the key ``(k0, k1)``."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def key(seed: int) -> Key:
    """``jax.random.key(seed)``'s two words."""
    return 0, seed & MASK


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, data)``, ``data`` taken as a uint32."""
    return threefry2x32(k[0], k[1], 0, data & MASK)


def random_bits(k: Key, shape: Sequence[int],
                device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """``jax.random.bits(k, shape)`` (uint32) as an int64 tensor of
    ``shape`` on ``device`` holding the 32-bit words."""
    n = math.prod(shape)
    if n >= 2 ** 32:
        raise ValueError(f"{n} draws need 64-bit counters")
    lo = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(k[0], k[1], torch.zeros_like(lo), lo)
    return (b0 ^ b1).reshape(tuple(shape))


def f32(x: float) -> float:
    """``x`` rounded to f32 (a Python float: no tensor to copy to the
    card; PyTorch rounds such a scalar to an f32 tensor's dtype)."""
    return float(torch.tensor(x, dtype=torch.float32))


def uniform(k: Key, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0,
            device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)`` on
    ``device``."""
    bits = random_bits(k, shape, device)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = f32(minval)
    width = f32(f32(maxval) - lo)
    return torch.clamp_min(_fma(floats - 1.0, width, lo), lo)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` for f32 values, rounded once to f32: the f32 product
    is exact in f64."""
    return (a.double() * b + c).float()


def erf_inv(u: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` as jax 0.9.0 compiles it on the CPU, each
    Horner step ``p * t + c`` one fused multiply-add."""
    w = -torch.log1p(-(u * u))
    small = w < 5.0
    t = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(small, _ERFINV_LO[0], _ERFINV_HI[0])
    for c_lo, c_hi in zip(_ERFINV_LO[1:], _ERFINV_HI[1:]):
        c = torch.where(small, c_lo, c_hi)
        p = _fma(p, t, c.double())
    return torch.where(u.abs() == 1.0, u * math.inf, p * u)


def normal(k: Key, shape: Sequence[int],
           device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """``jax.random.normal(k, shape, float32)`` on ``device``, within 4 f32
    spacings (bits and uniforms are exact; see the module docstring)."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    return erf_inv(uniform(k, shape, lo, 1.0, device)) * f32(math.sqrt(2))
