"""Optimizer-state codecs (counterpart of ``repro/optim/codec.py``).

* ``f32`` — passthrough: the engine never calls it.
* ``int8`` — blocked 8-bit: each moment slot is flattened row-major and
  quantized in blocks of 64 elements against a per-block absmax scale
  (``scale = absmax * f32(1/127)``), with stochastic rounding.  The encoded
  slot is ``{"q": int8 (slot shape), "scale": f32 (nb,)}``.

The rounding bits are a murmur3-style hash of ``(codec_key, step, slot,
leaf_id, element index)``, bit for bit the JAX package's, so a state
written by either package requantizes alike in the other, and a resumed run
draws the interrupted run's bits.

torch has no right shift for ``uint32`` on the CPU, so the hash runs in
``int64`` holding values in ``[0, 2^32)``.  A product of two such values
does not fit in ``int64``; :func:`_mul32` multiplies by 16-bit halves so
every intermediate stays below ``2^49`` and the low 32 bits are exact.
Everything stays on the tensors' device, and a plain-int operand (a slot
index, a step given as an int) is hashed on the host, so computing a salt
creates no device tensor and needs no host sync.  :func:`slot_salt`
broadcasts, so the engine computes every salt of a step, for all slots
and leaves, as one ``(slots, leaves)`` table.
"""

from __future__ import annotations

from typing import Any

import torch

DEFAULT_BLOCK = 64

_MASK = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLD = 0x9E3779B9
# the JAX package's jnp.float32(1.0 / 127.0): the double quotient rounded
_INV127 = 0.007874015718698502


def _u32(x, device=None) -> torch.Tensor:
    """``x`` (int, or an integer tensor of any dtype) as int64 holding its
    uint32 value, as ``jnp.asarray(x).astype(jnp.uint32)`` wraps it."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(x, dtype=torch.int64, device=device)
    return x.to(torch.int64) & _MASK


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2^32`` for ``h`` in ``[0, 2^32)``, without overflow."""
    lo = (h & 0xFFFF) * c
    hi = (((h >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _fmix(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    return h ^ (h >> 16)


def _fold(h: torch.Tensor, x) -> torch.Tensor:
    """``fmix(h ^ x * GOLD)``; an int ``x`` is multiplied on the host."""
    if isinstance(x, torch.Tensor):
        return _fmix(h ^ _mul32(_u32(x), _GOLD))
    return _fmix(h ^ (((x & _MASK) * _GOLD) & _MASK))


def make_key(seed: int, device=None) -> torch.Tensor:
    """The codec key of ``opt_state["codec_key"]``: a uint32 scalar."""
    h = _fold(_u32(0x8BADF00D, device), seed & _MASK)
    return h.to(torch.uint32)


def slot_salt(key, step, slot, leaf_id) -> torch.Tensor:
    """Per-(key, step, slot, leaf) salt, broadcast over ``slot`` and
    ``leaf_id`` (ints or integer tensors); uint32 values held in int64."""
    k = _u32(key)
    return _fold(_fold(_fold(k, step), slot), leaf_id)


def uniform01(salt: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Deterministic f32 uniforms in [0, 1) from ``(salt, element index)``:
    24 exact bits."""
    bits = _fmix(_u32(salt) ^ _mul32(_u32(idx), _GOLD))
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


# ---------------------------------------------------------------------------
# Blocked int8 quantization with stochastic rounding
# ---------------------------------------------------------------------------

def num_blocks(size: int, block: int = DEFAULT_BLOCK) -> int:
    return max(1, -(-size // block))


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """``(..., size)`` -> ``(..., nb, block)``, zero-padded at the end."""
    size = x.shape[-1]
    nb = num_blocks(size, block)
    if nb * block != size:
        x = torch.nn.functional.pad(x, (0, nb * block - size))
    return x.reshape(*x.shape[:-1], nb, block)


def quant_blocks(x: torch.Tensor, salt, block: int = DEFAULT_BLOCK,
                 rounding: str = "stochastic"):
    """Quantize the last axis of ``x`` (f32, ``(..., size)``) in flat
    blocks: ``(q int8 (..., size), scale f32 (..., nb))``.  ``salt`` is a
    scalar or broadcasts against the leading axes (one salt per row)."""
    size = x.shape[-1]
    blocks = _blocks(x.float(), block)
    absmax = blocks.abs().amax(-1)
    scale = absmax * _INV127
    inv = torch.where(scale > 0, 1.0 / scale, torch.zeros_like(scale))
    y = blocks * inv[..., None]
    if rounding == "nearest":
        q = torch.round(y)
    elif rounding == "stochastic":
        idx = torch.arange(blocks.shape[-2] * block, device=x.device,
                           dtype=torch.int64).reshape(blocks.shape[-2:])
        s = _u32(salt, x.device)
        s = s.reshape(s.shape + (1, 1))
        lo = torch.floor(y)
        q = lo + (uniform01(s, idx) < (y - lo)).to(torch.float32)
    else:
        raise ValueError(f"rounding {rounding!r}: expected 'stochastic' "
                         "or 'nearest'")
    q = torch.clamp(q, -127.0, 127.0).to(torch.int8)
    # contiguous: a partial last block leaves a strided slice, and the CUDA
    # kernel updates stored codes in place
    q = q.reshape(*q.shape[:-2], -1)[..., :size].contiguous()
    return q, scale


def dequant_blocks(q: torch.Tensor, scale: torch.Tensor,
                   block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Inverse of :func:`quant_blocks` over the last axis."""
    size = q.shape[-1]
    qf = _blocks(q.to(torch.float32), block)
    out = qf * scale.float()[..., None]
    return out.reshape(*out.shape[:-2], -1)[..., :size]


def blocked_quant(x: torch.Tensor, salt, block: int = DEFAULT_BLOCK,
                  rounding: str = "stochastic"):
    """``x -> (q int8 (x.shape), scale f32 (nb,))`` over row-major flat
    blocks; term for term the JAX package's ``blocked_quant``.

    ``scale = absmax * f32(1/127)`` per block, ``y = x * (1/scale)`` and
    ``q = floor(y) + (u < y - floor(y))`` with ``u = uniform01(salt,
    flat index)``, clipped to ±127.  All-zero blocks encode as scale 0.
    ``rounding="nearest"`` rounds to the nearest level (``salt`` ignored).
    """
    q, scale = quant_blocks(x.reshape(-1), salt, block, rounding)
    return q.reshape(x.shape), scale


def blocked_dequant(q: torch.Tensor, scale: torch.Tensor,
                    block: int = DEFAULT_BLOCK) -> torch.Tensor:
    return dequant_blocks(q.reshape(-1), scale, block).reshape(q.shape)


# ---------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------

class F32Codec:
    """Passthrough: slots are stored exactly as the rule produced them."""

    name = "f32"
    passthrough = True

    def init(self, x):
        return x

    def encode(self, x, salt):
        return x

    def decode(self, enc):
        return enc


class BlockedInt8Codec:
    """Blocked absmax int8 with stochastic rounding (see module doc)."""

    name = "int8"
    passthrough = False

    def __init__(self, block: int = DEFAULT_BLOCK):
        self.block = block

    def init(self, x: torch.Tensor):
        # zeros encode exactly (scale 0): built from the shape alone, so a
        # meta tensor gives a meta state
        nb = num_blocks(x.numel(), self.block)
        return {"q": torch.zeros(x.shape, dtype=torch.int8, device=x.device),
                "scale": torch.zeros((nb,), dtype=torch.float32,
                                     device=x.device)}

    def encode(self, x, salt):
        q, scale = blocked_quant(x, salt, self.block)
        return {"q": q, "scale": scale}

    def decode(self, enc):
        return blocked_dequant(enc["q"], enc["scale"], self.block)


CODECS = {"f32": F32Codec, "int8": BlockedInt8Codec}


def get_codec(codec) -> Any:
    """Name or instance -> codec instance."""
    if isinstance(codec, str):
        if codec not in CODECS:
            raise ValueError(
                f"unknown state codec {codec!r}; choices: {sorted(CODECS)}")
        return CODECS[codec]()
    return codec


# ---------------------------------------------------------------------------
# Slot trees: the codec applies to the True leaves of a rule's ``slots``
# mask; slot indices run in sorted-key order, the JAX package's dict order,
# so every path agrees on which salt quantizes which moment.
# ---------------------------------------------------------------------------

def map_slots(mask, state, fn):
    """``fn(slot_idx, slot_value)`` on each True mask leaf; other values
    pass through.  ``mask`` mirrors ``state``'s dict structure."""
    counter = [0]

    def rec(m, s):
        if m is True:
            i = counter[0]
            counter[0] += 1
            return fn(i, s)
        if m is None or m is False:
            return s
        if not isinstance(m, dict):
            raise TypeError(f"slots mask node {type(m).__name__}: expected "
                            "bool or dict")
        return {k: rec(m[k], s[k]) for k in sorted(s.keys())}

    return rec(mask, state)


def tree_init(codec, mask, state):
    if codec.passthrough or mask is None:
        return state
    return map_slots(mask, state, lambda i, s: codec.init(s))


def tree_decode(codec, mask, state):
    if codec.passthrough or mask is None:
        return state
    return map_slots(mask, state, lambda i, s: codec.decode(s))


def tree_encode(codec, mask, state, salts):
    """Encode each slot ``i`` with ``salts[i]``: the leaf's column of the
    step's :func:`slot_salt` table."""
    if codec.passthrough or mask is None:
        return state
    return map_slots(mask, state, lambda i, s: codec.encode(s, salts[i]))


def num_slots(mask) -> int:
    """The number of True leaves of a slots mask."""
    if mask is True:
        return 1
    if isinstance(mask, dict):
        return sum(num_slots(m) for m in mask.values())
    return 0
