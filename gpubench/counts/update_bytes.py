"""The bytes one optimizer update has to move, whatever implements it:
each leaf's gradient, parameter and moments read once, the parameter and
moments written once.  A GWT leaf (``reference.optim.mode``) keeps its
two moments on the ``2^-level`` band, a plain leaf on the whole leaf; a
moment element is 4 bytes in f32, or an int8 code plus its share of a
4-byte scale per 64 elements under the ``int8`` codec.  The gradient is
in the leaf's dtype."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from gpubench.reference.optim import BLOCK, mode

MOMENT_BYTES = {"f32": 4.0, "int8": 1.0 + 4.0 / BLOCK}


def leaf(path: str, shape: Tuple[int, ...], dtype: torch.dtype,
         level: int, codec: str) -> float:
    n = math.prod(shape)
    size = torch.empty((), dtype=dtype).element_size()
    moments = n if mode(path, shape, level) == "plain" else n >> level
    # g read, p read and written; m and v each read and written
    return n * 3 * size + moments * 4 * MOMENT_BYTES[codec]


def total(plan: Dict[str, tuple], level: int, codec: str) -> float:
    """``plan``: path -> (shape, dtype) of every trained leaf."""
    return sum(leaf(p, shape, dt, level, codec)
               for p, (shape, dt) in plan.items())
