"""Carry parameters and optimizer state from the JAX package into the port.

Both functions take a flat ``{path: ndarray}`` dict keyed by the JAX
flatten paths (``"layers/b0/mixer/wq"``,
``"buckets/gwt_last__layers.b0.mixer.wk/host/m"``).  A bf16 leaf arrives
either as float32 (every bf16 value is exact in float32) or as its raw bits
viewed as ``uint16``; ``ml_dtypes`` is not needed.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.optim.base import flatten_with_paths, unflatten


def _tensor(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint16:
        if dtype != torch.bfloat16:
            raise ValueError(f"uint16 bits are bf16, not {dtype}")
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True)).to(dtype)
    return t.to(device)


def params_from_numpy(cfg, arrays: Mapping[str, np.ndarray],
                      device) -> lm.LM:
    """An :class:`lm.LM` holding ``arrays``, checked path by path and shape
    by shape against the port's own parameter tree for ``cfg``."""
    paths, leaves = flatten_with_paths(lm.abstract_params(cfg))
    want = {p: tuple(l.shape) for p, l in zip(paths, leaves)}
    if set(arrays) != set(want):
        raise ValueError(f"parameter paths differ: missing "
                         f"{sorted(set(want) - set(arrays))}, unexpected "
                         f"{sorted(set(arrays) - set(want))}")
    out = []
    for p in paths:
        if tuple(np.shape(arrays[p])) != want[p]:
            raise ValueError(f"{p}: shape {np.shape(arrays[p])}, expected "
                             f"{want[p]}")
        out.append(_tensor(arrays[p], cfg.torch_dtype, device))
    return lm.LM(cfg, unflatten(paths, out))


def state_from_numpy(arrays: Mapping[str, np.ndarray],
                     device) -> Dict[str, object]:
    """The optimizer state: ``step`` int32, every other leaf f32."""
    paths = sorted(arrays)
    leaves = [_tensor(arrays[p], torch.int32 if p == "step"
                      else torch.float32, device) for p in paths]
    return unflatten(paths, leaves)
