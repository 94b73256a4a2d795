"""Carry parameters and optimizer state between the JAX package and the
port.

Both directions use a flat ``{path: ndarray}`` dict keyed by the JAX
flatten paths (``"layers/b0/mixer/wq"``,
``"buckets/gwt_last__layers.b0.mixer.wk/host/m/q"``; a LoRA tree's
``"base/..."`` and ``"lora/.../a"``).  A bf16 leaf arrives
either as float32 (every bf16 value is exact in float32) or as its raw bits
viewed as ``uint16``; ``ml_dtypes`` is not needed.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import from_numpy, to_numpy
from repro_torch.models import encdec, lm, lora, module_for
from repro_torch.optim.base import flatten_with_paths, unflatten


def _is_bf16(a: np.ndarray) -> bool:
    """bf16 bits as ``uint16``, or an ``ml_dtypes`` bfloat16 array."""
    return a.dtype == np.uint16 or a.dtype.name == "bfloat16"


def _tensor(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint16 and dtype != torch.bfloat16:
        raise ValueError(f"uint16 bits are bf16, not {dtype}")
    return from_numpy(a, "bfloat16" if _is_bf16(a) else str(a.dtype), dtype,
                      device)


def params_from_numpy(cfg, arrays: Mapping[str, np.ndarray],
                      device, lora_rank: Optional[int] = None) -> lm.LM:
    """An :class:`lm.LM` (an encoder-decoder config's
    :class:`encdec.EncDec`) holding ``arrays``, checked path by path and
    shape by shape against the port's own parameter tree for ``cfg``, each
    leaf in that tree's dtype (the model dtype; f32 for an MoE router).
    With ``lora_rank`` the tree is a LoRA fine-tune's ``{"base", "lora"}``
    (``models.lora.inject`` at that rank; the adapters are f32)."""
    mod = module_for(cfg)
    like = mod.abstract_params(cfg)
    if lora_rank is not None:
        like = lora.inject(like, lora_rank, (0, 0))
    paths, leaves = flatten_with_paths(like)
    want = {p: tuple(l.shape) for p, l in zip(paths, leaves)}
    if set(arrays) != set(want):
        raise ValueError(f"parameter paths differ: missing "
                         f"{sorted(set(want) - set(arrays))}, unexpected "
                         f"{sorted(set(arrays) - set(want))}")
    out = []
    for p, leaf in zip(paths, leaves):
        if tuple(np.shape(arrays[p])) != want[p]:
            raise ValueError(f"{p}: shape {np.shape(arrays[p])}, expected "
                             f"{want[p]}")
        out.append(_tensor(arrays[p], leaf.dtype, device))
    return (encdec.EncDec if mod is encdec else lm.LM)(
        cfg, unflatten(paths, out))


# optimizer-state leaves keep their integer dtypes: int8 moment codes, the
# uint32 codec key, the int32 step; bf16 moments (``state_dtype``) arrive as
# their bits or as ml_dtypes bfloat16; every other leaf is f32
_STATE_DTYPES = {np.dtype(np.int8): torch.int8,
                 np.dtype(np.uint32): torch.uint32,
                 np.dtype(np.int32): torch.int32}


def _state_dtype(a: np.ndarray) -> torch.dtype:
    if _is_bf16(a):
        return torch.bfloat16
    return _STATE_DTYPES.get(a.dtype, torch.float32)


def state_from_numpy(arrays: Mapping[str, np.ndarray],
                     device) -> Dict[str, object]:
    """The optimizer state from its flat ``{path: ndarray}`` export."""
    paths = sorted(arrays)
    leaves = [_tensor(arrays[p], _state_dtype(np.asarray(arrays[p])),
                      device) for p in paths]
    return unflatten(paths, leaves)


def state_to_numpy(state) -> Dict[str, np.ndarray]:
    """Inverse of :func:`state_from_numpy`: ``{path: ndarray}`` in each
    leaf's own dtype, a bf16 leaf as its ``uint16`` bits."""
    paths, leaves = flatten_with_paths(state)
    return {p: to_numpy(t)[0] for p, t in zip(paths, leaves)}
