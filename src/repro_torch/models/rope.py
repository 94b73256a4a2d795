"""Rotary embeddings (counterpart of ``repro/models/rope.py``): standard RoPE
and M-RoPE (Qwen2-VL's three-section rotary).

M-RoPE splits the head_dim/2 rotary frequency bands into (temporal, height,
width) sections, each rotated by its own position row.  For text-only input
the three rows coincide (the vision frontend is a stub, as in the JAX
package), and M-RoPE equals RoPE.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def _freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=32)
def _freqs_on(head_dim: int, theta: float, device: torch.device
              ) -> torch.Tensor:
    """The f32 frequencies on ``device``, copied there once: a copy from
    pageable host memory blocks the host on the card, once per forward
    without this cache (every serving tick).  Made outside inference mode,
    so the train forward may take it whichever mode called first."""
    with torch.inference_mode(False):
        return torch.as_tensor(_freqs(head_dim, theta), dtype=torch.float32,
                               device=device)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> cos/sin of shape (..., S, head_dim/2)."""
    freqs = _freqs_on(head_dim, theta, positions.device)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def mrope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                 sections: Tuple[int, ...]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (3, B, S); ``sections`` sum to head_dim/2, section ``i``
    taking its bands' angles from row ``i``.  Returns cos/sin (B, S,
    head_dim/2)."""
    if sum(sections) != head_dim // 2:
        raise ValueError(f"mrope sections {sections} must sum to head_dim/2 "
                         f"= {head_dim // 2}")
    freqs = _freqs_on(head_dim, theta, positions.device)
    ang_all = positions.float()[..., None] * freqs   # (3, B, S, hd/2)
    chunks, off = [], 0
    for i, sec in enumerate(sections):
        chunks.append(ang_all[i, ..., off:off + sec])
        off += sec
    ang = torch.cat(chunks, dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (B, S, hd/2) or (S, hd/2)."""
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
