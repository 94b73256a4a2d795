"""Fira's norm-growth limiter (counterpart of ``repro/core/limiter.py``).

    if ||G̃_t|| / ||G̃_{t-1}|| > γ:   G̃_t ← G̃_t / ||G̃_t|| · γ · ||G̃_{t-1}||

``prev_norm == 0`` (first step) disables limiting; a zero-norm update keeps
the previous norm so the history survives.
"""

from __future__ import annotations

from typing import Tuple

import torch

DEFAULT_GAMMA = 1.01


def limiter_scale(norm: torch.Tensor, prev: torch.Tensor,
                  gamma: float) -> torch.Tensor:
    """The limiter ratio, term for term as the reference computes it."""
    safe_prev = torch.where(prev > 0, prev, norm)
    return torch.where(norm > gamma * safe_prev,
                       gamma * safe_prev / torch.clamp_min(norm, 1e-30),
                       torch.ones_like(norm))


def limit(update: torch.Tensor, prev_norm: torch.Tensor,
          gamma: float = DEFAULT_GAMMA
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(limited_update, new_prev_norm)``."""
    norm = torch.linalg.vector_norm(update.float())
    scale = limiter_scale(norm, prev_norm, gamma)
    limited = update * scale.to(update.dtype)
    new_prev = torch.where(norm > 0, norm * scale, prev_norm)
    return limited, new_prev.float()


def clip_flags(prev_norm: torch.Tensor, new_norm: torch.Tensor,
               gamma: float = DEFAULT_GAMMA) -> torch.Tensor:
    """Did :func:`limit` clip, read back from the norms it threads: a clip
    lands ``new`` at ``γ·prev`` up to one rounding of the multiply chain."""
    margin = 1.0 - 2.0 ** -20
    return (prev_norm > 0) & (new_norm >= gamma * prev_norm * margin)
