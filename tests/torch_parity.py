"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``):
numpy <-> torch converters, the f32-spacing error measure, and the export
of JAX-initialised parameters into the port through ``repro_torch.interop``.

Inputs cross between the packages as numpy arrays only.  torch is held to
two threads so the tests stay cheap under ``pytest -n 6``.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(2)


def to_torch(a: np.ndarray, dtype=None) -> torch.Tensor:
    """numpy array -> CPU tensor (a copy), cast to ``dtype`` if given."""
    t = torch.from_numpy(np.array(a))
    return t.to(dtype) if dtype is not None else t


def to_numpy(t) -> np.ndarray:
    """tensor or jax array -> numpy; bf16 widens to float32 exactly."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    a = jnp.asarray(t)
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


def spacings(got, want) -> float:
    """Worst ``|got - want|`` in f32 spacings at ``want``'s largest
    magnitude: 0 is bitwise, 1 is one unit in the last place of the
    biggest element."""
    got, want = to_numpy(got).astype(np.float64), \
        to_numpy(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.spacing(np.float32(max(np.abs(want).max(), 1e-30)))
    return float(np.abs(got - want).max() / scale)


def bf16_spacings(got, want) -> float:
    """As :func:`spacings`, counted in bf16 units (2^16 f32 spacings)."""
    return spacings(got, want) / 2.0 ** 16


def flat_numpy(tree) -> Dict[str, np.ndarray]:
    """A JAX pytree as ``{path: ndarray}`` in the JAX flatten order."""
    from repro.optim.base import flatten_with_paths
    paths, leaves, _ = flatten_with_paths(tree)
    return {p: to_numpy(l) for p, l in zip(paths, leaves)}


def jax_params(cfg, seed: int = 0):
    from repro.models import lm
    return lm.init(cfg, jax.random.key(seed))


def port_model(jax_cfg, port_cfg, seed: int = 0):
    """``(jax_params, port LM)`` with the port holding the same values."""
    from repro_torch import interop
    jp = jax_params(jax_cfg, seed)
    return jp, interop.params_from_numpy(port_cfg, flat_numpy(jp), "cpu")
