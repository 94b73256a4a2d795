"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``):
numpy <-> torch converters, the f32-spacing error measure, and the export
of JAX-initialised parameters into the port through ``repro_torch.interop``.

Inputs cross between the packages as numpy arrays only.  torch is held to
two threads so the tests stay cheap under ``pytest -n 6``.
"""

from __future__ import annotations

import functools
import json
import os
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


def jit_light(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` without LLVM's expensive
    passes: on the CPU it halves the compile time of a smoke stack's
    gradient, and it gives the same values (bitwise on jamba's and
    xlstm-350m's smoke gradients)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_llvm_disable_expensive_passes": True})


def flat_numpy(tree) -> Dict[str, np.ndarray]:
    """A JAX pytree as ``{path: ndarray}`` in the JAX flatten order."""
    from repro.optim.base import flatten_with_paths
    paths, leaves, _ = flatten_with_paths(tree)
    return {p: to_numpy(l) for p, l in zip(paths, leaves)}


@functools.lru_cache(maxsize=None)
def _jax_init(cfg, seed: int):
    from repro.models import lm
    leaves, treedef = jax.tree_util.tree_flatten(
        lm.init(cfg, jax.random.key(seed)))
    return [np.array(l) for l in leaves], treedef


def jax_params(cfg, seed: int = 0):
    """The JAX package's ``lm.init(cfg, key(seed))``, initialised once per
    ``(cfg, seed)`` and process (op by op it takes seconds); every call
    gets arrays of its own, so a step that donates them leaves the cache
    whole."""
    leaves, treedef = _jax_init(cfg, seed)
    return jax.tree_util.tree_unflatten(treedef,
                                        [jnp.array(l) for l in leaves])


def port_model(jax_cfg, port_cfg, seed: int = 0):
    """``(jax_params, port LM)`` with the port holding the same values."""
    from repro_torch import interop
    jp = jax_params(jax_cfg, seed)
    return jp, interop.params_from_numpy(port_cfg, flat_numpy(jp), "cpu")


def jax_legacy_checkpoint(d, steps=2):
    """A checkpoint in the JAX package's legacy per-leaf optimizer layout
    (``Engine.to_legacy`` and its ``CheckpointManager``), after ``steps``
    GWT updates from random gradients on llama-60m-smoke; returns the
    reference's parameters, optimizer and bucketed state."""
    from repro import configs as jconfigs
    from repro.checkpoint import manager as jmanager
    from repro.core.gwt import gwt as jax_gwt
    from repro.models import lm as jlm
    jparams = jlm.init(jconfigs.get_smoke("llama-60m"), jax.random.key(0))
    jopt = jax_gwt(lr=0.01, impl="jnp")
    state = jopt.init(jparams)
    update = jax.jit(jopt.update)
    for s in range(steps):
        leaves, tree = jax.tree.flatten(jparams)
        keys = jax.random.split(jax.random.key(100 + s), len(leaves))
        grads = jax.tree.unflatten(tree, [
            0.1 * jax.random.normal(k, l.shape, l.dtype)
            for k, l in zip(keys, leaves)])
        jparams, state = update(grads, state, jparams)
    jmanager.CheckpointManager(d, run_meta={
        "data": {"kind": "synthetic", "order_seed": 0},
        "state_codec": "f32"}).save(
            steps, {"params": jparams,
                    "opt": jopt.engine.to_legacy(state, jparams)},
            blocking=True)
    return jparams, jopt, state


# the optimizer taps of two runs' --metrics-dir records

def tap_records(d):
    """``(step, [(tap key, value), ...])`` of every ``train_step`` record
    of ``d/metrics.jsonl`` in file order, the taps in the record's
    order."""
    out = []
    with open(os.path.join(d, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["kind"] == "train_step":
                out.append((rec["step"], [(k, v) for k, v in rec.items()
                                          if "/" in k]))
    return out


def tap_kind(key):
    tap = key.rsplit("/", 1)[1]
    if tap in ("grad_ssq", "band_a_ssq", "band_d_ssq"):
        return "grad"
    if tap in ("update_ssq", "gnorm_ssq"):
        return "update"
    return tap


def taps_gap(got, want):
    """The largest relative difference of each kind of tap (:func:`tap_kind`)
    between two runs' records; both must hold the same steps and, on each,
    the same keys in the same order."""
    assert [s for s, _ in got] == [s for s, _ in want]
    gap = {}
    for (_, g), (_, w) in zip(got, want):
        assert [k for k, _ in g] == [k for k, _ in w]
        for (k, a), (_, b) in zip(g, w):
            kind = tap_kind(k)
            d = abs(a - b) / abs(b) if b else abs(a)
            gap[kind] = max(gap.get(kind, 0.0), d)
    return gap
