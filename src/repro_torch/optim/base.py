"""Optimizer substrate (counterpart of ``repro/optim/base.py``).

``Optimizer.init(params) -> state``;
``Optimizer.update(grads, state, params) -> (params, new_state)``.

Parameter trees are nested dicts of tensors.  Leaves are addressed by
'/'-joined key paths in the order ``jax.tree_util`` flattens a dict tree
(keys sorted at every level), so bucket names and leaf order agree with the
JAX package.  ``update`` writes the new values into the parameter tensors
in place.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Tuple

import torch

Params = Dict[str, Any]
OptState = Dict[str, Any]


class Optimizer(NamedTuple):
    init: Callable[[Params], OptState]
    update: Callable[[Params, OptState, Params], Tuple[Params, OptState]]
    # the engine that built the optimizer (plan() for bucket names)
    engine: Any = None


def flatten_with_paths(tree: Mapping) -> Tuple[List[str], List[Any]]:
    """Returns ``(paths, leaves)`` in the JAX flatten order of a dict tree."""
    paths: List[str] = []
    leaves: List[Any] = []

    def walk(node, prefix):
        for k in sorted(node):
            v = node[k]
            path = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                walk(v, path)
            else:
                paths.append(path)
                leaves.append(v)

    walk(tree, "")
    return paths, leaves


def unflatten(paths: List[str], leaves: List[Any]) -> Dict[str, Any]:
    """Inverse of :func:`flatten_with_paths`: a nested dict from paths."""
    out: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return out


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf-wise over dict trees of the same structure; a tree
    that is a bare leaf (SGD's per-leaf state) is ``fn`` of it."""
    if not isinstance(tree, Mapping):
        return fn(tree, *rest)
    return {k: tree_map(fn, v, *(r[k] for r in rest))
            for k, v in tree.items()}


# Parameters that never get wavelet compression (embeddings, output head,
# norms, biases, ...), as in the JAX package's deny-list: the paper's
# module-wise strategy puts GWT on attention and MLP weights only.
_DENY_SUBSTRINGS = ("embed", "lm_head", "norm", "scale", "bias", "pos_",
                    "router", "a_log", "dt_bias", "conv",
                    "x_proj", "dt_proj", "igate", "fgate")

_DENY_SEGMENTS = ("r",)


def default_eligible(path: str, leaf: torch.Tensor) -> bool:
    """True if ``leaf`` should get wavelet-compressed states (name and rank
    only; divisibility by ``2^level`` is ``core.gwt._leaf_mode``'s job)."""
    lname = path.lower()
    if any(s in lname for s in _DENY_SUBSTRINGS):
        return False
    if lname.rsplit("/", 1)[-1] in _DENY_SEGMENTS:
        return False
    return leaf.ndim >= 2
