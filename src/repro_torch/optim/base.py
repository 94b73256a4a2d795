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

from typing import (Any, Callable, Dict, List, Mapping, NamedTuple,
                    Sequence, Tuple)

import torch

Params = Dict[str, Any]
OptState = Dict[str, Any]


class Optimizer(NamedTuple):
    init: Callable[[Params], OptState]
    update: Callable[[Params, OptState, Params], Tuple[Params, OptState]]
    # the engine that built the optimizer (plan() for bucket names)
    engine: Any = None
    # the tapped channel, ``(grads, state, params) -> (params, new_state,
    # taps)``: ``update`` plus a flat dict of f32 device scalars named
    # "<bucket>/<metric>" (``optim.engine``; DESIGN.md §12).  None where
    # the optimizer has none; ``update`` never computes a tap.
    tapped_update: Any = None


def path_str(path: Sequence[Any]) -> str:
    """A key path (the dict keys from the root to a leaf) as the
    '/'-joined string that addresses the leaf."""
    return "/".join(str(k) for k in path)


def flatten_with_paths(tree: Mapping) -> Tuple[List[str], List[Any]]:
    """Returns ``(paths, leaves)`` in the JAX flatten order of a dict tree."""
    paths: List[str] = []
    leaves: List[Any] = []
    _walk(tree, "", paths, leaves)
    return paths, leaves


def _walk(node, prefix, paths, leaves):
    # a module-level function: a recursive closure would be a reference
    # cycle holding the leaf lists (a step's gradients, an old optimizer
    # state) until the cyclic collector ran
    for k in sorted(node):
        v = node[k]
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            _walk(v, path, paths, leaves)
        else:
            paths.append(path)
            leaves.append(v)


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


def map_with_path(fn, tree, *rest):
    """:func:`tree_map` with the leaf's '/'-joined path as ``fn``'s first
    argument."""
    def walk(prefix, node, *others):
        if not isinstance(node, Mapping):
            return fn(path_str(prefix), node, *others)
        return {k: walk(prefix + (k,), v, *(o[k] for o in others))
                for k, v in node.items()}
    return walk((), tree, *rest)


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


def global_norm(tree) -> torch.Tensor:
    """The f32 Euclidean norm of every leaf of ``tree`` together: each
    leaf's f32 sum of squares, added in flatten order, then the root."""
    total = sum(torch.sum(leaf.float() ** 2)
                for leaf in flatten_with_paths(tree)[1])
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))
