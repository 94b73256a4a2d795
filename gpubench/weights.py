"""The weights a run trains, made by the benchmark from ``--seed`` on the
card: the configuration's published initialisation (normal matrices of
``initializer_range``, zero biases, norms of weight ``1 + 0``), one draw a
leaf from one ``torch.Generator`` on the device, in the type they are
trained in.  The same seed gives the same weights, which both the program
and the reference take."""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def dtype_of(path: str, model_dtype: torch.dtype) -> torch.dtype:
    """The router's logits are f32 (so is its weight); every other leaf
    is in the model dtype."""
    return torch.float32 if path.endswith("router") else model_dtype


class Weights:
    """Draws the leaves of ``layout`` (path -> (shape, init)) in its
    order, and draws one leaf again on request."""

    def __init__(self, layout: Dict[str, Tuple[tuple, str]],
                 model_dtype: torch.dtype, init_range: float, seed: int,
                 device):
        self.layout = layout
        self.model_dtype = model_dtype
        self.init_range = init_range
        self.device = torch.device(device)
        self.seed = seed
        self.gen = torch.Generator(device=self.device)
        self._states: Dict[str, torch.Tensor] = {}

    def _leaf(self, path: str) -> torch.Tensor:
        shape, init = self.layout[path]
        dt = dtype_of(path, self.model_dtype)
        if init == "zeros":
            return torch.zeros(shape, dtype=dt, device=self.device)
        t = torch.randn(shape, generator=self.gen, dtype=dt,
                        device=self.device)
        return t.mul_(self.init_range)

    def draw(self) -> Dict[str, torch.Tensor]:
        """Every leaf, in layout order: the same on every call."""
        self.gen.manual_seed(self.seed)
        out = {}
        for path in self.layout:
            self._states[path] = self.gen.get_state()
            out[path] = self._leaf(path)
        return out

    def again(self, path: str) -> torch.Tensor:
        """Leaf ``path`` as :meth:`draw` made it (after a draw)."""
        self.gen.set_state(self._states[path])
        return self._leaf(path)


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """``{"a/b": t}`` -> ``{"a": {"b": t}}``."""
    out: dict = {}
    for path, t in flat.items():
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = t
    return out


def flat(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """:func:`nest`'s inverse, keys sorted at every level."""
    out = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            out.update(flat(tree[k], path))
        else:
            out[path] = tree[k]
    return out
