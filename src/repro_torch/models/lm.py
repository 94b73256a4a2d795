"""Decoder-only LM (counterpart of ``repro/models/lm.py``, train mode):
parameter construction, the forward pass, the loss and the gradient-
accumulated train step.

Parameters live in a nested dict with the JAX package's paths
(``layers/b0/mixer/wq``, ...), every per-layer weight stacked on a leading
``(n_layers, ...)`` axis.  :class:`LM` is the ``nn.Module`` that holds them;
the functions here take the nested dict, as the JAX functions take the
pytree.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from repro_torch.models import blocks, rope as rope_lib
from repro_torch.models.layers import (Builder, cross_entropy, embed_apply,
                                       embed_init, logits_apply, rms_norm)
from repro_torch.optim.base import flatten_with_paths, unflatten


class ParamTree(nn.Module):
    """A nested dict of tensors registered as parameters and submodules
    under the same keys."""

    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, Mapping):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def tree(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self._parameters)
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


class LM(nn.Module):
    """Holds the stacked parameters; ``forward(tokens)`` gives logits."""

    def __init__(self, cfg, params: Mapping[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.params = ParamTree(params)

    def tree(self) -> Dict[str, Any]:
        """The parameters as the nested dict the optimizer and the
        functions of this module take (the tensors themselves, not
        copies)."""
        return self.params.tree()

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self.cfg, self.tree(), tokens)


def _build(cfg, generator: Optional[torch.Generator],
           device) -> Dict[str, Any]:
    b = Builder(generator, device, cfg.torch_dtype)
    p: Dict[str, Any] = {"embed": embed_init(b, cfg.vocab, cfg.d_model)}
    p["layers"] = {f"b{i}": blocks.block_init(b, cfg, kind,
                                             lead=(cfg.n_periods,))
                   for i, kind in enumerate(cfg.pattern)}
    p["final_norm"] = b.param((cfg.d_model,), init="zeros")
    return p


def init(cfg, generator: torch.Generator, device) -> LM:
    """Random init from ``generator`` (which must live on ``device``) with
    the JAX package's scheme: fan-in normal weights, scale-1.0 embedding,
    zero norms."""
    return LM(cfg, _build(cfg, generator, device))


def abstract_params(cfg) -> Dict[str, Any]:
    """The parameter tree on the ``meta`` device: shapes and dtypes only."""
    return _build(cfg, None, "meta")


def forward(cfg, params, tokens: torch.Tensor) -> torch.Tensor:
    """Train-mode forward over ``tokens`` (B, S); returns logits (B, S, V)."""
    S = tokens.shape[1]
    x = embed_apply(params["embed"], tokens, cfg.d_model)
    positions = torch.arange(S, device=tokens.device)
    cos, sin = rope_lib.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    # unbind once: the backward then stacks the per-layer gradients instead
    # of scattering each layer's into a full-size zero tensor
    paths, leaves = flatten_with_paths(params["layers"])
    per_layer = [unflatten(paths, ls)
                 for ls in zip(*(l.unbind(0) for l in leaves))]
    for layer in per_layer:
        for i, _ in enumerate(cfg.pattern):
            x = blocks.block_apply(layer[f"b{i}"], cfg, x, cos, sin)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_apply(params["embed"], x)


def loss_fn(cfg, params, batch) -> torch.Tensor:
    return cross_entropy(forward(cfg, params, batch["tokens"]),
                         batch["labels"])


def microbatch_split(batch: Dict[str, torch.Tensor], accum: int
                     ) -> Dict[str, torch.Tensor]:
    """``(B, ...) -> (accum, B/accum, ...)`` with microbatch ``a`` holding
    global rows ``m·accum + a``, the JAX package's layout."""
    out = {}
    for k, v in batch.items():
        mb = v.shape[0] // accum
        out[k] = v.reshape(mb, accum, *v.shape[1:]).transpose(0, 1)
    return out


def make_train_step(cfg, optimizer, accum_steps: int = 1):
    """Gradient-accumulated train step ``(params, opt_state, batch) ->
    (params, opt_state, {"loss": f32 scalar on the device})``.

    Gradients are summed in f32 over the microbatches, divided by
    ``accum_steps`` and cast to ``cfg.dtype`` before the update, as the JAX
    step does.  The optimizer writes the parameters in place."""
    def train_step(params, opt_state, batch):
        paths, leaves = flatten_with_paths(params)
        micro = microbatch_split(batch, accum_steps)
        gsum = [torch.zeros(l.shape, dtype=torch.float32, device=l.device)
                for l in leaves]
        lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for a in range(accum_steps):
            mb = {k: v[a] for k, v in micro.items()}
            loss = loss_fn(cfg, params, mb)
            grads = torch.autograd.grad(loss, leaves)
            for s, g in zip(gsum, grads):
                s.add_(g.float())
            lsum = lsum + loss.detach()
        grads = unflatten(paths, [(s / accum_steps).to(cfg.torch_dtype)
                                  for s in gsum])
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": lsum / accum_steps}

    return train_step
