"""Model substrate (counterpart of ``repro/models/layers.py``): parameter
construction, RMSNorm, the logit softcap, the SwiGLU MLP, the embedding with
its tied or untied head, and the loss.

Weights keep the JAX package's ``(d_in, d_out)`` layout and are applied as
``x @ W``; the GWT optimizer picks its transform axis from that layout.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


class Builder:
    """Draws parameters in the order and scheme of the JAX ``Builder``: fan-in
    scaled normal (``1/sqrt(shape[-2])``), zeros, or an explicit scale.
    On the ``meta`` device it allocates nothing and draws nothing."""

    def __init__(self, generator: Optional[torch.Generator],
                 device: torch.device, dtype: torch.dtype):
        self.generator = generator
        self.device = torch.device(device)
        self.dtype = dtype

    def param(self, shape: Tuple[int, ...], init: str = "normal",
              scale: Optional[float] = None, lead: Tuple[int, ...] = ()
              ) -> torch.Tensor:
        """``lead`` prepends stacked-layer axes; the fan-in is the per-layer
        shape's."""
        full = tuple(lead) + tuple(shape)
        if self.device.type == "meta":
            return torch.empty(full, dtype=self.dtype, device=self.device)
        if init == "zeros":
            return torch.zeros(full, dtype=self.dtype, device=self.device)
        if scale is None:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = 1.0 / math.sqrt(fan_in)
        x = torch.randn(full, generator=self.generator, dtype=torch.float32,
                        device=self.device)
        return (x * scale).to(self.dtype)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + gamma.float())
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """``cap * tanh(x / cap)`` in f32, cast back to ``x``'s dtype."""
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def mlp_init(b: Builder, d_model: int, d_ff: int, lead=()):
    return {"w_gate": b.param((d_model, d_ff), lead=lead),
            "w_up": b.param((d_model, d_ff), lead=lead),
            "w_down": b.param((d_ff, d_model), lead=lead)}


def mlp_apply(p, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


def embed_init(b: Builder, vocab: int, d_model: int, tie: bool):
    """The scale-1.0 embedding and, when untied, a fan-in normal
    ``lm_head`` of shape ``(d_model, vocab)``."""
    p = {"embedding": b.param((vocab, d_model), scale=1.0)}
    if not tie:
        p["lm_head"] = b.param((d_model, vocab))
    return p


def embed_apply(p, tokens: torch.Tensor, d_model: int) -> torch.Tensor:
    """Rows times ``sqrt(d)``, the scale rounded to the embedding dtype and
    the product taken in it, as the JAX package does."""
    emb = p["embedding"]
    return emb[tokens.long()] * torch.tensor(math.sqrt(d_model),
                                             dtype=emb.dtype)


def logits_apply(p, x: torch.Tensor) -> torch.Tensor:
    """``x @ lm_head`` where the head is untied, else ``x @ embedding.T``."""
    w = p.get("lm_head")
    return x @ (p["embedding"].T if w is None else w)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean cross-entropy in f32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll)
