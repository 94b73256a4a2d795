"""Model substrate (counterpart of ``repro/models/layers.py``): parameter
construction, RMSNorm, the logit softcap, the SwiGLU MLP, the embedding with
its tied or untied head, the loss, and the LoRA adapter pairs
(``models/lora.py`` builds trees out of them).

Weights keep the JAX package's ``(d_in, d_out)`` layout and are applied as
``x @ W``; the GWT optimizer picks its transform axis from that layout.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


class Axes:
    """The logical axis names of a parameter's dimensions (``"embed"``,
    ``"heads"``, ``"layers"``, ... or None), as the JAX package's ``Axes``:
    what ``distributed.sharding`` maps to mesh axes.

    ``blocks`` > 1 marks a last dimension made of that many equal
    contiguous blocks that the model splits apart (mamba's ``in_proj``
    columns ``[xm | z]``, mLSTM's ``up_proj``): where the rule table splits
    that dimension, a rank holds its slice of each block, in block order
    (``distributed.sharding.NamedSharding.blocks``).  The reference's
    ``Axes`` has no such field: its GSPMD layout is contiguous."""

    __slots__ = ("names", "blocks")

    def __init__(self, names: Tuple[Optional[str], ...], blocks: int = 1):
        self.names = tuple(names)
        self.blocks = int(blocks)

    def __repr__(self):
        if self.blocks > 1:
            return f"Axes({self.names}, blocks={self.blocks})"
        return f"Axes{self.names}"

    def __eq__(self, other):
        return isinstance(other, Axes) and self.names == other.names \
            and self.blocks == other.blocks

    def __hash__(self):
        return hash((self.names, self.blocks))


class Builder:
    """Draws parameters in the order and scheme of the JAX ``Builder``: fan-in
    scaled normal (``1/sqrt(shape[-2])``), zeros, ones, or an explicit
    scale.
    On the ``meta`` device it allocates nothing and draws nothing.  With
    ``mode="axes"`` each parameter is its :class:`Axes` instead, and nothing
    is built on any device."""

    def __init__(self, generator: Optional[torch.Generator],
                 device: torch.device, dtype: torch.dtype,
                 mode: str = "init"):
        if mode not in ("init", "axes"):
            raise ValueError(f"unknown builder mode {mode!r}")
        self.generator = generator
        self.device = torch.device(device)
        self.dtype = dtype
        self.mode = mode

    def param(self, shape: Tuple[int, ...], axes: Tuple[Optional[str], ...],
              init: str = "normal", scale: Optional[float] = None,
              lead: Tuple[int, ...] = (),
              dtype: Optional[torch.dtype] = None, blocks: int = 1):
        """``axes`` names each dimension of ``shape``; ``lead`` prepends
        stacked-layer axes, named ``"layers"``, and the fan-in is the
        per-layer shape's.  ``dtype`` overrides the builder's (the f32 MoE
        router); ``blocks`` is the :class:`Axes`' (the last dimension's
        paired halves)."""
        if len(shape) != len(axes):
            raise ValueError(f"shape {shape} and axes {axes} differ in rank")
        if self.mode == "axes":
            return Axes(("layers",) * len(lead) + tuple(axes), blocks)
        full = tuple(lead) + tuple(shape)
        dtype = dtype or self.dtype
        if self.device.type == "meta":
            return torch.empty(full, dtype=dtype, device=self.device)
        if init == "zeros":
            return torch.zeros(full, dtype=dtype, device=self.device)
        if init == "ones":
            return torch.ones(full, dtype=dtype, device=self.device)
        if scale is None:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = 1.0 / math.sqrt(fan_in)
        x = torch.randn(full, generator=self.generator, dtype=torch.float32,
                        device=self.device)
        return (x * scale).to(dtype)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6,
             tp=None) -> torch.Tensor:
    """``tp`` (a ``distributed.tensor_parallel.TP``): ``x``'s last dimension
    and ``gamma`` are this rank's channels of a width split over the group;
    the f32 sum of squares is all-reduced once, so the norm is the whole
    width's up to the sum's order."""
    x32 = x.float()
    if tp is None:
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    else:
        var = tp.reduce_split((x32 * x32).sum(-1, keepdim=True)) \
            / (x.shape[-1] * tp.size)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + gamma.float())
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """``cap * tanh(x / cap)`` in f32, cast back to ``x``'s dtype."""
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def mlp_init(b: Builder, d_model: int, d_ff: int, lead=()):
    return {"w_gate": b.param((d_model, d_ff), ("embed", "mlp"), lead=lead),
            "w_up": b.param((d_model, d_ff), ("embed", "mlp"), lead=lead),
            "w_down": b.param((d_ff, d_model), ("mlp", "embed"), lead=lead)}


def mlp_apply(p, x: torch.Tensor, tp=None) -> torch.Tensor:
    """SwiGLU.  With ``tp`` (a ``distributed.tensor_parallel.TP``; the
    caller passes it only where the hidden width splits) ``w_gate``/``w_up``
    are this rank's columns and ``w_down`` its rows, and the partial
    outputs are summed over the model group."""
    if tp is not None:
        x = tp.copy_in(x)
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    out = h @ p["w_down"]
    return out if tp is None else tp.reduce_out(out)


def embed_init(b: Builder, vocab: int, d_model: int, tie: bool):
    """The scale-1.0 embedding and, when untied, a fan-in normal
    ``lm_head`` of shape ``(d_model, vocab)``."""
    p = {"embedding": b.param((vocab, d_model), ("vocab", "embed"),
                              scale=1.0)}
    if not tie:
        p["lm_head"] = b.param((d_model, vocab), ("embed", "vocab"))
    return p


def embed_apply(p, tokens: torch.Tensor, d_model: int, tp=None
                ) -> torch.Tensor:
    """Rows times ``sqrt(d)``, the scale rounded to the embedding dtype and
    the product taken in it, as the JAX package does.  With ``tp`` the
    table is this rank's vocab rows: an id outside them gives a zero row,
    and the scaled rows are summed over the model group (one nonzero term
    a position, so the sum is exact)."""
    emb = p["embedding"]
    scale = torch.tensor(math.sqrt(d_model), dtype=emb.dtype)
    if tp is None:
        return emb[tokens.long()] * scale
    n = emb.shape[0]
    ids = tokens.long() - tp.rank * n
    inside = ((ids >= 0) & (ids < n))[..., None]
    x = emb[ids.clamp(0, n - 1)] * scale
    return tp.reduce_out(torch.where(inside, x, torch.zeros_like(x)))


def logits_apply(p, x: torch.Tensor, tp=None) -> torch.Tensor:
    """``x @ lm_head`` where the head is untied, else ``x @ embedding.T``.
    With ``tp``: this rank's vocab columns of the logits, never gathered
    (``distributed.tensor_parallel.vocab_cross_entropy`` takes them)."""
    w = p.get("lm_head")
    if tp is not None:
        x = tp.copy_in(x)
    return x @ (p["embedding"].T if w is None else w)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean cross-entropy in f32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll)


# ``core.prng`` is imported inside the functions that draw: the ``core``
# package imports GWT, whose optimizer engine imports
# ``distributed.sharding``, which imports this module.

def lora_pair_init(key, shape, rank: int, device,
                   dtype: torch.dtype = torch.float32):
    """Adapter pair for a ``(..., m, n)`` weight: ``a`` ``(..., m, r)``, a
    ``jax.random.normal`` draw of ``key`` (a ``core.prng`` key) over
    ``sqrt(m)`` in f32, and ``b`` ``(..., r, n)`` zeros, so the delta
    ``a @ b`` is exactly zero at init.  Leading axes (stacked layers,
    experts) carry through.  On the ``meta`` device it draws nothing."""
    m, n = shape[-2], shape[-1]
    lead = tuple(shape[:-2])
    b = torch.zeros(lead + (rank, n), dtype=dtype, device=device)
    if torch.device(device).type == "meta":
        return {"a": torch.empty(lead + (m, rank), dtype=dtype,
                                 device=device), "b": b}
    from repro_torch.core import prng
    a = prng.normal(key, lead + (m, rank), device)
    # an element-wise f32 division by sqrt(m) rounded to f32, as
    # jnp.asarray(np.sqrt(m), f32) divides (CUDA turns a division by a
    # host scalar into a product with its reciprocal)
    a = a / torch.full_like(a, math.sqrt(m))
    return {"a": a.to(dtype), "b": b}


def lora_delta(pair, alpha: float, rank: int) -> torch.Tensor:
    """The ``(..., m, n)`` update ``(a @ b) * (alpha / r)`` in the
    adapters' dtype, batched over the leading axes."""
    from repro_torch.core import prng
    return (pair["a"] @ pair["b"]) * prng.f32(alpha / rank)
