"""Mamba selective-SSM block, Jamba's sequence mixer (counterpart of
``repro/models/ssm.py``).

Train and prefill run the diagonal recurrence ``h_t = a_t·h_{t-1} + b_t``
as a log-depth scan with the combine ``(a₁,b₁)∘(a₂,b₂) = (a₁a₂, a₂b₁+b₂)``
(:func:`associative_scan`: the odd/even recursion of
``jax.lax.associative_scan``, so the products form in the reference's
order), in chunks of ``_SCAN_CHUNK`` steps that carry the state across,
each chunk recomputed in the backward (``torch.utils.checkpoint``, as the
reference wraps it in ``jax.checkpoint``).  Decode carries ``{"h", "conv"}``
(the state and the last ``ssm_conv - 1`` inputs of the causal conv) and
writes it in place, one token a step.

Along the ``model`` mesh axis (train mode, ``tp=``) a rank holds and
computes its block of the ``d_inner`` channels: ``in_proj`` column-parallel
by halves (``[xm_r | z_r]``, ``Axes.blocks``), the conv, ``dt_bias``,
``a_log``, ``d_skip`` and the scan on its channels with no collective,
``x_proj`` row-parallel (its small ``(B, T, dt_rank + 2·state)`` partial
product all-reduced once), ``dt_proj`` column-parallel, ``out_proj``
row-parallel.

No kernel here: the reference writes none for this block (stock ops)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import tensor_parallel
from repro_torch.models.layers import Builder


def _dt_rank(d_model: int) -> int:
    return max(1, int(math.ceil(d_model / 16)))


def mamba_init(b: Builder, cfg, lead=()) -> dict:
    d, di, st, k = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    dtr = _dt_rank(d)
    return {
        "in_proj": b.param((d, 2 * di), ("embed", "inner"), lead=lead,
                           blocks=2),
        "conv_w": b.param((k, di), (None, "inner"), scale=0.5, lead=lead),
        "conv_b": b.param((di,), ("inner",), init="zeros", lead=lead),
        "x_proj": b.param((di, dtr + 2 * st), ("inner", None), lead=lead),
        "dt_proj": b.param((dtr, di), (None, "inner"), scale=0.1,
                           lead=lead),
        "dt_bias": b.param((di,), ("inner",), init="zeros", lead=lead),
        "a_log": b.param((di, st), ("inner", None), init="ones", lead=lead),
        "d_skip": b.param((di,), ("inner",), init="ones", lead=lead),
        "out_proj": b.param((di, d), ("inner", "embed"), lead=lead),
    }


def causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv over time: x (B,T,C), w (k,C); ``prev``
    (B,k-1,C) is the window decode carries (zeros where not given).  The
    k products are summed in tap order, in x's dtype."""
    k = w.shape[0]
    if prev is None:
        prev = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([prev, x], dim=1)
    T = x.shape[1]
    out = sum(xp[:, i:i + T] * w[i] for i in range(k))
    return out + bias


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): ``max(x, 0) +
    log1p(exp(-|x|))`` in x's dtype (torch's own softplus switches to
    ``x`` past a threshold)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _ssm_params(p, cfg, x, tp=None):
    """x (B,T,di) -> (dA (B,T,di,st), dBx (B,T,di,st), C (B,T,st)); dA
    and dBx in f32.  Under ``tp`` x and the per-channel leaves are this
    rank's channels, and ``x_proj``'s partial product is summed over the
    group."""
    st = cfg.ssm_state
    dtr = _dt_rank(cfg.d_model)
    proj = x @ p["x_proj"]
    if tp is not None:
        proj = tp.reduce_split(proj)
    dt_in, Bm, Cm = torch.split(proj, [dtr, st, st], dim=-1)
    dt = softplus(dt_in @ p["dt_proj"] + p["dt_bias"])          # (B,T,di)
    A = -torch.exp(p["a_log"].float())                           # (di,st)
    dA = torch.exp(dt.float()[..., None] * A)                    # (B,T,di,st)
    dBx = (dt * x).float()[..., None] * Bm.float()[:, :, None, :]
    return dA, dBx, Cm


def _combine(a1, b1, a2, b2):
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Along axis 1: even[0], odd[0], even[1], ...; ``even`` has as many
    entries as ``odd`` or one more."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2)
    out = pairs.reshape(even.shape[0], 2 * n, *even.shape[2:])
    if even.shape[1] > n:
        out = torch.cat([out, even[:, n:]], dim=1)
    return out


def associative_scan(a: torch.Tensor, b: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``(a, b)`` along axis 1 under :func:`_combine`,
    by ``jax.lax.associative_scan``'s recursion: combine adjacent pairs,
    scan those (the odd outputs), combine each with the next even input
    (the even outputs), interleave."""
    T = a.shape[1]
    if T < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = associative_scan(ra, rb)
    if T % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


_SCAN_CHUNK = 1024


def _chunk_step(p, cfg, h0, xc, tp=None):
    """One chunk: the carried state ``h0`` (B,di,st) folded into the first
    element (``b'_1 = dA_1 h0 + b_1``), the scan, the readout.  Returns
    ``(h_last, y)``."""
    dA, dBx, Cm = _ssm_params(p, cfg, xc, tp)
    dBx = torch.cat([(dBx[:, 0] + dA[:, 0] * h0)[:, None], dBx[:, 1:]],
                    dim=1)
    _, hs = associative_scan(dA, dBx)
    yc = torch.einsum("btds,bts->btd", hs, Cm.float())
    return hs[:, -1], yc


def selective_scan_chunked(p, cfg, xm_c: torch.Tensor, tp=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan of the conv output ``xm_c`` (B,T,di) in chunks
    of ``_SCAN_CHUNK`` (one chunk where that does not divide ``T``), the
    state carried from chunk to chunk; exact, since the recurrence is
    linear, and it bounds the f32 ``(B, chunk, di, st)`` buffers.  Each
    chunk is recomputed in the backward where gradients are taken (under
    ``tp`` with its one collective, in the same order on every rank).
    Returns ``(y (B,T,di) f32, h_last (B,di,st) f32)``."""
    B, T, di = xm_c.shape
    chunk = min(_SCAN_CHUNK, T)
    if T % chunk:
        chunk = T
    h = torch.zeros((B, di, cfg.ssm_state), dtype=torch.float32,
                    device=xm_c.device)
    ys = []
    for c in range(T // chunk):
        xc = xm_c[:, c * chunk:(c + 1) * chunk]
        if torch.is_grad_enabled():
            h, yc = checkpoint(_chunk_step, p, cfg, h, xc, tp,
                               use_reentrant=False)
        else:
            h, yc = _chunk_step(p, cfg, h, xc, tp)
        ys.append(yc)
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    return y, h


def mamba_apply(p, cfg, x: torch.Tensor, *, mode: str = "train",
                cache: Optional[dict] = None, tp=None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """``(output, new_cache)``.  ``"train"``: no cache; ``"prefill"``:
    the state after the prompt and its last ``ssm_conv - 1`` inputs;
    ``"decode"`` (T = 1): one step from ``cache``, written in place.

    ``tp`` (a ``distributed.tensor_parallel.TP``, train mode): ``p`` holds
    this rank's channels (``sharding.tp_rules``), and the row-parallel
    ``out_proj``'s partial outputs are summed over the model group."""
    tensor_parallel.train_only(tp, mode, "mamba")
    tp = tensor_parallel.split(tp, cfg.d_inner)
    B, T, _ = x.shape
    if tp is not None:
        x = tp.copy_in(x)
    xz = x @ p["in_proj"]
    xm, z = xz.chunk(2, dim=-1)

    new_cache = None
    if mode == "decode":
        if cache is None or T != 1:
            raise ValueError("mamba decode takes one token and a cache")
        conv_win = torch.cat([cache["conv"], xm], dim=1)          # (B,k,di)
        xm_c = F.silu(causal_conv(xm, p["conv_w"], p["conv_b"],
                                  prev=cache["conv"]))
        dA, dBx, Cm = _ssm_params(p, cfg, xm_c)
        h = dA[:, 0] * cache["h"] + dBx[:, 0]                      # (B,di,st)
        y = torch.einsum("bds,bs->bd", h, Cm[:, 0].float())[:, None]
        cache["h"].copy_(h)
        cache["conv"].copy_(conv_win[:, 1:])
        new_cache = cache
    elif mode in ("train", "prefill"):
        xm_c = F.silu(causal_conv(xm, p["conv_w"], p["conv_b"]))
        y, h_last = selective_scan_chunked(p, cfg, xm_c, tp)
        if mode == "prefill":
            new_cache = {"h": h_last.clone(),
                         "conv": xm[:, -(cfg.ssm_conv - 1):].clone()}
    else:
        raise ValueError(f"mamba mode {mode!r}: the paged serving modes "
                         f"have no recurrent-state layout")

    y = y + xm_c.float() * p["d_skip"].float()
    y = y.to(x.dtype) * F.silu(z)
    out = y @ p["out_proj"]
    return (out if tp is None else tp.reduce_out(out)), new_cache


def mamba_cache(b: Builder, cfg, B: int, lead=()) -> dict:
    """A zeroed decode cache from ``b`` (zeros, ``meta`` tensors or axes):
    ``h`` f32 ``(*lead, B, di, st)``, ``conv`` ``(*lead, B, ssm_conv - 1,
    di)`` in the builder's (the model's) dtype."""
    di, st, k = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {"h": b.param((B, di, st), ("batch", "inner", None),
                         init="zeros", lead=lead, dtype=torch.float32),
            "conv": b.param((B, k - 1, di), ("batch", None, "inner"),
                            init="zeros", lead=lead)}
