"""GWT — Gradient Wavelet Transform optimizer, the paper's Algorithm 1
(counterpart of ``repro/core/gwt.py``: Haar wavelet, Adam host, f32 or
blocked-int8 state, fused write).

Per eligible weight with transform-axis width divisible by ``2^l``::

    [A_t, D_t]  = G_t · H^l                      (multi-level DHT)
    M, V        = Adam moments on A_t            (memory: shapes of A_t)
    Ã_t         = M / (√V + ε)
    D̃_k        = D_k · upsample(1/(√V+ε))
    G̃_t        = [Ã_t, D̃_t] · Hᵀ               (inverse DHT)
    G̃_t        = NormGrowthLimiter(G̃_t)         (γ = 1.01)
    W_{t+1}     = W_t − η_t · α · G̃_t

Ineligible leaves (embeddings, norms, 1-D) run plain Adam at the base lr.
Same-shaped eligible leaves form one ``(L, m, n)`` bucket, and each bucket
is one ``kernels.gwt_adam.ops.fused_write_update`` call, or with
``state_codec="int8"`` one ``fused_write_update_q8`` call, which dequantizes
and requantizes the moments inside the launch.  The plain-Adam leaves run
the engine's generic decode -> update -> encode under int8.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import haar, limiter
from repro_torch.kernels.gwt_adam import ops as gwt_ops
from repro_torch.optim import codec as codec_lib, engine, hosts as hosts_lib
from repro_torch.optim.base import Optimizer, default_eligible
from repro_torch.optim.schedules import Schedule, constant

B1, B2, EPS = 0.9, 0.999, 1e-6


class _Mode:
    PLAIN = "plain"       # ineligible: plain Adam on the full tensor
    LAST = "gwt_last"     # DHT along axis -1
    FIRST = "gwt_first"   # DHT along axis -2 (transposed)


def _leaf_mode(path: str, leaf: torch.Tensor, level: int,
               eligible: Callable[[str, torch.Tensor], bool]) -> str:
    block = 1 << level
    if level == 0 or not eligible(path, leaf):
        return _Mode.PLAIN
    if leaf.ndim >= 2 and leaf.shape[-1] % block == 0:
        return _Mode.LAST
    if leaf.ndim >= 2 and leaf.shape[-2] % block == 0:
        return _Mode.FIRST
    return _Mode.PLAIN


def gwt(lr: Schedule | float,
        level: int = 2,
        alpha: float = 0.25,
        gamma: float = limiter.DEFAULT_GAMMA,
        use_limiter: bool = True,
        eligible: Optional[Callable[[str, torch.Tensor], bool]] = None,
        weight_decay: float = 0.0,
        state_codec="f32") -> Optimizer:
    """Build the GWT optimizer (Haar wavelet, Adam host).  ``state_codec``
    ('f32' | 'int8') stores the Adam moments raw or blocked-int8."""
    if isinstance(lr, (int, float)):
        lr = constant(lr)
    cdc = codec_lib.get_codec(state_codec)
    h = hosts_lib.adam(B1, B2, EPS)
    elig = eligible or default_eligible

    def _apply(p, delta, lr_t, lr_mult, eff_alpha):
        step_size = (lr_t * lr_mult * eff_alpha).float()
        new_p = p.float() - step_size * delta.float()
        if weight_decay:
            new_p = new_p - lr_t * weight_decay * p.float()
        return new_p.to(p.dtype)

    # -- plain rule: Adam on the full tensor --------------------------------
    def plain_update(g, p, state, step):
        delta, _, lr_mult, hstate = h.update(g, state["host"], step)
        return _apply(p, delta, lr(step), lr_mult, 1.0), {"host": hstate}

    plain_rule = engine.LeafRule(
        kind=_Mode.PLAIN,
        init=lambda p: {"host": h.init(p.shape, p.device)},
        update=plain_update, slots={"host": h.slots})

    # -- GWT rules: DHT along axis -1 (LAST) or -2 (FIRST) ------------------
    def make_gwt_rule(mode: str) -> engine.LeafRule:
        swap = mode == _Mode.FIRST

        def init(p):
            g_shape = tuple(p.shape) if not swap \
                else tuple(p.shape[:-2]) + (p.shape[-1], p.shape[-2])
            a_shape = g_shape[:-1] + (g_shape[-1] >> level,)
            return {"host": h.init(a_shape, p.device),
                    "prev_norm": torch.zeros((), dtype=torch.float32,
                                             device=p.device)}

        def update(g, p, state, step):
            # the staged per-leaf path: DWT, host, inverse, then limiter and
            # apply outside any kernel
            gt = g.transpose(-1, -2) if swap else g
            a, details = haar.haar_forward(gt, level)
            precond, dscale, lr_mult, hstate = h.update(a, state["host"],
                                                        step)
            tilde_d = [d * haar.detail_scale_upsample(dscale, level,
                                                      level - i)
                       for i, d in enumerate(details)]
            g_tilde = haar.haar_inverse(precond, tilde_d)
            if swap:
                g_tilde = g_tilde.transpose(-1, -2)
            out = {"host": hstate, "prev_norm": state["prev_norm"]}
            if use_limiter:
                g_tilde, out["prev_norm"] = limiter.limit(
                    g_tilde, state["prev_norm"], gamma)
            return _apply(p, g_tilde, lr(step), lr_mult, alpha), out

        def vector_update(g_stk, p_stk, state, step):
            # one fused-write call for the whole (L, m, n) bucket; FIRST-mode
            # leaves go in as contiguous transposed copies
            gt = g_stk.transpose(-1, -2).contiguous() if swap else g_stk
            pt = p_stk.transpose(-1, -2).contiguous() if swap else p_stk
            new_p, new_norm, hstate = gwt_ops.fused_write_update(
                gt, pt, state["host"], step, state["prev_norm"],
                lr_t=lr(step), alpha=alpha, weight_decay=weight_decay,
                gamma=gamma, use_limiter=use_limiter, level=level,
                b1=B1, b2=B2, eps=EPS)
            if swap:
                new_p = new_p.transpose(-1, -2)
            return new_p, {"host": hstate, "prev_norm": new_norm}

        def vector_update_q8(g_stk, p_stk, state, step, salts):
            # codec-native: the launch dequantizes the blocked moments,
            # updates, requantizes with the (m=0, v=1) slot salts of
            # codec.map_slots and writes the parameters
            gt = g_stk.transpose(-1, -2).contiguous() if swap else g_stk
            pt = p_stk.transpose(-1, -2).contiguous() if swap else p_stk
            new_p, new_norm, hstate = gwt_ops.fused_write_update_q8(
                gt, pt, state["host"], step, salts, state["prev_norm"],
                lr_t=lr(step), alpha=alpha, weight_decay=weight_decay,
                gamma=gamma, use_limiter=use_limiter, level=level,
                block=cdc.block, b1=B1, b2=B2, eps=EPS)
            if swap:
                new_p = new_p.transpose(-1, -2)
            return new_p, {"host": hstate, "prev_norm": new_norm}

        quant = not cdc.passthrough
        return engine.LeafRule(
            kind=mode, init=init, update=update,
            vector_update=vector_update_q8 if quant else vector_update,
            slots={"host": h.slots, "prev_norm": False},
            codec_native=quant)

    rules = {_Mode.PLAIN: plain_rule, _Mode.LAST: make_gwt_rule(_Mode.LAST),
             _Mode.FIRST: make_gwt_rule(_Mode.FIRST)}
    return engine.build(
        lambda path, leaf: rules[_leaf_mode(path, leaf, level, elig)],
        codec=cdc)
