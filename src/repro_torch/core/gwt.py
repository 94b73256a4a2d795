"""GWT — Gradient Wavelet Transform optimizer, the paper's Algorithm 1
(counterpart of ``repro/core/gwt.py``).

Per eligible weight with transform-axis width divisible by ``2^l``::

    [A_t, D_t]  = G_t · H^l                      (multi-level DWT)
    M, V        = host moments on A_t            (memory: shapes of A_t)
    Ã_t         = host preconditioned A_t        (Adam: M / (√V + ε))
    D̃_k        = D_k · upsample(1/(√V+ε))       (hosts without one: D_k)
    G̃_t        = [Ã_t, D̃_t] · Hᵀ               (inverse DWT)
    G̃_t        = NormGrowthLimiter(G̃_t)         (γ = 1.01)
    W_{t+1}     = W_t − η_t · α · G̃_t

``host`` is ``adam`` (the paper's), ``adam_mini`` or ``muon``
(``optim/hosts.py``, with ``host_kwargs``); ``wavelet`` is ``haar`` (the
paper's) or ``db2``.  Ineligible leaves (embeddings, norms, 1-D) run the
host on the full tensor at the base lr (Adam under a MUON host).  State is
f32 moments, or blocked-int8 with ``state_codec="int8"``.

Dataflows.  Same-shaped eligible leaves form one ``(L, m, n)`` bucket.
With the Adam host and the Haar wavelet (``use_fused``):

* ``fused_write=True`` (default): each bucket is one
  ``kernels.gwt_adam.ops.fused_write_update`` call (K1), or under int8 one
  ``fused_write_update_q8`` call (K2) that dequantizes and requantizes the
  moments inside the launch;
* ``fused_write=False``, the staged path: no bucket call; each leaf's
  ``update`` runs ``ops.fused_update`` (K4: DWT, Adam, inverse, G̃ in the
  gradient's dtype), then the limiter, the step and the write as tensor
  ops.  Under int8 the engine decodes, runs that ``update`` and encodes,
  leaf by leaf.

Any other host or wavelet runs the op-by-op core (``_gwt_core``) in
``update``.  ``bucketed=False`` makes the engine run every leaf's
``update`` (the unrolled reference).  The plain-host leaves run the
engine's generic decode -> update -> encode under int8.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import haar, limiter
from repro_torch.kernels.gwt_adam import ops as gwt_ops
from repro_torch.optim import codec as codec_lib, engine, hosts as hosts_lib
from repro_torch.optim.base import Optimizer, default_eligible
from repro_torch.optim.schedules import Schedule, constant


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
        host: str = "adam",
        host_kwargs: Optional[dict] = None,
        gamma: float = limiter.DEFAULT_GAMMA,
        use_limiter: bool = True,
        eligible: Optional[Callable[[str, torch.Tensor], bool]] = None,
        weight_decay: float = 0.0,
        wavelet: str = "haar",
        fused_write: bool = True,
        bucketed: bool = True,
        state_codec="f32") -> Optimizer:
    """Build the GWT optimizer.  ``host`` in {'adam', 'adam_mini', 'muon'}
    with ``host_kwargs`` for its constructor; ``wavelet`` in {'haar',
    'db2'}; ``fused_write=False`` keeps the staged dataflow (G̃
    materialized, the limiter, step and write outside the kernel), a
    baseline and not a production knob; ``bucketed=False`` the unrolled
    per-leaf engine; ``state_codec`` ('f32' | 'int8') stores the host
    moments raw or blocked-int8."""
    if wavelet not in ("haar", "db2"):
        raise ValueError(f"unknown wavelet {wavelet!r}")
    if isinstance(lr, (int, float)):
        lr = constant(lr)
    cdc = codec_lib.get_codec(state_codec)
    quant = not cdc.passthrough
    fwd = haar.haar_forward if wavelet == "haar" else haar.db2_forward
    inv = haar.haar_inverse if wavelet == "haar" else haar.db2_inverse
    host_kwargs = dict(host_kwargs or {})
    h = hosts_lib.make_host(host, **host_kwargs)
    # ineligible leaves run Adam under a MUON host (MUON for 2-D, Adam for
    # the rest), the host itself otherwise
    plain = hosts_lib.adam() if host == "muon" else h
    elig = eligible or default_eligible
    use_fused = host == "adam" and wavelet == "haar"
    # the kernels take the Adam coefficients explicitly: the host's
    adam_kw = {k: host_kwargs.get(k, d)
               for k, d in (("b1", 0.9), ("b2", 0.999), ("eps", 1e-6))}

    def _gwt_core(g, hstate, step):
        a, details = fwd(g, level)
        precond_a, dscale, lr_mult, hstate = h.update(a, hstate, step)
        if dscale is None:
            tilde_d = list(details)
        else:
            tilde_d = [d * haar.detail_scale_upsample(dscale, level,
                                                      level - i)
                       for i, d in enumerate(details)]
        return inv(precond_a, tilde_d), lr_mult, hstate

    def _apply(p, delta, lr_t, lr_mult, eff_alpha):
        step_size = (lr_t * lr_mult * eff_alpha).float()
        new_p = p.float() - step_size * delta.float()
        if weight_decay:
            new_p = new_p - lr_t * weight_decay * p.float()
        return new_p.to(p.dtype)

    # -- plain rule: the host on the full tensor ----------------------------
    def plain_update(g, p, state, step):
        delta, _, lr_mult, hstate = plain.update(g, state["host"], step)
        return _apply(p, delta, lr(step), lr_mult, 1.0), {"host": hstate}

    plain_rule = engine.LeafRule(
        kind=_Mode.PLAIN,
        init=lambda p: {"host": plain.init(p.shape, p.device)},
        update=plain_update, slots={"host": plain.slots})

    # -- GWT rules: DWT along axis -1 (LAST) or -2 (FIRST) ------------------
    def make_gwt_rule(mode: str) -> engine.LeafRule:
        swap = mode == _Mode.FIRST

        def init(p):
            g_shape = tuple(p.shape) if not swap \
                else tuple(p.shape[:-2]) + (p.shape[-1], p.shape[-2])
            a_shape = g_shape[:-1] + (g_shape[-1] >> level,)
            return {"host": h.init(a_shape, p.device),
                    "prev_norm": torch.zeros((), dtype=torch.float32,
                                             device=p.device)}

        def core(g, hstate, step):
            gt = g.transpose(-1, -2) if swap else g
            if use_fused:
                g_tilde, lr_mult, hstate = gwt_ops.fused_update(
                    gt, hstate, step, level=level, **adam_kw)
            else:
                g_tilde, lr_mult, hstate = _gwt_core(gt, hstate, step)
            if swap:
                g_tilde = g_tilde.transpose(-1, -2)
            return g_tilde, lr_mult, hstate

        def update(g, p, state, step):
            # the staged per-leaf path: the core, then the limiter and the
            # apply as tensor ops
            g_tilde, lr_mult, hstate = core(g, state["host"], step)
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
                gamma=gamma, use_limiter=use_limiter, level=level, **adam_kw)
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
                block=cdc.block, **adam_kw)
            if swap:
                new_p = new_p.transpose(-1, -2)
            return new_p, {"host": hstate, "prev_norm": new_norm}

        vu = None
        if use_fused and fused_write:
            vu = vector_update_q8 if quant else vector_update
        return engine.LeafRule(
            kind=mode, init=init, update=update, vector_update=vu,
            slots={"host": h.slots, "prev_norm": False},
            codec_native=vu is not None and quant)

    rules = {_Mode.PLAIN: plain_rule, _Mode.LAST: make_gwt_rule(_Mode.LAST),
             _Mode.FIRST: make_gwt_rule(_Mode.FIRST)}
    return engine.build(
        lambda path, leaf: rules[_leaf_mode(path, leaf, level, elig)],
        bucketed=bucketed, codec=cdc)
