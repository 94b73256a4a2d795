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
host on the full tensor at the base lr (Adam under a MUON host).  The
moments are kept in ``state_dtype`` (f32, or bf16 for half the bytes; the
math stays f32), or blocked-int8 with ``state_codec="int8"``.

Dataflows.  Same-shaped eligible leaves form one ``(L, m, n)`` bucket.
With the Adam host and the Haar wavelet (``use_fused``):

* ``fused_write=True`` (default): each bucket is one
  ``kernels.gwt_adam.ops.fused_write_update`` call (K1, f32 or bf16
  moments), or under int8 one
  ``fused_write_update_q8`` call (K2) that dequantizes and requantizes the
  moments inside the launch; the LAST and FIRST rules share an
  ``engine.Group``, through which the buckets the card holds together
  (``ops.fused_write_groups``) go in one ``fused_write_update_group`` (int8:
  ``fused_write_update_q8_group``) call, one launch;
* ``fused_write=False``, the staged path: no bucket call; each leaf's
  ``update`` runs ``ops.fused_update`` (K4: DWT, Adam, inverse, G̃ in the
  gradient's dtype, f32 or bf16 moments), then the limiter, the step and
  the write as tensor ops.  Under int8 the engine decodes, runs that
  ``update`` and encodes, leaf by leaf.

Taps (``Optimizer.tapped_update``, DESIGN.md §12): each GWT bucket adds
``band_a_ssq`` and ``band_d_ssq`` (the gradient's energy in ``A_l`` and in
the details) and, with the limiter, ``gnorm_ssq`` (Σ of the limited ‖G̃‖²
over the leaves), ``clip_count`` and ``clip_rate``.

Any other host or wavelet runs the op-by-op core (``_gwt_core``) in
``update``.  ``bucketed=False`` makes the engine run every leaf's
``update`` (the unrolled reference).  The plain-host leaves run the
engine's generic decode -> update -> encode under int8 (the host rounds
the new moments to ``state_dtype`` before the encode, as the JAX package's
does).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from repro_torch.core import haar, limiter
from repro_torch.kernels.gwt_adam import ops as gwt_ops
from repro_torch.optim import codec as codec_lib, engine, hosts as hosts_lib
from repro_torch.optim.base import (Optimizer, default_eligible,
                                    flatten_with_paths)
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
        state_dtype: torch.dtype = torch.float32,
        wavelet: str = "haar",
        fused_write: bool = True,
        bucketed: bool = True,
        state_codec="f32",
        state_shardings=None) -> Optimizer:
    """Build the GWT optimizer.  ``host`` in {'adam', 'adam_mini', 'muon'}
    with ``host_kwargs`` for its constructor; ``wavelet`` in {'haar',
    'db2'}; ``fused_write=False`` keeps the staged dataflow (G̃
    materialized, the limiter, step and write outside the kernel), a
    baseline and not a production knob; ``bucketed=False`` the unrolled
    per-leaf engine; ``state_dtype`` (f32 | bf16) is the dtype of the host
    moments, which ``state_codec`` ('f32' | 'int8') stores raw or
    blocked-int8.  ``state_shardings`` (``distributed.sharding.
    gwt_state_shardings(...)["buckets"]``) keeps each bucket's state placed
    (``optim.engine.build``)."""
    if wavelet not in ("haar", "db2"):
        raise ValueError(f"unknown wavelet {wavelet!r}")
    if isinstance(lr, (int, float)):
        lr = constant(lr)
    cdc = codec_lib.get_codec(state_codec)
    quant = not cdc.passthrough
    fwd = haar.haar_forward if wavelet == "haar" else haar.db2_forward
    inv = haar.haar_inverse if wavelet == "haar" else haar.db2_inverse
    host_kwargs = dict(host_kwargs or {})
    host_kwargs.setdefault("state_dtype", state_dtype)
    h = hosts_lib.make_host(host, **host_kwargs)
    # ineligible leaves run Adam under a MUON host (MUON for 2-D, Adam for
    # the rest), the host itself otherwise
    plain = hosts_lib.adam(state_dtype=state_dtype) if host == "muon" else h
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
        # p - step * delta (- lr * wd * p), each term rounded as the
        # reference rounds it, the differences taken in place on a copy
        step_size = (lr_t * lr_mult * eff_alpha).float()
        new_p = p.to(torch.float32, copy=True)
        new_p.sub_(step_size * delta.float())
        if weight_decay:
            new_p.sub_(lr_t * weight_decay * p.float())
        return new_p.to(p.dtype)

    # -- plain rule: the host on the full tensor ----------------------------
    def plain_update(g, p, state, step, leaf_id):
        delta, dscale, lr_mult, hstate = plain.update(g, state["host"], step)
        del dscale   # GWT's detail scale: the plain rule has no details
        return _apply(p, delta, lr(step), lr_mult, 1.0), {"host": hstate}

    plain_rule = engine.LeafRule(
        kind=_Mode.PLAIN,
        init=lambda p: {"host": plain.init(p.shape, p.device)},
        update=plain_update, slots={"host": plain.slots})

    # -- GWT rules: DWT along axis -1 (LAST) or -2 (FIRST) ------------------
    def write_call(swap, g_stk, p_stk, state, step, salts=None, lr_t=None):
        # one bucket's fused-write call (K1; with salts K2): FIRST-mode
        # leaves go in as contiguous transposed copies.  A LoRA adapter of a
        # bf16 model is f32 under a bf16 gradient (the step casts it to the
        # model dtype, as the JAX package's does): the kernel rounds G~ and
        # the limited step to bf16, as the reference's.  Under int8 the
        # launch dequantizes the blocked moments, updates, requantizes with
        # the (m=0, v=1) slot salts of codec.map_slots and writes the
        # parameters
        gt = g_stk.transpose(-1, -2).contiguous() if swap else g_stk
        pt = p_stk.transpose(-1, -2).contiguous() if swap else p_stk
        kw = dict(lr_t=lr(step) if lr_t is None else lr_t, alpha=alpha,
                  weight_decay=weight_decay, gamma=gamma,
                  use_limiter=use_limiter, level=level, **adam_kw)
        if salts is None:
            return (gt, pt, state["host"], step, state["prev_norm"]), kw
        return (gt, pt, state["host"], step, salts, state["prev_norm"]), \
            dict(kw, block=cdc.block)

    def write_result(swap, out):
        new_p, new_norm, hstate = out
        if swap:
            new_p = new_p.transpose(-1, -2)
        return new_p, {"host": hstate, "prev_norm": new_norm}

    def group_launches(members, device):
        # the buckets' fused-write calls as the kernel takes them: a
        # FIRST-mode stack transposed, rows merged
        buckets = []
        for kind, shape, g_dtype, p_dtype, st in members:
            if kind == _Mode.FIRST:
                shape = shape[:-2] + (shape[-1], shape[-2])
            buckets.append(((shape[0], math.prod(shape[1:-1]), shape[-1]),
                            g_dtype, p_dtype,
                            None if quant else st["host"]["m"].dtype))
        return gwt_ops.fused_write_groups(buckets, q8=quant, level=level,
                                          device=device)

    def group_update(members, step):
        lr_t = lr(step)
        swaps = [kind == _Mode.FIRST for kind, *_ in members]
        calls = [write_call(swap, g_stk, p_stk, st, step, *salts, lr_t=lr_t)
                 for swap, (_, g_stk, p_stk, st, *salts) in zip(swaps,
                                                                members)]
        fn = gwt_ops.fused_write_update_q8_group if quant \
            else gwt_ops.fused_write_update_group
        return [write_result(swap, out) for swap, out in zip(swaps,
                                                             fn(calls))]

    group = engine.Group(launches=group_launches, update=group_update) \
        if use_fused and fused_write else None

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

        def update(g, p, state, step, leaf_id):
            # the staged per-leaf path: the core, then the limiter and the
            # apply as tensor ops
            g_tilde, lr_mult, hstate = core(g, state["host"], step)
            out = {"host": hstate, "prev_norm": state["prev_norm"]}
            if use_limiter:
                g_tilde, out["prev_norm"] = limiter.limit(
                    g_tilde, state["prev_norm"], gamma)
            return _apply(p, g_tilde, lr(step), lr_mult, alpha), out

        def vector_update(g_stk, p_stk, state, step):
            # one fused-write call for the whole (L, m, n) bucket
            args, kw = write_call(swap, g_stk, p_stk, state, step)
            return write_result(swap, gwt_ops.fused_write_update(*args,
                                                                 **kw))

        def vector_update_q8(g_stk, p_stk, state, step, salts):
            # codec-native: K2 on the encoded bucket
            args, kw = write_call(swap, g_stk, p_stk, state, step, salts)
            return write_result(swap, gwt_ops.fused_write_update_q8(*args,
                                                                    **kw))

        def taps(gs, old_st, new_st):
            # the band energies of the transformed gradient (a FIRST-mode
            # leaf's transpose): A_l's from the averaging chain alone, the
            # details' as Parseval's remainder Σ g² - Σ A_l² (the DWT is
            # orthonormal), over row blocks (the transform is per row);
            # the limiter's from the norms the update threads
            sums, bands = [], []
            for g in gs:
                for (blk,) in engine.row_blocks(g.transpose(-1, -2) if swap
                                                else g):
                    b = blk.to(torch.float32,
                               memory_format=torch.contiguous_format)
                    bands.append(engine.block_ssq(
                        haar.haar_approx(b, level) if wavelet == "haar"
                        else fwd(b, level)[0]))
                    sums.append(engine.block_ssq(blk))
            band_a = engine.sum_in_order(bands)
            out = {"band_a_ssq": band_a,
                   "band_d_ssq": engine.sum_in_order(sums) - band_a}
            if use_limiter:
                new_pn = new_st["prev_norm"]
                clipped = limiter.clip_flags(old_st["prev_norm"], new_pn,
                                             gamma)
                out["gnorm_ssq"] = torch.sum(new_pn * new_pn)
                out["clip_count"] = torch.sum(clipped.float())
                out["clip_rate"] = out["clip_count"] / float(len(gs))
            return out

        vu = None
        if use_fused and fused_write:
            vu = vector_update_q8 if quant else vector_update
        return engine.LeafRule(
            kind=mode, init=init, update=update, vector_update=vu,
            slots={"host": h.slots, "prev_norm": False},
            codec_native=vu is not None and quant, taps=taps, group=group)

    rules = {_Mode.PLAIN: plain_rule, _Mode.LAST: make_gwt_rule(_Mode.LAST),
             _Mode.FIRST: make_gwt_rule(_Mode.FIRST)}
    return engine.build(
        lambda path, leaf: rules[_leaf_mode(path, leaf, level, elig)],
        bucketed=bucketed, codec=cdc, state_shardings=state_shardings)


# ---------------------------------------------------------------------------
# Memory accounting (the paper's Table I / Table XI): optimizer-state bytes
# ---------------------------------------------------------------------------

def _host_elements(shape, host: str) -> int:
    """State elements a host keeps for one tensor of ``shape``: Adam 2x
    (M and V), MUON 1x (M), Adam-mini a full M and one V per row."""
    size = 1
    for s in shape:
        size *= s
    if host == "muon":
        return size
    if host == "adam_mini":
        rows = size // shape[-1] if len(shape) >= 2 else 1
        return size + rows
    return 2 * size


def state_memory_bytes(params, level: int,
                       eligible: Optional[Callable[[str, torch.Tensor],
                                                   bool]] = None,
                       bytes_per_el: int = 2, host: str = "adam"
                       ) -> Dict[str, int]:
    """Analytic optimizer-state memory of GWT over a parameter tree (real or
    ``meta`` tensors): a GWT leaf keeps host states on its ``A_l`` band
    (``size / 2^l`` elements), a plain leaf on the whole tensor; Adam 2x,
    MUON 1x (its plain leaves run Adam), Adam-mini 1x plus one per row.
    ``bytes_per_el`` prices an element (2: bf16 states, the paper's
    accounting).  The exact bytes of a built state are
    ``optim.engine.state_bytes(opt.init(params))``."""
    elig = eligible or default_eligible
    acc = {"gwt_bytes": 0, "plain_bytes": 0, "gwt_params": 0,
           "plain_params": 0}
    plain_host = "adam" if host == "muon" else host
    paths, leaves = flatten_with_paths(params)
    for path, p in zip(paths, leaves):
        mode = _leaf_mode(path, p, level, elig)
        if mode == _Mode.PLAIN:
            acc["plain_bytes"] += _host_elements(tuple(p.shape),
                                                 plain_host) * bytes_per_el
            acc["plain_params"] += p.numel()
        else:
            width = (p.shape[-1] if mode == _Mode.LAST
                     else p.shape[-2]) >> level
            a_shape = (p.numel() // (width << level), width)
            acc["gwt_bytes"] += _host_elements(a_shape, host) * bytes_per_el
            acc["gwt_params"] += p.numel()
    acc["total_bytes"] = acc["gwt_bytes"] + acc["plain_bytes"]
    return acc
