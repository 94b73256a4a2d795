"""xLSTM blocks (counterpart of ``repro/models/xlstm.py``): mLSTM
(matrix memory) and sLSTM (scalar memory, exponential gating).

mLSTM trains and prefills in the stabilised chunkwise form
(:func:`mlstm_chunkwise`: the quadratic form inside a chunk, the matrix
memory ``(C, n, m)`` carried from chunk to chunk) and decodes with the
recurrent matrix-memory update.  sLSTM is a loop over time
(:func:`slstm_step` each position), as the reference's ``lax.scan``.
Decode writes each block's cache in place.

Along the ``model`` mesh axis (train mode, ``tp=``; the rule table sends
``inner`` to ``model``):

* mLSTM: ``up_proj`` column-parallel by halves (``[xm_r | z_r]``), the
  conv local; ``wq``/``wk``/``wv`` and the gate weights row-parallel (their
  ``inner`` rows take ``model``, so ``heads`` finds it used), their partial
  products summed in one all-reduce of ``[q|k|v|i|f]``; the chunkwise form
  on the rank's heads (its channel block: heads are contiguous columns),
  or on all heads where the axis does not divide them, keeping the rank's
  channels; ``out_norm`` over the split channels; ``down_proj``
  row-parallel.
* sLSTM: ``w``/``b`` by columns (a contiguous block is whole heads), the
  recurrent ``r`` (split by gates) gathered whole once a block and cut to
  the rank's heads, the time loop on those heads with no collective inside
  it, the hidden states gathered for ``out_norm``, the post-MLP column-
  then row-parallel.  Where the axis does not divide the heads, ``w``,
  ``b`` and ``r`` are gathered whole and the recurrence runs replicated.

No kernel here: the reference writes none for these blocks (stock ops)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel
from repro_torch.models.layers import Builder, mlp_apply, rms_norm
from repro_torch.models.ssm import causal_conv


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(b: Builder, cfg, lead=()) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    di = 2 * d                       # xLSTM up-projection factor 2
    k = cfg.ssm_conv
    return {
        "up_proj": b.param((d, 2 * di), ("embed", "inner"), lead=lead,
                           blocks=2),
        "conv_w": b.param((k, di), (None, "inner"), scale=0.5, lead=lead),
        "conv_b": b.param((di,), ("inner",), init="zeros", lead=lead),
        "wq": b.param((di, di), ("inner", "heads"), lead=lead),
        "wk": b.param((di, di), ("inner", "heads"), lead=lead),
        "wv": b.param((di, di), ("inner", "heads"), lead=lead),
        "w_igate": b.param((di, H), ("inner", None), scale=0.01,
                           lead=lead),
        "b_igate": b.param((H,), (None,), init="zeros", lead=lead),
        "w_fgate": b.param((di, H), ("inner", None), scale=0.01,
                           lead=lead),
        "b_fgate": b.param((H,), (None,), init="ones", lead=lead),
        "out_norm": b.param((di,), ("inner",), init="zeros", lead=lead),
        "down_proj": b.param((di, d), ("inner", "embed"), lead=lead),
    }


def _causal(T, dev):
    t = torch.arange(T, device=dev)
    return t[:, None] >= t[None, :]


def mlstm_parallel(q, k, v, log_i, log_f):
    """The stabilised parallel (quadratic) mLSTM over the whole sequence.
    q, k, v (B,T,H,dh); gates (B,T,H).  The chunkwise form equals it."""
    B, T, H, dh = q.shape
    F_ = torch.cumsum(F.logsigmoid(log_f.float()), dim=1)        # (B,T,H)
    D = F_[:, :, None] - F_[:, None, :] + log_i.float()[:, None, :]
    D = torch.where(_causal(T, q.device)[None, :, :, None], D,
                    -torch.inf)                                   # (B,T,S,H)
    m = torch.clamp_min(D.amax(dim=2, keepdim=True), 0.0)        # (B,T,1,H)
    W = torch.exp(D - m)
    s = torch.einsum("bthd,bshd->btsh", q.float(), k.float()) / math.sqrt(dh)
    sw = s * W
    n = torch.maximum(sw.sum(2, keepdim=True).abs(), torch.exp(-m))
    h = torch.einsum("btsh,bshd->bthd", sw / n, v.float())
    return h.to(q.dtype)


_MLSTM_CHUNK = 1024


def mlstm_chunkwise(q, k, v, log_i, log_f, chunk: int = _MLSTM_CHUNK):
    """Chunkwise-parallel mLSTM, stabilised: within a chunk the quadratic
    form over a ``(chunk, chunk)`` decay tile, across chunks the matrix
    memory carried recurrently.  Exact; it bounds the decay matrix to
    ``(B, chunk, chunk, H)``.  ``T`` must be a multiple of ``chunk``.

    Returns ``(h (B,T,H,dh) in q's dtype, (C, n, m))``: the final state,
    ``C`` and ``n`` stabilised by ``m``."""
    B, T, H, dh = q.shape
    if T % chunk:
        raise ValueError(f"mlstm_chunkwise: T={T} is not a multiple of "
                         f"chunk={chunk}")
    dev = q.device
    lf_all = F.logsigmoid(log_f.float())
    C0 = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=dev)
    n0 = torch.zeros((B, H, dh), dtype=torch.float32, device=dev)
    m0 = torch.full((B, H), -1e30, dtype=torch.float32, device=dev)
    causal = _causal(chunk, dev)[None, :, :, None]
    scale = math.sqrt(dh)
    hs = []
    for c in range(T // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        qc, kc, vc = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        lic, lfc = log_i[:, sl].float(), lf_all[:, sl]
        ksc = kc / scale                       # decode-path convention
        F_ = torch.cumsum(lfc, dim=1)          # (B,c,H)
        # intra-chunk decay D[t,s] = F_t - F_s + i_s (s <= t)
        D = F_[:, :, None] - F_[:, None, :] + lic[:, None, :]
        D = torch.where(causal, D, -torch.inf)
        inter_log = F_ + m0[:, None]           # weight of C0 at position t
        m = torch.clamp_min(torch.maximum(D.amax(dim=2), inter_log), 0.0)
        W = torch.exp(D - m[:, :, None])                          # (B,c,c,H)
        s = torch.einsum("bthd,bshd->btsh", qc, ksc)
        sw = s * W
        inter_w = torch.exp(inter_log - m)                        # (B,c,H)
        num = torch.einsum("btsh,bshd->bthd", sw, vc) \
            + inter_w[..., None] * torch.einsum("bthd,bhde->bthe", qc, C0)
        den = (sw.sum(2) + inter_w
               * torch.einsum("bthd,bhd->bth", qc, n0)).abs()
        den = torch.maximum(den, torch.exp(-m))
        hs.append(num / den[..., None])
        # end-of-chunk state under the new stabiliser m_end
        Ftot = F_[:, -1]                                          # (B,H)
        decay_s = Ftot[:, None] - F_ + lic                        # (B,c,H)
        m_end = torch.maximum(Ftot + m0, decay_s.amax(dim=1))
        wgt = torch.exp(decay_s - m_end[:, None])                 # (B,c,H)
        carry = torch.exp(Ftot + m0 - m_end)
        C0 = carry[..., None, None] * C0 \
            + torch.einsum("bsh,bshd,bshe->bhde", wgt, ksc, vc)
        n0 = carry[..., None] * n0 + torch.einsum("bsh,bshd->bhd", wgt, ksc)
        m0 = m_end
    h = hs[0] if len(hs) == 1 else torch.cat(hs, dim=1)
    return h.to(q.dtype), (C0, n0, m0)


def mlstm_apply(p, cfg, x: torch.Tensor, *, mode: str = "train",
                cache: Optional[dict] = None, tp=None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """``(output, new_cache)``; ``"decode"`` (T = 1) updates ``cache``
    ``{"C", "n", "m", "conv"}`` in place, ``"prefill"`` returns it.

    ``tp`` (a ``distributed.tensor_parallel.TP``, train mode): ``p`` holds
    this rank's shards of ``sharding.tp_rules`` (see the module's
    docstring), and ``down_proj``'s partial outputs are summed over the
    model group."""
    tensor_parallel.train_only(tp, mode, "mLSTM")
    B, T, d = x.shape
    H = cfg.n_heads
    di = 2 * d
    dh = di // H
    tp = tensor_parallel.split(tp, di)
    if tp is not None:
        x = tp.copy_in(x)
    xz = x @ p["up_proj"]
    xm, z = xz.chunk(2, dim=-1)

    new_cache = None
    if mode == "decode":
        if cache is None or T != 1:
            raise ValueError("mLSTM decode takes one token and a cache")
        conv_win = torch.cat([cache["conv"], xm], dim=1)
        xc = F.silu(causal_conv(xm, p["conv_w"], p["conv_b"],
                                prev=cache["conv"]))
        q = (xc @ p["wq"]).reshape(B, H, dh)
        k = (xc @ p["wk"]).reshape(B, H, dh) / math.sqrt(dh)
        v = (xc @ p["wv"]).reshape(B, H, dh)
        log_i = (xc[:, 0] @ p["w_igate"] + p["b_igate"]).float()
        log_f = F.logsigmoid(
            (xc[:, 0] @ p["w_fgate"] + p["b_fgate"]).float())
        m_new = torch.maximum(log_f + cache["m"], log_i)          # (B,H)
        i_s = torch.exp(log_i - m_new)
        f_s = torch.exp(log_f + cache["m"] - m_new)
        C = f_s[..., None, None] * cache["C"] + i_s[..., None, None] \
            * torch.einsum("bhd,bhe->bhde", k.float(), v.float())
        nvec = f_s[..., None] * cache["n"] + i_s[..., None] * k.float()
        num = torch.einsum("bhde,bhd->bhe", C, q.float())
        den = torch.maximum(
            torch.einsum("bhd,bhd->bh", nvec, q.float()).abs(),
            torch.exp(-m_new))
        h = (num / den[..., None]).reshape(B, 1, di).to(x.dtype)
        for name, val in (("C", C), ("n", nvec), ("m", m_new),
                          ("conv", conv_win[:, 1:])):
            cache[name].copy_(val)
        new_cache = cache
    elif mode in ("train", "prefill"):
        xc = F.silu(causal_conv(xm, p["conv_w"], p["conv_b"]))
        ws = [p[w] for w in ("wq", "wk", "wv", "w_igate", "w_fgate")]
        b_i, b_f = p["b_igate"], p["b_fgate"]
        if tp is None:
            q, k, v, log_i, log_f = (xc @ w for w in ws)
        else:
            # the row-parallel products, summed in one all-reduce; the
            # replicated gate biases inside the region (their gradient is
            # summed over the group)
            q, k, v, log_i, log_f = torch.split(
                tp.reduce_split(torch.cat([xc @ w for w in ws], dim=-1)),
                [di, di, di, H, H], dim=-1)
            b_i, b_f = tp.copy_in(b_i), tp.copy_in(b_f)
        log_i, log_f = log_i + b_i, log_f + b_f
        hl = H
        if tp is not None and H % tp.size == 0:
            # the rank's heads are its channel block
            hl = H // tp.size
            h0 = tp.rank * hl
            q, k, v = (t[..., h0 * dh:(h0 + hl) * dh] for t in (q, k, v))
            log_i, log_f = log_i[..., h0:h0 + hl], log_f[..., h0:h0 + hl]
        # k raw; the forms scale inside
        q, k, v = (t.reshape(B, T, hl, dh) for t in (q, k, v))
        chunk = min(_MLSTM_CHUNK, T)
        if T % chunk:
            chunk = T
        h, (C, n, m) = mlstm_chunkwise(q, k, v, log_i, log_f, chunk=chunk)
        h = h.reshape(B, T, hl * dh)
        if tp is not None and hl == H:
            # every rank ran all heads: it keeps its channels
            dl = di // tp.size
            h = h[..., tp.rank * dl:(tp.rank + 1) * dl]
        if mode == "prefill":
            new_cache = {"C": C, "n": n, "m": m,
                         "conv": xm[:, -(cfg.ssm_conv - 1):].clone()}
    else:
        raise ValueError(f"mLSTM mode {mode!r}: the paged serving modes "
                         f"have no recurrent-state layout")

    h = rms_norm(h, p["out_norm"], cfg.norm_eps, tp) * F.silu(z)
    out = h @ p["down_proj"]
    return (out if tp is None else tp.reduce_out(out)), new_cache


def mlstm_cache(b: Builder, cfg, B: int, lead=()) -> dict:
    """A zeroed decode cache from ``b``: the f32 matrix memory ``C``, its
    normaliser ``n`` and stabiliser ``m``, and the conv window in the model
    dtype."""
    H = cfg.n_heads
    di = 2 * cfg.d_model
    dh = di // H

    def f32(shape, axes):
        return b.param(shape, axes, init="zeros", lead=lead,
                       dtype=torch.float32)

    return {"C": f32((B, H, dh, dh), ("batch", None, None, None)),
            "n": f32((B, H, dh), ("batch", None, None)),
            "m": f32((B, H), ("batch", None)),
            "conv": b.param((B, cfg.ssm_conv - 1, di),
                            ("batch", None, "inner"), init="zeros",
                            lead=lead)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_ff(d: int) -> int:
    """xLSTM sLSTM post-MLP (proj factor 4/3), rounded to the 128-lane
    unit."""
    return ((4 * d // 3) + 127) // 128 * 128


def slstm_init(b: Builder, cfg, lead=()) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    ff = slstm_ff(d)
    return {
        "w": b.param((d, 4 * d), ("embed", "inner"), lead=lead),
        "r": b.param((H, dh, 4 * dh), (None, None, "inner"), scale=0.1,
                     lead=lead),
        "b": b.param((4 * d,), ("inner",), init="zeros", lead=lead),
        "out_norm": b.param((d,), (None,), init="zeros", lead=lead),
        "up_gate": b.param((d, ff), ("embed", "mlp"), lead=lead),
        "up": b.param((d, ff), ("embed", "mlp"), lead=lead),
        "down": b.param((ff, d), ("mlp", "embed"), lead=lead),
    }


def slstm_step(p, cfg, xt, state):
    """One sLSTM step.  xt (B,d); state ``(c, n, h, m)``, each f32
    (B,H,dh); ``H`` and ``dh`` are ``p["r"]``'s (H, dh, 4·dh): a
    tensor-parallel rank passes its heads' ``w``, ``r`` and ``b``.  Returns
    ``(new state, h_new)``."""
    B = xt.shape[0]
    H, dh = p["r"].shape[0], p["r"].shape[1]
    c, n, h, m = state
    wx = (xt @ p["w"]).reshape(B, H, 4 * dh)
    rh = torch.einsum("bhd,hde->bhe", h, p["r"].to(h.dtype))
    g = (wx + rh + p["b"].reshape(H, 4 * dh)).float()
    gi, gf, gz, go = g.chunk(4, dim=-1)                           # (B,H,dh)
    m_new = torch.maximum(gf + m, gi)          # exp-gate stabiliser
    i_s = torch.exp(gi - m_new)
    f_s = torch.exp(gf + m - m_new)
    c = f_s * c + i_s * torch.tanh(gz)
    n = f_s * n + i_s
    h_new = torch.sigmoid(go) * c / torch.clamp_min(n, 1e-6)
    return (c, n, h_new.float(), m_new), h_new


def _slstm_tp_cell(p, cfg, x, tp):
    """The recurrence's weights for a rank of ``tp`` and its input:
    ``(cell, x, tp of the heads or None)``.  Where the axis divides the
    heads, its heads' ``w``/``b`` columns, ``r`` gathered whole and cut to
    them, and ``x`` into the region; else everything whole (replicated
    compute: every rank runs the same recurrence)."""
    H = cfg.n_heads
    tph = tensor_parallel.split(tp, H)
    if tph is None:
        return ({"w": tp.gather(p["w"], -1), "b": tp.gather(p["b"], -1),
                 "r": tp.gather(p["r"], -1)}, x, None)
    hl = H // tp.size
    r = tp.gather_reduce(p["r"], -1)[tp.rank * hl:(tp.rank + 1) * hl]
    return {"w": p["w"], "b": p["b"], "r": r}, tp.copy_in(x), tph


def slstm_apply(p, cfg, x: torch.Tensor, *, mode: str = "train",
                cache: Optional[dict] = None, tp=None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """``(output, new_cache)``: :func:`slstm_step` over each position in
    turn, from ``cache`` (``{"c", "n", "h", "m"}``) where given, else from
    zeros and a ``-1e30`` stabiliser; the serving modes return the final
    state (``"decode"``: written into ``cache`` in place).

    ``tp`` (a ``distributed.tensor_parallel.TP``, train mode): ``p`` holds
    this rank's shards of ``sharding.tp_rules``; the time loop runs the
    rank's heads with no collective inside it (see the module's
    docstring)."""
    tensor_parallel.train_only(tp, mode, "sLSTM")
    B, T, d = x.shape
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"sLSTM mode {mode!r}: the paged serving modes "
                         f"have no recurrent-state layout")
    cell, tph = p, None
    if tp is not None:
        cell, x, tph = _slstm_tp_cell(p, cfg, x, tp)
    H, dh = cell["r"].shape[0], cell["r"].shape[1]
    if cache is not None:
        state = (cache["c"], cache["n"], cache["h"], cache["m"])
    else:
        z = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
        state = (z, z, z, torch.full((B, H, dh), -1e30, dtype=torch.float32,
                                     device=x.device))
    hs = []
    for t in range(T):
        state, h = slstm_step(cell, cfg, x[:, t], state)
        hs.append(h)
    hs = torch.stack(hs, dim=1)                                   # (B,T,H,dh)
    hs = hs.reshape(B, T, H * dh).to(x.dtype)
    if tph is not None:
        hs = tph.gather(hs, -1)     # the whole hidden state, for out_norm

    y = rms_norm(hs, p["out_norm"], cfg.norm_eps)
    y = mlp_apply({"w_gate": p["up_gate"], "w_up": p["up"],
                   "w_down": p["down"]}, y,
                  tensor_parallel.split(tp, slstm_ff(d)))
    new_cache = None
    if mode == "decode" and cache is not None:
        for name, val in zip("cnhm", state):
            cache[name].copy_(val)
        new_cache = cache
    elif mode in ("decode", "prefill"):
        new_cache = dict(zip("cnhm", state))
    return y, new_cache


def slstm_cache(b: Builder, cfg, B: int, lead=()) -> dict:
    """A zeroed decode cache from ``b``: the f32 states ``c``, ``n``, ``h``
    and ``m``, ``(*lead, B, H, d_model / H)`` each."""
    H = cfg.n_heads
    return {n: b.param((B, H, cfg.d_model // H), ("batch", None, None),
                       init="zeros", lead=lead, dtype=torch.float32)
            for n in "cnhm"}
