"""The decoder's loss and gradients in plain PyTorch, f32 with TF32 off:
the dense decoder (qwen2.5) and the MoE decoder (qwen3-moe), from the
configuration file's published keys.

Equations, as the program under test defines the family (its departures
from the published models are listed in each configuration file):
pre-norm blocks ``x + attn(rms(x))`` then ``x + ffn(rms(x))``, RMSNorm as
``x / sqrt(mean(x^2) + eps) * (1 + w)``, the embedding rows times
``sqrt(hidden_size)``, rotary embeddings on the two halves of each head,
grouped-query attention with a causal mask, optional QKV biases and a
per-head RMSNorm of q and k before the rotation, a SwiGLU MLP, a tied or
untied head, the mean token cross-entropy.  The MoE block routes each token
to its ``num_experts_per_tok`` most probable experts (softmax over the f32
router logits, gates renormalised to sum to 1), keeps a ``(token, k)`` pair
if fewer than ``C = ceil(T*K/E * capacity_factor)`` earlier pairs in
``(token, k)`` order went to its expert, and adds the Switch load-balance
loss ``E * sum_e f_e * P_e`` times the coefficient the program runs
(the file's ``as_run``, else ``router_aux_loss_coef``).

Parameters come in the benchmark's weight layout (``gpubench.weights``):
every layer's tensors stacked on a leading layer axis under
``layers/b0/...``.  The gradients are taken layer by layer: the forward
keeps only each layer's input, and the backward recomputes one layer at a
time, so the reference fits on the card beside nothing else.

``precision="fp8"`` is the control: both operands of every matrix product
(forward and backward) rounded to float8 e4m3 with one scale per tensor,
the rest unchanged.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


@dataclass(frozen=True)
class Spec:
    """The sizes the reference reads from a configuration file."""
    family: str
    n_layers: int
    d: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    tie: bool
    rope_theta: float
    eps: float
    qkv_bias: bool
    qk_norm: bool
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    capacity_factor: float = 1.25
    aux_coef: float = 0.0

    @staticmethod
    def from_config(c: dict) -> "Spec":
        heads = c["num_attention_heads"]
        moe = c.get("num_experts", 0) > 0
        return Spec(
            family="moe" if moe else "dense",
            n_layers=c["num_hidden_layers"], d=c["hidden_size"],
            n_heads=heads, n_kv=c["num_key_value_heads"],
            head_dim=c.get("head_dim", c["hidden_size"] // heads),
            d_ff=0 if moe else c["intermediate_size"],
            vocab=c["vocab_size"], tie=c["tie_word_embeddings"],
            rope_theta=float(c["rope_theta"]), eps=float(c["rms_norm_eps"]),
            qkv_bias=bool(c["qkv_bias"]), qk_norm=bool(c["qk_norm"]),
            n_experts=c.get("num_experts", 0),
            top_k=c.get("num_experts_per_tok", 0),
            d_expert=c.get("moe_intermediate_size", 0),
            capacity_factor=float(c.get("capacity_factor", 1.25)),
            aux_coef=float(c.get("as_run", c).get("router_aux_loss_coef",
                                                   0.0)) if moe else 0.0)


def layout(s: Spec) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """The weight layout the reference reads: path -> (shape, init),
    ``init`` "normal" or "zeros" (the published scheme: normal matrices,
    zero biases, norms of weight ``1 + 0``).  The router is f32 (its
    path ends in ``router``), everything else in the model dtype."""
    L, d, hd = s.n_layers, s.d, s.head_dim
    H, KV = s.n_heads * hd, s.n_kv * hd
    out = {"embed/embedding": ((s.vocab, d), "normal"),
           "final_norm": ((d,), "zeros")}
    if not s.tie:
        out["embed/lm_head"] = ((d, s.vocab), "normal")
    b = "layers/b0/"
    out.update({b + "norm1": ((L, d), "zeros"), b + "norm2": ((L, d), "zeros"),
                b + "mixer/wq": ((L, d, H), "normal"),
                b + "mixer/wk": ((L, d, KV), "normal"),
                b + "mixer/wv": ((L, d, KV), "normal"),
                b + "mixer/wo": ((L, H, d), "normal")})
    if s.qkv_bias:
        out.update({b + "mixer/bq": ((L, H), "zeros"),
                    b + "mixer/bk": ((L, KV), "zeros"),
                    b + "mixer/bv": ((L, KV), "zeros")})
    if s.qk_norm:
        out.update({b + "mixer/q_norm": ((L, hd), "zeros"),
                    b + "mixer/k_norm": ((L, hd), "zeros")})
    if s.family == "moe":
        E, f = s.n_experts, s.d_expert
        out.update({b + "ffn/router": ((L, d, E), "normal"),
                    b + "ffn/w_gate": ((L, E, d, f), "normal"),
                    b + "ffn/w_up": ((L, E, d, f), "normal"),
                    b + "ffn/w_down": ((L, E, f, d), "normal")})
    else:
        out.update({b + "ffn/w_gate": ((L, d, s.d_ff), "normal"),
                    b + "ffn/w_up": ((L, d, s.d_ff), "normal"),
                    b + "ffn/w_down": ((L, s.d_ff, d), "normal")})
    return dict(sorted(out.items()))


# -- matrix products --------------------------------------------------------

def _q8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under one per-tensor scale, back in f32."""
    s = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _q8(a), _q8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _q8(g)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return _Fp8Matmul.apply(a, b)
    return a @ b


# -- layers -----------------------------------------------------------------

def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope_tables(s: Spec, S: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    inv = 1.0 / (s.rope_theta ** (np.arange(0, s.head_dim, 2) / s.head_dim))
    ang = np.arange(S, dtype=np.float64)[:, None] * inv[None, :]
    return (torch.tensor(np.cos(ang), dtype=torch.float32, device=device),
            torch.tensor(np.sin(ang), dtype=torch.float32, device=device))


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (B, S, H, hd); cos/sin (S, hd/2)."""
    c, sn = cos[None, :, None, :], sin[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * sn, x2 * c + x1 * sn], dim=-1)


def attention(s: Spec, p: dict, h: torch.Tensor, cos, sin, prec: str):
    B, S, d = h.shape
    hd = s.head_dim
    h2 = h.reshape(B * S, d)
    q, k, v = mm(h2, p["wq"], prec), mm(h2, p["wk"], prec), \
        mm(h2, p["wv"], prec)
    if s.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.view(B, S, s.n_heads, hd)
    k = k.view(B, S, s.n_kv, hd)
    v = v.view(B, S, s.n_kv, hd)
    if s.qk_norm:
        q, k = rms(q, p["q_norm"], s.eps), rms(k, p["k_norm"], s.eps)
    q, k = rope(q, cos, sin), rope(k, cos, sin)
    rep = s.n_heads // s.n_kv
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))     # (B, H, S, hd)
    scores = mm(q, k.transpose(-1, -2), prec) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    w = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = mm(w, v, prec).transpose(1, 2).reshape(B * S, s.n_heads * hd)
    return mm(o, p["wo"], prec).view(B, S, d)


def mlp(p: dict, h: torch.Tensor, prec: str) -> torch.Tensor:
    return mm(F.silu(mm(h, p["w_gate"], prec)) * mm(h, p["w_up"], prec),
              p["w_down"], prec)


def route(s: Spec, probs: torch.Tensor):
    """Each token's top-k experts (ties to the lower index), each pair's
    place in its expert's queue in ``(token, k)`` order, and ``C``."""
    T, E = probs.shape
    K = s.top_k
    idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :K]
    C = max(1, math.ceil(T * K / E * s.capacity_factor))
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * K, device=probs.device) - starts[flat[order]]
    pos = torch.empty_like(flat)
    pos[order] = rank
    return idx, pos.view(T, K), C


def moe(s: Spec, p: dict, h: torch.Tensor, prec: str):
    """h (T, d) -> (out (T, d), aux)."""
    T, d = h.shape
    E, K = s.n_experts, s.top_k
    probs = torch.softmax(mm(h, p["router"], prec), dim=-1)
    idx, pos, C = route(s, probs.detach())
    gates = torch.gather(probs, 1, idx)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    kept = pos < C
    tok = torch.arange(T, device=h.device)[:, None].expand(T, K)[kept]
    e, slot = idx[kept], pos[kept]
    xe = h.new_zeros(E, C, d).index_put((e, slot), h[tok])
    he = F.silu(mm(xe, p["w_gate"], prec)) * mm(xe, p["w_up"], prec)
    ye = mm(he, p["w_down"], prec)
    out = h.new_zeros(T, d).index_add(0, tok, ye[e, slot] * gates[kept][:, None])
    f = torch.bincount(idx.reshape(-1), minlength=E).float() / T
    aux = E * torch.sum(f * probs.mean(0))
    return out, aux


def block(s: Spec, p: dict, x: torch.Tensor, cos, sin, prec: str):
    """One layer: ``(x_out, aux or None)``."""
    x = x + attention(s, p["mixer"], rms(x, p["norm1"], s.eps), cos, sin,
                      prec)
    h = rms(x, p["norm2"], s.eps)
    if s.family == "moe":
        B, S, d = h.shape
        y, aux = moe(s, p["ffn"], h.reshape(B * S, d), prec)
        return x + y.view(B, S, d), aux
    B, S, d = h.shape
    return x + mlp(p["ffn"], h.reshape(B * S, d), prec).view(B, S, d), None


# -- loss and gradients -----------------------------------------------------

def _layer(weights: Dict[str, torch.Tensor], l: int, grad: bool):
    """Layer ``l``'s parameters in f32 as a nested dict, and the leaves
    (path, tensor) that take a gradient."""
    tree: dict = {}
    leaves = []
    for path, w in weights.items():
        if not path.startswith("layers/b0/"):
            continue
        t = w[l].detach().to(torch.float32, copy=True)
        if grad:
            t.requires_grad_(True)
            leaves.append((path, t))
        node = tree
        *heads, last = path[len("layers/b0/"):].split("/")
        for k in heads:
            node = node.setdefault(k, {})
        node[last] = t
    return tree, leaves


HEAD_ROWS = 1024   # tokens a block of the head's logits and loss


def loss_and_grads(s: Spec, weights: Dict[str, torch.Tensor],
                   tokens: torch.Tensor, labels: torch.Tensor,
                   prec: str = "f32"):
    """The mean loss (f32 scalar) and every leaf's f32 gradient."""
    B, S = tokens.shape
    T = B * S
    dev = tokens.device
    cos, sin = rope_tables(s, S, dev)
    emb = weights["embed/embedding"]
    scale = math.sqrt(s.d)
    xs = [emb[tokens.long()].float() * scale]
    aux_total = torch.zeros((), device=dev)
    with torch.no_grad():
        for l in range(s.n_layers):
            p, _ = _layer(weights, l, False)
            x, aux = block(s, p, xs[-1], cos, sin, prec)
            xs.append(x)
            if aux is not None:
                aux_total = aux_total + aux
    grads = {k: torch.zeros(w.shape, dtype=torch.float32, device=dev)
             for k, w in weights.items()}
    # head and loss, in row blocks
    head_key = "embed/embedding" if s.tie else "embed/lm_head"
    w_head = weights[head_key].detach().to(torch.float32, copy=True)
    w_norm = weights["final_norm"].detach().to(torch.float32, copy=True)
    w_head.requires_grad_(True)
    w_norm.requires_grad_(True)
    xf = xs[-1].reshape(T, s.d)
    lab = labels.reshape(T).long()
    g_x = torch.empty_like(xf)
    ce_total = torch.zeros((), device=dev)
    for r0 in range(0, T, HEAD_ROWS):
        xb = xf[r0:r0 + HEAD_ROWS].detach().requires_grad_(True)
        hb = rms(xb, w_norm, s.eps)
        logits = mm(hb, w_head.t() if s.tie else w_head, prec)
        ce = (torch.logsumexp(logits, -1)
              - logits.gather(1, lab[r0:r0 + HEAD_ROWS, None])[:, 0]).sum() / T
        gx, gw, gn = torch.autograd.grad(ce, [xb, w_head, w_norm])
        g_x[r0:r0 + HEAD_ROWS] = gx
        grads[head_key] += gw
        grads["final_norm"] += gn
        ce_total = ce_total + ce.detach()
        del logits, ce, gx, gw, gn
    del w_head, w_norm
    g = g_x.view(B, S, s.d)
    xs.pop()
    for l in reversed(range(s.n_layers)):
        x_in = xs.pop().requires_grad_(True)
        p, leaves = _layer(weights, l, True)
        y, aux = block(s, p, x_in, cos, sin, prec)
        outs, gouts = [y], [g]
        if aux is not None:
            outs.append(aux * s.aux_coef)
            gouts.append(torch.ones((), device=dev))
        got = torch.autograd.grad(outs, [x_in] + [t for _, t in leaves],
                                  gouts)
        g = got[0]
        for (path, _), gl in zip(leaves, got[1:]):
            grads[path][l] = gl
        del y, aux, got, leaves, p, x_in
    grads["embed/embedding"].index_add_(
        0, tokens.reshape(T).long(), g.reshape(T, s.d) * scale)
    loss = ce_total + s.aux_coef * aux_total
    return loss, grads


def microbatches(tokens: torch.Tensor, accum: int) -> List[torch.Tensor]:
    """Microbatch ``a`` holds rows ``a, a + accum, ...``: the training
    step's split of a global batch."""
    return [tokens[a::accum] for a in range(accum)]


def batch_loss_and_grads(s: Spec, weights, tokens, labels, accum: int,
                         prec: str = "f32"):
    """The step's loss and gradients: the mean over ``accum``
    microbatches."""
    if accum == 1:
        return loss_and_grads(s, weights, tokens, labels, prec)
    loss, grads = None, None
    for t, y in zip(microbatches(tokens, accum), microbatches(labels, accum)):
        lm, gm = loss_and_grads(s, weights, t, y, prec)
        if grads is None:
            loss, grads = lm, gm
        else:
            loss = loss + lm
            for k in grads:
                grads[k] += gm[k]
        del gm
    for k in grads:
        grads[k] /= accum
    return loss / accum, grads

