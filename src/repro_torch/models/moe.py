"""Mixture-of-Experts FFN (counterpart of ``repro/models/moe.py``): a top-k
softmax router over ``n_experts``, capacity-bounded dispatch, the experts'
SwiGLU MLPs, optional shared (always-on) experts, and the Switch
load-balancing auxiliary loss.

Routing is the JAX package's, term for term: the f32 router logits and
softmax, the top-k (on exact ties the lower expert index first, as
``jax.lax.top_k``), the gates renormalized by ``max(sum, 1e-9)``, and each
``(token, k)`` pair's slot in its expert's queue, the exclusive running
count of that expert over the flattened ``(t, k)`` order; a slot at or past
the capacity ``C = ceil(T·K/E · capacity_factor)`` is dropped.

Dispatch.  The JAX package dispatches with one-hot einsums so that GSPMD
can shard them; the port has no GSPMD and moves tokens by index
(``index_put`` into an ``(E_pad·C, d)`` buffer, a gather back), which
copies every token exactly, as the one-hot product does.  The combine
weights are the gates rounded to the activation dtype, as the JAX
package's ``comb``; the weighted sum over a token's kept experts runs in
f32 and is rounded once.

Along the ``model`` mesh axis (``tp``, a ``distributed.tensor_parallel.TP``):
every rank routes identically (the router is replicated, ``route`` and the
aux loss unchanged).  Where the axis divides ``E_pad`` each rank holds and
runs its ``E_pad/M`` experts' rows of the dispatch buffer, and their
outputs are all-gathered, so the combine reads the replicated step's
``ye`` (expert parallelism); else, where it divides ``d_ff_expert``, each
expert's MLP is split over the ranks and its partial outputs are summed
(tensor parallelism inside the expert).  The shared experts are a
tensor-parallel MLP.

``expert_padding`` pads the expert weights (the router stays at
``n_experts``): padded experts are never routed, so their buffers stay
zero.  Above ``_MOE_CHUNK_TOKENS`` tokens the layer runs in token chunks,
each recomputed in the backward, and the aux loss is the chunks' mean
(the JAX package's documented deviation).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import tensor_parallel
from repro_torch.models.layers import Builder, mlp_apply, mlp_init

_MOE_CHUNK_TOKENS = 8192  # tokens per dispatch chunk, as the JAX package


def moe_init(b: Builder, cfg, lead=()) -> dict:
    d, dff = cfg.d_model, cfg.d_ff_expert
    E = cfg.n_experts + cfg.expert_padding  # padded experts never routed
    p = {"router": b.param((d, cfg.n_experts), ("embed", None), lead=lead,
                           dtype=torch.float32),
         "w_gate": b.param((E, d, dff), ("expert", "embed", "expert_mlp"),
                           lead=lead),
         "w_up": b.param((E, d, dff), ("expert", "embed", "expert_mlp"),
                         lead=lead),
         "w_down": b.param((E, dff, d), ("expert", "expert_mlp", "embed"),
                           lead=lead)}
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(b, d, cfg.n_shared_experts * dff, lead=lead)
    return p


def moe_apply(p, cfg, x: torch.Tensor, tp=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux loss f32 scalar); ``tp`` splits
    the experts over the model axis (the module doc)."""
    B, S, d = x.shape
    if B * S > _MOE_CHUNK_TOKENS and S % (_MOE_CHUNK_TOKENS // B or 1) == 0 \
            and _MOE_CHUNK_TOKENS >= B:
        sc = _MOE_CHUNK_TOKENS // B
        outs, auxs = [], []
        for c in range(S // sc):
            xc = x[:, c * sc:(c + 1) * sc]
            if torch.is_grad_enabled():
                # without the recompute, every chunk's expert activations
                # would stay alive through the backward
                out_c, aux_c = checkpoint(_moe_dense, p, cfg, xc, tp,
                                          use_reentrant=False)
            else:
                out_c, aux_c = _moe_dense(p, cfg, xc, tp)
            outs.append(out_c)
            auxs.append(aux_c)
        return torch.cat(outs, dim=1), torch.stack(auxs).mean()
    return _moe_dense(p, cfg, x, tp)


def top_k(probs: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values in
    descending order, exact ties taking the lower index first (a stable
    descending sort; ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(probs: torch.Tensor, cfg):
    """The routing of ``probs`` (T, E): ``(gates (T, K) f32, expert ids
    (T, K), slots (T, K), C)``, a slot equal to ``C`` marking a dropped
    pair."""
    T, E = probs.shape
    K = cfg.top_k
    gate_vals, expert_idx = top_k(probs, K)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    C = max(1, math.ceil(T * K / E * cfg.capacity_factor))
    flat = expert_idx.reshape(T * K)
    onehot = F.one_hot(flat, E)
    pos = torch.cumsum(onehot, dim=0) - onehot
    slot = torch.gather(pos, 1, flat[:, None])[:, 0]
    slot = torch.where(slot < C, slot, C).reshape(T, K)
    return gate_vals, expert_idx, slot, C


def _moe_dense(p, cfg, x: torch.Tensor, tp=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, d = x.shape
    E = cfg.n_experts
    E_pad = E + cfg.expert_padding
    T = B * S
    xt = x.reshape(T, d)
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)                      # (T, E)
    gate_vals, expert_idx, slot, C = route(probs, cfg)
    kept = slot < C
    # each kept pair's row of the (E_pad·C, d) expert buffer; a dropped
    # pair writes the trash row past it (sliced off)
    trash = E_pad * C
    dest = torch.where(kept, expert_idx * C + slot,
                       torch.full_like(slot, trash)).reshape(-1)
    ep = tensor_parallel.split(tp, E_pad)
    etp = None if ep is not None \
        else tensor_parallel.split(tp, cfg.d_ff_expert)
    xd = xt if ep is None and etp is None else tp.copy_in(xt)
    src = xd.repeat_interleave(cfg.top_k, dim=0)               # (T·K, d)
    if ep is None:
        rows, local = trash, dest
    else:
        # this rank's experts' rows; the other pairs go to the trash row
        rows = trash // ep.size
        local = dest - ep.rank * rows
        local = torch.where((local >= 0) & (local < rows), local,
                            torch.full_like(local, rows))
    xe = xt.new_zeros((rows + 1, d)).index_put((local,), src)
    xe = xe[:rows].reshape(-1, C, d)
    h = F.silu(xe @ p["w_gate"]) * (xe @ p["w_up"])
    ye = (h @ p["w_down"]).reshape(rows, d)
    if ep is not None:
        ye = ep.gather(ye, 0)
    elif etp is not None:
        ye = etp.reduce_out(ye)
    ye = torch.cat([ye, ye.new_zeros((1, d))])                 # trash: 0
    w = torch.where(kept, gate_vals, torch.zeros_like(gate_vals)) \
        .to(x.dtype).float()                                   # (T, K)
    out = (ye[dest].reshape(T, cfg.top_k, d).float()
           * w[..., None]).sum(1).to(x.dtype)

    # Switch aux loss: E * sum_e f_e * P_e, f_e counting every routed pair
    # (dropped ones too)
    f = torch.bincount(expert_idx.reshape(-1), minlength=E).float() / T
    aux = E * torch.sum(f * probs.mean(0))

    if cfg.n_shared_experts:
        out = out + mlp_apply(p["shared"], xt, tensor_parallel.split(
            tp, cfg.n_shared_experts * cfg.d_ff_expert))
    return out.reshape(B, S, d), aux
