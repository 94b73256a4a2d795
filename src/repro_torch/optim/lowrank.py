"""Low-rank baselines the paper compares against, Tables II/III
(counterpart of ``repro/optim/lowrank.py``):

* **GaLore** (Zhao et al. 2024): SVD projection of gradients; Adam states in
  the rank-r subspace; projector refreshed every ``update_gap`` steps.
* **APOLLO** (Zhu et al. 2024): SVD-free — random projection + channel-wise
  gradient scaling; full-rank update direction.
* **Fira** (Chen et al. 2024): GaLore + scaled full-rank residual + the
  norm-growth limiter.
* **AdaRankGrad** (arXiv 2410.17881): per-leaf rank adapted from the
  gradient spectrum's energy decay — the projector keeps only the top-k
  singular directions covering a ``tau`` fraction of squared energy, k
  monotone non-increasing over refreshes; moments are rotated into each new
  basis.
* **RSO** (arXiv 2502.07222): an orthonormalized Gaussian projector
  resampled every ``update_gap`` steps (SVD-free), with the same moment
  rotation across resamples.

All share GWT's per-leaf routing: eligible weights of two or more dims get
compressed states, the rest run plain Adam.  ``r = rank_frac · min(m, n)``
(GaLore-1/4 is ``rank_frac=0.25``), or ``rank``.  The moments are kept in
``state_dtype`` and only they go through the state codec; the projector,
Fira's and APOLLO's limiter norm and AdaRankGrad's live rank (a device f32
scalar) stay exact.  Bucket names and state paths are the JAX package's.

Differences from the JAX package, each forced by eager PyTorch:

* The projector refresh is a ``lax.cond`` on the traced step there.  Here
  the rules are ``host_step`` rules (``optim/engine.py``): they get the step
  as an int from the engine's host mirror and branch in Python, so a
  non-refresh step makes no synchronizing call and runs no SVD.  A refresh
  step may synchronize inside ``torch.linalg.svd``/``qr``.
* APOLLO and RSO draw with ``jax.random.fold_in(key(seed + leaf_id),
  step // update_gap)`` there, and here with the same key through
  :mod:`repro_torch.core.prng` (:func:`draw_normal`): the same uniforms bit
  for bit, normals within 4 f32 spacings, so a run the JAX package wrote
  continues in the port with the projectors it would have drawn.
* SVD and QR are ``torch.linalg`` calls in f32 (the JAX package leaves
  them to XLA, outside any Pallas kernel).  SVD signs are arbitrary: the
  update is invariant to a column sign flip within a refresh epoch.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch.core import limiter, prng
from repro_torch.optim import engine, hosts as hosts_lib
from repro_torch.optim.base import Optimizer, default_eligible
from repro_torch.optim.schedules import constant


def _norm_lr(lr):
    return constant(lr) if isinstance(lr, (int, float)) else lr


def _rank(p, rank, rank_frac) -> int:
    if rank is not None:
        return max(1, min(rank, min(p.shape[-2:])))
    return max(1, int(min(p.shape[-2:]) * rank_frac))


def _project_left(p) -> bool:
    """GaLore projects the smaller side: left if rows <= cols."""
    return p.shape[-2] <= p.shape[-1]


def svd(g32: torch.Tensor):
    """``(U, S, Vh)`` of an f32 matrix stack, reduced."""
    return torch.linalg.svd(g32, full_matrices=False)


def draw_normal(shape, seed: int, leaf_id: int, epoch: int,
                device) -> torch.Tensor:
    """Standard normal f32 draws of ``shape`` for leaf ``leaf_id`` in
    refresh epoch ``epoch`` (``step // update_gap``) on ``device``: the
    JAX package's ``jax.random.normal(fold_in(key(seed + leaf_id),
    epoch))`` (:mod:`repro_torch.core.prng`)."""
    return prng.normal(prng.fold_in(prng.key(seed + leaf_id), epoch), shape,
                       device)


def _basis(u, vh, r, left):
    return (u[..., :, :r] if left
            else vh.transpose(-1, -2)[..., :, :r]).contiguous()


def _svd_projector(g, r, left):
    u, _, vh = svd(g.float())
    return _basis(u, vh, r, left)


def _proj_shape(p, r, left):
    return tuple(p.shape[:-2]) + ((p.shape[-2] if left else p.shape[-1]), r)


def _rand_projector(p, r, left, seed, leaf_id, epoch):
    """A Gaussian ``(…, m, r)`` projector scaled by ``1/√r``."""
    return draw_normal(_proj_shape(p, r, left), seed, leaf_id, epoch,
                       p.device) / math.sqrt(r)


def _orth_rand_projector(p, r, left, seed, leaf_id, epoch):
    """Orthonormalized Gaussian projector: reduced QR of an ``(…, m, r)``
    normal draw.  ``m ≥ r`` (``_rank``), so ``PᵀP = I_r``."""
    q, _ = torch.linalg.qr(draw_normal(_proj_shape(p, r, left), seed,
                                       leaf_id, epoch, p.device))
    return q


def _down(g, proj, left):
    """Full grad -> subspace: ``(r×n) = Pᵀ G`` or ``(m×r) = G P``."""
    g = g.to(proj.dtype)
    return proj.transpose(-1, -2) @ g if left else g @ proj


def _up(rlow, proj, left):
    return proj @ rlow if left else rlow @ proj.transpose(-1, -2)


def _effective_rank(s, tau, r_max):
    """The number of singular values whose squared energy reaches a ``tau``
    fraction.  ``s``: ``(…, k)``, descending.  Returns an f32 scalar in
    ``[1, r_max]``; batch dims collapse by max (one rank per leaf)."""
    e = s.float() ** 2
    c = torch.cumsum(e, dim=-1)
    tot = torch.clamp_min(c[..., -1:], 1e-30)
    k = ((c / tot) < tau).sum(-1) + 1
    return torch.clamp(k, 1, r_max).max().float()


def _rotate_moments(hstate, proj_old, proj_new, left):
    """Carry Adam moments across a basis change via ``T = P_newᵀ P_old``:
    ``m' = T m`` (left) rotates the first moment exactly; ``v' = (T∘T) v``
    is the standard nonnegative approximation for the second moment."""
    t = proj_new.transpose(-1, -2) @ proj_old
    m, v = hstate["m"].float(), hstate["v"].float()
    if left:
        m, v = t @ m, (t * t) @ v
    else:
        m = m @ t.transpose(-1, -2)
        v = v @ (t * t).transpose(-1, -2)
    return {"m": m.to(hstate["m"].dtype), "v": v.to(hstate["v"].dtype)}


def _lowrank_init(host, rank, rank_frac, extra):
    """The state of a low-rank leaf: the host's moments in the subspace,
    the zero projector, and ``extra(p)``'s exact scalars."""
    def init(p):
        r = _rank(p, rank, rank_frac)
        left = _project_left(p)
        low_shape = tuple(p.shape[:-2]) + (
            (r, p.shape[-1]) if left else (p.shape[-2], r))
        st = {"host": host.init(low_shape, p.device),
              "proj": torch.zeros(_proj_shape(p, r, left),
                                  dtype=torch.float32, device=p.device)}
        st.update(extra(p, r))
        return st
    return init


def _build(name, host, lr, rule_init, rule_update, exact, eligible,
           bucketed, state_codec) -> Optimizer:
    """The engine over a plain-Adam rule and the family's low-rank rule on
    the eligible leaves of two or more dims, both sides at least 2."""
    elig = eligible or default_eligible

    def plain_update(g, p, state, step, leaf_id):
        precond, _, lr_mult, hstate = host.update(g, state["host"], step)
        q = p.float() - (lr(step) * lr_mult) * precond.float()
        return q.to(p.dtype), {"host": hstate}

    plain_rule = engine.LeafRule(
        kind="plain", init=lambda p: {"host": host.init(p.shape, p.device)},
        update=plain_update, slots={"host": host.slots})
    # the projector and the scalars stay exact: re-quantizing the
    # projector would rotate the moments' basis
    slots = {"host": host.slots, "proj": False, **{k: False for k in exact}}
    lowrank_rule = engine.LeafRule(kind=name, init=rule_init,
                                   update=rule_update, slots=slots,
                                   host_step=True)

    def assign(path, leaf):
        if elig(path, leaf) and leaf.ndim >= 2 and min(leaf.shape[-2:]) >= 2:
            return lowrank_rule
        return plain_rule

    return engine.build(assign, bucketed=bucketed, codec=state_codec)


def _make_lowrank(name: str, lr, rank, rank_frac, alpha, update_gap,
                  eligible, use_limiter_flag, gamma, seed: int, state_dtype,
                  b1=0.9, b2=0.999, eps=1e-6, bucketed: bool = True,
                  state_codec="f32") -> Optimizer:
    """GaLore, APOLLO and Fira: a projector refreshed every ``update_gap``
    steps, the moments left in place across a refresh."""
    lr = _norm_lr(lr)
    host = hosts_lib.adam(b1, b2, eps, state_dtype)
    limited = name in ("fira", "apollo")
    init = _lowrank_init(host, rank, rank_frac, lambda p, r: {
        "prev_norm": torch.zeros((), dtype=torch.float32, device=p.device)}
        if limited else {})

    def update(g, p, state, step, leaf_id, host_step):
        out = dict(state)
        lr_t = lr(step)
        r = _rank(p, rank, rank_frac)
        left = _project_left(p)
        if host_step % update_gap != 0:
            proj = state["proj"].float()
        elif name == "apollo":
            # deterministic per-(leaf, epoch) random projector, O(mnr)
            proj = _rand_projector(p, r, left, seed, leaf_id,
                                   host_step // update_gap)
        else:
            proj = _svd_projector(g, r, left)
        out["proj"] = proj

        rlow = _down(g, proj, left)
        rtilde, _, lr_mult, out["host"] = host.update(rlow, state["host"],
                                                      step)
        if name == "galore":
            delta = _up(rtilde, proj, left)
        elif name == "fira":
            resid = g.float() - _up(rlow, proj, left)
            phi = torch.linalg.vector_norm(rtilde) / torch.clamp_min(
                torch.linalg.vector_norm(rlow), 1e-12)
            delta = _up(rtilde, proj, left) + phi * resid
        else:  # apollo: channel-wise scaling of the full-rank gradient
            axis = -2 if left else -1  # the norm over the projected dim
            snum = torch.linalg.vector_norm(rtilde, dim=axis, keepdim=True)
            sden = torch.clamp_min(torch.linalg.vector_norm(
                rlow, dim=axis, keepdim=True), 1e-12)
            delta = g.float() * (snum / sden)
            lr_mult = torch.ones((), dtype=torch.float32, device=g.device)

        if use_limiter_flag and limited:
            delta, out["prev_norm"] = limiter.limit(delta,
                                                    state["prev_norm"], gamma)
        q = p.float() - (lr_t * lr_mult * alpha) * delta.float()
        return q.to(p.dtype), out

    return _build(name, host, lr, init, update,
                  ("prev_norm",) if limited else (), eligible, bucketed,
                  state_codec)


def _make_adaptive(name: str, lr, rank, rank_frac, alpha, update_gap, tau,
                   seed: int, eligible, state_dtype, b1=0.9, b2=0.999,
                   eps=1e-6, bucketed: bool = True,
                   state_codec="f32") -> Optimizer:
    """AdaRankGrad and RSO: every ``update_gap`` steps a new basis (the
    gradient's SVD with energy-masked columns, or a seeded orthonormal
    draw) and the host moments rotated into it (``_rotate_moments``)."""
    lr = _norm_lr(lr)
    host = hosts_lib.adam(b1, b2, eps, state_dtype)
    ada = name == "adarankgrad"
    # the rank ceiling r_max of adarankgrad starts as the live rank
    init = _lowrank_init(host, rank, rank_frac, lambda p, r: {
        "rank": torch.tensor(float(r), dtype=torch.float32,
                             device=p.device)} if ada else {})

    def update(g, p, state, step, leaf_id, host_step):
        out = dict(state)
        r = _rank(p, rank, rank_frac)
        left = _project_left(p)
        hstate = state["host"]
        if host_step % update_gap != 0:
            proj = state["proj"].float()
        else:
            if ada:
                u, s, vh = svd(g.float())
                # monotone non-increasing rank: never above the previous
                # effective rank (init: r_max); a device scalar, no read
                k = torch.minimum(_effective_rank(s, tau, r), state["rank"])
                mask = (torch.arange(r, device=g.device) < k).float()
                proj = _basis(u, vh, r, left) * mask
                out["rank"] = k
            else:  # rso: a deterministic per-(leaf, epoch) draw
                proj = _orth_rand_projector(p, r, left, seed, leaf_id,
                                            host_step // update_gap)
            # zeros at step 0 stay zeros: the old projector is the zero
            # init, so T = 0 on the first refresh
            hstate = _rotate_moments(hstate, state["proj"].float(), proj,
                                     left)
        out["proj"] = proj

        rlow = _down(g, proj, left)
        rtilde, _, lr_mult, out["host"] = host.update(rlow, hstate, step)
        delta = _up(rtilde, proj, left)
        q = p.float() - (lr(step) * lr_mult * alpha) * delta.float()
        return q.to(p.dtype), out

    return _build(name, host, lr, init, update, ("rank",) if ada else (),
                  eligible, bucketed, state_codec)


def galore(lr, rank: Optional[int] = None, rank_frac: float = 0.25,
           alpha: float = 0.25, update_gap: int = 200,
           eligible: Callable = None, state_dtype=torch.float32,
           bucketed: bool = True, state_codec="f32") -> Optimizer:
    return _make_lowrank("galore", lr, rank, rank_frac, alpha, update_gap,
                         eligible, False, limiter.DEFAULT_GAMMA, 0,
                         state_dtype, bucketed=bucketed,
                         state_codec=state_codec)


def apollo(lr, rank: Optional[int] = None, rank_frac: float = 0.25,
           alpha: float = 1.0, update_gap: int = 200, seed: int = 0,
           eligible: Callable = None, state_dtype=torch.float32,
           bucketed: bool = True, state_codec="f32") -> Optimizer:
    return _make_lowrank("apollo", lr, rank, rank_frac, alpha, update_gap,
                         eligible, True, limiter.DEFAULT_GAMMA, seed,
                         state_dtype, bucketed=bucketed,
                         state_codec=state_codec)


def fira(lr, rank: Optional[int] = None, rank_frac: float = 0.25,
         alpha: float = 0.25, update_gap: int = 200,
         eligible: Callable = None, state_dtype=torch.float32,
         bucketed: bool = True, state_codec="f32") -> Optimizer:
    return _make_lowrank("fira", lr, rank, rank_frac, alpha, update_gap,
                         eligible, True, limiter.DEFAULT_GAMMA, 0,
                         state_dtype, bucketed=bucketed,
                         state_codec=state_codec)


def adarankgrad(lr, rank: Optional[int] = None, rank_frac: float = 0.25,
                alpha: float = 0.25, update_gap: int = 200, tau: float = 0.9,
                eligible: Callable = None, state_dtype=torch.float32,
                bucketed: bool = True, state_codec="f32") -> Optimizer:
    """AdaRankGrad: ``rank``/``rank_frac`` set the rank ceiling r_max (the
    buffers' shape); the live rank is a device f32 scalar in the state,
    monotone non-increasing across refreshes, realized as column masking
    of the projector."""
    return _make_adaptive("adarankgrad", lr, rank, rank_frac, alpha,
                          update_gap, tau, 0, eligible, state_dtype,
                          bucketed=bucketed, state_codec=state_codec)


def rso(lr, rank: Optional[int] = None, rank_frac: float = 0.25,
        alpha: float = 0.25, update_gap: int = 200, seed: int = 0,
        eligible: Callable = None, state_dtype=torch.float32,
        bucketed: bool = True, state_codec="f32") -> Optimizer:
    """RSO: an orthonormal Gaussian projector resampled every
    ``update_gap`` steps, SVD-free, the moments rotated across
    resamples."""
    return _make_adaptive("rso", lr, rank, rank_frac, alpha, update_gap,
                          0.0, seed, eligible, state_dtype,
                          bucketed=bucketed, state_codec=state_codec)
