"""The optimizer the cells state, in plain PyTorch and f32: GWT over the
Haar transform with Adam on the approximation band (the paper's
Algorithm 1) and plain Adam on the leaves GWT leaves out.

A leaf takes GWT if its path names none of the deny-listed substrings
(embeddings, head, norms, biases, router, ...), its last path segment is
not ``r``, it has two axes or more, and ``2^level`` divides its last axis
(the transform runs along it) or else its second-to-last (the transform
runs along that one).  Every other leaf runs plain Adam on the whole
tensor.  GWT on a leaf ``G`` (its rows along the transform axis)::

    A, [D_l .. D_1] = Haar(G)                   (pairs (2i, 2i+1) / sqrt 2)
    m = b1 m + (1 - b1) A;  v = b2 v + (1 - b2) A^2
    s = 1 / (sqrt(v) + eps)
    G~ = Haar^-1(m s, [D_k * s upsampled to D_k's width])
    G~ = G~ * min(1, gamma |G~_prev| / |G~|)    (norm-growth limiter, the
                                                whole leaf; off at first)
    W = W - lr_t * sqrt(1 - b2^t) / (1 - b1^t) * alpha * G~ - lr_t * wd * W

with ``t = step + 1`` and ``lr_t`` the warm-up-cosine schedule at
``step``.  Plain Adam takes ``alpha = 1`` and ``m s`` on the whole leaf.
Parameters are stored in the model dtype; everything else is f32.  The
``int8`` codec stores ``m`` and ``v`` in blocks of 64 flat elements
against their absmax over 127, rounded stochastically (the reference
draws its own uniforms).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

DENY = ("embed", "lm_head", "norm", "scale", "bias", "pos_", "router",
        "a_log", "dt_bias", "conv", "x_proj", "dt_proj", "igate", "fgate")
BLOCK = 64
INV127 = 0.007874015718698502   # f32(1 / 127)


@dataclass(frozen=True)
class Rule:
    lr: float                 # the schedule's peak
    schedule_steps: int
    level: int = 2
    alpha: float = 0.25
    gamma: float = 1.01
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-6
    weight_decay: float = 0.0
    codec: str = "f32"

    def lr_at(self, step: int) -> float:
        """Linear warm-up over the first tenth, then cosine to a tenth of
        the peak."""
        warm = max(1, int(self.schedule_steps * 0.1))
        if step < warm:
            return self.lr * step / warm
        prog = min(max((step - warm) / max(1, self.schedule_steps - warm),
                       0.0), 1.0)
        return self.lr * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))


def mode(path: str, shape, level: int) -> str:
    """``"last"``, ``"first"`` or ``"plain"``."""
    name = path.lower()
    if level == 0 or any(s in name for s in DENY) \
            or name.rsplit("/", 1)[-1] == "r" or len(shape) < 2:
        return "plain"
    if shape[-1] % (1 << level) == 0:
        return "last"
    if shape[-2] % (1 << level) == 0:
        return "first"
    return "plain"


def haar(x: torch.Tensor, level: int):
    """``(A_l, [D_l, ..., D_1])`` along the last axis."""
    r = 1.0 / math.sqrt(2.0)
    a, ds = x, []
    for _ in range(level):
        even, odd = a[..., 0::2], a[..., 1::2]
        a, d = (even + odd) * r, (even - odd) * r
        ds.append(d)
    return a, ds[::-1]


def haar_inv(a: torch.Tensor, ds: List[torch.Tensor]) -> torch.Tensor:
    r = 1.0 / math.sqrt(2.0)
    x = a
    for d in ds:
        x = torch.stack([(x + d) * r, (x - d) * r], -1).flatten(-2)
    return x


def band(g: torch.Tensor, m: str, level: int) -> torch.Tensor:
    """The gradient as the moments see it: GWT's ``A_l``, or the leaf."""
    if m == "plain":
        return g
    return haar(g.transpose(-1, -2) if m == "first" else g, level)[0]


def slices(x: torch.Tensor) -> torch.Tensor:
    """``x`` with a leading axis to walk: a stack of matrices (three axes
    or more) by its first axis, anything smaller whole."""
    return x if x.dim() >= 3 else x.unsqueeze(0)


def quant(x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Blocked int8 round trip with stochastic rounding (f32 out)."""
    flat = x.reshape(-1)
    n = flat.numel()
    nb = -(-n // BLOCK)
    blk = torch.nn.functional.pad(flat, (0, nb * BLOCK - n)).view(nb, BLOCK)
    scale = blk.abs().amax(-1, keepdim=True) * INV127
    inv = torch.where(scale > 0, 1.0 / scale, torch.zeros_like(scale))
    y = blk * inv
    lo = torch.floor(y)
    u = torch.rand(y.shape, generator=gen, device=y.device)
    q = (lo + (u < y - lo).float()).clamp(-127.0, 127.0)
    return (q * scale).reshape(-1)[:n].view(x.shape)


class Optimizer:
    """The rule over a dict of leaves (path -> tensor in the model dtype)."""

    def __init__(self, rule: Rule, weights: Dict[str, torch.Tensor],
                 seed: int = 0):
        self.rule = rule
        self.modes = {k: mode(k, w.shape, rule.level)
                      for k, w in weights.items()}
        self.state: Dict[str, dict] = {}
        self.step = 0
        dev = next(iter(weights.values())).device
        self.gen = torch.Generator(device=dev).manual_seed(seed)

    def update(self, weights: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor]) -> None:
        """One step, in place on ``weights``; ``grads`` are f32.  A leaf is
        taken one slice of its first axis at a time (the transform runs
        along the last two), twice for GWT: the limiter needs the whole
        leaf's norm before any slice is written."""
        r = self.rule
        t = self.step + 1
        lr_t = r.lr_at(self.step)
        lr_mult = math.sqrt(1 - r.b2 ** t) / (1 - r.b1 ** t)
        for k, w in weights.items():
            m_ = self.modes[k]
            g, w = slices(grads[k]), slices(w)
            st = self.state.get(k)
            if st is None:
                shape = band(g[:1], m_, r.level).shape[1:]
                st = {"m": g.new_zeros((g.shape[0],) + shape),
                      "v": g.new_zeros((g.shape[0],) + shape), "prev": 0.0}
                self.state[k] = st
            alpha, scale = 1.0, 1.0
            if m_ != "plain":
                ssq = 0.0
                for i in range(g.shape[0]):
                    ssq += norm(self._slice(k, g, st, i, True)) ** 2
                nrm = math.sqrt(ssq)
                prev = st["prev"]
                safe = prev if prev > 0 else nrm
                if nrm > r.gamma * safe:
                    scale = r.gamma * safe / max(nrm, 1e-30)
                st["prev"] = nrm * scale if nrm > 0 else prev
                alpha = r.alpha
            step_size = lr_t * lr_mult * alpha * scale
            for i in range(g.shape[0]):
                upd = self._slice(k, g, st, i, m_ == "plain")
                w32 = w[i].float()
                new = w32 - step_size * upd
                if r.weight_decay:
                    new = new - lr_t * r.weight_decay * w32
                w[i].copy_(new.to(w.dtype))
                if r.codec == "int8":
                    st["m"][i] = quant(st["m"][i], self.gen)
                    st["v"][i] = quant(st["v"][i], self.gen)
        self.step += 1

    def _slice(self, k: str, g: torch.Tensor, st: dict, i: int,
               advance: bool) -> torch.Tensor:
        """Slice ``i`` of leaf ``k``'s preconditioned update (G~ before
        the limiter); ``advance`` first moves its moments to this step."""
        r = self.rule
        m_ = self.modes[k]
        x = g[i].transpose(-1, -2) if m_ == "first" else g[i]
        if m_ == "plain":
            a, ds = x, []
        else:
            a, ds = haar(x, r.level)
        if advance:
            st["m"][i] = r.b1 * st["m"][i] + (1 - r.b1) * a
            st["v"][i] = r.b2 * st["v"][i] + (1 - r.b2) * a * a
        s = 1.0 / (torch.sqrt(st["v"][i]) + r.eps)
        if m_ == "plain":
            return st["m"][i] * s
        tilde = [d * s.repeat_interleave(1 << (r.level - j), -1)
                 for d, j in zip(ds, range(r.level, 0, -1))]
        upd = haar_inv(st["m"][i] * s, tilde)
        return upd.transpose(-1, -2) if m_ == "first" else upd

    def band_norms(self, grads: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """Each leaf's ``|A_l(g)|`` (GWT) or ``|g|`` (plain)."""
        return {k: norm(band(g, self.modes[k], self.rule.level))
                for k, g in grads.items()}


def norm(x: Optional[torch.Tensor]) -> float:
    """The f64 Euclidean norm of ``x``, in row blocks."""
    flat = x.reshape(-1)
    total = 0.0
    for i in range(0, flat.numel(), 1 << 26):
        total += float(torch.sum(flat[i:i + (1 << 26)].double() ** 2))
    return math.sqrt(total)
