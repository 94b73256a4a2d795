"""The ``model`` mesh axis: tensor and expert parallelism of every model
family's train step (the reference leaves this axis to GSPMD; the port
writes its collectives out, Megatron's way): the attention and MLP blocks
of the dense decoders and the encoder-decoder stack, the MoE layers,
mamba's channels and xLSTM's mLSTM and sLSTM heads, and LoRA's adapters
split with their base weights (``models.lora.merge(..., tp=)``).

The collectives are ``torch.autograd.Function``s over the model group:

* :meth:`TP.copy_in` — into a model-parallel region: the identity forward,
  an all-reduce of the gradient backward (each rank's part of the input's
  gradient comes from its own heads, columns or experts);
* :meth:`TP.reduce_out` — out of it: an all-reduce forward (the partial
  products of a row-parallel weight), the identity backward;
* :meth:`TP.reduce_split` — an all-reduce forward into a region where each
  rank uses its own part of the sum (mamba's ``x_proj`` product, xLSTM's
  ``[q|k|v|i|f]``, a channel-split RMSNorm's sum of squares): the gradient
  is all-reduced too;
* :meth:`TP.gather` — an all-gather along one dimension forward, this
  rank's slice of the gradient backward (every rank then computes the same
  thing: the experts' outputs, sLSTM's hidden states);
* :meth:`TP.gather_reduce` — a weight gathered whole and used by each rank
  for its own part (sLSTM's recurrent ``r``, split by gates, used by
  heads): an all-gather forward, and backward an all-reduce of the
  gradient over the group, then this rank's slice.

On a one-rank group each is the identity and issues no collective.

Which layers split is the rule table's (``distributed.sharding.tp_rules``):
a dimension splits where the axis divides it, heads only at head
granularity.  The model code asks :func:`split` with the dimension's whole
size and computes replicated where it gets None.  A replicated weight used
inside a region (a K/V projection left whole, the QK norms, mLSTM's gate
biases) gets a partial gradient on each rank and is passed through
:meth:`TP.copy_in` too, so that its gradient is summed over the group.

The loss over a vocab-split head (:func:`vocab_cross_entropy`) reduces the
f32 log-sum-exp terms and the label's logit over the group: the logits are
never gathered whole.  ``models.layers.rms_norm(..., tp=)`` normalises a
channel-split last dimension with one all-reduce of the sum of squares.

Only train mode splits: a cached serving mode given a ``TP`` raises
(:func:`train_only`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, rank, size):
        ctx.dim, ctx.rank, ctx.n, ctx.group = dim, rank, x.shape[dim], group
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, None,
                None)


class _GatherReduce(_Gather):
    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return (g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, None,
                None)


class TP:
    """This process's place along ``model``: its ``group`` (None: one
    rank), ``rank`` and ``size``."""

    __slots__ = ("group", "rank", "size")

    def __init__(self, group=None, rank: int = 0, size: int = 1):
        self.group, self.rank, self.size = group, rank, size

    def __repr__(self):
        return f"TP(rank={self.rank}, size={self.size})"

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        if self.size == 1:
            return x
        return _CopyIn.apply(x, self.group)

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        if self.size == 1:
            return x
        return _ReduceOut.apply(x, self.group)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        if self.size == 1:
            return x
        return _Gather.apply(x, dim % x.ndim, self.group, self.rank,
                             self.size)

    def reduce_split(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group of partial products, into a region where
        each rank uses its own part of it: all-reduce forward and
        backward."""
        return self.copy_in(self.reduce_out(x))

    def gather_reduce(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x``'s whole tensor along ``dim`` for a rank that uses its own
        part of it: its gradient is summed over the group, then sliced."""
        if self.size == 1:
            return x
        return _GatherReduce.apply(x, dim % x.ndim, self.group, self.rank,
                                   self.size)

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        """The element-wise maximum over the group, without a gradient."""
        x = x.detach().contiguous().clone()
        if self.size > 1:
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
        return x


def from_dp(dp) -> Optional[TP]:
    """The :class:`TP` of a ``launch.mesh.DPContext``'s model axis; None
    without one (or with one rank along it)."""
    if dp is None or getattr(dp, "model_world", 1) <= 1:
        return None
    return TP(dp.model_group, dp.model_rank, dp.model_world)


def train_only(tp: Optional[TP], mode: str, what: str) -> None:
    """Raise where a cached serving mode is given a ``TP``: serving keeps
    the replicated layout along ``model`` (its ``decode_rules``, the
    cache's sequence over ``model``, are ROADMAP Queue 1 item 7.4.5)."""
    if tp is not None and mode != "train":
        raise NotImplementedError(
            f"tensor-parallel {what} is train mode only, not {mode!r}: "
            "serving keeps the replicated layout along 'model' (its "
            "decode_rules are ROADMAP Queue 1 item 7.4.5)")


def split(tp: Optional[TP], n: int) -> Optional[TP]:
    """``tp`` where a dimension of ``n`` splits over the model axis, else
    None (the layer stays replicated)."""
    return tp if tp is not None and n % tp.size == 0 else None


def heads_split(tp: Optional[TP], cfg) -> Tuple[Optional[TP], bool]:
    """``(tp for the attention, whether K/V split too)``: the attention is
    split where the axis divides ``n_heads``, its K/V projections where it
    also divides ``n_kv_heads`` (``sharding.tp_rules``)."""
    tp = split(tp, cfg.n_heads)
    return tp, tp is not None and cfg.n_kv_heads % tp.size == 0


def kv_heads_of(tp: TP, cfg) -> Tuple[int, int, torch.Tensor]:
    """For a rank whose K/V projections are whole: ``(lo, hi, idx)``, the
    range of KV heads its query heads read and, per local query head, its
    KV head's index in that range (by the query head's global index, so
    that GQA groups stay right)."""
    h_local = cfg.n_heads // tp.size
    group = cfg.n_heads // cfg.n_kv_heads
    first = tp.rank * h_local
    lo, hi = first // group, (first + h_local - 1) // group + 1
    idx = torch.arange(first, first + h_local) // group - lo
    return lo, hi, idx


def vocab_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                        tp: TP) -> torch.Tensor:
    """Mean cross-entropy in f32 over vocab-split logits ``(..., V/M)``
    (this rank's columns ``[rank·V/M, (rank+1)·V/M)``): the maximum over the
    group, then ``Σ exp(l - max)`` and the label's logit summed over it in
    one all-reduce.  Equals :func:`models.layers.cross_entropy` of the
    whole logits up to the summation order of the exponentials."""
    logits = logits.float()
    n = logits.shape[-1]
    m = tp.all_max(logits.amax(-1))
    sumexp = torch.exp(logits - m[..., None]).sum(-1)
    lab = labels.long() - tp.rank * n
    inside = (lab >= 0) & (lab < n)
    ll = torch.gather(logits, -1, lab.clamp(0, n - 1)[..., None])[..., 0]
    ll = torch.where(inside, ll, torch.zeros_like(ll))
    sumexp, ll = tp.reduce_out(torch.stack([sumexp, ll])).unbind(0)
    return torch.mean(torch.log(sumexp) + m - ll)

