"""Wavelet-domain compression of the data-parallel gradient reduction
(counterpart of ``repro/distributed/compression.py``).

Each rank splits a gradient leaf with the level-l Haar DWT along its last
axis and ships the approximation band ``A_l`` in f32 and the detail bands
``D_l..D_1`` in a narrower wire dtype (bf16, f16 or float8_e4m3fn).  The
transform is linear and orthonormal, so ``mean(G_i) = IDWT(mean(DWT(G_i)))``
and the only error is the detail quantization (and the one rounding of the
summed details back to the wire dtype).

The reduction: every rank's wire payload travels as raw bytes
(``all_gather`` of a ``uint8`` view, so every wire dtype travels, gloo's
included), and each rank sums the payloads in f32 in rank order and rounds
the sum once to the wire dtype.  That is the JAX package's reference
semantics of its ``psum`` (:func:`_psum_like_sum`), bitwise, for the exact
mode and every wire dtype; an NCCL or gloo all-reduce would round at every
hop, and gloo has no fp8.  The gather receives ``(D-1)`` payloads per rank;
:func:`tree_wire_bytes` keeps the reference's ring-all-reduce accounting.

The split runs the K3 kernel on CUDA tensors, all compressible leaves of
a step in one grouped launch (``ops.dwt_wire_group``, from
:func:`compressed_means`), and the reconstruction the K7 kernel
(``ops.idwt``) leaf by leaf; CPU tensors take their plain versions.
``level == 0`` or ``detail_dtype=None`` is the exact mode: one f32 sum.
Leaves that are not :func:`compressible` always take it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.distributed import sharding
from repro_torch.kernels.haar_dwt import ops
from repro_torch.kernels.haar_dwt.ref import to_wire
from repro_torch.optim.base import flatten_with_paths, tree_map, unflatten

WIRE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
               "float8_e4m3fn": torch.float8_e4m3fn}


@dataclasses.dataclass(frozen=True)
class DPReduceSpec:
    """How the sharded train step reduces gradients over the ranks.

    * ``level``: wavelet levels of the split.
    * ``detail_dtype``: the wire dtype of the detail bands; ``None`` is the
      exact f32 reduction.
    * ``error_feedback``: each rank keeps the residue its quantization
      discarded and adds it back before the next reduction.
    """

    level: int = 2
    detail_dtype: Optional[torch.dtype] = torch.bfloat16
    error_feedback: bool = False

    @property
    def exact(self) -> bool:
        return self.detail_dtype is None or self.level == 0

    @classmethod
    def parse(cls, mode: str, level: int = 2,
              detail_dtype: str = "bfloat16",
              error_feedback: bool = False) -> Optional["DPReduceSpec"]:
        """Launcher-flag constructor: ``none`` | ``exact`` | ``compressed``,
        with the JAX package's errors."""
        if mode in ("", "none"):
            if error_feedback:
                raise ValueError("--dp-error-feedback needs --dp-reduce "
                                 "compressed")
            return None
        if mode == "exact":
            if error_feedback:
                raise ValueError("--dp-error-feedback is meaningless for "
                                 "the exact (lossless) reduction — use "
                                 "--dp-reduce compressed")
            return cls(level=level, detail_dtype=None)
        if mode == "compressed":
            if detail_dtype not in WIRE_DTYPES:
                raise ValueError(f"unknown detail dtype {detail_dtype!r}; "
                                 f"choices: {'|'.join(WIRE_DTYPES)}")
            return cls(level=level, detail_dtype=WIRE_DTYPES[detail_dtype],
                       error_feedback=error_feedback)
        raise ValueError(f"unknown dp-reduce mode {mode!r}; "
                         "choices: none|exact|compressed")


def compressible(shape: Sequence[int], level: int) -> bool:
    """Leaves the wavelet split applies to; the rest take the exact sum."""
    return len(shape) >= 2 and level > 0 and shape[-1] % (1 << level) == 0


def reduce_terms_group(gs: Sequence[torch.Tensor], level: int,
                       detail_dtype: torch.dtype
                       ) -> List[Tuple[torch.Tensor, List[torch.Tensor]]]:
    """One rank's wire terms of each leaf of ``gs``: ``A_l`` in f32 and the
    details in ``detail_dtype``, through one grouped K3 launch on the
    leaves' ``(-1, n)`` rows."""
    flats = [g.float().reshape(-1, g.shape[-1]).contiguous() for g in gs]
    return [(bands[0].reshape(*g.shape[:-1], -1),
             [d.reshape(*g.shape[:-1], -1) for d in bands[1:]])
            for g, bands in zip(gs, ops.dwt_wire_group(flats, level,
                                                       detail_dtype))]


def reduce_terms(g: torch.Tensor, level: int, detail_dtype: torch.dtype
                 ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """:func:`reduce_terms_group` of one leaf."""
    return reduce_terms_group([g], level, detail_dtype)[0]


def reconstruct(a: torch.Tensor, ds: Sequence[torch.Tensor], n
                ) -> torch.Tensor:
    """Inverse of :func:`reduce_terms` after the sum over ``n`` ranks:
    everything widens to f32 and divides by ``n``, then the K7 kernel
    inverts the transform."""
    lead = a.shape[:-1]
    a = (a / n).reshape(-1, a.shape[-1])
    ds = [(d.float() / n).reshape(-1, d.shape[-1]) for d in ds]
    return ops.idwt(a, ds).reshape(*lead, -1)


def local_residual(gc: torch.Tensor, a: torch.Tensor,
                   ds: Sequence[torch.Tensor]) -> torch.Tensor:
    """What this rank's quantization discarded: the compensated local
    gradient minus what its wire terms reconstruct to."""
    return gc - reconstruct(a, ds, 1)


def _psum_like_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The reference's ``psum``: accumulate in f32 in rank order, starting
    from zero, and round once to the payload's dtype."""
    acc = torch.zeros(parts[0].shape, dtype=torch.float32,
                      device=parts[0].device)
    for x in parts:
        acc = acc + x.float()
    return to_wire(acc, parts[0].dtype)


def _wire_sum(terms: Sequence[torch.Tensor], dp) -> List[torch.Tensor]:
    """Each of ``terms`` summed over the ranks of ``dp`` (a
    ``launch.mesh.DPContext``, or None for one rank).  The terms travel as
    one ``uint8`` payload per rank, the f32 ones first so that every term
    starts at a multiple of its item size."""
    if dp is None or dp.group is None:
        gathered = [list(terms)]
    else:
        payload = torch.cat([t.reshape(-1).view(torch.uint8) for t in terms])
        gathered = []
        for buf in dp.gather(payload):
            parts, at = [], 0
            for t in terms:
                nbytes = t.numel() * t.element_size()
                parts.append(buf[at:at + nbytes].view(t.dtype)
                             .reshape(t.shape))
                at += nbytes
            gathered.append(parts)
    return [_psum_like_sum([g[k] for g in gathered])
            for k in range(len(terms))]


def _world(dp) -> int:
    return 1 if dp is None else dp.world


def exact_mean(x: torch.Tensor, dp) -> torch.Tensor:
    """The f32 mean of ``x`` over the ranks of ``dp``, summed in rank
    order."""
    return _wire_sum([x.float()], dp)[0] / _world(dp)


def _compressed(shape, level: int, detail_dtype) -> bool:
    return detail_dtype is not None and compressible(shape, level)


def compressed_means(gs: Sequence[torch.Tensor], dp, level: int = 2,
                     detail_dtype: Optional[torch.dtype] = torch.bfloat16
                     ) -> List[torch.Tensor]:
    """Mean of each leaf of ``gs`` over the ranks of ``dp``: A_l in f32, the
    details in ``detail_dtype``; ``detail_dtype=None`` or ``level == 0`` is
    the exact f32 mean, which non-compressible leaves always take.  The
    compressible leaves are split in one grouped K3 launch; then leaf by
    leaf, in order, each one's terms are summed over the ranks (one gather
    a leaf) and reconstructed."""
    n = _world(dp)
    terms = iter(reduce_terms_group(
        [g for g in gs if _compressed(g.shape, level, detail_dtype)], level,
        detail_dtype))
    out = []
    for g in gs:
        if not _compressed(g.shape, level, detail_dtype):
            out.append(exact_mean(g, dp))
            continue
        a, ds = next(terms)
        a, *ds = _wire_sum([a, *ds], dp)
        out.append(reconstruct(a, ds, n))
    return out


def compressed_means_ef(gs: Sequence[torch.Tensor],
                        errs: Sequence[torch.Tensor], dp, level: int = 2,
                        detail_dtype: Optional[torch.dtype] = torch.bfloat16
                        ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """:func:`compressed_means` with error feedback: ``errs[i]`` is this
    rank's residue of leaf i (its shape, f32).  Returns ``(means,
    new_errs)``; the exact and non-compressible leaves keep a zero
    residue."""
    n = _world(dp)
    gcs = [g.float() + e for g, e in zip(gs, errs)
           if _compressed(g.shape, level, detail_dtype)]
    terms = iter(zip(gcs, reduce_terms_group(gcs, level, detail_dtype)))
    means, new_errs = [], []
    for g, err in zip(gs, errs):
        if not _compressed(g.shape, level, detail_dtype):
            means.append(exact_mean(g, dp))
            new_errs.append(torch.zeros_like(err))
            continue
        gc, (a, ds) = next(terms)
        new_errs.append(local_residual(gc, a, ds))
        a, *ds = _wire_sum([a, *ds], dp)
        means.append(reconstruct(a, ds, n))
    return means, new_errs


def compressed_mean(g: torch.Tensor, dp, level: int = 2,
                    detail_dtype: Optional[torch.dtype] = torch.bfloat16
                    ) -> torch.Tensor:
    """:func:`compressed_means` of one leaf."""
    return compressed_means([g], dp, level, detail_dtype)[0]


def compressed_mean_ef(g: torch.Tensor, err: torch.Tensor, dp,
                       level: int = 2,
                       detail_dtype: Optional[torch.dtype] = torch.bfloat16
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`compressed_means_ef` of one leaf: ``(mean, new_err)``."""
    means, errs = compressed_means_ef([g], [err], dp, level, detail_dtype)
    return means[0], errs[0]


def ef_init(tree):
    """This rank's zero residues for a gradient tree: one f32 leaf ``(1,
    *shape)`` per leaf, its row of the reference's ``(D, *shape)``
    (checkpoints hold every rank's row)."""
    return tree_map(lambda p: torch.zeros((1, *p.shape), dtype=torch.float32,
                                          device=p.device), tree)


def ef_state_shardings(ef_tree, mesh: sharding.Mesh,
                       dp_axis_names: Optional[Sequence[str]] = None):
    """The ``NamedSharding`` tree of a residue tree: each leaf's leading
    per-rank axis over the data axes of ``mesh`` (``dp_axis_names``, by
    default ``("pod", "data")`` or ``("data",)``), the rest replicated.
    Each rank holds its own row ``(1, *shape)`` (:func:`ef_init`)."""
    names = tuple(dp_axis_names or sharding.dp_axes(mesh))
    axis = names if len(names) > 1 else names[0]
    return tree_map(lambda e: sharding.NamedSharding(
        mesh, sharding.Spec(axis, *([None] * (e.ndim - 1)))), ef_tree)


def make_compressed_grad_reducer(dp, level: int = 2,
                                 detail_dtype: Optional[torch.dtype]
                                 = torch.bfloat16):
    """A tree -> tree reducer: each rank's gradient tree to its mean over
    the ranks of ``dp`` (a ``launch.mesh.DPContext``; None is one rank),
    through :func:`compressed_means`: every compressible leaf split in one
    grouped K3 launch, ``detail_dtype=None`` the exact f32 mean."""
    def reduce_tree(grads):
        paths, leaves = flatten_with_paths(grads)
        return unflatten(paths, compressed_means(leaves, dp, level,
                                                 detail_dtype))
    return reduce_tree


def split_ef(opt_state) -> Tuple[Any, Optional[Any]]:
    """``(optimizer state, residues)`` of a state wrapped as ``{"opt": ...,
    "dp_ef": ...}`` (the reference's layout under error feedback), or
    ``(opt_state, None)`` of one that is not."""
    if isinstance(opt_state, dict) and set(opt_state) == {"opt", "dp_ef"}:
        return opt_state["opt"], opt_state["dp_ef"]
    return opt_state, None


def emulated_mean(g_stack: torch.Tensor, level: int,
                  detail_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """Reference semantics of :func:`compressed_mean` on a stacked
    ``(n_ranks, ...)`` tensor, without a process group: each rank's
    payload keeps its leading length-1 axis, as in the reference."""
    n = g_stack.shape[0]
    local_shape = (1, *g_stack.shape[1:])
    if detail_dtype is None or level == 0 \
            or not compressible(local_shape, level):
        return _psum_like_sum(g_stack.float().unbind(0)) / n
    terms = [reduce_terms(g_stack[i:i + 1], level, detail_dtype)
             for i in range(n)]
    a = _psum_like_sum([t[0] for t in terms])
    ds = [_psum_like_sum([t[1][k] for t in terms])
          for k in range(len(terms[0][1]))]
    return reconstruct(a, ds, n)[0]


def emulated_mean_ef(g_stack: torch.Tensor, err_stack: torch.Tensor,
                     level: int, detail_dtype: Optional[torch.dtype]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference semantics of :func:`compressed_mean_ef` on stacked
    ``(n_ranks, ...)`` tensors.  Returns ``(mean, new_err_stack)``."""
    n = g_stack.shape[0]
    local_shape = (1, *g_stack.shape[1:])
    if detail_dtype is None or level == 0 \
            or not compressible(local_shape, level):
        return _psum_like_sum(g_stack.float().unbind(0)) / n, \
            torch.zeros_like(err_stack)
    terms, errs = [], []
    for i in range(n):
        gc = g_stack[i:i + 1].float() + err_stack[i:i + 1]
        a, ds = reduce_terms(gc, level, detail_dtype)
        errs.append(local_residual(gc, a, ds))
        terms.append((a, ds))
    a = _psum_like_sum([t[0] for t in terms])
    ds = [_psum_like_sum([t[1][k] for t in terms])
          for k in range(len(terms[0][1]))]
    return reconstruct(a, ds, n)[0], torch.cat(errs, 0)


def wire_bytes(num_elements: int, level: int, detail_bytes: int = 2,
               approx_bytes: int = 4) -> int:
    """Bytes on the wire per rank per reduction, ring all-reduce accounting
    (about twice the payload), as the reference counts them."""
    approx = num_elements >> level
    detail = num_elements - approx
    return 2 * (approx * approx_bytes + detail * detail_bytes)


def tree_wire_bytes(tree: Any, dp: Optional[DPReduceSpec]) -> int:
    """Per-rank wire bytes of one reduction of a gradient tree under ``dp``
    (``None`` or exact: f32 accounting); non-compressible leaves are
    charged at f32 either way."""
    total = 0
    for leaf in flatten_with_paths(tree)[1]:
        if dp is None or dp.exact or not compressible(leaf.shape, dp.level):
            total += wire_bytes(leaf.numel(), 0)
        else:
            total += wire_bytes(leaf.numel(), dp.level,
                                detail_bytes=dp.detail_dtype.itemsize)
    return total
