"""Decoder-only LM (counterpart of ``repro/models/lm.py``): parameter
construction, the forward pass, the loss, the gradient-accumulated train
step, and the serving caches and steps (dense prefill/decode, and the paged
decode and chunk-prefill steps of ``repro_torch.serve.engine``).

Parameters live in a nested dict with the JAX package's paths
(``layers/b0/mixer/wq``, ...): the ``n_periods`` whole periods of
``cfg.pattern`` stacked on a leading ``(n_periods, ...)`` axis under
``layers`` (absent when there is none), the ``rem_layers`` remainder blocks
unstacked under ``rem/b{i}``.  :class:`LM` is the ``nn.Module`` that holds
them; the functions here take the nested dict, as the JAX functions take
the pytree.

The MoE blocks' Switch auxiliary loss is summed over periods and remainder
blocks in the JAX package's order and enters the loss as ``CE + AUX_COEF *
aux``.  M-RoPE configs (``cfg.mrope_sections``) take a batch's
``mrope_positions`` (3, B, S), or broadcast the 1-D positions to it.

A period may mix attention and recurrent blocks (jamba's mamba, xLSTM's
mLSTM and sLSTM): the dense serving caches then hold K/V beside each
recurrent block's state (``blocks.block_cache``), and decode updates both
in place.  The encoder-decoder stack is ``models/encdec.py``.

The train forward and the loss take ``tp`` (the ``model`` mesh axis,
``distributed.tensor_parallel``): every block kind of a period (jamba's
attention, mamba and MoE blocks side by side), a tied or untied head over
its vocab rows, as ``sharding.tp_rules`` places them.
"""

from __future__ import annotations

import functools
import inspect
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import compression, sharding, tensor_parallel
from repro_torch.models import blocks, rope as rope_lib
from repro_torch.models.layers import (Axes, Builder, cross_entropy,
                                       embed_apply, embed_init, logits_apply,
                                       rms_norm, softcap)
from repro_torch.optim.base import flatten_with_paths, tree_map, unflatten

AUX_COEF = 0.01  # MoE load-balance loss weight, as the JAX package


class ParamTree(nn.Module):
    """A nested dict of tensors registered as parameters and submodules
    under the same keys."""

    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, Mapping):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def tree(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self._parameters)
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


class LM(nn.Module):
    """Holds the stacked parameters; ``forward(tokens)`` gives logits."""

    def __init__(self, cfg, params: Mapping[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.params = ParamTree(params)

    def tree(self) -> Dict[str, Any]:
        """The parameters as the nested dict the optimizer and the
        functions of this module take (the tensors themselves, not
        copies)."""
        return self.params.tree()

    def forward(self, tokens: torch.Tensor,
                mrope_positions: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        return forward(self.cfg, self.tree(), tokens,
                       mrope_positions=mrope_positions)


def _build(cfg, generator: Optional[torch.Generator], device,
           mode: str = "init") -> Dict[str, Any]:
    b = Builder(generator, device, cfg.torch_dtype, mode)
    p: Dict[str, Any] = {"embed": embed_init(b, cfg.vocab, cfg.d_model,
                                             cfg.tie_embeddings)}
    if cfg.n_periods > 0:
        p["layers"] = {f"b{i}": blocks.block_init(b, cfg, kind,
                                                 lead=(cfg.n_periods,))
                       for i, kind in enumerate(cfg.pattern)}
    if cfg.rem_layers:
        p["rem"] = {f"b{i}": blocks.block_init(b, cfg, cfg.pattern[i])
                    for i in range(cfg.rem_layers)}
    p["final_norm"] = b.param((cfg.d_model,), (None,), init="zeros")
    return p


def init(cfg, generator: torch.Generator, device) -> LM:
    """Random init from ``generator`` (which must live on ``device``) with
    the JAX package's scheme: fan-in normal weights, scale-1.0 embedding,
    zero norms."""
    return LM(cfg, _build(cfg, generator, device))


def abstract_params(cfg, shardings=None) -> Dict[str, Any]:
    """The parameter tree on the ``meta`` device: shapes and dtypes only;
    with ``shardings`` (a placement tree, e.g. ``sharding.
    tp_step_shardings(...).params``) each rank's local shapes."""
    p = _build(cfg, None, "meta")
    return p if shardings is None else sharding.local_meta(p, shardings)


def param_count(cfg) -> int:
    """The number of parameters of ``cfg`` (counted on the ``meta``
    device)."""
    return sum(t.numel() for t in flatten_with_paths(abstract_params(cfg))[1])


def param_axes(cfg) -> Dict[str, Any]:
    """The parameter tree's logical axes (``layers.Axes`` leaves), the
    JAX package's ``param_axes``: the stacked periods' leaves lead with
    ``"layers"``.  Builds nothing on any device."""
    return _build(cfg, None, "meta", mode="axes")


def _block(cfg, kind: str, p, x, cos, sin, tp=None):
    """One block: ``(x, aux)``; with ``cfg.remat`` its activations are
    recomputed in the backward instead of kept (the reference's memory
    contract; the values are the same).  Under ``tp`` the recompute runs
    the block's collectives again, in the same order on every rank."""
    if cfg.remat:
        x, _, aux = checkpoint(blocks.block_apply, p, cfg, kind, x, cos,
                               sin, use_reentrant=False, tp=tp)
    else:
        x, _, aux = blocks.block_apply(p, cfg, kind, x, cos, sin, tp=tp)
    return x, aux


def _add_aux(total, aux):
    """Sum the blocks' aux losses as the JAX package's scan does, from an
    f32 zero; MLP blocks (None) add nothing."""
    if aux is None:
        return total
    return (torch.zeros((), dtype=torch.float32, device=aux.device)
            if total is None else total) + aux


def _angles(cfg, positions, mrope_positions, B, S):
    """cos/sin for ``positions`` ((S,) or (B, S)); an M-RoPE config rotates
    by ``mrope_positions`` (3, B, S), or by ``positions`` broadcast to it."""
    if cfg.mrope_sections:
        if mrope_positions is None:
            mrope_positions = positions.expand(3, B, S)
        return rope_lib.mrope_angles(mrope_positions, cfg.head_dim,
                                     cfg.rope_theta, cfg.mrope_sections)
    return rope_lib.rope_angles(positions, cfg.head_dim, cfg.rope_theta)


def forward(cfg, params, tokens: torch.Tensor, *, mode: str = "train",
            caches=None, mrope_positions: Optional[torch.Tensor] = None):
    """Forward over ``tokens`` (B, S): each period's blocks in
    ``cfg.pattern`` order, then the remainder blocks, the final norm, the
    head and the final softcap.

    ``mode="train"`` returns the logits (B, S, V).  The serving modes
    return ``(logits, new_caches)`` and run under inference mode, without
    remat:

    * ``"prefill"`` (no ``caches``): the last position's logits (B, 1, V)
      and the dense caches the prompt fills, ``pos = S``;
    * ``"decode"`` with dense ``caches`` (``init_cache``, or a padded
      prefill's; ``pos`` a host int): one token per row, written into the
      caches in place; ``pos`` advances by one;
    * ``"decode"`` / ``"chunk_prefill"`` with paged caches (the pools of
      ``init_paged_caches`` plus ``"pos"``, a per-slot length tensor, and
      ``"page_table"``): one token per slot, or one slot's (1, C) chunk at
      positions ``pos[0] .. pos[0]+C-1`` with the full chunk logits (the
      prompt's last position may land mid-chunk).  The pools are written
      in place.

    ``mrope_positions`` (3, B, S) rotates an M-RoPE config in train mode
    and the dense serving modes (the paged engine refuses M-RoPE, as the
    JAX package's does).
    """
    if mode != "train":
        with torch.inference_mode():
            return _serve_forward(cfg, params, tokens, mode, caches,
                                  mrope_positions)
    if caches is not None:
        raise ValueError("train mode takes no caches")
    return _train_forward(cfg, params, tokens, mrope_positions)[0]


def _train_forward(cfg, params, tokens, mrope_positions=None, tp=None):
    """Train-mode logits and the summed aux loss (None without MoE).
    ``tp`` (a ``distributed.tensor_parallel.TP``): ``params`` are this
    rank's shards of ``sharding.tp_rules``' placement, and the logits are
    its vocab columns where the vocab splits."""
    B, S = tokens.shape
    tpv = tensor_parallel.split(tp, cfg.vocab)
    x = embed_apply(params["embed"], tokens, cfg.d_model, tpv)
    cos, sin = _angles(cfg, torch.arange(S, device=tokens.device),
                       mrope_positions, B, S)
    aux_total = None
    if "layers" in params:
        # unbind once: the backward then stacks the per-layer gradients
        # instead of scattering each layer's into a full-size zero tensor
        paths, leaves = flatten_with_paths(params["layers"])
        for ls in zip(*(l.unbind(0) for l in leaves)):
            layer = unflatten(paths, ls)
            aux_p = None
            for i, kind in enumerate(cfg.pattern):
                x, aux = _block(cfg, kind, layer[f"b{i}"], x, cos, sin,
                                tp)
                aux_p = _add_aux(aux_p, aux)
            aux_total = _add_aux(aux_total, aux_p)
    aux_r = None
    for i in range(cfg.rem_layers):
        x, aux = _block(cfg, cfg.pattern[i], params["rem"][f"b{i}"], x, cos,
                        sin, tp)
        aux_r = _add_aux(aux_r, aux)
    aux_total = _add_aux(aux_total, aux_r)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_apply(params["embed"], x, tpv)
    if cfg.final_softcap:
        logits = softcap(logits, cfg.final_softcap)
    return logits, aux_total


def _period(cfg, pattern, p, x, cos, sin, mode, caches, pos, page_table):
    """The blocks of one period (or the remainder) in a serving mode:
    ``(x, {"b{i}": new cache})``."""
    new = {}
    for i, kind in enumerate(pattern):
        c = None if caches is None else caches[f"b{i}"]
        x, new[f"b{i}"], _ = blocks.block_apply(
            p[f"b{i}"], cfg, kind, x, cos, sin, mode=mode, cache=c, pos=pos,
            page_table=page_table)
    return x, new


def _serve_forward(cfg, params, tokens, mode, caches, mrope_positions):
    B, S = tokens.shape
    dev = tokens.device
    if mode == "prefill":
        if caches is not None:
            raise ValueError("prefill builds its caches: pass none")
        pos = page_table = None
        positions = torch.arange(S, device=dev)
    elif caches is None:
        raise ValueError(f"mode {mode!r} needs caches")
    else:
        pos, page_table = caches["pos"], caches.get("page_table")
        if page_table is not None:
            # per-slot positions: each slot rotates at its own fill level
            positions = pos[:, None] + (
                torch.arange(S, device=dev)[None, :]
                if mode == "chunk_prefill" else 0)
        elif mode == "decode":
            positions = torch.full((B, S), pos, device=dev)
        else:
            raise ValueError(f"mode {mode!r} needs a page table")
    if mrope_positions is not None and page_table is not None:
        raise NotImplementedError("paged serving does not thread "
                                  "multimodal rope position trees")
    x = embed_apply(params["embed"], tokens, cfg.d_model)
    cos, sin = _angles(cfg, positions, mrope_positions, B, S)
    new: Dict[str, Any] = {}
    if "layers" in params:
        paths, leaves = flatten_with_paths(params["layers"])
        stacked = None if caches is None else caches["layers"]
        periods = []
        for idx, ls in enumerate(zip(*(l.unbind(0) for l in leaves))):
            # a period's caches are views of the stacked ones: written in
            # place, they need no restacking
            pc = None if stacked is None \
                else tree_map(lambda c: c[idx], stacked)
            x, nc = _period(cfg, cfg.pattern, unflatten(paths, ls), x, cos,
                            sin, mode, pc, pos, page_table)
            periods.append(nc)
        new["layers"] = stacked if stacked is not None else tree_map(
            lambda *cs: torch.stack(cs), *periods)
    if cfg.rem_layers:
        x, new["rem"] = _period(cfg, cfg.pattern[:cfg.rem_layers],
                                params["rem"], x, cos, sin, mode,
                                None if caches is None else caches["rem"],
                                pos, page_table)
    if mode == "prefill":
        # only the last position's logits are consumed: full-sequence
        # logits over a 152k or 262k vocab are GiBs
        x = x[:, -1:]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_apply(params["embed"], x)
    if cfg.final_softcap:
        logits = softcap(logits, cfg.final_softcap)
    if mode == "prefill":
        new["pos"] = S
    else:
        new["pos"] = pos + (1 if mode == "decode" else S)
        if page_table is not None:
            new["page_table"] = page_table
    return logits, new


def _build_cache(cfg, b: Builder, B: int, max_len: int) -> Dict[str, Any]:
    """The per-block dense caches from ``b``, without ``pos``."""
    cache: Dict[str, Any] = {}
    if cfg.n_periods > 0:
        cache["layers"] = {
            f"b{i}": blocks.block_cache(b, cfg, kind, B, max_len,
                                        lead=(cfg.n_periods,))
            for i, kind in enumerate(cfg.pattern)}
    if cfg.rem_layers:
        cache["rem"] = {f"b{i}": blocks.block_cache(b, cfg, cfg.pattern[i],
                                                    B, max_len)
                        for i in range(cfg.rem_layers)}
    return cache


def init_cache(cfg, B: int, max_len: int, device) -> Dict[str, Any]:
    """Zeroed dense decode caches for ``B`` rows of ``max_len`` positions:
    per block ``{"k", "v"}`` (see ``blocks.block_cache``), the periods'
    stacked on a leading ``n_periods`` axis as ``params["layers"]`` is,
    and ``pos = 0``."""
    cache = _build_cache(cfg, Builder(None, device, cfg.torch_dtype), B,
                         max_len)
    cache["pos"] = 0
    return cache


def abstract_cache(cfg, B: int, max_len: int) -> Dict[str, Any]:
    """:func:`init_cache`'s tree on the ``meta`` device, ``pos`` an
    ``int32`` scalar: shapes and dtypes only."""
    cache = _build_cache(cfg, Builder(None, "meta", cfg.torch_dtype), B,
                         max_len)
    cache["pos"] = torch.empty((), dtype=torch.int32, device="meta")
    return cache


def cache_axes(cfg, B: int = 1, max_len: int = 2) -> Dict[str, Any]:
    """:func:`init_cache`'s tree of logical axes (``layers.Axes``), the
    stacked periods' leading with ``"layers"``; ``pos`` has none."""
    cache = _build_cache(cfg, Builder(None, "meta", cfg.torch_dtype,
                                      mode="axes"), B, max_len)
    cache["pos"] = Axes(())
    return cache


def _build_paged_caches(cfg, b: Builder, num_pages: int, page_size: int,
                        kv_quant: Optional[str]) -> Dict[str, Any]:
    cache: Dict[str, Any] = {}
    if cfg.n_periods > 0:
        cache["layers"] = {
            f"b{i}": blocks.block_paged_cache(b, cfg, kind, num_pages,
                                              page_size, kv_quant,
                                              lead=(cfg.n_periods,))
            for i, kind in enumerate(cfg.pattern)}
    if cfg.rem_layers:
        cache["rem"] = {f"b{i}": blocks.block_paged_cache(
            b, cfg, cfg.pattern[i], num_pages, page_size, kv_quant)
            for i in range(cfg.rem_layers)}
    return cache


def init_paged_caches(cfg, num_pages: int, page_size: int,
                      kv_quant: Optional[str] = None, device="cuda"
                      ) -> Dict[str, Any]:
    """The serving arena: one ``(num_pages, page_size, KV, hd)`` pool per K
    and V per block (``{"q": int8, "scale": f32}`` with ``kv_quant=
    "int8"``), stacked over periods as the dense caches are.  No ``pos`` or
    ``page_table``: the engine owns those and passes them per call."""
    return _build_paged_caches(cfg, Builder(None, device, cfg.torch_dtype),
                               num_pages, page_size, kv_quant)


def abstract_paged_caches(cfg, num_pages: int, page_size: int,
                          kv_quant: Optional[str] = None) -> Dict[str, Any]:
    """:func:`init_paged_caches`' tree on the ``meta`` device."""
    return _build_paged_caches(cfg, Builder(None, "meta", cfg.torch_dtype),
                               num_pages, page_size, kv_quant)


def make_prefill_step(cfg):
    """``(params, {"tokens": (B, S)[, "mrope_positions": (3, B, S)]}) ->
    (last logits (B, V), caches)``."""
    def prefill_step(params, batch):
        logits, caches = forward(
            cfg, params, batch["tokens"], mode="prefill",
            mrope_positions=batch.get("mrope_positions"))
        return logits[:, -1], caches
    return prefill_step


def make_decode_step(cfg):
    """``(params, caches, {"tokens": (B, 1)[, "mrope_positions": (3, B,
    1)]}) -> (logits (B, V), caches)`` over dense caches, written in
    place."""
    def decode_step(params, caches, batch):
        logits, new = forward(cfg, params, batch["tokens"], mode="decode",
                              caches=caches,
                              mrope_positions=batch.get("mrope_positions"))
        return logits[:, -1], new
    return decode_step


def make_paged_decode_step(cfg):
    """One serving decode tick: ``tokens (num_slots, 1)``, every slot every
    tick (inactive slots carry trash-page rows and length 0, masked out).
    Returns ``(logits (num_slots, V), pools)``, the pools written in
    place."""
    def step(params, pools, page_table, lens, tokens):
        caches = dict(pools, pos=lens, page_table=page_table)
        logits, _ = forward(cfg, params, tokens, mode="decode",
                            caches=caches)
        return logits[:, -1], pools
    return step


def make_chunk_prefill_step(cfg):
    """Page in ONE slot's next prompt chunk: ``tokens (1, C)`` at positions
    ``filled[0] .. filled[0]+C-1``, ``page_table`` that slot's row ``(1,
    max_pages)``.  Returns the full ``(1, C, V)`` chunk logits and the
    pools, written in place."""
    def step(params, pools, page_table, filled, tokens):
        caches = dict(pools, pos=filled, page_table=page_table)
        logits, _ = forward(cfg, params, tokens, mode="chunk_prefill",
                            caches=caches)
        return logits, pools
    return step


def loss_fn(cfg, params, batch, tp=None) -> torch.Tensor:
    """Mean cross-entropy, plus ``AUX_COEF`` times the MoE blocks' summed
    load-balancing loss where the model has MoE blocks.  ``tp``: the
    tensor-parallel forward over this rank's shards (the same loss on every
    rank of the model group)."""
    logits, aux = _train_forward(cfg, params, batch["tokens"],
                                 batch.get("mrope_positions"), tp)
    tpv = tensor_parallel.split(tp, cfg.vocab)
    loss = cross_entropy(logits, batch["labels"]) if tpv is None \
        else tensor_parallel.vocab_cross_entropy(logits, batch["labels"],
                                                 tpv)
    return loss if aux is None else loss + AUX_COEF * aux


def microbatch_split(batch: Dict[str, torch.Tensor], accum: int
                     ) -> Dict[str, torch.Tensor]:
    """``(B, ...) -> (accum, B/accum, ...)`` with microbatch ``a`` holding
    global rows ``m·accum + a``, the JAX package's layout;
    ``mrope_positions`` (3, B, S) is split on its batch axis 1, into
    ``(accum, 3, B/accum, S)``."""
    out = {}
    for k, v in batch.items():
        if k == "mrope_positions":
            mb = v.shape[1] // accum
            out[k] = v.reshape(3, mb, accum, v.shape[2]).permute(2, 0, 1, 3)
        else:
            mb = v.shape[0] // accum
            out[k] = v.reshape(mb, accum, *v.shape[1:]).transpose(0, 1)
    return out


def contiguous_microbatches(batch: Dict[str, torch.Tensor], accum: int
                            ) -> Dict[str, torch.Tensor]:
    """``(B, ...) -> (accum, B/accum, ...)`` in contiguous row blocks, the
    split of the JAX package's sharded step: logical shard ``s`` holds rows
    ``[s·B/S, (s+1)·B/S)`` whether ``s`` is a rank, a microbatch or both."""
    out = {}
    for k, v in batch.items():
        bdim = 1 if k == "mrope_positions" else 0   # (3, B, S)
        if v.shape[bdim] % accum:
            raise ValueError(f"local batch {v.shape[bdim]} not divisible "
                             f"by accum_steps={accum}")
        if bdim:
            out[k] = v.reshape(3, accum, v.shape[1] // accum, v.shape[2]) \
                .transpose(0, 1)
        else:
            out[k] = v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
    return out


def _accumulate(cfg, params, leaves, micro, accum_steps, loss=None,
                dtype=None):
    """f32 gradient sums and the loss sum over the microbatches.  A leaf
    that does not require grad (the frozen LoRA base) gets no gradient:
    its sum is None.

    With ``dtype``, the gradient means in ``dtype`` and the mean loss, as
    the train step hands them to the update: each f32 sum dies as its leaf
    is cast.  One microbatch then takes no f32 sums at all (``(0 + g) / 1``
    cast is ``g + 0`` cast, exact; a -0 becomes +0 either way), and each raw
    gradient dies as its leaf is cast, so a model whose f32 sums would not
    fit beside its state still trains (jamba's cut on the card)."""
    loss = loss or loss_fn
    train = [l for l in leaves if l.requires_grad]
    direct = dtype is not None and accum_steps == 1
    out = None if direct else [
        torch.zeros(l.shape, dtype=torch.float32, device=l.device)
        for l in train]
    lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for a in range(accum_steps):
        mb = {k: v[a] for k, v in micro.items()}
        lval = loss(cfg, params, mb)
        grads = torch.autograd.grad(lval, train)
        if direct:
            out = list(grads)
        else:
            for s, g in zip(out, grads):
                s.add_(g.float())
        del grads
        lsum = lsum + lval.detach()
    if dtype is not None:
        for i, s in enumerate(out):
            out[i] = None    # one leaf at a time: the sum or gradient dies
            out[i] = (s + 0.0 if direct else s / accum_steps).to(dtype)
            del s
        lsum = lsum / accum_steps
    it = iter(out)
    return [next(it) if l.requires_grad else None for l in leaves], lsum


def make_sharded_train_step(cfg, optimizer, *, dp, dp_reduce,
                            accum_steps: int = 1, loss=None,
                            shardings=None, tp=None, taps: bool = False):
    """Data-parallel train step over the ranks of ``dp`` (a
    ``launch.mesh.DPContext``; None is one rank), counterpart of the JAX
    package's ``make_sharded_train_step``.

    Rank ``r`` of ``D`` takes the contiguous rows ``[r·B/D, (r+1)·B/D)`` of
    the global batch and splits them into contiguous microbatches.  Its f32
    gradient means are reduced by ``distributed.compression.compressed_means``
    (exact f32 or wavelet-compressed, every compressible leaf split in one
    grouped launch, then summed over the ranks leaf by leaf in flatten
    order; with error feedback when ``dp_reduce.error_feedback``), then cast
    to ``cfg.dtype`` for ``optimizer.update``.  The returned loss is the mean
    over ranks.

    With error feedback the state is ``{"opt": <optimizer state>, "dp_ef":
    <residues>}``, each residue leaf ``(1, *param_shape)`` f32: this rank's
    row of the reference's ``(D, *param_shape)``.

    Numerics: the gradient is the mean over ``D × accum_steps`` contiguous
    shards, summed shard by shard in order, so in the exact mode ``D`` ranks
    with accum 1 equal one rank with accum ``D`` bitwise.

    ``shardings`` (a ``distributed.sharding.StepShardings``; the
    sharded-parameter layout, ``--shard-params auto``): the step takes and
    returns the parameters as this rank's shards of ``shardings.params``.
    It gathers them whole at its start, runs the forward, the backward and
    the reduction as above, updates (the optimizer built with
    ``state_shardings=shardings.opt["buckets"]`` keeps its state placed),
    and keeps this rank's slices of the new parameters.  Every rank holds
    the same reduced gradient and computes the same update, so the numbers
    are the replicated step's, bitwise.

    ``tp`` (a ``distributed.tensor_parallel.TP`` over ``model``, with
    ``shardings`` from ``sharding.tp_step_shardings``): the tensor-parallel
    step.  The parameters stay this rank's shards through the forward and
    the backward (:func:`loss_fn`, or ``loss``, called with ``tp=``; a loss
    without that keyword is refused: it has no tensor-parallel form; LoRA's
    ``models.lora.loss_module`` merges each rank's shards), the data
    ranks' exact mean
    reduces each shard's gradient, and the update (``optimizer.update(...,
    param_shardings=)``) gathers each bucket's parameters, gradients and
    state whole over ``model``, runs on them as the replicated update does,
    and keeps this rank's slices.  Row-parallel sums and the vocab-split
    loss reorder f32/bf16 additions, so the numbers are the replicated
    step's within rounding, not bitwise.

    ``taps=True`` updates through the optimizer's ``tapped_update`` (with
    ``param_shardings=`` under ``tp``) and returns its per-bucket scalars
    as ``metrics["taps"]``, as :func:`make_train_step` does: read off the
    reduced gradient and the whole buckets, so every rank holds the same
    taps and their keys are one rank's.  Ignored when the optimizer has no
    tapped channel; refused with error feedback (the residues are not
    tapped)."""
    param_sh = None if shardings is None else shardings.params
    if tp is not None:
        if shardings is None:
            raise ValueError("tp= needs shardings=sharding."
                             "tp_step_shardings(...)")
        if loss is not None and "tp" not in inspect.signature(
                loss).parameters:
            raise ValueError("the tensor-parallel step calls its loss with "
                             "tp=; a loss without it has no "
                             "tensor-parallel form")
        # the objective's tensor-parallel form: this module's loss_fn, or
        # the one passed (encdec.loss_fn), each taking tp=
        loss = functools.partial(loss or loss_fn, tp=tp)
    if isinstance(dp_reduce, str):
        dp_reduce = compression.DPReduceSpec.parse(dp_reduce)
    if dp_reduce is None:
        raise ValueError("dp_reduce None/'none' is the plain step: call "
                         "make_train_step")
    ef_on = dp_reduce.error_feedback and not dp_reduce.exact
    if taps and ef_on:
        raise ValueError("taps=True is not supported with error feedback: "
                         "run taps-off or drop --dp-error-feedback")
    tapped = getattr(optimizer, "tapped_update", None) if taps else None
    level, wire = dp_reduce.level, dp_reduce.detail_dtype
    rank, world = (0, 1) if dp is None else (dp.rank, dp.world)

    def train_step(params, opt_state, batch):
        if ef_on:
            opt_state, ef = compression.split_ef(opt_state)
            if ef is None:
                raise ValueError(
                    "error-feedback train step expects opt_state = "
                    "{'opt': <optimizer state>, 'dp_ef': "
                    "compression.ef_init(params)}")
        rows = batch["tokens"].shape[0]
        if rows % world:
            raise ValueError(f"global batch {rows} not divisible by "
                             f"{world} ranks")
        per = rows // world
        # mrope_positions (3, B, S) splits on its batch axis 1
        local = {k: v[:, rank * per:(rank + 1) * per]
                 if k == "mrope_positions" else v[rank * per:(rank + 1) * per]
                 for k, v in batch.items()}
        if tp is None:
            # the whole parameter tree lives only inside the step
            params = sharding.gather_tree(params, param_sh)
        paths, leaves = flatten_with_paths(params)
        gsum, lsum = _accumulate(cfg, params, leaves,
                                 contiguous_microbatches(local, accum_steps),
                                 accum_steps, loss)
        loss_mean = compression.exact_mean(lsum / accum_steps, dp)
        # the leaves without a gradient (LoRA's frozen base) take no
        # reduction and keep a None gradient
        trained = [i for i, s in enumerate(gsum) if s is not None]
        # the means in place: the f32 sums are not needed again
        gmean = [gsum[i].div_(accum_steps) for i in trained]
        del gsum
        if ef_on:
            means, errs = compression.compressed_means_ef(
                gmean, [e[0] for e in flatten_with_paths(ef)[1]], dp, level,
                wire)
            new_ef = [err[None] for err in errs]
        else:
            means = compression.compressed_means(gmean, dp, level, wire)
        del gmean
        for i, m in enumerate(means):   # each f32 mean dies as it is cast
            means[i] = None
            means[i] = m.to(cfg.torch_dtype)
            del m
        full = [None] * len(paths)
        for i, m in zip(trained, means):
            full[i] = m
        grads = unflatten(paths, full)
        del leaves, means, full
        metrics = {"loss": loss_mean}
        # under tp the update gathers each bucket whole over 'model'
        kw = {} if tp is None else {"param_shardings": param_sh}
        if tapped is not None:
            params, opt_state, metrics["taps"] = tapped(grads, opt_state,
                                                        params, **kw)
        else:
            params, opt_state = optimizer.update(grads, opt_state, params,
                                                 **kw)
        del grads
        if tp is None:
            params = sharding.shard_tree(params, param_sh)
        if ef_on:
            opt_state = {"opt": opt_state, "dp_ef": unflatten(paths, new_ef)}
        return params, opt_state, metrics

    return train_step


def make_train_step(cfg, optimizer, accum_steps: int = 1, dp_reduce=None,
                    dp=None, loss=None, taps: bool = False, shardings=None,
                    tp=None):
    """Gradient-accumulated train step ``(params, opt_state, batch) ->
    (params, opt_state, {"loss": f32 scalar on the device})``.

    Gradients are summed in f32 over the microbatches, divided by
    ``accum_steps`` and cast to ``cfg.dtype`` before the update, as the JAX
    step does (with one microbatch the same values come without the f32
    sums: :func:`_accumulate`).  The optimizer writes the parameters in
    place.

    ``dp_reduce`` is the caller's reduction (the launcher's
    ``--dp-reduce``): a ``distributed.compression.DPReduceSpec`` or
    ``'exact'`` / ``'compressed'`` routes to :func:`make_sharded_train_step`
    over ``dp`` (a ``launch.mesh.DPContext``; None is one rank), with the
    parameters placed by ``shardings`` there (refused without
    ``dp_reduce`` or ``tp``, as the JAX package pins a layout only on that
    path).  Left None, the exact f32 mean is implicit wherever there is
    more than one rank to reduce over, as GSPMD's mean is in the JAX
    package: ``dp`` of several data ranks (``dp.world > 1``, a ``--mesh D``
    run) or ``tp`` (the model axis of ``dp``, ``distributed.
    tensor_parallel.from_dp``, with ``shardings`` from
    ``sharding.tp_step_shardings``: the tensor-parallel step) routes to
    :func:`make_sharded_train_step` with ``'exact'``.

    ``loss`` (``loss(cfg, params, batch) -> scalar``, default
    :func:`loss_fn`) swaps the objective, as the JAX package's ``loss=``
    does (``models/lora.py`` merges adapters there).  Leaves that do not
    require grad get a ``None`` gradient, which only a frozen rule
    (``optim.engine.FROZEN``) takes.

    ``taps=True`` routes the update through the optimizer's
    ``tapped_update`` and adds its per-bucket scalars to the metrics as
    ``metrics["taps"]`` (device tensors; DESIGN.md §12).  It is ignored
    when the optimizer has no tapped channel, and refused with the
    caller's ``dp_reduce``, as in the JAX package; with the implicit exact
    mean the sharded step carries them (one rank's keys and numbers up to
    the reduction's rounding)."""
    if isinstance(dp_reduce, str):
        dp_reduce = compression.DPReduceSpec.parse(dp_reduce)  # 'none': None
    if dp_reduce is not None:
        if taps:
            raise ValueError("taps=True is not supported on the sharded "
                             "dp_reduce path: run taps-off or drop "
                             "dp_reduce")
    elif shardings is not None and tp is None:
        raise ValueError("shardings= places the parameters of the "
                         "dp_reduce step only: pass dp_reduce")
    elif tp is not None or (dp is not None and dp.world > 1):
        dp_reduce = compression.DPReduceSpec.parse("exact")
    if dp_reduce is not None:
        return make_sharded_train_step(cfg, optimizer, dp=dp,
                                       dp_reduce=dp_reduce,
                                       accum_steps=accum_steps, loss=loss,
                                       shardings=shardings, tp=tp,
                                       taps=taps)
    tapped = getattr(optimizer, "tapped_update", None) if taps else None

    def train_step(params, opt_state, batch):
        paths, leaves = flatten_with_paths(params)
        # the f32 sums die inside, as XLA frees a buffer after its last
        # use: the update then runs beside the cast gradients only
        grads, loss_val = _accumulate(cfg, params, leaves,
                                      microbatch_split(batch, accum_steps),
                                      accum_steps, loss, cfg.torch_dtype)
        grads = unflatten(paths, grads)
        if tapped is not None:
            params, opt_state, tp = tapped(grads, opt_state, params)
            return params, opt_state, {"loss": loss_val, "taps": tp}
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss_val}

    return train_step
