"""Encoder-decoder backbone, the seamless-m4t-large-v2 config
(counterpart of ``repro/models/encdec.py``).

The audio front end is the reference's stub: precomputed frame embeddings
``(B, S_frames, d_model)`` (``data.pipeline.WithEncoderFrames``) feed the
encoder, a stack of bidirectional self-attention and SwiGLU blocks.  Each
decoder block is causal self-attention, cross-attention to the encoder's
output, and a SwiGLU MLP; training is teacher-forced, decoding cached (the
self-attention K/V written in place, the cross K/V computed once at
prefill).

Parameters keep the reference's paths, the blocks stacked on a leading
layers axis: ``embed``, ``encoder/...`` ``(n_enc_layers, ...)``,
``enc_norm``, ``decoder/...`` ``(n_dec_layers, ...)``, ``final_norm``.

Along the ``model`` mesh axis (train mode, ``tp=``) the self-attention of
both stacks and the MLPs split as the decoder-only stack's do; the
cross-attention splits ``wq``/``wo`` by heads and ``wk``/``wv`` by KV heads
(or reads its heads' KV heads from whole ones), the encoder's output
entering each rank's heads through ``copy_in``; the tied embedding and the
loss split the vocab where the axis divides it (256206 divides 2, not 4).
No kernel here: the reference writes none (stock ops)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import sharding, tensor_parallel
from repro_torch.models import attention, lm, rope as rope_lib
from repro_torch.models.layers import (Axes, Builder, cross_entropy,
                                       embed_apply, embed_init, logits_apply,
                                       mlp_apply, mlp_init, rms_norm)
from repro_torch.optim.base import flatten_with_paths, tree_map, unflatten


def _xattn_init(b: Builder, cfg, lead=()) -> dict:
    d, hd, H, KV = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    return {"wq": b.param((d, H * hd), ("embed", "heads"), lead=lead),
            "wk": b.param((d, KV * hd), ("embed", "kv_heads"), lead=lead),
            "wv": b.param((d, KV * hd), ("embed", "kv_heads"), lead=lead),
            "wo": b.param((H * hd, d), ("heads", "embed"), lead=lead)}


def _xattn_apply(p, cfg, x, kv_src=None, kv_cache=None, tp=None):
    """Cross-attention: q from ``x``, k/v from ``kv_src`` (the encoder's
    output) or from ``kv_cache`` (decode).  Returns ``(output, {"k",
    "v"})``.

    ``tp`` (train mode; heads as ``tensor_parallel.heads_split`` says):
    this rank's query heads and ``wo`` rows, its KV heads where those
    split, else the range its query heads read from the whole ``wk``/``wv``
    (``tensor_parallel.kv_heads_of``); the output's partial sums reduced
    over the model group."""
    tp, kv_split = tensor_parallel.heads_split(tp, cfg)
    B, S, _ = x.shape
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    wk, wv, kv_idx = p["wk"], p["wv"], None
    if tp is not None:
        tensor_parallel.train_only(
            tp, "train" if kv_cache is None else "decode", "cross-attention")
        x, kv_src = tp.copy_in(x), tp.copy_in(kv_src)
        H = H // tp.size
        if not kv_split:
            lo, hi, kv_idx = tensor_parallel.kv_heads_of(tp, cfg)
            wk, wv = (tp.copy_in(w)[..., lo * hd:hi * hd] for w in (wk, wv))
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    if kv_cache is not None:
        k, v = kv_cache["k"], kv_cache["v"]
    else:
        T = kv_src.shape[1]
        k = (kv_src @ wk).reshape(B, T, -1, hd)
        v = (kv_src @ wv).reshape(B, T, -1, hd)
    kr = attention._repeat_kv(k, H, kv_idx)
    vr = attention._repeat_kv(v, H, kv_idx)
    if S * k.shape[1] > 4096 * 4096:   # long cross-attention: chunked
        o = attention._flash_attn_noncausal(q, kr, vr)
    else:
        o = attention._direct_attn(q, kr, vr, causal_offset=int(1e9),
                                   window=0, cap=0.0)
    o = o.reshape(B, S, H * hd) @ p["wo"]
    return (o if tp is None else tp.reduce_out(o)), {"k": k, "v": v}


def _enc_block_init(b: Builder, cfg, lead) -> dict:
    d = cfg.d_model
    return {"norm1": b.param((d,), (None,), init="zeros", lead=lead),
            "attn": attention.attn_init(b, cfg, lead=lead),
            "norm2": b.param((d,), (None,), init="zeros", lead=lead),
            "mlp": mlp_init(b, d, cfg.d_ff, lead=lead)}


def _dec_block_init(b: Builder, cfg, lead) -> dict:
    d = cfg.d_model
    return {"norm1": b.param((d,), (None,), init="zeros", lead=lead),
            "self_attn": attention.attn_init(b, cfg, lead=lead),
            "norm_x": b.param((d,), (None,), init="zeros", lead=lead),
            "cross_attn": _xattn_init(b, cfg, lead=lead),
            "norm2": b.param((d,), (None,), init="zeros", lead=lead),
            "mlp": mlp_init(b, d, cfg.d_ff, lead=lead)}


def _build(cfg, generator: Optional[torch.Generator], device,
           mode: str = "init") -> Dict[str, Any]:
    b = Builder(generator, device, cfg.torch_dtype, mode)
    return {
        "embed": embed_init(b, cfg.vocab, cfg.d_model, cfg.tie_embeddings),
        "encoder": _enc_block_init(b, cfg, (cfg.n_enc_layers,)),
        "enc_norm": b.param((cfg.d_model,), (None,), init="zeros"),
        "decoder": _dec_block_init(b, cfg, (cfg.n_dec_layers,)),
        "final_norm": b.param((cfg.d_model,), (None,), init="zeros"),
    }


class EncDec(lm.LM):
    """Holds the encoder-decoder parameters; ``forward(tokens,
    enc_embeds)`` gives the teacher-forced logits."""

    def forward(self, tokens: torch.Tensor,
                enc_embeds: torch.Tensor) -> torch.Tensor:
        tree = self.tree()
        return decode_stack(self.cfg, tree, tokens,
                            encode(self.cfg, tree, enc_embeds))[0]


def init(cfg, generator: torch.Generator, device) -> EncDec:
    """Random init from ``generator`` (on ``device``), the JAX package's
    scheme (see ``lm.init``)."""
    return EncDec(cfg, _build(cfg, generator, device))


def abstract_params(cfg, shardings=None) -> Dict[str, Any]:
    """The parameter tree on the ``meta`` device; with ``shardings`` (a
    placement tree, e.g. ``sharding.tp_step_shardings(...).params``) each
    rank's local shapes (``lm.abstract_params``)."""
    p = _build(cfg, None, "meta")
    return p if shardings is None else sharding.local_meta(p, shardings)


def param_axes(cfg) -> Dict[str, Any]:
    """The parameter tree's logical axes (``lm.param_axes``)."""
    return _build(cfg, None, "meta", mode="axes")


def _layers(stacked):
    """The per-layer subtrees of a stack (views, unbound once: the
    backward then stacks the per-layer gradients)."""
    paths, leaves = flatten_with_paths(stacked)
    return [unflatten(paths, ls) for ls in zip(*(l.unbind(0)
                                                 for l in leaves))]


def _remat(cfg, fn, *args):
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def encode(cfg, params, enc_embeds: torch.Tensor, tp=None) -> torch.Tensor:
    """The encoder over the frames ``enc_embeds`` (B, S, d), cast to the
    model dtype: bidirectional self-attention blocks, then ``enc_norm``.
    ``tp``: each block's attention and MLP over this rank's shards."""
    B, S, _ = enc_embeds.shape
    cos, sin = rope_lib.rope_angles(
        torch.arange(S, device=enc_embeds.device), cfg.head_dim,
        cfg.rope_theta)
    tpm = tensor_parallel.split(tp, cfg.d_ff)

    def body(bp, x):
        h = rms_norm(x, bp["norm1"], cfg.norm_eps)
        h, _ = attention.attn_apply(bp["attn"], cfg, h, cos, sin,
                                    mode="train", bidirectional=True, tp=tp)
        x = x + h
        h = rms_norm(x, bp["norm2"], cfg.norm_eps)
        return x + mlp_apply(bp["mlp"], h, tpm)

    x = enc_embeds.to(cfg.torch_dtype)
    for bp in _layers(params["encoder"]):
        x = _remat(cfg, body, bp, x)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _dec_block(cfg, bp, x, cos, sin, enc_out, mode, cache, pos, tp=None):
    h = rms_norm(x, bp["norm1"], cfg.norm_eps)
    h, new_self = attention.attn_apply(
        bp["self_attn"], cfg, h, cos, sin, mode=mode,
        cache=None if cache is None else cache["self"], pos=pos, tp=tp)
    x = x + h
    h = rms_norm(x, bp["norm_x"], cfg.norm_eps)
    h, new_cross = _xattn_apply(
        bp["cross_attn"], cfg, h, kv_src=enc_out,
        kv_cache=cache["cross"] if (cache is not None and mode == "decode")
        else None, tp=tp)
    x = x + h
    h = rms_norm(x, bp["norm2"], cfg.norm_eps)
    return (x + mlp_apply(bp["mlp"], h, tensor_parallel.split(tp, cfg.d_ff)),
            new_self, new_cross)


def decode_stack(cfg, params, tokens: torch.Tensor,
                 enc_out: Optional[torch.Tensor], *, mode: str = "train",
                 caches=None, tp=None):
    """The decoder over ``tokens`` (B, S).  Returns ``(logits,
    new_caches)``:

    * ``"train"``: teacher-forced logits (B, S, V) against ``enc_out``;
      no caches;
    * ``"prefill"``: the last position's logits (B, 1, V) and the caches
      ``{"dec": {"self": {"k", "v"}, "cross": {"k", "v"}}, "pos": S}``,
      each stacked on the layers axis; the self-attention K/V are the
      prompt's (grow them with ``launch.serve.pad_cache``), the cross K/V
      the encoder output's projections;
    * ``"decode"`` (``enc_out`` None): one token a row at ``caches["pos"]``
      (a host int), the self-attention K/V written into ``caches`` in
      place, the cross K/V read; ``pos`` advances by one.

    The serving modes run under inference mode.  ``tp`` (train mode):
    the blocks over this rank's shards, and the logits its vocab columns
    where the vocab splits."""
    tensor_parallel.train_only(tp, mode, "encoder-decoder decoding")
    if mode != "train":
        with torch.inference_mode():
            return _decode_stack(cfg, params, tokens, enc_out, mode, caches)
    if caches is not None:
        raise ValueError("train mode takes no caches")
    return _decode_stack(cfg, params, tokens, enc_out, mode, None, tp)


def _decode_stack(cfg, params, tokens, enc_out, mode, caches, tp=None):
    B, S = tokens.shape
    dev = tokens.device
    tpv = tensor_parallel.split(tp, cfg.vocab)
    x = embed_apply(params["embed"], tokens, cfg.d_model, tpv)
    if mode == "decode":
        if caches is None:
            raise ValueError("decode needs the prefill's caches")
        pos = caches["pos"]
        positions = torch.full((B, S), pos, device=dev)
    elif mode in ("train", "prefill"):
        if caches is not None:
            raise ValueError(f"{mode} builds its caches: pass none")
        pos = None
        positions = torch.arange(S, device=dev)
    else:
        raise ValueError(f"encoder-decoder mode {mode!r}")
    cos, sin = rope_lib.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    stacked = None if caches is None else caches["dec"]
    new = []
    for idx, bp in enumerate(_layers(params["decoder"])):
        # a layer's caches are views of the stacked ones: written in place
        bc = None if stacked is None else tree_map(lambda c: c[idx], stacked)
        if mode == "train":
            x, _, _ = _remat(cfg, _dec_block, cfg, bp, x, cos, sin, enc_out,
                             mode, None, None, tp)
        else:
            x, ns, nx = _dec_block(cfg, bp, x, cos, sin, enc_out, mode, bc,
                                   pos)
            new.append({"self": ns, "cross": nx})
    if mode == "prefill":
        x = x[:, -1:]   # only the last position's logits are consumed
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_apply(params["embed"], x, tpv)
    if mode == "train":
        return logits, None
    if mode == "prefill":
        return logits, {"dec": tree_map(lambda *cs: torch.stack(cs), *new),
                        "pos": S}
    return logits, {"dec": stacked, "pos": pos + 1}


def loss_fn(cfg, params, batch, tp=None) -> torch.Tensor:
    """Mean cross-entropy of the teacher-forced decoder on
    ``batch["enc_embeds"]``'s encoding.  ``tp``: the tensor-parallel
    forward over this rank's shards (the same loss on every rank of the
    model group)."""
    enc_out = encode(cfg, params, batch["enc_embeds"], tp)
    logits, _ = decode_stack(cfg, params, batch["tokens"], enc_out, tp=tp)
    tpv = tensor_parallel.split(tp, cfg.vocab)
    if tpv is None:
        return cross_entropy(logits, batch["labels"])
    return tensor_parallel.vocab_cross_entropy(logits, batch["labels"], tpv)


def make_train_step(cfg, optimizer, accum_steps: int = 1, dp_reduce=None,
                    dp=None, loss=None, taps: bool = False, shardings=None,
                    tp=None):
    """``lm.make_train_step`` over :func:`loss_fn` (``loss`` swaps the
    objective, as there; ``dp_reduce`` routes to the data-parallel step
    with this module's loss, its parameters placed by ``shardings``;
    ``taps`` adds ``metrics["taps"]``; ``tp`` with ``shardings`` from
    ``sharding.tp_step_shardings`` is the tensor-parallel step, as
    there)."""
    return lm.make_train_step(cfg, optimizer, accum_steps=accum_steps,
                              dp_reduce=dp_reduce, dp=dp,
                              loss=loss or loss_fn, taps=taps,
                              shardings=shardings, tp=tp)


def _build_cache(cfg, b: Builder, B: int, max_len: int, enc_len: int
                 ) -> Dict[str, Any]:
    def kv(T):
        return {n: b.param((B, T, cfg.n_kv_heads, cfg.head_dim),
                           ("batch", "seq", "kv_heads", None), init="zeros",
                           lead=(cfg.n_dec_layers,))
                for n in ("k", "v")}
    return {"self": kv(max_len), "cross": kv(enc_len)}


def init_cache(cfg, B: int, max_len: int, enc_len: int, device
               ) -> Dict[str, Any]:
    """Zeroed decode caches: per decoder layer (stacked) the
    self-attention K/V ``(B, max_len, KV, hd)`` and the cross K/V ``(B,
    enc_len, KV, hd)``, in the model dtype; ``pos = 0``."""
    return {"dec": _build_cache(cfg, Builder(None, device, cfg.torch_dtype),
                                B, max_len, enc_len), "pos": 0}


def abstract_cache(cfg, B: int, max_len: int, enc_len: int
                   ) -> Dict[str, Any]:
    """:func:`init_cache`'s tree on the ``meta`` device, ``pos`` an
    ``int32`` scalar."""
    return {"dec": _build_cache(cfg, Builder(None, "meta", cfg.torch_dtype),
                                B, max_len, enc_len),
            "pos": torch.empty((), dtype=torch.int32, device="meta")}


def cache_axes(cfg) -> Dict[str, Any]:
    """:func:`init_cache`'s tree of logical axes (``layers.Axes``)."""
    b = Builder(None, "meta", cfg.torch_dtype, mode="axes")
    return {"dec": _build_cache(cfg, b, 1, 2, 2), "pos": Axes(())}


def make_prefill_step(cfg):
    """``(params, {"tokens": (B, S), "enc_embeds": (B, F, d)}) -> (last
    logits (B, V), caches)``."""
    def prefill_step(params, batch):
        with torch.inference_mode():
            enc_out = encode(cfg, params, batch["enc_embeds"])
        logits, caches = decode_stack(cfg, params, batch["tokens"], enc_out,
                                      mode="prefill")
        return logits[:, -1], caches
    return prefill_step


def make_decode_step(cfg):
    """``(params, caches, {"tokens": (B, 1)}) -> (logits (B, V), caches)``,
    the self-attention caches written in place."""
    def decode_step(params, caches, batch):
        logits, new = decode_stack(cfg, params, batch["tokens"], None,
                                   mode="decode", caches=caches)
        return logits[:, -1], new
    return decode_step
