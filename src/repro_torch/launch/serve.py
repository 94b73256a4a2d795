"""Serving launcher of the port (counterpart of ``repro/launch/serve.py``):
the continuous-batching engine's command line, and the small dense
``generate`` the tests and checks hold the engine against.

    # continuous batching over a slot-paged KV cache, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-60m \
        --requests 16 --prompt-len 32 --gen 16 --num-slots 4

    # int8 KV pages, serving a training checkpoint of the port or of the
    # JAX package; --device cpu runs on the CPU (the tests)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-60m \
        --smoke --ckpt runs/smoke/ckpt --kv-quant int8 --device cpu

    # a --finetune lora checkpoint: its adapters are merged into the base
    # at load (detected from its run metadata; --merge-lora --lora-rank R
    # --lora-alpha A for one written without it)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-60m \
        --ckpt runs/ft

The engine serves full-attention decoder stacks.  The recurrent configs
(jamba's mamba blocks, xLSTM) and the windowed or M-RoPE ones decode
through :func:`generate`, the dense path (their caches hold each
recurrent block's state beside the K/V); the encoder-decoder config is
refused here: its decoding is ``models.encdec.decode_stack``.

Runs on CUDA unless ``--device cpu`` is given; without a card it raises
instead of falling back to the CPU.  The engine lives in
:mod:`repro_torch.serve.engine`; this module builds a workload and prints
the stats.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import configs, obs
from repro_torch.launch.train import resolve_device
from repro_torch.models import blocks, lm
from repro_torch.serve.engine import Engine, EngineConfig, Request


def _map_kv(fn, cache: Mapping[str, Any]):
    """``fn`` over the K/V leaves (dict key ``k`` or ``v``, 4 or more
    dims) of a cache tree; every other entry is kept."""
    out = {}
    for name, x in cache.items():
        if isinstance(x, Mapping):
            out[name] = _map_kv(fn, x)
        elif name in ("k", "v") and x.ndim >= 4:
            out[name] = fn(x)
        else:
            out[name] = x
    return out


def pad_cache(cache, max_len: int, window: int = 0):
    """Grow full-attention prefill caches (depth = prompt) to decode
    capacity ``max_len``; only ``k``/``v`` leaves grow (a recurrent
    block's state keeps its shape).  Ring-buffer caches (depth =
    ``window``) stay: their slot arithmetic needs ``prompt % window == 0``
    (checked at prefill).  The sequence axis is -3 of ``(..., S, KV, hd)``, stacked
    ``(L, B, S, KV, hd)`` or flat ``(B, S, KV, hd)``.  Growing is one-way;
    check the result with :func:`ensure_capacity` before decoding."""
    def grow(x):
        if x.shape[-3] < max_len and x.shape[-3] != window:
            return F.pad(x, (0, 0, 0, 0, 0, max_len - x.shape[-3]))
        return x
    return _map_kv(grow, cache)


def ensure_capacity(cache, needed: int, window: int = 0):
    """Raise unless every full-attention K/V leaf can hold ``needed``
    positions.  The JAX package's decode write past an undersized cache
    would silently clamp (XLA's dynamic_update_slice) and corrupt the last
    row; the port's would stop mid-generation with an index error.  Either
    way, this check fails at the call site.  Ring-buffer leaves (depth ==
    ``window``) wrap by construction.  Returns ``cache``."""
    def check(x):
        if x.shape[-3] != window and x.shape[-3] < needed:
            raise ValueError(
                f"KV cache depth {x.shape[-3]} < {needed} required: decode "
                f"writes past the end would silently clamp (XLA) or fail "
                f"mid-generation: grow the cache with pad_cache(cache, "
                f"{needed}) first")
        return x
    _map_kv(check, cache)
    return cache


def grow_for_decode(cfg, cache, max_len: int):
    """:func:`pad_cache` block by block: a windowed block's ring buffer
    (depth ``cfg.window``) stays, every full-attention block's K/V grows to
    ``max_len``.  By depth alone a full-attention block whose prompt is
    ``cfg.window`` long looks like a ring buffer; the JAX package's
    ``generate`` leaves it at that depth, and its decode writes then clamp
    onto the prompt's last row."""
    out = dict(cache)
    for group in ("layers", "rem"):
        if group not in cache:
            continue
        out[group] = {}
        for name, blk in cache[group].items():
            local = blocks.parse_kind(cfg.pattern[int(name[1:])])[0] \
                == "attn_local"
            out[group][name] = pad_cache(blk, max_len,
                                         window=cfg.window if local else 0)
    return out


def generate(cfg, params, tokens: torch.Tensor, gen_len: int
             ) -> torch.Tensor:
    """Greedy ``(B, gen_len)`` continuation of ``tokens`` (B, S) over dense
    caches: one prefill, then ``gen_len - 1`` decode steps."""
    if isinstance(params, lm.LM):
        params = params.tree()
    B, S = tokens.shape
    prefill = lm.make_prefill_step(cfg)
    decode = lm.make_decode_step(cfg)
    logits, cache = prefill(params, {"tokens": tokens})
    cache = ensure_capacity(grow_for_decode(cfg, cache, S + gen_len),
                            S + gen_len, window=cfg.window)
    out = []
    nxt = torch.argmax(logits, -1)[:, None]
    for _ in range(gen_len):
        out.append(nxt)
        logits, cache = decode(params, cache, {"tokens": nxt})
        nxt = torch.argmax(logits, -1)[:, None]
    return torch.cat(out, dim=1)


def build_workload(n: int, vocab: int, max_prompt: int, max_gen: int,
                   rate: float, seed: int):
    """Mixed-length serving workload: prompts uniform in
    [max_prompt//4, max_prompt]; generation lengths BIMODAL, 75% short
    (~max_gen/16..max_gen/8, chat-style turns) and 25% long
    (3·max_gen/4..max_gen, completion-style), the length skew that makes
    static waves idle their short-request slots behind the long tail.
    ``rate`` > 0 adds Poisson (exponential inter-arrival) open-loop
    arrivals at that many req/s; 0 backlogs everything at t=0.  The same
    draws as the JAX package's."""
    rng = np.random.RandomState(seed)
    t = 0.0
    reqs = []
    for i in range(n):
        plen = int(rng.randint(max(1, max_prompt // 4), max_prompt + 1))
        if rng.rand() < 0.25:
            glen = int(rng.randint(max(2, 3 * max_gen // 4), max_gen + 1))
        else:
            glen = int(rng.randint(max(1, max_gen // 16),
                                   max(2, max_gen // 8) + 1))
        if rate > 0:
            t += float(rng.exponential(1.0 / rate))
        reqs.append(Request(
            rid=i, prompt=rng.randint(0, vocab, size=plen).tolist(),
            max_gen=glen, arrival=t if rate > 0 else 0.0))
    return reqs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-60m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt", default=None,
                    help="training checkpoint dir to serve (params-only "
                         "load); default: random init")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="open-loop Poisson arrival rate (req/s); "
                         "0 = backlogged")
    ap.add_argument("--num-slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--kv-quant", default=None, choices=[None, "int8"])
    ap.add_argument("--eos-id", type=int, default=None,
                    help="retire a request early when it generates this "
                         "token (default: max_gen-bounded only)")
    ap.add_argument("--merge-lora", action="store_true",
                    help="treat --ckpt as a --finetune lora checkpoint: "
                         "restore {'base','lora'} and serve the merged "
                         "weights (checkpoints the launcher wrote are "
                         "detected from their run metadata without it)")
    ap.add_argument("--lora-rank", type=int, default=8,
                    help="adapter rank for --merge-lora on checkpoints "
                         "without run metadata")
    ap.add_argument("--lora-alpha", type=float, default=16.0)
    ap.add_argument("--static", action="store_true",
                    help="static-wave admission (the benchmark baseline)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--metrics-dir", default="",
                    help="telemetry directory: per-request JSONL records "
                         "-> <dir>/metrics.jsonl (emitted at retirement, "
                         "so a killed run keeps its completed requests) "
                         "and per-tick Chrome-trace spans and counters "
                         "(queue depth, slot occupancy, page-arena "
                         "utilization) -> <dir>/trace.json")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if cfg.arch_class == "encdec":
        raise SystemExit(
            "the serving engine is decoder-only; encoder-decoder decoding "
            "is repro_torch.models.encdec.decode_stack (make_prefill_step "
            "and make_decode_step; tests/test_torch_encdec.py holds it "
            "against teacher forcing)")
    ecfg = EngineConfig(num_slots=args.num_slots, page_size=args.page_size,
                        max_ctx=args.prompt_len + args.gen,
                        prefill_chunk=args.prefill_chunk,
                        kv_quant=args.kv_quant, eos_id=args.eos_id)
    tel = obs.configure(args.metrics_dir or None,
                        run={"cmd": "serve", "arch": args.arch,
                             "ckpt": args.ckpt, "requests": args.requests,
                             "num_slots": args.num_slots,
                             "kv_quant": args.kv_quant,
                             "static": args.static, "seed": args.seed,
                             "device": str(device)})
    try:
        if args.ckpt:
            eng = Engine.from_checkpoint(
                cfg, args.ckpt, ecfg, device=device,
                merge_lora=True if args.merge_lora else None,
                lora_rank=args.lora_rank, lora_alpha=args.lora_alpha)
        else:
            gen = torch.Generator(device=device).manual_seed(args.seed)
            eng = Engine(cfg, lm.init(cfg, gen, device), ecfg)
        reqs = build_workload(args.requests, cfg.vocab, args.prompt_len,
                              args.gen, args.rate, args.seed)
        eng.warmup()
        stats = eng.run(reqs, static=args.static)
        stats["kv_arena_bytes"] = eng.kv_bytes()
        stats["mode"] = "static" if args.static else "continuous"
        tel.emit("serve_summary", **stats)
        print(json.dumps(stats, indent=2, sort_keys=True))
    finally:
        obs.shutdown()   # writes <metrics-dir>/trace.json
    return stats


if __name__ == "__main__":
    main()
