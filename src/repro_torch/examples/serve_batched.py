"""Batched serving (counterpart of ``examples/serve_batched.py``): prefill a
batch of prompts, decode greedily over KV caches, and check the tokens
against the argmax of the full forward pass.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \
        [--arch gemma2-9b] [--device cpu]

Runs the smoke config of any decoder-only arch; the default takes the
sliding-window ring-buffer cache path.
"""

from __future__ import annotations

import argparse
from typing import Tuple

import torch

from repro_torch import configs
from repro_torch.launch.serve import generate
from repro_torch.launch.train import resolve_device
from repro_torch.models import lm

AGREEMENT = 0.9   # the least share of greedy tokens equal to the full pass's


def full_pass_greedy(cfg, params, tokens: torch.Tensor, gen: int
                     ) -> torch.Tensor:
    """``gen`` greedy tokens, each from the full forward over the prompt
    and the tokens chosen so far."""
    full = tokens
    with torch.inference_mode():
        for _ in range(gen):
            logits = lm.forward(cfg, params, full)
            nxt = torch.argmax(logits[:, -1], -1)[:, None].to(full.dtype)
            full = torch.cat([full, nxt], dim=1)
    return full[:, tokens.shape[1]:]


def run(cfg, params, tokens: torch.Tensor, gen: int
        ) -> Tuple[torch.Tensor, float]:
    """Greedy ``(B, gen)`` tokens over the caches, and their agreement with
    :func:`full_pass_greedy`."""
    out = generate(cfg, params, tokens, gen)
    ref = full_pass_greedy(cfg, params, tokens, gen)
    return out, float((ref == out).float().mean())


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch)
    if cfg.arch_class == "encdec":
        raise SystemExit("decoder-only example; see tests for enc-dec decode")
    gen = torch.Generator(device=device).manual_seed(0)
    params = lm.init(cfg, gen, device).tree()
    tokens = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=device, dtype=torch.int32)
    out, match = run(cfg, params, tokens, args.gen)
    print(f"[{cfg.name}] generated {tuple(out.shape)}")
    print(f"incremental-vs-full greedy agreement: {match * 100:.1f}%")
    if not match > AGREEMENT:
        raise AssertionError("KV-cache decode diverged from full forward")
    print("OK")
    return match


if __name__ == "__main__":
    main()
