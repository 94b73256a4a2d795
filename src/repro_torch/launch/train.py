"""Training launcher of the port (counterpart of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama-60m \
        --optimizer gwt --level 2 --steps 200 --batch 16 --seq 256

Runs on CUDA unless ``--device cpu`` is given; without a card and without
``--device cpu`` it raises instead of falling back to the CPU.
"""

from __future__ import annotations

import argparse
from typing import Any, List, NamedTuple, Optional

import torch

from repro_torch import configs
from repro_torch.core.gwt import gwt
from repro_torch.data.pipeline import make_source
from repro_torch.models import lm
from repro_torch.optim.engine import state_bytes
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.runtime.fault_tolerance import TrainLoop


class TrainResult(NamedTuple):
    params: Any
    opt_state: Any
    losses: List[float]
    step_ms: Optional[float]   # steady-state wall time per step


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "train on the CPU")
    return device


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-60m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config for --arch")
    ap.add_argument("--optimizer", default="gwt", choices=["gwt"])
    ap.add_argument("--level", type=int, default=2)
    ap.add_argument("--alpha", type=float, default=0.25)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get_config(args.arch))
    generator = torch.Generator(device=device).manual_seed(args.seed)
    model = lm.init(cfg, generator, device)
    params = model.tree()
    n_params = sum(p.numel() for p in model.parameters())

    source = make_source("synthetic", cfg.vocab, args.seq, args.batch,
                         seed=args.seed)
    optimizer = gwt(warmup_cosine(args.lr, args.steps), level=args.level,
                    alpha=args.alpha)
    opt_state = optimizer.init(params)

    # f32 Adam keeps m and v per parameter plus the int32 step
    mem_bytes = state_bytes(opt_state)
    adam_f32_bytes = 8 * n_params + 4
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"optimizer={args.optimizer} codec=f32 "
          f"opt_state={mem_bytes/2**20:.2f}MiB "
          f"({adam_f32_bytes/max(mem_bytes, 1):.1f}x smaller than "
          f"full-Adam f32 {adam_f32_bytes/2**20:.2f}MiB)")

    train_step = lm.make_train_step(cfg, optimizer, accum_steps=args.accum)
    loop = TrainLoop(train_step, source, device=device,
                     log_every=args.log_every)
    params, opt_state, losses = loop.run(params, opt_state,
                                         num_steps=args.steps)
    if losses:
        k = max(1, len(losses) // 10)
        print(f"final loss (mean of last {k}): {sum(losses[-k:]) / k:.4f}")
    step_ms = None if loop.steady_step_s is None \
        else loop.steady_step_s * 1e3
    return TrainResult(params, opt_state, losses, step_ms)


if __name__ == "__main__":
    main()
