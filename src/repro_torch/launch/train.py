"""Training launcher of the port (counterpart of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama-60m \
        --optimizer gwt --level 2 --steps 200 --batch 16 --seq 256 \
        [--state-codec int8] [--ckpt-dir D --ckpt-every N --resume]

Runs on CUDA unless ``--device cpu`` is given; without a card and without
``--device cpu`` it raises instead of falling back to the CPU.

Fault tolerance: with ``--ckpt-dir`` the loop checkpoints every
``--ckpt-every`` steps and at the end, in the JAX package's format;
SIGTERM -> checkpoint at the next chunk boundary -> clean exit; a restart
with ``--resume`` continues from the latest committed step with the data
stream aligned, bitwise as if it had not stopped.  A checkpoint written
under the other ``--state-codec`` is transcoded on resume.
"""

from __future__ import annotations

import argparse
from typing import Any, List, NamedTuple, Optional

import torch

from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager, \
    StructureMismatch
from repro_torch.core.gwt import gwt
from repro_torch.data.pipeline import make_source
from repro_torch.models import lm
from repro_torch.optim import engine
from repro_torch.optim.base import tree_map
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.runtime.fault_tolerance import TrainLoop


class TrainResult(NamedTuple):
    params: Any
    opt_state: Any
    losses: List[float]
    step_ms: Optional[float]   # steady-state wall time per step
    start_step: int = 0        # the step the run resumed from


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "train on the CPU")
    return device


def _meta(tree):
    """The shapes and dtypes of a tensor tree, on the ``meta`` device."""
    return tree_map(lambda t: torch.empty_like(t, device="meta"), tree)


def resume(ckpt: CheckpointManager, params, opt_state, make_optimizer,
           codec: str, data_meta: dict, device, log=print):
    """Restore ``{"params", "opt"}`` from the latest checkpoint.  A state
    saved under another codec is restored in its own layout and transcoded
    to ``codec``.  Returns ``(params, opt_state, step)``."""
    saved_data = ckpt.saved_run().get("data")
    if saved_data is not None:
        for k in ("kind", "corpus_hash", "order_seed"):
            if k in saved_data and saved_data[k] != data_meta.get(k):
                raise SystemExit(
                    f"--resume provenance mismatch: checkpoint in {ckpt.dir} "
                    f"was trained with data {k}={saved_data[k]!r}, this run "
                    f"has {data_meta.get(k)!r}; refusing to continue on a "
                    f"different data stream")
    try:
        state, start = ckpt.restore(None, {"params": params,
                                           "opt": opt_state})
        return state["params"], state["opt"], start
    except StructureMismatch as e:
        saved_codec = ckpt.saved_run().get("state_codec", "f32")
        if "'leaves'" in ckpt.manifest().get("treedef", ""):
            raise StructureMismatch(
                f"checkpoint in {ckpt.dir} holds the legacy per-leaf "
                f"optimizer state, which the port does not migrate; resume "
                f"it once with the JAX package to rewrite it") from e
        if saved_codec == codec:
            raise StructureMismatch(
                f"checkpoint in {ckpt.dir} does not match this run's "
                f"optimizer state; did --optimizer/--level or the model "
                f"config change since it was saved? ({e})") from e
    saved_opt = make_optimizer(saved_codec)
    like = saved_opt.init(_meta(params))
    state, start = ckpt.restore(None, {"params": params, "opt": like},
                                device=device)
    new_opt = make_optimizer(codec)
    opt_state = engine.transcode(state["opt"], state["params"], saved_opt,
                                 new_opt)
    log(f"transcoded optimizer state {saved_codec} -> {codec}")
    return state["params"], opt_state, start


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-60m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config for --arch")
    ap.add_argument("--optimizer", default="gwt", choices=["gwt"])
    ap.add_argument("--level", type=int, default=2)
    ap.add_argument("--state-codec", default="f32", choices=["f32", "int8"],
                    help="optimizer-state substrate: 'f32' raw moments, "
                         "'int8' blocked 8-bit moments (one absmax scale per "
                         "64 elements, stochastic rounding); --resume "
                         "transcodes a checkpoint of the other codec")
    ap.add_argument("--alpha", type=float, default=0.25)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
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

    def make_optimizer(codec: str):
        return gwt(warmup_cosine(args.lr, args.steps), level=args.level,
                   alpha=args.alpha, state_codec=codec)

    optimizer = make_optimizer(args.state_codec)
    opt_state = optimizer.init(params)

    # f32 Adam keeps m and v per parameter plus the int32 step
    mem_bytes = engine.state_bytes(opt_state)
    adam_f32_bytes = 8 * n_params + 4
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"optimizer={args.optimizer} codec={args.state_codec} "
          f"opt_state={mem_bytes/2**20:.2f}MiB "
          f"({adam_f32_bytes/max(mem_bytes, 1):.1f}x smaller than "
          f"full-Adam f32 {adam_f32_bytes/2**20:.2f}MiB)")

    # data provenance, stamped into every manifest: a resume on another
    # data stream fails instead of training on
    data_meta = {"kind": "synthetic", "order_seed": args.seed}
    run_meta = {"data": data_meta, "state_codec": args.state_codec}
    ckpt = CheckpointManager(args.ckpt_dir, run_meta=run_meta) \
        if args.ckpt_dir else None
    start = 0
    if args.resume and ckpt is not None and ckpt.latest_step() is not None:
        params, opt_state, start = resume(
            ckpt, params, opt_state, make_optimizer, args.state_codec,
            data_meta, device)
        params = lm.LM(cfg, params).tree()
        print(f"resumed from step {start}")

    train_step = lm.make_train_step(cfg, optimizer, accum_steps=args.accum)
    loop = TrainLoop(train_step, source, device=device, ckpt=ckpt,
                     ckpt_every=args.ckpt_every, log_every=args.log_every)
    params, opt_state, losses = loop.run(params, opt_state, start_step=start,
                                         num_steps=args.steps)
    if losses:
        k = max(1, len(losses) // 10)
        print(f"final loss (mean of last {k}): {sum(losses[-k:]) / k:.4f}")
    step_ms = None if loop.steady_step_s is None \
        else loop.steady_step_s * 1e3
    return TrainResult(params, opt_state, losses, step_ms, start)


if __name__ == "__main__":
    main()
