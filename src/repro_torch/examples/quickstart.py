"""Quickstart: GWT-Adam against full-rank Adam on a tiny LLaMA (counterpart
of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The public API end to end: config, init, the GWT optimizer, the train loop
and the exact optimizer-state bytes.  It shows the paper's headline:
comparable loss at a fraction of the optimizer-state memory (Table I,
Fig. 1).
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Tuple

import torch

from repro_torch import configs, optim
from repro_torch.data.pipeline import make_source
from repro_torch.launch.train import resolve_device
from repro_torch.models import lm
from repro_torch.optim.engine import state_bytes
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.runtime.fault_tolerance import TrainLoop

STEPS = 60
BATCH = 16
SEQ = 128
CFG = configs.LLAMA["llama-60m"].with_(n_layers=4, d_model=256, n_heads=4,
                                       n_kv_heads=4, head_dim=64, d_ff=688,
                                       vocab=2048, name="llama-tiny")
METHODS = [("adam", {}), ("gwt", {"level": 2}), ("gwt", {"level": 3})]


def init_params(device, seed: int = 0) -> Dict:
    """``CFG``'s weights drawn from a generator on ``device`` seeded
    ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return lm.init(CFG, gen, device).tree()


def run(optimizer_name: str, device, steps: int = STEPS,
        params: Optional[Dict] = None, batch: int = BATCH, seq: int = SEQ,
        log=print, **kw) -> Tuple[float, float]:
    """Trains ``CFG`` for ``steps`` under ``optimizer_name`` (a warmup-cosine
    schedule peaking at 0.01), from ``params`` or :func:`init_params`.
    Returns the final loss and the optimizer state's exact MiB."""
    if params is None:
        params = init_params(device)
    opt = optim.make(optimizer_name, lr=warmup_cosine(0.01, steps), **kw)
    data = make_source("synthetic", CFG.vocab, seq, batch, seed=0)
    loop = TrainLoop(lm.make_train_step(CFG, opt), data, device=device,
                     log_every=20, log=log)
    _, opt_state, losses = loop.run(params, opt.init(params),
                                    num_steps=steps)
    return losses[-1], state_bytes(opt_state) / 2**20


def tag(name: str, kw: dict) -> str:
    return name if name == "adam" else f"gwt-{kw['level']}"


def main(argv=None) -> Dict[str, Tuple[float, float]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    results = {}
    for name, kw in METHODS:
        print(f"=== {tag(name, kw)} ===")
        results[tag(name, kw)] = run(name, device, **kw)
    print("\noptimizer  final-loss  opt-state-MiB")
    for t, (loss, mem) in results.items():
        print(f"{t:9s}  {loss:10.4f}  {mem:10.1f}")
    adam_loss = results["adam"][0]
    gwt_loss = results["gwt-2"][0]
    gap = (gwt_loss / adam_loss - 1) * 100
    share = results["gwt-2"][1] / results["adam"][1] * 100
    print(f"\nGWT-2 keeps loss within {gap:+.1f}% of Adam at {share:.0f}% "
          f"of its optimizer memory")
    return results


if __name__ == "__main__":
    main()
