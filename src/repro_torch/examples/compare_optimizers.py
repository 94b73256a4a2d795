"""Optimizer shoot-out, the paper's Table II proxy (counterpart of
``examples/compare_optimizers.py``): Adam, MUON, GaLore, APOLLO, Fira and
GWT-2/GWT-3 on a tiny LLaMA, the same data and schedule for each.

    PYTHONPATH=src python -m repro_torch.examples.compare_optimizers \
        [--steps 120] [--device cpu]

Prints each method's final loss and optimizer-state memory (analytic, 2
bytes an element, ``core.gwt.state_memory_bytes``): the paper's claim
under test is that GWT matches or beats the low-rank baselines at equal or
lower memory (Table II) and stays close to full-rank Adam.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, NamedTuple, Optional

from repro_torch import optim
from repro_torch.core.gwt import state_memory_bytes
from repro_torch.data.pipeline import make_source
from repro_torch.examples.quickstart import CFG, init_params
from repro_torch.launch.train import resolve_device
from repro_torch.models import lm
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.runtime.fault_tolerance import TrainLoop

METHODS = [
    ("adam", {"lr_scale": 0.25}),          # Adam needs the smaller lr (paper)
    ("muon", {}),
    ("galore", {"rank_frac": 0.25, "alpha": 0.25, "update_gap": 50}),
    ("apollo", {"rank_frac": 0.25, "alpha": 1.0, "update_gap": 50}),
    ("fira", {"rank_frac": 0.25, "alpha": 0.25, "update_gap": 50}),
    ("gwt", {"level": 2, "alpha": 0.25}),
    ("gwt", {"level": 3, "alpha": 0.25}),
    ("gwt", {"level": 2, "alpha": 0.25, "host": "adam_mini"}),
    ("gwt", {"level": 2, "alpha": 0.25, "host": "muon"}),
]


class Row(NamedTuple):
    tag: str
    final_loss: float     # mean of the last tenth of the losses
    state_bytes: int      # analytic, 2 bytes an element
    losses: List[float]


def method_tag(name: str, kw: dict) -> str:
    if name == "gwt":
        return f"gwt-{kw.get('level')}({kw.get('host', 'adam')})"
    return name


def run_method(name: str, kw: dict, steps: int, device,
               params: Optional[Dict] = None, batch: int = 16,
               seq: int = 128) -> Row:
    """One method of the table: ``steps`` steps from ``params`` (or
    :func:`quickstart.init_params`, the same for every method)."""
    kw = dict(kw)
    lr = 0.01 * kw.pop("lr_scale", 1.0)
    if params is None:
        params = init_params(device)
    opt = optim.make(name, lr=warmup_cosine(lr, steps), **kw)
    data = make_source("synthetic", CFG.vocab, seq, batch)
    loop = TrainLoop(lm.make_train_step(CFG, opt), data, device=device,
                     log_every=10**9)
    params, _, losses = loop.run(params, opt.init(params), num_steps=steps)
    level = kw.get("level", 0) if name == "gwt" else 0
    host = kw.get("host", "adam") if name == "gwt" else "adam"
    mem = state_memory_bytes(params, level, host=host)["total_bytes"]
    k = max(1, len(losses) // 10)
    return Row(method_tag(name, kw), sum(losses[-k:]) / k, mem, losses)


def print_table(rows: List[Row]) -> None:
    print("\nmethod                  final-loss   opt-state-MiB")
    for r in sorted(rows, key=lambda r: r.final_loss):
        print(f"{r.tag:22s} {r.final_loss:10.4f} "
              f"{r.state_bytes / 2**20:12.1f}")


def main(argv=None) -> List[Row]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rows = []
    for name, kw in METHODS:
        r = run_method(name, kw, args.steps, device, batch=args.batch,
                       seq=args.seq)
        rows.append(r)
        print(f"{r.tag:22s} final_loss={r.final_loss:8.4f} "
              f"state={r.state_bytes / 2**20:7.1f}MiB")
    print_table(rows)
    return rows


if __name__ == "__main__":
    main()
