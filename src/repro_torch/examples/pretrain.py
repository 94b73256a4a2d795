"""End-to-end pre-training driver (counterpart of ``examples/pretrain.py``):
a ~100M LLaMA trained with GWT-Adam for a few hundred steps, with
checkpoint and restart.

    PYTHONPATH=src python -m repro_torch.examples.pretrain \
        [--model llama-130m] [--steps 300] [--batch 16] [--seq 256] \
        [--ckpt-dir D] [--device cpu]

The paper's Table II setting: the module-wise GWT policy, lr 0.01, alpha
0.25, a cosine schedule and the norm-growth limiter.  SIGTERM-safe; run
again with the same ``--ckpt-dir`` to resume.  ``--ckpt-every`` (100, the
reference's fixed interval) sets how often a checkpoint is written.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import List

from repro_torch.launch import train as train_cli


def launcher_argv(argv=None) -> List[str]:
    """The launcher's arguments for this driver's command line."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="llama-130m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--level", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_pretrain_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--data", default="synthetic")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return ["--arch", args.model, "--optimizer", "gwt",
            "--level", str(args.level), "--alpha", "0.25", "--lr", "0.01",
            "--steps", str(args.steps), "--batch", str(args.batch),
            "--seq", str(args.seq), "--data", args.data,
            "--ckpt-dir", args.ckpt_dir,
            "--ckpt-every", str(args.ckpt_every), "--resume",
            "--device", args.device]


def main(argv=None) -> train_cli.TrainResult:
    return train_cli.main(launcher_argv(argv))


if __name__ == "__main__":
    main()
