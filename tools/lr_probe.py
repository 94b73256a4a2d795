"""Does a full-width depth cut's loss rise under the optimizer, or under
the step size?  Trains the cut through ``repro_torch.launch.train`` with
GWT-2 and with Adam, each at several peak learning rates, and prints each
run's per-step losses and whether the last is above the first.

    python tools/lr_probe.py [--arch deepseek-67b] [--layers 2] \
        [--lrs 0.01,0.001] [--steps 5] [--batch 16] [--seq 256]

Every width is the published config's (``chip_smoke.depth_cut``); the
data are the launcher's synthetic batches, seed 0.  Runs on the card.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="deepseek-67b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--lrs", default="0.01,0.001")
    ap.add_argument("--optimizers", default="gwt,adam")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.launch import train
    print(cs.smi())
    t0 = time.perf_counter()
    build.build_all(tuple(build.SOURCES), verbose=False)
    print(f"build {time.perf_counter() - t0:.1f} s")
    runs = []
    for opt in args.optimizers.split(","):
        for lr in args.lrs.split(","):
            with cs.depth_cut(args.arch, args.layers):
                t1 = time.perf_counter()
                res = train.main(["--arch", args.arch, "--optimizer", opt,
                                  "--lr", lr, "--steps", str(args.steps),
                                  "--batch", str(args.batch), "--seq",
                                  str(args.seq), "--log-every", "1",
                                  "--seed", "0"])
                torch.cuda.synchronize()
            run = {"arch": args.arch, "layers": args.layers,
                   "optimizer": opt, "lr": float(lr),
                   "losses": res.losses,
                   "rises": res.losses[-1] > res.losses[0],
                   "wall_s": time.perf_counter() - t1}
            runs.append(run)
            print(f"{args.arch} ({args.layers} layers) {opt} lr {lr}: "
                  f"losses {res.losses}; "
                  f"{'rises' if run['rises'] else 'falls'}")
            del res
            gc.collect()
            torch.cuda.empty_cache()
    print(cs.smi())
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
