"""Time the port's launcher on the card — ``repro_torch.launch.train.main``
with its ``TrainLoop``, data source and loss fetches — for one checkout of
``src/repro_torch`` or for two compared in one run.

One checkout (prints one JSON line per run)::

    python tools/loop_time.py --src src [--runs 3] [-- LAUNCHER ARGS]

Each run trains llama-60m at full width (batch 16 x seq 256, GWT-2 f32,
the synthetic source, 20 steps, loss fetched every 5; the arguments after
``--`` are added) and reports the launcher's steady step time (``step_ms``:
host time between the first and the last loss fetch, each of which waits
for the card, over the steps between them) and, where the checkout's
launcher reports it, the watchdog's dispatch and blocked seconds per step.
Runs after the first in a process find the kernels built and loaded.

Two checkouts, compared in order A, B, B, A (each in its own process,
``--runs`` runs each; prints every line, then a summary)::

    python tools/loop_time.py --ab PARENT/src src [--rounds 2]

Unpack the parent with ``git archive`` into ``build/`` (which
``.gitignore`` lists) so that the chip copy carries it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

MAIN_ARGS = ["--arch", "llama-60m", "--steps", "20", "--batch", "16",
             "--seq", "256", "--log-every", "5", "--seed", "0"]


def time_runs(src: str, runs: int, extra) -> list:
    sys.path.insert(0, os.path.abspath(src))
    import torch

    from repro_torch.launch import train
    out = []
    for _ in range(runs):
        res = train.main(MAIN_ARGS + list(extra))
        torch.cuda.synchronize()
        wd = getattr(res, "watchdog", None) or {}
        out.append({"src": src, "step_ms": res.step_ms,
                    "dispatch_ms": None if wd.get("dispatch_s_per_step")
                    is None else wd["dispatch_s_per_step"] * 1e3,
                    "blocked_ms": None if wd.get("blocked_s_per_step")
                    is None else wd["blocked_s_per_step"] * 1e3,
                    "card": torch.cuda.get_device_name(0)})
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    extra = []
    if "--" in argv:
        cut = argv.index("--")
        argv, extra = argv[:cut], argv[cut + 1:]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default="src")
    ap.add_argument("--ab", nargs=2, metavar=("A", "B"))
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    if not args.ab:
        for line in time_runs(args.src, args.runs, extra):
            print(json.dumps(line))
        return 0
    lines = []
    order = [args.ab[0], args.ab[1], args.ab[1], args.ab[0]] * args.rounds
    for src in order:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--src", src,
             "--runs", str(args.runs), "--", *extra],
            capture_output=True, text=True, check=False)
        if res.returncode != 0:
            sys.stderr.write(res.stdout[-4000:] + res.stderr[-4000:])
            return res.returncode
        for raw in res.stdout.splitlines():
            if raw.startswith("{\"src\""):
                print(raw)
                lines.append(json.loads(raw))
    summary = {"A": args.ab[0], "B": args.ab[1], "order": order,
               "args": MAIN_ARGS + extra}
    for key in ("step_ms", "dispatch_ms", "blocked_ms"):
        for side, src in (("A", args.ab[0]), ("B", args.ab[1])):
            vals = [r[key] for r in lines
                    if r["src"] == src and r[key] is not None]
            summary[f"{key}_{side}"] = vals
            summary[f"{key}_{side}_median"] = statistics.median(vals) \
                if vals else None
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
