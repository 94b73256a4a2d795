"""Kernel launches per profiled llama-60m f32 step
(``chip_smoke.profile_step``: full width, 16 x 256, GWT-2) for one checkout
or for two compared in one run.

    python tools/launch_count.py                      # this checkout
    python tools/launch_count.py --ab build/parent .  # order A B B A

A checkout is a directory holding ``chip_smoke.py`` and ``src/`` (unpack the
parent with ``git archive`` into ``build/``, which ``.gitignore`` lists, so
that the chip copy carries it).  Each run is its own process, imports the
checkout's ``chip_smoke`` (which puts its ``src/`` first on the path) and
prints one JSON line: launches, step and update ms, device busy ms.  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

CODE = """
import json, sys
sys.path.insert(0, {root!r})
import torch
import chip_smoke as cs
p = cs.profile_step(torch.device("cuda"), "f32")
print("RESULT " + json.dumps({{"checkout": {root!r},
      "launches_per_step": p["launches_per_step"], "step_ms": p["step_ms"],
      "update_ms": p["update_ms"], "device_busy_ms": p["device_busy_ms"]}}))
"""


def run(root: str) -> str:
    root = os.path.abspath(root)
    out = subprocess.run([sys.executable, "-c", CODE.format(root=root)],
                         capture_output=True, text=True, cwd=root)
    lines = [l for l in out.stdout.splitlines() if l.startswith("RESULT ")]
    if out.returncode or not lines:
        sys.stderr.write(out.stdout[-3000:] + out.stderr[-3000:])
        raise SystemExit(f"{root}: exit {out.returncode}")
    return lines[-1][len("RESULT "):]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ab", nargs=2, metavar=("A", "B"),
                    help="two checkouts, run A B B A")
    args = ap.parse_args(argv)
    roots = [args.ab[0], args.ab[1], args.ab[1], args.ab[0]] if args.ab \
        else [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    for root in roots:
        print(run(root), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
