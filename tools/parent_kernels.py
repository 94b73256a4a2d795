"""Write an earlier revision's kernel sources where the timing scripts find
them, so that they time that revision's kernels beside the ones as built,
in the same call.

    python tools/parent_kernels.py [--rev HEAD~1]

Takes every file of ``src/repro_torch/kernels/gwt_adam/csrc`` and
``src/repro_torch/kernels/haar_dwt/csrc`` at ``REV`` (``git show``) into
``build/parent_kernels/``.  ``chip_smoke.py`` phase 1 builds that
``gwt_adam_tile.cu`` under the library name ``gwt_adam_tile@parent`` (the
same C interface) and that ``haar_dwt.cu`` as ``haar_dwt@parent``; phase 17
times the parent's K4/K5 in turns with the current ones, phase 12 its
K3/K6 (the one-leaf-a-launch design) and K7.  ``tools/tile_variants.py``
and ``tools/haar_variants.py`` do the same, and ``tools/fused_variants.py
--parent`` times that revision's K1/K2, one pass at llama-60m's buckets
and two passes at qwen2.5-3b's.  ``chip_smoke.register_parent`` skips a
parent whose C interface it does not call (a K1/K4 entry without the
moment-dtype code; a K3 already grouped).  Run it in a git checkout
before copying the repository to the card's machine: the copy keeps
``build/`` but has no git history.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CSRC = ("src/repro_torch/kernels/gwt_adam/csrc",
        "src/repro_torch/kernels/haar_dwt/csrc")
OUT = REPO / "build" / "parent_kernels"


def git(*args: str) -> str:
    return subprocess.run(["git", *args], cwd=REPO, capture_output=True,
                          text=True, check=True).stdout


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rev", default="HEAD~1")
    args = ap.parse_args()
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    names = []
    for csrc in CSRC:
        for name in git("ls-tree", "--name-only",
                        f"{args.rev}:{csrc}").split():
            (OUT / name).write_text(git("show", f"{args.rev}:{csrc}/{name}"))
            names.append(name)
    rev = git("rev-parse", "--short", args.rev).strip()
    (OUT / "REVISION").write_text(rev + "\n")
    print(f"{', '.join(names)} of {args.rev} ({rev}) -> "
          f"{OUT.relative_to(REPO)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
