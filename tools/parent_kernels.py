"""Write an earlier revision's GWT-Adam kernel sources where the timing
scripts find them, so that they time that revision's kernels beside the
ones as built, in the same call.

    python tools/parent_kernels.py [--rev HEAD~1]

Takes every file of ``src/repro_torch/kernels/gwt_adam/csrc`` at ``REV``
(``git show``) into ``build/parent_kernels/``.  ``chip_smoke.py`` phase 17
builds that ``gwt_adam_tile.cu`` under the library name
``gwt_adam_tile@parent`` (the same C interface) and times its K4/K5 in
turns with the current ones; ``tools/tile_variants.py`` does the same, and
``tools/fused_variants.py --parent`` times that revision's K1/K2 one pass.
Run it in a git checkout before copying the repository to the card's
machine: the copy keeps ``build/`` but has no git history.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CSRC = "src/repro_torch/kernels/gwt_adam/csrc"
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
    names = git("ls-tree", "--name-only", f"{args.rev}:{CSRC}").split()
    for name in names:
        (OUT / name).write_text(git("show", f"{args.rev}:{CSRC}/{name}"))
    rev = git("rev-parse", "--short", args.rev).strip()
    (OUT / "REVISION").write_text(rev + "\n")
    print(f"{', '.join(names)} of {args.rev} ({rev}) -> "
          f"{OUT.relative_to(REPO)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
