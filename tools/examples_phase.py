"""``chip_smoke.py``'s phase 38 (the paper's example drivers) alone, on the
card: the kernels' build, then ``quickstart``, ``compare_optimizers``,
``pretrain`` (llama-130m, resumed from half, bitwise), ``serve_batched``
and ``live_update_bytes`` of one llama-60m update, fused against staged.
Prints the phase's lines, then its summary as one JSON line.

    python tools/examples_phase.py
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.gwt_adam import kernel
    from repro_torch.kernels.haar_dwt import kernel as hk
    print(cs.smi())
    t0 = time.perf_counter()
    build.build_all(tuple(build.SOURCES), verbose=False)
    print(f"build {time.perf_counter() - t0:.1f} s")
    out = cs.run_examples(kernel, hk, torch.device("cuda"))
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
