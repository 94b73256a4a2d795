"""``chip_smoke.py``'s phase 37 (sharded parameters) alone, on the card:
the kernels' build, then ``--shard-params auto`` against ``none`` under a
one-rank NCCL group at qwen2.5-3b (full width and depth) and llama-60m
(int8 moments, compressed means).  Prints the phase's lines, then its
summary as one JSON line.

    python tools/shard_phase.py
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.gwt_adam import kernel
    from repro_torch.kernels.haar_dwt import kernel as hk
    from repro_torch.launch import train
    print(cs.smi())
    t0 = time.perf_counter()
    build.build_all(tuple(build.SOURCES), verbose=False)
    print(f"build {time.perf_counter() - t0:.1f} s")
    out = cs.run_sharding(train, kernel, hk)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
