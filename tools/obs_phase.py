"""``chip_smoke.py``'s phase 36 (observability) alone, on the card, after
the runs it compares with: the kernels' build, phases 5-6 (the launcher at
full-width llama-60m, f32 and int8) and phase 9's f32 profile (the taps-off
launches per step).  Prints each phase's lines, then phase 36's summary as
one JSON line.

    python tools/obs_phase.py
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
    from repro_torch.launch import train
    dev = torch.device("cuda")
    print(cs.smi())
    t0 = time.perf_counter()
    build.build_all(tuple(build.SOURCES), verbose=False)
    print(f"build {time.perf_counter() - t0:.1f} s")
    res32, _, _ = cs.run_main_path(train, kernel, hk, "f32")
    res8, _, _ = cs.run_main_path(train, kernel, hk, "int8")
    prof32 = cs.profile_step(dev, "f32")
    out = cs.run_observability(train, kernel, hk, dev, res32, res8, prof32)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
