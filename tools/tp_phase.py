"""``chip_smoke.py``'s phase 39 (the ``model`` mesh axis) alone, on the
card: the kernels' build, then each run of ``chip_smoke.TP_RUNS``
(llama-60m with f32 and int8 moments, qwen3-moe-30b-a3b's 2-layer cut,
jamba-v0.1-52b's first block, one period of xlstm-350m in f32 and in
bf16, seamless at 2+2 layers) at world 1 and at ``--mesh 1x2`` on two processes sharing the card
(``tools/tp_rank.py``).  Prints the phase's lines, then its summary as one
JSON line.

    python tools/tp_phase.py            # the phase
    python tools/tp_phase.py --spread   # and, first, world 1 against
                                        # itself at --accum 2
    python tools/tp_phase.py --runs 3,4,5   # only those runs of TP_RUNS
                                            # (and the f32 runs a bf16
                                            # one is held to)

``--spread`` runs each dense run of ``chip_smoke.TP_RUNS`` at world 1
twice, at ``--accum 1`` and ``--accum 2`` (the same gradient summed in
another order), and prints the losses' largest relative difference a
step: the rounding spread of the trajectory the phase's loss bound sits
on.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def spread(train) -> None:
    import chip_smoke as cs
    for label, arch, layers, steps, extra in cs.TP_RUNS:
        if layers is not None:
            continue
        argv = cs.tp_argv(arch, steps, extra)
        one, two = (list(train.main(argv + ["--accum", a]).losses)
                    for a in ("1", "2"))
        rel = [abs(a - b) / abs(a) for a, b in zip(one, two)]
        print(f"spread {label}: losses {one} at --accum 1, {two} at "
              f"--accum 2; relative {rel}")


def main(argv) -> int:
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.gwt_adam import kernel
    from repro_torch.kernels.haar_dwt import kernel as hk
    from repro_torch.launch import train
    print(cs.smi())
    t0 = time.perf_counter()
    build.build_all(tuple(build.SOURCES), verbose=False)
    print(f"build {time.perf_counter() - t0:.1f} s")
    if "--spread" in argv:
        spread(train)
    only = None
    if "--runs" in argv:
        only = [int(i) for i in argv[argv.index("--runs") + 1].split(",")]
    out = cs.run_tp(train, kernel, hk, only=only)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
