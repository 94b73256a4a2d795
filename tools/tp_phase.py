"""``chip_smoke.py``'s phase 39 (the ``model`` mesh axis) alone, on the
card: the kernels' build, then each run of ``chip_smoke.TP_RUNS``
(llama-60m with f32 and int8 moments, qwen3-moe-30b-a3b's 1-layer cut,
jamba-v0.1-52b's first block, one period of xlstm-350m in f32 and in
bf16, seamless at 2+2 layers, and three ``--finetune lora`` runs:
llama-60m f32 and int8 for 5 steps, qwen2.5-3b's 2-layer cut in bf16 for
4) at world 1 and at ``--mesh 1x2`` on two processes sharing the card
(``tools/tp_rank.py``), and llama-60m f32 at ``--mesh 2`` (the data axis
alone) against world 1 at ``--accum 2``.  Every run but LoRA's records
its optimizer taps (``--metrics-dir``), rank 0's held to world 1's.
Prints the phase's lines, then its summary as one JSON line.

The LoRA runs take 4-5 steps because ``b`` starts at zero and the
schedule's first learning rate is 0: ``b`` first moves at step 2 and
``a`` first gets a nonzero gradient at step 3, so with fewer than four
steps ``a``'s moments would still be zero and a missing all-reduce of the
replicated factor's gradient would not show.

    python tools/tp_phase.py            # the phase
    python tools/tp_phase.py --spread   # and, first, world 1 against
                                        # itself at --accum 2
    python tools/tp_phase.py --runs 3,4,5   # only those runs of TP_RUNS
                                            # (and the f32 runs a bf16
                                            # one is held to)
    python tools/tp_phase.py --runs 7,8,9   # the three LoRA runs
    python tools/tp_phase.py --runs 0,1,10  # llama-60m f32 and int8 at
                                            # 1x2 and f32 at --mesh 2

``--spread`` first runs each run of ``chip_smoke.TP_RUNS`` (of
``--runs``) at world 1 twice, at ``--accum 1`` and ``--accum 2`` (the same
gradient summed in another order), and prints the second's distance from
the first as the phase measures a rank's: the losses' largest relative
difference, the state's and the parameters' move's largest leaf: the
rounding spread of the trajectory the phase's bounds sit on.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def spread(train, kernel, hk, only) -> None:
    """Each run of ``chip_smoke.TP_RUNS`` (``only``: those indices) at
    world 1 twice, at ``--accum 1`` and ``--accum 2``, and the second held
    to the first as phase 39 holds a rank: losses, and the state and
    parameters' move leaf by leaf (``chip_smoke.state_check``)."""
    import chip_smoke as cs
    for i, spec in enumerate(cs.TP_RUNS):
        if only is not None and i not in only:
            continue
        run = cs.tp_run(*spec)
        label = run["label"]
        one = cs.tp_world1(train, kernel, hk, run)
        two = cs.tp_world1(train, kernel, hk, {
            **run, "argv": run["argv"] + ["--accum", "2"]})
        rel = max(abs(a - b) / abs(a)
                  for a, b in zip(one["losses"], two["losses"]))
        worst, _ = cs.state_check(two["sketch"], one["sketch"])
        print(f"spread {label}: --accum 2 against --accum 1 at world 1: "
              f"losses {rel:.3g} relative, state {worst['opt'][0]:.3g} "
              f"of the norm (at {worst['opt'][1]}), move "
              f"{worst['params'][0]:.3g} (at {worst['params'][1]})")


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
    only = None
    if "--runs" in argv:
        only = [int(i) for i in argv[argv.index("--runs") + 1].split(",")]
    if "--spread" in argv:
        spread(train, kernel, hk, only)
    out = cs.run_tp(train, kernel, hk, only=only)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
