"""The seconds of each phase of ``chip_smoke.py`` whose depth was cut, at
its old depth and at its new one, in one call on the card (the host's
speed swings by a third between calls, so only one call compares them).

    python tools/depth_cuts.py              # every cut
    python tools/depth_cuts.py --only 34    # phase 34's alone

The cuts, each run at the old depth and then at the new one: phase 34,
xlstm-350m 24 -> 8 layers, and phase 35, seamless-m4t-large-v2 12 + 12 ->
6 + 6 layers (``chip_smoke.SUBSTRATE_RUNS``); phase 39's qwen3-moe-30b-a3b
at ``--mesh 1x2``, 2 -> 1 layers (``chip_smoke.TP_RUNS``); qwen2.5-3b 36
-> 9 layers (``QWEN_LAYERS``) in phase 22 (its two runs through the
launcher and its profile; the kernel timings keep the full depth's
buckets), phase 27 (serving) and phase 37 (sharded parameters); phase
38's nine methods, llama-tiny 4 -> 2 layers (``COMPARE_LAYERS``).  Each
run makes every check the script makes of it.  Prints one line a run and,
last, the seconds as one JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# (phase, what, old depth, new depth)
CUTS = [(34, "xlstm-350m layers", 24, 8),
        (22, "qwen2.5-3b layers", 36, 9),
        (27, "serving qwen2.5-3b layers", 36, 9),
        (37, "sharded qwen2.5-3b layers", 36, 9),
        (38, "compare_optimizers llama-tiny layers", 4, 2),
        (35, "seamless-m4t-large-v2 layers", 24, 12),
        (39, "qwen3-moe-30b-a3b layers (1x2)", 2, 1)]


def full_state_bytes(cs, arch, codecs):
    """GWT-2's state bytes of ``arch`` at its published depth, per codec,
    from its shapes on the meta device (chip_smoke names the JAX package's
    count at the cut depth only)."""
    from repro_torch import configs
    from repro_torch.models import module_for
    from repro_torch.optim import engine, make
    cfg = configs.get_config(arch)
    params = module_for(cfg).abstract_params(cfg)
    return {c: engine.state_bytes(make("gwt", lr=0.0, level=cs.LEVEL,
                                       state_codec=c).init(params))
            for c in codecs}


def run_phase(cs, phase, depth, train, kernel, ref, hk, dev):
    """One of the cut phases at ``depth`` (chip_smoke's constants set for
    the call and restored)."""
    if phase in (34, 35):
        saved = cs.SUBSTRATE_RUNS
        entry = next(r for r in saved if r[0] == (
            "xlstm-350m" if phase == 34 else "seamless-m4t-large-v2"))
        cut = entry[1] if phase == 34 else entry[1]["n_layers"]
        if depth != cut:
            entry = (entry[0], None, entry[2], entry[3],
                     full_state_bytes(cs, entry[0], entry[4]))
        cs.SUBSTRATE_RUNS = [entry]
        try:
            cs.run_substrates(train, kernel, hk, ref, dev)
        finally:
            cs.SUBSTRATE_RUNS = saved
    elif phase in (22, 27, 37):
        saved = cs.QWEN_LAYERS, cs.QWEN_STATE_BYTES
        if depth != cs.QWEN_LAYERS:
            cs.QWEN_STATE_BYTES = full_state_bytes(cs, "qwen2.5-3b",
                                                   cs.QWEN_STATE_BYTES)
        cs.QWEN_LAYERS = depth
        try:
            if phase == 22:
                cs.run_dense_main(train, kernel, hk)
                cs.profile_step(dev, "f32", arch="qwen2.5-3b",
                                cfg=cs.qwen_cut())
                cs.run_dense_main(train, kernel, hk, "int8")
            elif phase == 27:
                cs.run_serve_qwen(kernel, hk, dev)
            else:
                cs.run_sharding(train, kernel, hk)
        finally:
            cs.QWEN_LAYERS, cs.QWEN_STATE_BYTES = saved
    elif phase == 39:
        saved = cs.TP_RUNS
        i = next(i for i, r in enumerate(saved)
                 if r[1] == "qwen3-moe-30b-a3b")
        cs.TP_RUNS = [*saved[:i], (f"qwen3-moe-30b-a3b {depth} layers",
                                   *saved[i][1:2], depth, *saved[i][3:]),
                      *saved[i + 1:]]
        try:
            cs.run_tp(train, kernel, hk, only=[i])
        finally:
            cs.TP_RUNS = saved
    else:
        saved = cs.COMPARE_LAYERS
        cs.COMPARE_LAYERS = depth
        try:
            cs.run_compare_optimizers(kernel, hk)
        finally:
            cs.COMPARE_LAYERS = saved


def main(argv) -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.gwt_adam import kernel, ref
    from repro_torch.kernels.haar_dwt import kernel as hk
    from repro_torch.launch import train
    if not torch.cuda.is_available():
        print("depth_cuts: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    only = None
    if "--only" in argv:
        only = int(argv[argv.index("--only") + 1])
    print(cs.smi())
    build.build_all(tuple(build.SOURCES), verbose=False)
    out = {}
    for phase, what, old, new in CUTS:
        if only is not None and phase != only:
            continue
        for depth in (old, new):
            t0 = time.perf_counter()
            run_phase(cs, phase, depth, train, kernel, ref, hk, dev)
            dt = time.perf_counter() - t0
            out[f"phase {phase} {what} {depth}"] = dt
            print(f"depth cut: phase {phase}, {what} {depth}: {dt:.1f} s")
    print(cs.smi())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
