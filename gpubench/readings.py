"""The readings a cell's limits are set from, on the card: for each seed,
the checked steps of the program and of each fault planted in it, and of
the control (the reference in fp8) in its place, each against the f32
reference.  No measured window.  One JSON line per seed and kind.

    python3 gpubench/readings.py --workload <cell> --seeds 1,2,3 \
        --kinds program,control,half,frozen,bf16_moments --out FILE
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kinds", default="program,control")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from gpubench import check, harness, spec
    cell = spec.load(args.workload, ROOT)
    kinds = args.kinds.split(",")
    out = open(args.out, "a")
    for seed in (int(s) for s in args.seeds.split(",")):
        ref = None
        for kind in kinds:
            t0 = time.perf_counter()
            fault = kind if kind in ("half", "frozen") else None
            dtype = torch.bfloat16 if kind == "bf16_moments" else None
            if kind == "control":
                b = harness.Inputs(cell, seed, args.device)
            else:
                marks = harness.Marks([], events=False, fault=fault)
                b = harness.Built(cell, seed, args.device, marks, dtype)
                got = b.checked(cell.traffic["checked_steps"])
                b.free()
            if ref is None:
                ref = harness.reference(cell, b, seed)
            if kind == "control":
                got = harness.reference(cell, b, seed, "fp8")
            rec = {"cell": cell.name, "seed": seed, "kind": kind,
                   "numbers": check.numbers(got, ref),
                   "losses": got["losses"], "ref_losses": ref["losses"],
                   "grad": got["grad"], "ref_grad": ref["grad"],
                   "delta": got["delta"], "ref_delta": ref["delta"],
                   "seconds": time.perf_counter() - t0}
            out.write(json.dumps(rec) + "\n")
            out.flush()
            print(json.dumps({k: rec[k] for k in
                              ("seed", "kind", "numbers", "seconds")}),
                  flush=True)
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
