"""One run of one benchmark cell of the PyTorch/CUDA port, on the card.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Cells are the ``workloads`` of ``BENCHMARK.json``; their files live under
``gpubench/``.  The last line of standard output is the result, one JSON
object; the last lines of standard error are the numbers the correctness
check compared, each beside its limit.  The run needs a CUDA card and the
port's package under ``src/``; without either it exits with a non-zero
code and prints no result.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# no module of these top-level names may be loaded in the process that
# prints a result: the port is measured, never the JAX package
BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules(names=None):
    """The banned top-level names among ``names`` (``sys.modules``),
    compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(BANNED))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(res: dict, metrics: dict, device: dict, limits: dict,
                trace_on: bool) -> dict:
    """The result object, its keys in the order the contract reads them,
    the compared numbers last."""
    line = {"correct": bool(res["correct"]), "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    tr = res["ctx"]["trace"]
    if trace_on and tr:
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["check"] = {k: {"value": res["numbers"][k], "limit": limits[k]}
                     for k in limits}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    # every cache the program may fill stays at a fixed path in the
    # checkout (the kernels' own build goes to build/torch_kernels)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from gpubench import spec
    cell = spec.load(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from gpubench import check, harness
    res = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_PROCESS)
    found = banned_modules()
    if found:
        print(f"modules of the JAX package or JAX were loaded: {found}",
              file=sys.stderr)
        return 3
    ctx = res["ctx"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": ctx["peak_bytes"]}
    if args.trace and ctx["trace"]:
        device["busy_s"] = ctx["trace"]["busy_s"]
        device["window_s"] = ctx["trace"]["window_s"]
    metrics = harness.metrics(res, bool(args.trace))
    line = result_line(res, metrics, device, cell.limits, bool(args.trace))
    print(f"window: {ctx['window']}; setup {ctx['setup_s']:.1f} s; "
          f"reference {res['reference_s']:.1f} s",
          file=sys.stderr)
    for text in check.lines(res["numbers"], cell.limits):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
