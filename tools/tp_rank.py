"""One rank of ``chip_smoke.py``'s phase 39 (the ``model`` mesh axis), not
run by hand: ``chip_smoke.run_tp`` starts two of these on one card with
``RANK``, ``WORLD_SIZE=2``, ``LOCAL_RANK=0``, ``MASTER_ADDR`` set.

    python tools/tp_rank.py OUT '[{"label", "arch", "layers", "argv",
                                   "mesh", "taps"}, ...]'

Joins the card, waits for ``OUT/go`` (its parent runs the world-1
references meanwhile), then makes each run through the launcher at
``--mesh <mesh> --dist-backend gloo`` (``mesh``: ``1x2``, or ``2`` for a
run on the data axis alone; ``layers``: the config cut to that depth, or
the config fields of a dict, ``chip_smoke.depth_cut``; ``taps``: with
``--metrics-dir OUT/tp_<i>``, where rank 0 writes the records), the
kernels' launch counts set to 0 just before and read just after.  Rank 0
takes a free port for each run just before it and writes it to
``OUT/port<i>``, where rank 1 reads it.  Writes
``OUT/rank<RANK>.json``: per run its losses, counts, peak
``max_memory_allocated``, step time, the bytes of the parameters (and of a
LoRA run's frozen base) and state this rank held, and the sketches of the whole parameters and optimizer
state at the end (``chip_smoke.tree_sketch``).
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

GO_TIMEOUT_S = 900
PORT_TIMEOUT_S = 120


def held_bytes(tree) -> int:
    from repro_torch.optim.base import flatten_with_paths
    return sum(t.numel() * t.element_size()
               for t in flatten_with_paths(tree)[1])


def wait_for(path: str, timeout_s: float) -> None:
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} within {timeout_s} s")
        time.sleep(0.05)


def run_port(out: str, i: int, rank: int) -> str:
    """Run ``i``'s rendezvous port: taken by rank 0 just before the run
    (so nothing else binds it in between), read by rank 1."""
    import chip_smoke as cs
    path = os.path.join(out, f"port{i}")
    if rank == 0:
        with open(path + ".tmp", "w") as f:
            f.write(str(cs.free_port()))
        os.replace(path + ".tmp", path)
    else:
        wait_for(path, PORT_TIMEOUT_S)
    with open(path) as f:
        return f.read()


def main(out: str, runs: str) -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.gwt_adam import kernel
    from repro_torch.kernels.haar_dwt import kernel as hk
    from repro_torch.launch import train
    rank = int(os.environ["RANK"])
    torch.zeros(1, device="cuda")
    wait_for(os.path.join(out, "go"), GO_TIMEOUT_S)
    results = []
    for i, run in enumerate(json.loads(runs)):
        cut = cs.depth_cut(run["arch"], run["layers"]) if run["layers"] \
            else contextlib.nullcontext()
        with cut:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            os.environ["MASTER_PORT"] = run_port(out, i, rank)
            cs.reset_counts(kernel, hk)
            taps = ["--metrics-dir", os.path.join(out, f"tp_{i}")] \
                if run["taps"] else []
            res = train.main(run["argv"] + ["--mesh", run["mesh"],
                                            "--dist-backend", "gloo",
                                            *taps])
            torch.cuda.synchronize()
            counts = cs.all_counts(kernel, hk)
            peak = torch.cuda.max_memory_allocated()
        result = {"label": run["label"], "losses": list(res.losses),
                  "counts": counts, "peak_mib": peak / 2**20,
                  "step_ms": res.step_ms,
                  "params_bytes": held_bytes(res.local["params"]),
                  "base_bytes": held_bytes(res.local["params"]["base"])
                  if "base" in res.local["params"] else None,
                  "state_bytes": held_bytes(res.local["opt"]),
                  "sketch": {"params": cs.tree_sketch(res.params),
                             "opt": cs.tree_sketch(res.opt_state)}}
        results.append(result)
        del res
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
