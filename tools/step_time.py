"""Time the port's full-width training step on the card, for one checkout
of ``src/repro_torch`` or for two of them compared in one run.

One checkout (prints one JSON line)::

    python tools/step_time.py --src src --codec int8

llama-60m (batch 16 x seq 256, GWT-2, random init from seed 1, the
synthetic data source) runs ``WARMUP`` steps, then ``STEPS`` steps with
the batches already on the card.  It reports, per step: the step
time between two CUDA events around the whole loop (``step_ms``), the
host's wall time for the loop followed by one synchronize (``host_ms``),
the summed CUDA-event time of ``optimizer.update`` (``update_ms``), and
how many synchronizing calls one step and one ``optimizer.update`` make
(``syncs_per_step``, ``syncs_per_update``: PyTorch's sync debug mode,
which flags every call that blocks the host on the card).

Two checkouts, compared in order A, B, B, A, each run in its own process
(prints each run's line, then a summary)::

    python tools/step_time.py --ab PARENT/src src --codec f32

The package is imported from ``--src``, so a checkout that predates this
script (and, with ``--codec f32``, one that predates the int8 codec) can
be timed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

STEPS = 20
WARMUP = 3


def _count_syncs(fn) -> int:
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message).lower() for w in caught)


def time_one(src: str, codec: str) -> dict:
    steps, warmup = STEPS, WARMUP
    sys.path.insert(0, os.path.abspath(src))
    import torch

    from repro_torch import configs
    from repro_torch.core.gwt import gwt
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import lm
    from repro_torch.optim.schedules import warmup_cosine

    dev = torch.device("cuda")
    cfg = configs.get_config("llama-60m")
    tree = lm.init(cfg, torch.Generator(device=dev).manual_seed(1),
                   dev).tree()
    kw = {} if codec == "f32" else {"state_codec": codec}
    opt = gwt(warmup_cosine(0.01, 1000), **kw)
    state = opt.init(tree)
    marks = []

    def timed_update(grads, st, params):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = opt.update(grads, st, params)
        b.record()
        marks.append((a, b))
        return out

    step = lm.make_train_step(cfg, opt._replace(update=timed_update))
    data = SyntheticLM(cfg.vocab, 256, 16, seed=1)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in data.batch(i).items()}
               for i in range(warmup + steps + 1)]
    for b in batches[:warmup]:
        tree, state, _ = step(tree, state, b)
    torch.cuda.synchronize()

    marks.clear()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    for b in batches[warmup:warmup + steps]:
        tree, state, metrics = step(tree, state, b)
    stop.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    step_ms = start.elapsed_time(stop) / steps
    update_ms = sum(a.elapsed_time(b) for a, b in marks) / steps
    loss = float(metrics["loss"])

    out = {}

    def one_step():
        out["r"] = step(tree, state, batches[-1])

    syncs_step = _count_syncs(one_step)
    tree, state, _ = out["r"]
    # the update alone, on the gradients of one more step
    grads_holder = {}

    def capture(grads, st, params):
        grads_holder["g"] = grads
        return opt.update(grads, st, params)

    lm.make_train_step(cfg, opt._replace(update=capture))(
        tree, state, batches[-1])
    torch.cuda.synchronize()
    syncs_update = _count_syncs(
        lambda: opt.update(grads_holder["g"], state, tree))
    return {"src": src, "codec": codec, "steps": steps,
            "step_ms": step_ms, "host_ms": host_ms, "update_ms": update_ms,
            "syncs_per_step": syncs_step,
            "syncs_per_update": syncs_update, "loss": loss,
            "card": torch.cuda.get_device_name(0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default="src")
    ap.add_argument("--ab", nargs=2, metavar=("A", "B"))
    ap.add_argument("--codec", default="f32", choices=["f32", "int8"])
    args = ap.parse_args(argv)
    if not args.ab:
        print(json.dumps(time_one(args.src, args.codec)))
        return 0
    runs = []
    for src in (args.ab[0], args.ab[1], args.ab[1], args.ab[0]):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--src", src,
             "--codec", args.codec],
            capture_output=True, text=True, check=False)
        if res.returncode != 0:
            sys.stderr.write(res.stderr)
            return res.returncode
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps(line))
        runs.append(line)
    summary = {"codec": args.codec, "A": args.ab[0], "B": args.ab[1]}
    for key in ("step_ms", "host_ms", "update_ms"):
        a = [r[key] for r in runs if r["src"] == args.ab[0]]
        b = [r[key] for r in runs if r["src"] == args.ab[1]]
        summary[key] = {"A": a, "B": b, "B/A": (sum(b) / sum(a))}
    for key in ("syncs_per_step", "syncs_per_update"):
        summary[key] = {"A": runs[0][key], "B": runs[1][key]}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
