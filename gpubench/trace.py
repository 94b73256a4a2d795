"""The traced sub-window: ``torch.profiler`` (CPU and CUDA) over one
chunk of steps after the window, read into the device's busy time, the
kernels that took the most time and the longest idle gaps, each gap named
by what the host was running when it began.  The sub-window runs from the
start of the chunk's second step (the harness marks each step with a
``STEP`` range) to the last kernel's end, so the profiler's own start-up
is left out; its per-op recording still slows a step the host paces.

The host's dispatch of a step is the host time of each ``STEP`` range
less the time it waited on the card inside CUDA runtime calls: the whole
of a synchronising call, and of any other call what it took beyond its
kind's median (a launch that found the queue full, a copy to the host).
So it reads the host's own work a step also where the card paces the
loop and the host's calls block on a full launch queue."""

from __future__ import annotations

import re
import statistics
from typing import Callable, Dict, List, Tuple

import torch

TOP = 10
STEP = "gpubench.step"
RUNTIME = re.compile(r"^cu(da)?[A-Z]")   # a CUDA runtime or driver call


def _events(prof):
    """``(name, kind, start ns, end ns)`` of every recorded event, ``kind``
    "kernel", "host" or "mark" (a range the harness opened)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        on_card = str(e.device_type()).endswith("CUDA")
        if e.is_user_annotation():
            if on_card:     # the card's copy of a host range
                continue
            kind = "mark"
        else:
            kind = "kernel" if on_card else "host"
        out.append((e.name(), kind, start, start + e.duration_ns()))
    return out


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def dispatch_s(steps: List[Tuple[int, int]], events) -> float:
    """Mean host seconds of the ``steps`` ranges outside the waits on the
    card in CUDA runtime calls (see the module's note)."""
    calls = [(n, a, b) for n, k, a, b in events
             if k == "host" and RUNTIME.match(n)]
    med: Dict[str, float] = {}
    for name in {n for n, _, _ in calls}:
        med[name] = statistics.median(b - a for n, a, b in calls
                                      if n == name)
    own = []
    for s0, s1 in steps:
        waited = sum((b - a) if "Synchronize" in n else max(0, b - a - med[n])
                     for n, a, b in calls if s0 <= a < s1)
        own.append(s1 - s0 - waited)
    return sum(own) / len(own) / 1e9


def read(events) -> Dict:
    """Busy seconds, the window, the top kernels, the longest gaps and the
    host's dispatch a step of ``events``, from the second ``STEP`` mark
    on."""
    steps = sorted((a, b) for n, k, a, b in events
                   if k == "mark" and n == STEP)
    kernels = [(n, a, b) for n, k, a, b in events if k == "kernel" and b > a]
    t0 = steps[1][0] if len(steps) > 1 else min(a for _, a, _ in kernels)
    t1 = max(b for _, _, b in kernels)
    kernels = [(n, max(a, t0), b) for n, a, b in kernels if b > t0]
    host = [(n, a, b) for n, k, a, b in events if k == "host"]
    busy = union([(a, b) for _, a, b in kernels])
    busy_s = sum(b - a for a, b in busy) / 1e9
    by_name: Dict[str, float] = {}
    for n, a, b in kernels:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = []
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        gaps.append((s1 - e0, e0))
    gaps.sort(reverse=True)
    named = []
    for length, at in gaps[:TOP]:
        inside = [(a, n) for n, a, b in host if a <= at < b]
        outer = [n for a, n in sorted(inside) if not n.startswith("cuda")]
        label = " / ".join(outer[:1] + outer[-1:]) if outer else "host"
        named.append([label[:160], length / 1e9])
    return {"busy_s": busy_s, "window_s": (t1 - t0) / 1e9,
            "dispatch_s": dispatch_s(steps[1:], events) if len(steps) > 1
            else None,
            "device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": named}


def profile(fn: Callable, device) -> Dict:
    """Runs ``fn`` under the profiler; its sub-window's reading."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    torch.cuda.synchronize(device)
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    return read(_events(prof))
