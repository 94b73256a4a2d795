"""Wall-clock span tracing with Chrome ``trace_event`` JSON export.

Events accumulate in memory as plain dicts and are written once at
shutdown — recording a span is two ``perf_counter`` reads and a list
append, cheap enough for per-chunk train phases and per-tick serve
loops (thousands of events, not millions).

The export is the Trace Event Format's JSON-object flavor::

    {"traceEvents": [{"name", "ph", "ts", "dur", "pid", "tid",
                      "cat", "args"}, ...],
     "displayTimeUnit": "ms", "otherData": {...}}

* complete spans: ``ph = "X"`` with ``ts``/``dur`` in microseconds,
* counters:       ``ph = "C"`` with the sampled values in ``args``,
* instants:       ``ph = "i"`` with scope ``"p"`` (process).

Open the file in https://ui.perfetto.dev or ``chrome://tracing``.
Timestamps are relative to tracer construction (``perf_counter`` is an
arbitrary-epoch monotonic clock); the wall-clock origin is recorded in
``otherData.t0_unix`` for correlation with JSONL metric ``ts`` fields.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

PHASES = ("X", "C", "i")


class Tracer:
    """Collects trace events; thread-compat via the ``tid`` argument
    (callers pick stable small ints per logical lane)."""

    def __init__(self, process_name: str = "repro_torch"):
        self.process_name = process_name
        self.events: List[Dict[str, Any]] = []
        self._t0 = time.perf_counter()
        self._t0_unix = time.time()

    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    @contextmanager
    def span(self, name: str, cat: str = "train", tid: int = 0,
             **args: Any):
        """Complete-event span around a ``with`` body.  ``args`` given at
        entry land in the event; the body may add more via the yielded
        dict (e.g. a token count known only afterwards)."""
        ev_args = dict(args)
        t0 = self.now_us()
        try:
            yield ev_args
        finally:
            t1 = self.now_us()
            self.events.append({
                "name": name, "ph": "X", "ts": t0, "dur": t1 - t0,
                "pid": 0, "tid": tid, "cat": cat, "args": ev_args,
            })

    def counter(self, name: str, cat: str = "train", tid: int = 0,
                **values: Any) -> None:
        """Sampled counter track (queue depth, slot occupancy, ...)."""
        self.events.append({
            "name": name, "ph": "C", "ts": self.now_us(),
            "pid": 0, "tid": tid, "cat": cat,
            "args": {k: float(v) for k, v in values.items()},
        })

    def instant(self, name: str, cat: str = "train", tid: int = 0,
                **args: Any) -> None:
        self.events.append({
            "name": name, "ph": "i", "s": "p", "ts": self.now_us(),
            "pid": 0, "tid": tid, "cat": cat, "args": dict(args),
        })

    def export(self) -> Dict[str, Any]:
        """The Chrome trace JSON object (events sorted by ``ts`` plus a
        process-name metadata event so Perfetto labels the track)."""
        meta = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                 "args": {"name": self.process_name}}]
        return {
            "traceEvents": meta + sorted(self.events,
                                         key=lambda e: e["ts"]),
            "displayTimeUnit": "ms",
            "otherData": {"t0_unix": self._t0_unix},
        }

    def write(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.export(), f)
        return path


def validate(doc: Dict[str, Any]) -> None:
    """Schema check used by tests and the obs benchmark: raises
    ``ValueError`` on the first malformed event."""
    if not isinstance(doc.get("traceEvents"), list):
        raise ValueError("traceEvents missing or not a list")
    for i, ev in enumerate(doc["traceEvents"]):
        ph = ev.get("ph")
        if ph == "M":
            continue
        if ph not in PHASES:
            raise ValueError(f"event {i}: bad ph {ph!r}")
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            raise ValueError(f"event {i}: bad name")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"event {i}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i}: bad dur {dur!r}")
        if "pid" not in ev or "tid" not in ev:
            raise ValueError(f"event {i}: missing pid/tid")
        json.dumps(ev.get("args", {}))
