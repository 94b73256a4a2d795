"""Metric sinks and the process-global :class:`Telemetry` registry.

A *record* is one flat-ish JSON-serializable dict with a ``kind`` key
(``"train_step"``, ``"taps"``, ``"serve_request"``, ``"log"``, ...).
Sinks are dumb transports — no aggregation, no schema enforcement beyond
JSON serializability.  Aggregation belongs to whoever reads the file.

``JsonlSink`` writes a provenance *header* record first (``kind:
"run"``, carrying the same ``run_meta`` dict the checkpoint manifest
stores — data provenance, state codec, fine-tune config) and stamps
every subsequent record with a monotone ``seq``, so a metrics file is
attributable to its run without a side channel.  Each record is
flushed as it is written: a SIGKILLed run still leaves every completed
record readable.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import nullcontext
from typing import Any, Dict, Optional, Protocol, runtime_checkable

from repro_torch.obs.trace import Tracer


@runtime_checkable
class MetricSink(Protocol):
    """Transport for metric records: ``emit`` one dict, ``close`` once."""

    def emit(self, record: Dict[str, Any]) -> None: ...

    def close(self) -> None: ...


class NullSink:
    """Drops everything.  The default process-global sink."""

    enabled = False

    def emit(self, record: Dict[str, Any]) -> None:
        pass

    def close(self) -> None:
        pass


class MemorySink:
    """Keeps records in a list — tests and in-process consumers."""

    enabled = True

    def __init__(self) -> None:
        self.records: list = []
        self.closed = False

    def emit(self, record: Dict[str, Any]) -> None:
        self.records.append(dict(record))

    def close(self) -> None:
        self.closed = True


def _jsonable(x):
    """Best-effort coercion: numpy/torch scalars -> python, else repr."""
    if isinstance(x, (int, float, str, bool, type(None))):
        return x  # fast path: a per-field json.dumps probe costs more
        # than the whole record's final dumps on the train_step hot path
    try:
        json.dumps(x)
        return x
    except TypeError:
        pass
    item = getattr(x, "item", None)
    if item is not None and getattr(x, "ndim", 1) == 0:
        try:
            return item()
        except Exception:  # noqa: BLE001 - fall through to tolist/repr
            pass
    tolist = getattr(x, "tolist", None)
    if tolist is not None:
        try:
            return tolist()
        except Exception:  # noqa: BLE001
            pass
    return repr(x)


class JsonlSink:
    """One flushed JSON line per record under ``path``.

    ``run`` is the provenance dict (the checkpoint manifest's ``run``
    metadata); it is written once as the ``kind: "run"`` header record.
    Records are stamped with ``seq`` (monotone per sink) and, when the
    caller did not provide one, a wall-clock ``ts``.
    """

    enabled = True

    def __init__(self, path: str, run: Optional[Dict[str, Any]] = None):
        self.path = str(path)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._f = open(self.path, "a", encoding="utf-8")
        self._seq = 0
        self._write({"kind": "run", "ts": time.time(),
                     "pid": os.getpid(), "run": run or {}})

    def _write(self, record: Dict[str, Any]) -> None:
        record = {k: _jsonable(v) for k, v in record.items()}
        record["seq"] = self._seq
        self._seq += 1
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def emit(self, record: Dict[str, Any]) -> None:
        if self._f.closed:
            return
        if "ts" not in record:
            record = {**record, "ts": time.time()}
        self._write(record)

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


_NULL_SPAN = nullcontext()


class Telemetry:
    """A sink plus an optional tracer behind no-op-safe entry points.

    Every method is safe (and near-free) when the backend is absent, so
    call sites never guard on enablement.
    """

    def __init__(self, sink: Optional[MetricSink] = None,
                 tracer: Optional[Tracer] = None,
                 trace_path: Optional[str] = None):
        self.sink: MetricSink = sink if sink is not None else NullSink()
        self.tracer = tracer
        self.trace_path = trace_path

    @property
    def enabled(self) -> bool:
        return getattr(self.sink, "enabled", True) or self.tracer is not None

    def emit(self, kind: str, **fields: Any) -> None:
        self.sink.emit({"kind": kind, **fields})

    def log(self, msg: str, kind: str = "log", **fields: Any) -> None:
        """Console backend: prints to stdout *and* records the same line,
        so the terminal transcript and the JSONL file agree."""
        print(msg)
        self.sink.emit({"kind": kind, "msg": msg, **fields})

    def span(self, name: str, cat: str = "train", tid: int = 0,
             **args: Any):
        if self.tracer is None:
            return _NULL_SPAN
        return self.tracer.span(name, cat=cat, tid=tid, **args)

    def counter(self, name: str, cat: str = "train", **values: Any) -> None:
        if self.tracer is not None:
            self.tracer.counter(name, cat=cat, **values)

    def close(self) -> None:
        if self.tracer is not None and self.trace_path:
            self.tracer.write(self.trace_path)
        self.sink.close()


_GLOBAL = Telemetry()


def get() -> Telemetry:
    """The process-global Telemetry (a null instance until configured)."""
    return _GLOBAL


def configure(metrics_dir: Optional[str] = None,
              run: Optional[Dict[str, Any]] = None,
              sink: Optional[MetricSink] = None,
              tracer: Optional[Tracer] = None,
              trace: bool = True) -> Telemetry:
    """Install the process-global Telemetry and return it.

    ``metrics_dir`` is the one-knob path: a :class:`JsonlSink` at
    ``<dir>/metrics.jsonl`` (header stamped with ``run``) plus a tracer
    exported to ``<dir>/trace.json`` on :func:`shutdown`.  Explicit
    ``sink``/``tracer`` override the dir-derived ones (tests).  With
    neither, installs a null Telemetry (useful to reset).
    """
    global _GLOBAL
    trace_path = None
    if metrics_dir is not None:
        os.makedirs(metrics_dir, exist_ok=True)
        if sink is None:
            sink = JsonlSink(os.path.join(metrics_dir, "metrics.jsonl"),
                             run=run)
        if tracer is None and trace:
            tracer = Tracer()
        trace_path = os.path.join(metrics_dir, "trace.json")
    if _GLOBAL.enabled:
        _GLOBAL.close()
    _GLOBAL = Telemetry(sink=sink, tracer=tracer, trace_path=trace_path)
    return _GLOBAL


def shutdown() -> None:
    """Close the global Telemetry (writes the trace file) and reset to
    the null instance."""
    global _GLOBAL
    _GLOBAL.close()
    _GLOBAL = Telemetry()
