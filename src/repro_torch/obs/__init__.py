"""Unified telemetry (a copy of ``repro/obs``): metric sinks, span
tracing, and the process-global :class:`Telemetry` registry.

Three layers, composable and individually optional:

* :mod:`repro_torch.obs.sink` — the :class:`MetricSink` record protocol with
  JSONL (one flushed line per record: a killed run leaves a readable
  file), in-memory, and null backends.
* :mod:`repro_torch.obs.trace` — wall-clock span/counter tracer exporting
  Chrome ``trace_event`` JSON (open in Perfetto / ``chrome://tracing``).
* :class:`Telemetry` — bundles a sink and a tracer behind no-op-safe
  ``emit`` / ``span`` / ``log`` entry points.  A process-global instance
  (:func:`configure` / :func:`get` / :func:`shutdown`) lets deep layers
  (train loop, serve engine, watchdog) report without plumbing a handle
  through every constructor.

The default global is a *null* Telemetry: ``emit`` drops the record,
``span`` yields a shared no-op context, ``log`` only prints.  Hot-path
call sites therefore never need an ``if enabled`` guard — the disabled
cost is one attribute load and a dict drop.  The train launcher's
``--metrics-dir`` and the serve launcher configure a non-null global.
On-device tap *values* are not routed through here at all: they live in
the train step's metrics (device tensors) and the train loop fetches them
with the losses at ``log_every`` boundaries; this layer only receives the
already-fetched host scalars.
"""

from repro_torch.obs.sink import (JsonlSink, MemorySink, MetricSink,
                                  NullSink, Telemetry, configure, get,
                                  shutdown)
from repro_torch.obs.trace import Tracer

__all__ = [
    "JsonlSink", "MemorySink", "MetricSink", "NullSink", "Telemetry",
    "Tracer", "configure", "get", "shutdown",
]
