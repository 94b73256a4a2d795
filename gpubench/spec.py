"""What a run reads, found by name: the cell's entry in ``BENCHMARK.json``
at the checkout's root, ``gpubench/configs/<config>.json``,
``gpubench/traffic/<traffic>.json``, ``gpubench/workloads/<cell>.json``
(the cell's limits) and, for each per-layer metric,
``gpubench/metrics/<metric>.py``; a metric whose reader finds nothing to
read in a cell is left out of that cell's line.  A cell, a configuration,
a traffic mix or a metric is added by adding its files and its entry,
without an edit here."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict          # the configuration file
    traffic_name: str
    traffic: dict         # the traffic file
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(name: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"choices: {sorted(cells)}")
    w = cells[name]
    cell_file = _json(here / "workloads" / f"{name}.json")
    return Cell(name=name, chips=int(w["chips"]),
                config_name=w["config"],
                config=_json(here / "configs" / f"{w['config']}.json"),
                traffic_name=w["traffic"],
                traffic=_json(here / "traffic" / f"{w['traffic']}.json"),
                limits=dict(cell_file["limits"]),
                end_to_end=bench["end_to_end"],
                per_layer=bench["per_layer"])


def reader(metric: str, here: Path = HERE):
    """``read(ctx)`` of ``gpubench/metrics/<metric>.py``."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
