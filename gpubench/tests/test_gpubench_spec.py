"""The benchmark is driven by its files: every cell, configuration,
traffic mix and metric of ``BENCHMARK.json`` is found by name, and a cell
added as files alone is found without an edit."""

import json
import re
import shutil

import pytest

from gpubench.tests.helpers import ROOT
from gpubench import spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELL_NAMES = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_keys_and_names():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELL_NAMES + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert {"tokens_per_s", "peak_mem_gib", "setup_s"} <= e2e
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])
    assert all(0 < m["bound"] <= 0.25 for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", CELL_NAMES)
def test_cell_files_found_by_name(cell):
    c = spec.load(cell)
    assert c.chips == 1
    assert c.config["source"] == next(
        x["source"] for x in BENCH["configs"] if x["name"] == c.config_name)
    assert c.limits and set(c.limits) <= {"loss", "grad", "grad_unrouted",
                                          "delta"}
    assert all(v > 0 for v in c.limits.values())
    for m in c.per_layer:
        assert callable(spec.reader(m["name"]))
    assert [m["name"] for m in c.end_to_end] == [
        "tokens_per_s", "peak_mem_gib", "setup_s"]


def test_config_files_hold_what_is_reduced():
    for c in BENCH["configs"]:
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert body[key] != body["published"][key]


def test_readers_return_nothing_without_a_trace():
    ctx = {"window": {"tokens_per_s": 1000.0}, "fwd_bwd_ms": None,
           "update_ms": None, "state_bytes": 2 ** 30,
           "trace": None, "update_bytes": 1e9, "flops_per_token": 1e10,
           "peak_flops": 989e12, "peak_bytes_per_s": 3.35e12}
    got = {m["name"]: spec.reader(m["name"])(ctx)
           for m in BENCH["per_layer"]}
    assert got["device.idle_pct"] is None
    assert got["loop.dispatch_ms"] is None
    assert got["opt.roofline_pct"] is None
    assert got["opt.state_gib"] == 1.0
    assert got["step.mfu_pct"] == pytest.approx(100 * 1e13 / 989e12)


def test_added_cell_found_without_edits(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "gpubench", root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    new = dict(bench["workloads"][0], name="qwen2.5-3b.new-mix",
               traffic="new-mix")
    bench["workloads"].append(new)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((ROOT / "gpubench" / "traffic" /
                          f"{bench['workloads'][0]['traffic']}.json")
                         .read_text())
    (root / "gpubench" / "traffic" / "new-mix.json").write_text(
        json.dumps(dict(traffic, seq=512)))
    (root / "gpubench" / "workloads" / "qwen2.5-3b.new-mix.json").write_text(
        json.dumps({"config": "qwen2.5-3b", "traffic": "new-mix",
                    "limits": {"loss": 1, "grad": 1, "delta": 1}}))
    c = spec.load("qwen2.5-3b.new-mix", root=root, here=root / "gpubench")
    assert c.traffic["seq"] == 512 and c.config_name == "qwen2.5-3b"
    with pytest.raises(KeyError):
        spec.load("no-such-cell", root=root, here=root / "gpubench")


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11])
def test_traffic_is_the_programs_synthetic_source(seed):
    """The frozen generator draws what the program's data pipeline draws
    (the port is imported here only to compare)."""
    from gpubench import traffic
    from repro_torch.data.pipeline import SyntheticLM
    mine = traffic.MarkovLM(151936, 64, 3, seed)
    theirs = SyntheticLM(151936, 64, 3, seed)
    for i in (0, 9):
        a, b = mine.batch(i), theirs.batch(i)
        assert all((a[k] == b[k]).all() for k in ("tokens", "labels"))
