"""The result line's keys and order, and the check that no module of JAX
or of the JAX package is loaded, compared by whole top-level names."""

import pytest

from gpubench.tests.helpers import ROOT  # noqa: F401  (the import path)
from gpubench import run


def _res(trace):
    tr = {"busy_s": 1.0, "window_s": 2.0, "device_ops": [["k", 1.0]],
          "idle_gaps": [["host", 0.5]]} if trace else None
    return {"correct": True, "attempted": 10, "failed": 0,
            "numbers": {"loss": 1e-4, "grad": 1e-3, "delta": 1e-2},
            "ctx": {"trace": tr}}


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    limits = {"loss": 1e-3, "grad": 1e-2, "delta": 1e-1}
    line = run.result_line(_res(trace), {"x": {"value": 1.0, "unit": "s"}},
                           {"platform": "gpu"}, limits, trace)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == want + (["breakdown"] if trace else []) + ["check"]
    assert line["check"]["grad"] == {"value": 1e-3, "limit": 1e-2}
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("names,found", [
    (["jax"], ["jax"]), (["jax.numpy", "os"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]), (["flax.linen"], ["flax"]),
    (["repro", "repro.core.gwt"], ["repro"]),
    (["repro_torch", "repro_torch.optim.engine"], []),
    (["jaxtyping", "reprolib", "torch"], []),
])
def test_banned_modules_by_whole_top_level_name(names, found):
    assert run.banned_modules(names) == found


def test_run_refuses_without_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    code = run.main(["--workload", "qwen2.5-3b.gwt2-f32.b64s256",
                     "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert code != 0 and out.out == ""
