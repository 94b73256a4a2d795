"""The benchmark's own counts against hand counts and the program's."""

import json
import math

import pytest
import torch

from gpubench.tests.helpers import ROOT
from gpubench.counts import dense, flops_module, moe, update_bytes
from gpubench.reference import model
from gpubench import program

Q25 = json.loads((ROOT / "gpubench/configs/qwen2.5-3b.json").read_text())
Q3 = json.loads(
    (ROOT / "gpubench/configs/qwen3-moe-30b-a3b-l6.json").read_text())


def _params(layout):
    return sum(math.prod(shape) for shape, _ in layout.values())


def test_qwen25_parameters():
    s = model.Spec.from_config(Q25)
    assert _params(model.layout(s)) == 3_085_938_688
    from repro_torch.models import lm
    assert lm.param_count(program.model_config(Q25)) == 3_085_938_688


def test_program_layout_is_the_benchmarks():
    for c in (Q25, Q3):
        s = model.Spec.from_config(c)
        mine = {k: shape for k, (shape, _) in model.layout(s).items()}
        theirs = {k: shape for k, (shape, _) in
                  program.layout_of(program.model_config(c)).items()}
        assert mine == theirs


def test_dense_flops_by_hand():
    s = model.Spec.from_config(Q25)
    layer = (2048 * 2048 * 2 + 2048 * 256 * 2 + 3 * 2048 * 11008)
    by_hand = 6 * (36 * layer + 151936 * 2048) + 6 * 256 * 2048 * 36
    assert dense.per_token(s, 256) == by_hand == 18_627_428_352
    assert flops_module("dense") is dense


def test_moe_active_parameters_by_hand():
    s = model.Spec.from_config(Q3)
    attn = 2 * 2048 * 4096 + 2 * 2048 * 512
    experts = 8 * 3 * 2048 * 768
    assert moe.active(s) == attn + 2048 * 128 + experts == 56_885_248
    active = 6 * moe.active(s) + 151936 * 2048
    assert moe.per_token(s, 256) == 6 * active + 6 * 256 * 4096 * 6


def test_k1_bound_at_qwen25():
    """The GWT leaves' bytes under f32 moments (10 a bf16 element) over
    3.35 TB/s: the K1 bound of the kernel table, 8.2826 ms a step."""
    s = model.Spec.from_config(Q25)
    plan = {k: (shape, torch.bfloat16)
            for k, (shape, _) in model.layout(s).items()}
    from gpubench.reference.optim import mode
    gwt = {k: v for k, v in plan.items() if mode(k, v[0], 2) != "plain"}
    assert set(gwt) == {f"layers/b0/{n}" for n in (
        "mixer/wq", "mixer/wk", "mixer/wv", "mixer/wo", "mixer/bq",
        "mixer/bk", "mixer/bv", "ffn/w_gate", "ffn/w_up", "ffn/w_down")}
    # one bound a bucket of leaves of one shape, rounded as the table is
    buckets = {}
    for k, (shape, dt) in gwt.items():
        buckets[shape] = buckets.get(shape, 0) + update_bytes.leaf(
            k, shape, dt, 2, "f32")
    ms = [round(b / 3.35e12 * 1e3, 4) for b in buckets.values()]
    assert sorted(ms) == [0.0001, 0.0002, 0.1127, 0.9015, 2.4227, 4.8454]
    assert round(sum(ms), 4) == 8.2826
    per = {k: update_bytes.leaf(k, shape, dt, 2, "int8") / math.prod(shape)
           for k, (shape, dt) in gwt.items()}
    assert all(v == pytest.approx(7.0625) for v in per.values())
    assert update_bytes.leaf("embed/embedding", (151936, 2048),
                             torch.bfloat16, 2, "f32") \
        == 151936 * 2048 * 22
