"""The sharded-parameter layout across two ranks: two processes of
``tests/torch_shard_worker.py`` joined by a gloo process group on the CPU,
three steps of llama-60m-smoke through the launcher in each scenario.

* ``--dp-reduce exact`` under ``--shard-params auto`` is bitwise to
  ``none`` at world 2 and to one rank with ``--accum 2`` (which
  ``test_torch_dp_step.py`` holds against the JAX package);
  ``--state-codec int8 --dp-reduce compressed`` under ``auto`` is bitwise
  to ``none``.
* Each rank held the shard shapes of the rule table, and its state bytes
  are the table's per-rank bytes at ``data=2``.
* A checkpoint written at world 2 under ``auto`` resumes at world 1 under
  ``none`` bitwise, and the reverse; it holds whole arrays.
* ``--mesh 2x1`` without ``--dp-reduce`` is bitwise to ``--mesh 2
  --dp-reduce exact``, its tapped step included; ``--mesh 1x2`` gives both
  ranks the whole batch on their ``model`` shards, one rank with
  ``--dp-reduce exact`` within rounding.
* ``--mesh 2x1 --metrics-dir``: rank 0's taps hold one rank's keys in one
  rank's order, and one rank's values at ``--accum 2`` within the
  tolerances of ``test_torch_obs.py``.
* The placement helpers round-trip bitwise over the group.
"""

import os
import shutil
import socket
import subprocess
import sys

import pytest
import torch

from torch_parity import tap_records, taps_gap

from repro_torch import configs, optim
from repro_torch.checkpoint import manager
from repro_torch.distributed import sharding
from repro_torch.launch import train
from repro_torch.models import lm
from repro_torch.optim import engine
from repro_torch.optim.base import flatten_with_paths

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_shard_worker as worker  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("localhost", 0))
        return [str(s.getsockname()[1]) for s in socks]
    finally:
        for s in socks:
            s.close()


def _one(argv):
    """One rank of llama-60m-smoke (no torchrun variables)."""
    return train.main(worker.SMOKE + argv)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("shard_ranks"))
    # one rank under none, 6 steps (the straight run every resume is held
    # to), checkpointed at 3 and 6; the ranks resume its step 3
    straight = _one(["--steps", "6", "--dp-reduce", "exact",
                     "--shard-params", "none", "--accum", "2", "--ckpt-dir",
                     os.path.join(out, "ck_none1"), "--ckpt-every", "3"])
    shutil.rmtree(os.path.join(out, "ck_none1", "step_000000006"))
    ports = _free_ports(len(worker.SCENARIOS) + 1)
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                   RANK=str(rank), WORLD_SIZE=str(WORLD),
                   MASTER_ADDR="localhost")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests",
                                          "torch_shard_worker.py"),
             out, *ports], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return out, logs, _res(straight)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """The one-rank runs the two-rank scenarios are held to: exact with
    accum 2 and with accum 1 over 3 steps, and the plain step with accum 2
    and taps (``--dp-reduce`` builds no tapped step), its records under
    ``"taps"``."""
    taps = str(tmp_path_factory.mktemp("shard_one_taps"))
    _one(["--steps", "3", "--accum", "2", "--metrics-dir", taps])
    return {"accum2": _one(["--steps", "3", "--dp-reduce", "exact",
                            "--accum", "2"]),
            "accum1": _one(["--steps", "3", "--dp-reduce", "exact"]),
            "taps": taps}


def _load(out, name, rank):
    return torch.load(os.path.join(out, f"{name}_{rank}.pt"),
                      weights_only=False)


def _same(a, b, what):
    """Losses, whole parameters and whole optimizer state bitwise."""
    assert a["losses"] == b["losses"], what
    ta = flatten_with_paths({"p": a["params"], "o": a["opt"]})
    tb = flatten_with_paths({"p": b["params"], "o": b["opt"]})
    assert ta[0] == tb[0], what
    for path, x, y in zip(ta[0], ta[1], tb[1]):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{what} {path}"


def _res(r):
    return {"losses": r.losses, "params": r.params, "opt": r.opt_state}


@pytest.mark.parametrize("key", ["P()", "P('data',)", "P(None, 'data')",
                                 "P(None, None, 'data')", "int8", "bf16"])
def test_placement_round_trips_bitwise(ranks, key):
    out, _, _ = ranks
    for rank in range(WORLD):
        res = _load(out, "roundtrip", rank)
        full = {"int8": res["q"], "bf16": res["h"]}.get(key, res["full"])
        local, back = res[key]
        assert back.dtype == full.dtype and torch.equal(back, full)
        if key == "P()":
            assert torch.equal(local, full)
        else:
            d = {"int8": 0, "P('data',)": 0, "bf16": 2}.get(
                key, key.count("None"))
            n = full.shape[d] // WORLD
            assert torch.equal(local, full.narrow(d, rank * n, n))


@pytest.mark.parametrize("auto,none", [("exact_auto", "exact_none"),
                                       ("q8_auto", "q8_none")])
def test_auto_is_bitwise_to_none(ranks, auto, none):
    out, logs, _ = ranks
    assert "shard_params=auto mesh={'data': 2}" in logs[0]
    assert "shard_params" not in logs[1]     # rank 0 logs
    for rank in range(WORLD):
        _same(_load(out, auto, rank), _load(out, none, rank),
              f"rank {rank} {auto} vs {none}")
    _same(_load(out, auto, 0), _load(out, auto, 1), f"{auto} ranks")


def test_exact_auto_two_ranks_equal_one_rank_with_accum(ranks, one_rank):
    out, _, _ = ranks
    for rank in range(WORLD):
        _same(_load(out, "exact_auto", rank), _res(one_rank["accum2"]),
              f"rank {rank}")


@pytest.mark.parametrize("name,codec", [("exact_auto", "f32"),
                                        ("q8_auto", "int8"),
                                        ("resume_auto", "f32")])
def test_each_rank_holds_the_table_shards(ranks, name, codec):
    """The shapes of what each rank held are those the rule table gives
    rank shards at ``data=2``, and its state bytes the table's."""
    out, _, _ = ranks
    cfg = configs.get_smoke("llama-60m")
    mesh = sharding.Mesh((WORLD,), ("data",))
    sh = sharding.train_step_shardings(
        cfg, lm, {"tokens": torch.empty((4, 16), device="meta")}, mesh,
        state_codec=codec)
    abs_p = lm.abstract_params(cfg)
    st = optim.make("gwt", lr=0.0, level=2, state_codec=codec).init(abs_p)
    want = {}
    for key, tree, tsh in (("params", abs_p, sh.params), ("opt", st, sh.opt)):
        flat = sharding.flat_shardings(tsh)
        for path, t in zip(*flatten_with_paths(tree)):
            want[f"{key}/{path}"] = (sharding.local_shape(t.shape, flat[path]),
                                     t.dtype)
    n_split = sum(w[0] != tuple(t.shape) for w, t in zip(
        want.values(), flatten_with_paths({"params": abs_p, "opt": st})[1]))
    assert n_split > 0
    for rank in range(WORLD):
        local = _load(out, name, rank)["local"]
        paths, got = flatten_with_paths(local)
        got = dict(zip(paths, got))
        assert got == want, f"rank {rank}"
        held = sum(int(torch.Size(s).numel()) * torch.empty(
            (), dtype=d).element_size() for p, (s, d) in got.items()
            if p.startswith("opt/"))
        assert held == sharding.shard_bytes(st, sh.opt)
        assert held < engine.state_bytes(st)


def _resumed(got, straight):
    """A run resumed from step 3, its losses led by the straight run's
    first three."""
    return {**got, "losses": straight["losses"][:3] + got["losses"]}


def test_checkpoint_world2_auto_resumes_world1_none_bitwise(ranks):
    out, _, straight = ranks
    for rank in range(WORLD):
        _same(_load(out, "ckpt_auto", rank), straight, f"rank {rank}")
    d = os.path.join(out, "ck_auto2")
    ck = manager.CheckpointManager(d)
    assert ck.committed_steps() == [3, 6]
    # whole arrays, in the reference's flatten order
    shapes = [list(t.shape) for t in flatten_with_paths(
        {"opt": straight["opt"], "params": straight["params"]})[1]]
    assert [m["shape"] for m in ck.manifest()["leaves"]] == shapes
    shutil.rmtree(os.path.join(d, "step_000000006"))
    resumed = _one(["--steps", "6", "--dp-reduce", "exact", "--shard-params",
                    "none", "--accum", "2", "--ckpt-dir", d, "--resume"])
    assert resumed.start_step == 3
    _same(_resumed(_res(resumed), straight), straight,
          "world 2 auto -> world 1 none")


def test_checkpoint_world1_none_resumes_world2_auto_bitwise(ranks):
    out, _, straight = ranks
    for rank in range(WORLD):
        _same(_resumed(_load(out, "resume_auto", rank), straight), straight,
              f"world 1 none -> world 2 auto, rank {rank}")


def test_mesh_without_dp_reduce(ranks, one_rank):
    """``2x1``: the exact mean over the data axis, parameters unplaced:
    bitwise ``--mesh 2 --dp-reduce exact``.  ``1x2``: each rank the whole
    batch on its ``model`` shards (the tensor-parallel step), one rank with
    ``--dp-reduce exact`` within the tolerances of
    ``test_torch_tp_ranks.py`` (losses 1e-5 relative, the parameters' move
    1e-4): row-parallel sums reorder f32 additions."""
    out, logs, _ = ranks
    want = _res(one_rank["accum1"])
    init = dict(zip(*flatten_with_paths(lm.init(
        configs.get_smoke("llama-60m"), torch.Generator().manual_seed(0),
        "cpu").tree())))
    for rank in range(WORLD):
        _same(_load(out, "mesh_2x1", rank), _load(out, "exact_auto", rank),
              f"2x1 rank {rank}")
        got = _load(out, "mesh_1x2", rank)
        assert max(abs(a - b) / abs(b) for a, b in zip(
            got["losses"], want["losses"])) <= 1e-5, f"1x2 rank {rank}"
        gp = dict(zip(*flatten_with_paths(got["params"])))
        num = den = 0.0
        for path, w in zip(*flatten_with_paths(want["params"])):
            w, g = w.detach().double(), gp[path].detach().double()
            num += float(((g - w) ** 2).sum())
            den += float(((w - init[path].detach().double()) ** 2).sum())
        assert (num / den) ** 0.5 <= 1e-4, f"1x2 rank {rank}"


def test_mesh_2x1_taps_match_one_rank(ranks, one_rank):
    """Under ``--mesh 2x1`` the gradient is the exact mean over the two
    data ranks; one rank's plain step at ``--accum 2`` splits the same rows
    into other microbatches (the JAX package's strided split), so the taps
    agree within ``test_torch_obs.py``'s tolerances and not bitwise: the
    gradient's within 1e-5 (measured 4.3e-7), the update's within 2e-4
    (measured 1.0e-5), the clip counts exactly."""
    out, _, _ = ranks
    got = tap_records(os.path.join(out, "taps_2x1"))
    want = tap_records(one_rank["taps"])
    assert got and all(t for _, t in got)
    gap = taps_gap(got, want)
    assert gap["grad"] <= 1e-5 and gap["update"] <= 2e-4, gap
    assert gap["clip_count"] == gap["clip_rate"] == 0.0, gap
