"""The port's data-parallel reduction across two ranks: two processes of
``tests/torch_dp_worker.py`` joined by a gloo process group on the CPU.

* ``compressed_mean`` and ``compressed_mean_ef`` over the group are
  bitwise equal to the JAX package's ``emulated_mean`` and
  ``emulated_mean_ef`` (run op by op: see ``test_torch_dp.py``) on the
  stacked per-rank gradients, for the exact mode and every wire dtype.
* The topology contract of the reference, held by the port itself: with
  ``--dp-reduce exact``, 2 ranks with accum 1 equal 1 rank with accum 2
  bitwise over 3 steps of llama-60m-smoke (the same contiguous shards,
  summed in the same order).
* An error-feedback checkpoint of 2 ranks holds every rank's residue as
  ``(2, *shape)``; resuming it on another rank count raises.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as jc
from repro_torch.checkpoint import manager
from repro_torch.launch import train
from repro_torch.optim.base import flatten_with_paths

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dp_worker as worker  # noqa: E402

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


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dp_ranks"))
    ports = _free_ports(3)
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                   RANK=str(rank), WORLD_SIZE=str(WORLD),
                   MASTER_ADDR="localhost")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "torch_dp_worker.py"),
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
    return out, logs


def _load(out, name, rank):
    return torch.load(os.path.join(out, f"{name}_{rank}.pt"),
                      weights_only=False)


def _bitwise(a, b, what):
    a = a.detach().view(torch.int32) if a.dtype == torch.float32 else a
    b = b.detach().view(torch.int32) if b.dtype == torch.float32 else b
    assert torch.equal(a, b), what


@pytest.mark.parametrize("wire", [str(w) for w in worker.WIRES])
def test_group_means_equal_reference_emulation(ranks, wire):
    out, _ = ranks
    g, err, _ = worker.mean_inputs(WORLD)
    jw = None if wire == "None" else jnp.dtype(wire.split(".")[1])
    with jax.disable_jit():
        want = jc.emulated_mean(jnp.asarray(g), 2, jw)
        want_ef, want_err = jc.emulated_mean_ef(jnp.asarray(g),
                                                jnp.asarray(err), 2, jw)
    want, want_ef, want_err = (torch.from_numpy(jax.device_get(x).copy())
                               for x in (want, want_ef, want_err))
    for rank in range(WORLD):
        mean, mean_ef, new_err = _load(out, "means", rank)[wire]
        _bitwise(mean, want, f"rank {rank} mean")
        _bitwise(mean_ef, want_ef, f"rank {rank} mean with error feedback")
        _bitwise(new_err, want_err[rank], f"rank {rank} residue")


def test_non_compressible_leaf_takes_the_exact_mean(ranks):
    out, _ = ranks
    _, _, odd = worker.mean_inputs(WORLD)
    want = (torch.zeros(6) + torch.from_numpy(odd[0])
            + torch.from_numpy(odd[1])) / WORLD
    for rank in range(WORLD):
        _bitwise(_load(out, "means", rank)["odd"], want, f"rank {rank}")


def test_exact_reduce_two_ranks_equal_one_rank_with_accum_bitwise(ranks):
    out, logs = ranks
    one = train.main(worker.SMOKE + ["--steps", "3", "--dp-reduce", "exact",
                                     "--accum", str(WORLD)])
    assert "dp=2" in logs[0] and "dp=2" not in logs[1]   # rank 0 logs
    for rank in range(WORLD):
        got = _load(out, "topo", rank)
        assert got["losses"] == one.losses
        for path, a, b in zip(*flatten_with_paths(got["params"]),
                              flatten_with_paths(one.params)[1]):
            _bitwise(a, b, f"rank {rank} {path}")


def test_error_feedback_checkpoint_holds_every_rank(ranks):
    """Rank 0 writes each residue leaf as ``(2, *shape)``, row ``r`` being
    rank ``r``'s residue; the residues come first in flatten order."""
    out, _ = ranks
    ck = manager.CheckpointManager(os.path.join(out, "ck"))
    assert ck.committed_steps() == [2]
    rows = [flatten_with_paths(_load(out, "ef", rank))
            for rank in range(WORLD)]
    meta = ck.manifest()["leaves"]
    for i, path in enumerate(rows[0][0]):
        assert meta[i]["shape"] == [WORLD, *rows[0][1][i].shape[1:]], path
        assert meta[i]["dtype"] == "float32", path
        with open(os.path.join(out, "ck", "step_000000002",
                               f"arr_{i:06d}.bin"), "rb") as f:
            saved = np.frombuffer(f.read(), np.float32).reshape(
                meta[i]["shape"])
        for rank in range(WORLD):
            _bitwise(torch.from_numpy(saved[rank:rank + 1].copy()),
                     rows[rank][1][i], f"{path} row {rank}")
    wq = rows[0][0].index("layers/b0/mixer/wq")
    assert not torch.equal(rows[0][1][wq], rows[1][1][wq])
    assert float(rows[0][1][wq].abs().max()) > 0
    with pytest.raises(manager.StructureMismatch, match="2 data-parallel"):
        train.main(worker.SMOKE + [
            "--steps", "4", "--dp-reduce", "compressed", "--dp-detail-dtype",
            "float8_e4m3fn", "--dp-error-feedback", "--ckpt-dir",
            os.path.join(out, "ck"), "--resume"])
