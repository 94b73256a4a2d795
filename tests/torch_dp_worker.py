"""One rank of the port's two-rank gloo checks (``test_torch_dp_ranks.py``
starts two of these; not a test module).

    RANK=r WORLD_SIZE=2 MASTER_ADDR=localhost \
        python tests/torch_dp_worker.py OUT PORT_MEANS PORT_TOPO PORT_EF

Imports neither JAX nor the JAX package.  Writes, for its rank ``r``:

* ``means_r.pt``: ``compression.compressed_mean`` and
  ``compressed_mean_ef`` over the process group of rank ``r``'s row of
  seeded stacked inputs, for every wire dtype and the exact mode;
* ``topo_r.pt``: parameters and losses of 3 steps of the launcher on
  llama-60m-smoke with ``--dp-reduce exact``;
* ``ef_r.pt``: this rank's error-feedback residues after 2 steps of
  ``--dp-reduce compressed --dp-error-feedback``, checkpointed to
  ``OUT/ck``.
"""

import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

from repro_torch.distributed import compression  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.mesh import init_dp  # noqa: E402

WIRES = [None, torch.bfloat16, torch.float16, torch.float8_e4m3fn]
SMOKE = ["--smoke", "--batch", "4", "--seq", "16", "--log-every", "1",
         "--device", "cpu"]


def mean_inputs(world: int):
    """Seeded ``(world, 8, 64)`` gradients and residues, and a
    non-compressible ``(world, 6)`` gradient."""
    rng = np.random.RandomState(5)
    g = (rng.randn(world, 8, 64) * 50).astype(np.float32)
    err = (rng.randn(world, 8, 64) * 1e-2).astype(np.float32)
    odd = rng.randn(world, 6).astype(np.float32)
    return g, err, odd


def main(out, port_means, port_topo, port_ef):
    rank = int(os.environ["RANK"])
    os.environ["MASTER_PORT"] = port_means
    dp = init_dp(torch.device("cpu"))
    g, err, odd = mean_inputs(dp.world)
    res = {}
    try:
        for wire in WIRES:
            gr, er = torch.from_numpy(g[rank]), torch.from_numpy(err[rank])
            res[str(wire)] = (
                compression.compressed_mean(gr, dp, 2, wire),
                *compression.compressed_mean_ef(gr, er, dp, 2, wire))
        res["odd"] = compression.compressed_mean(torch.from_numpy(odd[rank]),
                                                 dp, 2, torch.bfloat16)
    finally:
        dp.close()
    torch.save(res, os.path.join(out, f"means_{rank}.pt"))

    os.environ["MASTER_PORT"] = port_topo
    r = train.main(SMOKE + ["--steps", "3", "--dp-reduce", "exact"])
    torch.save({"params": r.params, "losses": r.losses},
               os.path.join(out, f"topo_{rank}.pt"))

    os.environ["MASTER_PORT"] = port_ef
    r = train.main(SMOKE + ["--steps", "2", "--dp-reduce", "compressed",
                            "--dp-detail-dtype", "float8_e4m3fn",
                            "--dp-error-feedback", "--ckpt-dir",
                            os.path.join(out, "ck"), "--ckpt-every", "2"])
    torch.save(r.opt_state["dp_ef"], os.path.join(out, f"ef_{rank}.pt"))


if __name__ == "__main__":
    main(*sys.argv[1:])
