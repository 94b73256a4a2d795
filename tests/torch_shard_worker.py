"""One rank of the port's two-rank checks of the sharded-parameter layout
(``test_torch_shard_ranks.py`` starts two of these; not a test module).

    RANK=r WORLD_SIZE=2 MASTER_ADDR=localhost \
        python tests/torch_shard_worker.py OUT PORT0 PORT1 ...

Imports neither JAX nor the JAX package.  Runs every scenario of
:data:`SCENARIOS` through the launcher on llama-60m-smoke, each on its own
port, and writes ``OUT/<name>_<rank>.pt`` with the losses, the whole
parameters and optimizer state the launcher returns, and this rank's
shards as it held them (``TrainResult.local``, shapes and dtypes).  The
placement helpers' round trip over the gloo group is ``roundtrip_<rank>.pt``.
"""

import os
import sys

import torch

torch.set_num_threads(1)

from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.mesh import init_mesh  # noqa: E402
from repro_torch.optim.base import tree_map  # noqa: E402

SMOKE = ["--smoke", "--batch", "4", "--seq", "16", "--log-every", "1",
         "--device", "cpu"]
INT8 = ["--state-codec", "int8", "--dp-reduce", "compressed"]

# name -> launcher arguments (the checkpoint directories under OUT)
SCENARIOS = {
    "exact_auto": ["--steps", "3", "--mesh", "2", "--dp-reduce", "exact"],
    "ckpt_auto": ["--steps", "6", "--dp-reduce", "exact", "--ckpt-dir",
                  "{out}/ck_auto2", "--ckpt-every", "3"],
    "exact_none": ["--steps", "3", "--dp-reduce", "exact",
                   "--shard-params", "none"],
    "q8_auto": ["--steps", "3", *INT8],
    "q8_none": ["--steps", "3", *INT8, "--shard-params", "none"],
    "resume_auto": ["--steps", "6", "--dp-reduce", "exact", "--ckpt-dir",
                    "{out}/ck_none1", "--ckpt-every", "3", "--resume"],
    # the taps on the data axis (rank 0 writes the records)
    "mesh_2x1": ["--steps", "3", "--mesh", "2x1", "--metrics-dir",
                 "{out}/taps_2x1"],
    "mesh_1x2": ["--steps", "3", "--mesh", "1x2"],
}


def roundtrip(out, port, rank):
    """Seeded tensors cut to this rank's shard and gathered back over the
    group, for specs over each dimension and the replicated one."""
    os.environ["MASTER_PORT"] = port
    dp, mesh = init_mesh(torch.device("cpu"), (2,))
    try:
        g = torch.Generator().manual_seed(7)
        full = torch.randn(6, 8, 4, generator=g)
        res = {}
        for spec in [sharding.Spec(), sharding.Spec("data"),
                     sharding.Spec(None, "data"),
                     sharding.Spec(None, None, "data")]:
            sh = sharding.NamedSharding(mesh, spec)
            local = sharding.shard(full, sh)
            res[repr(spec)] = (local, sharding.gather(local, sh))
        q = torch.randint(-127, 128, (4, 6), generator=g,
                          dtype=torch.int32).to(torch.int8)
        sh = sharding.NamedSharding(mesh, sharding.Spec("data"))
        res["int8"] = (sharding.shard(q, sh),
                       sharding.gather(sharding.shard(q, sh), sh))
        h = full.to(torch.bfloat16)
        sh = sharding.NamedSharding(mesh, sharding.Spec(None, None, "data"))
        res["bf16"] = (sharding.shard(h, sh),
                       sharding.gather(sharding.shard(h, sh), sh))
        res["full"], res["q"], res["h"] = full, q, h
    finally:
        dp.close()
    torch.save(res, os.path.join(out, f"roundtrip_{rank}.pt"))


def main(out, *ports):
    rank = int(os.environ["RANK"])
    roundtrip(out, ports[0], rank)
    for (name, argv), port in zip(SCENARIOS.items(), ports[1:]):
        os.environ["MASTER_PORT"] = port
        r = train.main(SMOKE + [a.format(out=out) for a in argv])
        torch.save({"losses": r.losses, "params": r.params,
                    "opt": r.opt_state,
                    "local": tree_map(lambda t: (tuple(t.shape), t.dtype),
                                      r.local)},
                   os.path.join(out, f"{name}_{rank}.pt"))


if __name__ == "__main__":
    main(*sys.argv[1:])
