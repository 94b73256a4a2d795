"""The data-parallel context of a run (the port's counterpart of the
``'data'`` axis of ``repro/launch/mesh.py``): rank, world size, process
group and device.

Under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT`` set) :func:`init_dp` joins the process
group: NCCL on ``cuda:LOCAL_RANK``, gloo for CPU tensors.  There is no
fallback: if NCCL cannot start, the run fails.  Without those variables
the run is one rank, and no collective is issued.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass
class DPContext:
    device: torch.device
    rank: int = 0
    world: int = 1
    group: Optional[dist.ProcessGroup] = None   # None: one rank

    def gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (equal shape and dtype on every rank), in
        rank order; a collective, so every rank calls it."""
        if self.group is None:
            return [t]
        out = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(out, t.contiguous(), group=self.group)
        return out

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``(1, ...)`` rows of a per-rank tensor as one
        ``(world, ...)`` tensor."""
        return torch.cat(self.gather(t), 0)

    def any(self, flag: bool) -> bool:
        """True on every rank if ``flag`` is True on any rank."""
        if self.group is None:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int32, device=self.device)
        return any(int(x) for x in self.gather(t))

    def close(self) -> None:
        if self.group is not None:
            dist.destroy_process_group()
            self.group = None


def init_dp(device: torch.device) -> DPContext:
    """Join the process group the environment describes, or make a
    one-rank context on ``device``."""
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return DPContext(device=device)
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    try:
        addr, port = env["MASTER_ADDR"], env["MASTER_PORT"]
    except KeyError as e:
        raise RuntimeError(f"RANK and WORLD_SIZE are set but {e} is not: "
                           "launch with torchrun, or set MASTER_ADDR and "
                           "MASTER_PORT") from e
    if device.type == "cuda":
        device = torch.device("cuda", int(env.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=rank, world_size=world)
    return DPContext(device=device, rank=rank, world=world,
                     group=dist.group.WORLD)
