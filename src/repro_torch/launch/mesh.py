"""The device mesh and the data-parallel context of a run (counterpart of
``repro/launch/mesh.py`` and of the ``--mesh`` parsing of
``repro/launch/train.py``).

Under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT`` set) :func:`init_dp` joins the process
group: NCCL on ``cuda:LOCAL_RANK``, gloo for CPU tensors.  There is no
fallback: if NCCL cannot start, the run fails.  Without those variables
the run is one rank, and no collective is issued.

:func:`init_mesh` lays the ranks out on a mesh of 1-3 axes, ``(data)``,
``(data, model)`` or ``(pod, data, model)`` (``--mesh 8``, ``4x2``,
``2x4x2``), rank ``r`` at the row-major coordinate of ``r``.  The mesh's
size must be ``WORLD_SIZE``.  The :class:`DPContext` it returns is the data
axes' (pod x data): its ``rank`` and ``world`` are this process's index and
the count along them, its ``group`` theirs; the ranks along ``model`` form
separate data groups.  Its ``model_group`` holds this process's ranks along
``model`` (one group per data coordinate; ``model_rank`` of
``model_world``), over which the tensor-parallel step runs its collectives.
The ``sharding.Mesh`` it returns carries this process's group along each
axis of size > 1, over which placed tensors are gathered.  Every process
creates every group in the same order.

``backend`` picks the process group's backend: NCCL for CUDA and gloo for
CPU tensors by default; ``"gloo"`` on CUDA lets several ranks share one
card (gloo takes ``all_reduce``, ``all_gather`` and ``broadcast`` of CUDA
tensors), with ``LOCAL_RANK`` naming the card each rank takes.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding

# the axis names of a mesh of 1, 2 or 3 axes, as the JAX launcher's
MESH_AXES = (("data",), ("data", "model"), ("pod", "data", "model"))


def parse_mesh(text: str) -> Tuple[int, ...]:
    """``'4x2'`` -> ``(4, 2)``; raises ValueError with the JAX launcher's
    messages."""
    try:
        shape = tuple(int(s) for s in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {text!r}: expected integers joined by "
                         "'x', e.g. '8' or '4x2' or '2x4x2'") from None
    if not 1 <= len(shape) <= 3:
        raise ValueError(f"--mesh {text!r}: 1-3 axes supported "
                         "((data), (data, model), (pod, data, model))")
    if any(n < 1 for n in shape):
        raise ValueError(f"--mesh {text!r}: every axis needs at least one "
                         "device")
    return shape


def env_world() -> int:
    """``WORLD_SIZE`` of the environment (1 without torchrun)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


@dataclasses.dataclass
class DPContext:
    """The data axes of a run: ``rank`` of ``world`` along them and their
    ``group`` (None: one rank along them).  ``process_rank`` and
    ``processes`` count every process of the run (rank 0 logs and writes
    checkpoints); by default the data axes are the whole run."""

    device: torch.device
    rank: int = 0
    world: int = 1
    group: Optional[dist.ProcessGroup] = None   # None: one rank
    process_rank: Optional[int] = None
    processes: Optional[int] = None
    # the ranks along ``model`` at this process's data coordinate
    model_group: Optional[dist.ProcessGroup] = None   # None: one rank
    model_rank: int = 0
    model_world: int = 1

    def __post_init__(self):
        if self.process_rank is None:
            self.process_rank = self.rank
        if self.processes is None:
            self.processes = self.world

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
        """True on every process if ``flag`` is True on any process of the
        run (the model axis's too)."""
        if self.processes == 1:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int32, device=self.device)
        out = [torch.empty_like(t) for _ in range(self.processes)]
        dist.all_gather(out, t)
        return any(int(x) for x in out)

    def close(self) -> None:
        if self.processes > 1 or self.group is not None:
            if dist.is_initialized():
                dist.destroy_process_group()
            self.group = None


def init_dp(device: torch.device, backend: Optional[str] = None
            ) -> DPContext:
    """Join the process group the environment describes, or make a
    one-rank context on ``device``.  ``backend`` None: NCCL on CUDA, gloo
    on the CPU."""
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
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=rank, world_size=world)
    return DPContext(device=device, rank=rank, world=world,
                     group=dist.group.WORLD)


def _coords(rank: int, shape: Sequence[int]) -> Tuple[int, ...]:
    """The row-major coordinate of ``rank`` on a mesh of ``shape``."""
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def _axis_groups(shape: Sequence[int], axis: int, coords: Sequence[int]):
    """Every group of ranks that differ only along ``axis`` (each created
    by every process, in the same order); returns this process's, None
    where it holds one rank."""
    world = math.prod(shape)
    mine = None
    seen = set()
    for r in range(world):
        c = _coords(r, shape)
        key = c[:axis] + c[axis + 1:]
        if key in seen:
            continue
        seen.add(key)
        ranks = [q for q in range(world)
                 if _coords(q, shape)[:axis] + _coords(q, shape)[axis + 1:]
                 == key]
        g = dist.new_group(ranks) if len(ranks) > 1 else None
        if key == tuple(coords[:axis]) + tuple(coords[axis + 1:]):
            mine = g
    return mine


def init_mesh(device: torch.device, shape: Optional[Sequence[int]] = None,
              backend: Optional[str] = None
              ) -> Tuple[DPContext, sharding.Mesh]:
    """Join the run's process group (:func:`init_dp`) and lay its ranks out
    on a mesh of ``shape`` (default: every rank over ``data``).  Returns the
    data axes' :class:`DPContext` and the ``sharding.Mesh``.  A mesh whose
    size is not ``WORLD_SIZE`` raises before any group is joined."""
    world = env_world()
    shape = tuple(shape) if shape else (world,)
    names = MESH_AXES[len(shape) - 1]
    if math.prod(shape) != world:
        raise ValueError(
            f"--mesh {'x'.join(map(str, shape))} holds {math.prod(shape)} "
            f"devices but WORLD_SIZE is {world}: launch "
            f"{math.prod(shape)} ranks (torchrun --nproc-per-node "
            f"{math.prod(shape)}) or change --mesh")
    dp = init_dp(device, backend)
    coords = _coords(dp.process_rank, shape)
    groups = {}
    if dp.processes > 1:
        for i, name in enumerate(names):
            if shape[i] > 1:
                groups[name] = _axis_groups(shape, i, coords)
    mesh = sharding.Mesh(shape, names, coords, groups)
    if "model" not in names:
        return dp, mesh
    # the data axes (pod x data) of each model coordinate form one group
    # (on a (data, model) mesh, the group along 'data'); every process
    # makes every group, in the same order
    data_shape = shape[:-1]
    n_data = math.prod(data_shape)
    group = groups.get("data")
    if len(data_shape) > 1:
        for m in range(shape[-1]):
            ranks = [r for r in range(world) if _coords(r, shape)[-1] == m]
            g = dist.new_group(ranks) if n_data > 1 else None
            if m == coords[-1]:
                group = g
    data_rank = 0
    for c, n in zip(coords[:-1], data_shape):
        data_rank = data_rank * n + c
    return DPContext(device=dp.device, rank=data_rank, world=n_data,
                     group=group, process_rank=dp.process_rank,
                     processes=dp.processes,
                     model_group=groups.get("model"),
                     model_rank=coords[-1], model_world=shape[-1]), mesh
