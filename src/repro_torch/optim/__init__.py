"""Optimizer registry of the port (counterpart of ``repro/optim``):
``make('gwt', lr=..., level=3)`` etc., for every name of the JAX package's
registry.

Every optimizer is a rule declaration over the engine
(``optim/engine.py``); ``bucketed=False`` gives the unrolled per-leaf
reference.
"""

from repro_torch.optim import engine, hosts, schedules
from repro_torch.optim.base import Optimizer, default_eligible, global_norm
from repro_torch.optim.lowrank import adarankgrad, apollo, fira, galore, rso
from repro_torch.optim.standard import adam, adam_mini, from_host, muon, sgd


def _gwt(**kw) -> Optimizer:
    from repro_torch.core.gwt import gwt  # core.gwt imports this package
    return gwt(**kw)


REGISTRY = {"adam": adam, "adam_mini": adam_mini, "muon": muon, "sgd": sgd,
            "galore": galore, "apollo": apollo, "fira": fira, "gwt": _gwt,
            "adarankgrad": adarankgrad, "rso": rso}
LOWRANK = ("galore", "apollo", "fira", "adarankgrad", "rso")


def make(name: str, **kw) -> Optimizer:
    if name not in REGISTRY:
        raise ValueError(f"unknown optimizer {name!r}; choices: "
                         f"{sorted(REGISTRY)}")
    return REGISTRY[name](**kw)


__all__ = ["Optimizer", "make", "adam", "adam_mini", "muon", "sgd", "galore",
           "apollo", "fira", "adarankgrad", "rso", "from_host",
           "default_eligible", "global_norm", "engine", "hosts", "schedules",
           "REGISTRY", "LOWRANK"]
