"""Optimizer registry of the port (counterpart of ``repro/optim``):
``make('gwt', lr=..., level=3)`` etc.

Every optimizer is a rule declaration over the engine
(``optim/engine.py``); ``bucketed=False`` gives the unrolled per-leaf
reference.  The JAX package's low-rank families are not ported yet:
``make`` names them and raises.
"""

from repro_torch.optim.base import Optimizer
from repro_torch.optim.standard import adam, adam_mini, from_host, muon, sgd

NOT_PORTED = ("galore", "apollo", "fira", "adarankgrad", "rso")


def _gwt(**kw) -> Optimizer:
    from repro_torch.core.gwt import gwt  # core.gwt imports this package
    return gwt(**kw)


REGISTRY = {"adam": adam, "adam_mini": adam_mini, "muon": muon, "sgd": sgd,
            "gwt": _gwt}


def make(name: str, **kw) -> Optimizer:
    if name in NOT_PORTED:
        raise ValueError(f"optimizer {name!r} is not ported yet (the JAX "
                         f"package has it); ported: {sorted(REGISTRY)}")
    if name not in REGISTRY:
        raise ValueError(f"unknown optimizer {name!r}; choices: "
                         f"{sorted(REGISTRY)}")
    return REGISTRY[name](**kw)


__all__ = ["Optimizer", "make", "adam", "adam_mini", "muon", "sgd",
           "from_host", "REGISTRY", "NOT_PORTED"]
