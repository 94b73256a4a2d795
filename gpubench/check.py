"""The comparison that decides ``correct``: the program's checked steps
against the reference's, as numbers; a cell compares those its file gives
a limit (``gpubench/workloads/<cell>.json``).

* ``loss``: the largest ``|L_prog - L_ref| / |L_ref|`` over the steps.
* ``grad``: over the leaves, the largest gap between the norms of the
  first gradient as the optimizer's moments hold it (GWT's band, or the
  whole leaf), ``|n_prog - n_ref| / max(n_ref, median n_ref)``.
* ``grad_unrouted``: the same worst gap over the leaves outside a routed
  block (an FFN with a ``router`` leaf): the router's and the experts'
  gaps follow the program's bf16 gates and near-tie routing, and swing
  more than what a lower precision adds elsewhere.
* ``delta``: the same gap for each leaf's change over the steps, ``|w_end
  - w_start|``, leaving out the leaves whose first reference gradient is
  under a thousandth of the median leaf's (a bias that softmax cancels
  moves under Adam by round-off alone).

A number passes when it is at most its limit.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict

QUIET = 1e-3   # a leaf whose gradient is under this share of the median's


def _gaps(prog: Dict[str, float], ref: Dict[str, float], keys):
    """Each leaf's ``|prog - ref| / max(ref, median ref)``."""
    keys = list(keys)
    med = statistics.median(ref[k] for k in keys)
    out = []
    for k in keys:
        denom = max(ref[k], med)
        gap = abs(prog[k] - ref[k]) / denom if denom > 0 else 0.0
        out.append(gap if math.isfinite(gap) else math.inf)
    return out


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``{"loss", "grad", "grad_unrouted", "delta"}`` of the program's
    readings against the reference's (``harness.Built.checked`` and
    ``reference.train.readings`` give both in one form)."""
    losses = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
              for a, b in zip(prog["losses"], ref["losses"])]
    med = statistics.median(ref["grad_full"].values())
    moving = [k for k, v in ref["grad_full"].items() if v >= QUIET * med]
    leaves = list(ref["grad"])
    grad = dict(zip(leaves, _gaps(prog["grad"], ref["grad"], leaves)))
    routed = tuple(k[:-len("router")] for k in leaves
                   if k.endswith("/router"))
    return {"loss": max(losses), "grad": max(grad.values()),
            "grad_unrouted": max(v for k, v in grad.items()
                                 if not k.startswith(routed)),
            "delta": max(_gaps(prog["delta"], ref["delta"], moving))}


def verdict(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(nums[k] <= limits[k] for k in limits)


def lines(nums: Dict[str, float], limits: Dict[str, float]):
    """One line a number: its name, its value and its limit."""
    return [f"check {k}: {nums[k]!r} limit {limits[k]!r}"
            for k in limits]
