"""The host's dispatch of a step: the host time of each train-step call
in the traced sub-window, less its waits on the card inside CUDA runtime
calls (``gpubench.trace``), averaged over the sub-window's steps, in ms.
Where the card paces the loop it stays below the step time; where the
host paces it, it is the step."""


def read(ctx):
    t = ctx["trace"]
    if not t or t.get("dispatch_s") is None:
        return None
    return t["dispatch_s"] * 1e3
