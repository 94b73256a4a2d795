"""The share of the traced sub-window's wall time in which no kernel ran
on the card, in %."""


def read(ctx):
    t = ctx["trace"]
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
