"""The update's share of its memory roofline: the bytes it has to move
(``counts.update_bytes``) over the card's 3.35 TB/s, divided by
``opt.update_ms``, in %."""


def read(ctx):
    ms = ctx["update_ms"]
    if not ms:
        return None
    return 100.0 * ctx["update_bytes"] / ctx["peak_bytes_per_s"] / (ms / 1e3)
