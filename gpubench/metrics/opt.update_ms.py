"""Device ms of ``optimizer.update`` (the whole engine: stacking, K1/K2,
the plain Adam leaves, the writes), from CUDA events around each call,
averaged over the window's steps."""


def read(ctx):
    return ctx["update_ms"]
