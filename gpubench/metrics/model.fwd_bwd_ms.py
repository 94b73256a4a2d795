"""Device ms from a step's start to its ``optimizer.update`` call
(forward, backward and the gradients' cast), from CUDA events, averaged
over the window's steps."""


def read(ctx):
    return ctx["fwd_bwd_ms"]
