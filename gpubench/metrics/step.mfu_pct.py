"""The whole step's share of the card's bf16 peak (989 TFLOP/s): model
FLOPs a token (``counts.<family>``) times the window's tokens a second
(the steps outside the profiler's sub-window), in %."""


def read(ctx):
    rate = ctx["window"]["tokens_per_s"]
    return 100.0 * ctx["flops_per_token"] * rate / ctx["peak_flops"]
