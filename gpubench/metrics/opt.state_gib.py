"""The optimizer state's exact bytes (``engine.state_bytes``), in GiB."""


def read(ctx):
    return ctx["state_bytes"] / 2 ** 30
