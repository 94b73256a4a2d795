"""The benchmark's own counting: model FLOPs a token by model family
(``dense``, ``moe``, one file each, looked up by the configuration's
``family``) and the bytes an optimizer update must move
(``update_bytes``)."""

import importlib


def flops_module(family: str):
    """The FLOP counter of ``family`` (``counts/<family>.py``)."""
    return importlib.import_module(f"gpubench.counts.{family}")
