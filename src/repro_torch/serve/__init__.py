"""Serving runtime of the port (counterpart of ``repro/serve``): continuous
batching over a slot-paged, optionally int8 KV cache.

``repro_torch.serve.kv`` holds the page arena (imported by the attention
layer for its paged modes); ``repro_torch.serve.engine`` holds the
scheduler.  The engine import is lazy so ``models -> serve.kv`` never
cycles back through ``engine -> models``.
"""

__all__ = ["kv", "Engine", "Request", "EngineConfig"]

import importlib


def __getattr__(name):
    # importlib.import_module, not ``from repro_torch.serve import x``: the
    # from-import re-enters this __getattr__ and recurses
    if name in ("Engine", "Request", "EngineConfig"):
        return getattr(importlib.import_module("repro_torch.serve.engine"),
                       name)
    if name == "kv":
        return importlib.import_module("repro_torch.serve.kv")
    raise AttributeError(
        f"module 'repro_torch.serve' has no attribute {name!r}")
