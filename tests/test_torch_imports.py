"""Import boundary of the port: no module of ``repro_torch`` and no part of
``chip_smoke.py``, ``tools/step_time.py`` or ``tools/loop_time.py``
imports JAX or the JAX package, and ``triton``, where it is used, is
imported only inside a function, so every module imports where triton is
not installed."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py"),
           os.path.join(REPO, "tools", "step_time.py"),
           os.path.join(REPO, "tools", "loop_time.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(tree):
    """(top-level module name, inside a function?) for every import."""
    found = []

    def visit(node, in_fn):
        for child in ast.iter_child_nodes(node):
            fn = in_fn or isinstance(child, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))
            if isinstance(child, ast.Import):
                found.extend((a.name.split(".")[0], fn) for a in child.names)
            elif isinstance(child, ast.ImportFrom):
                if child.level == 0:
                    found.append((child.module.split(".")[0], fn))
            visit(child, fn)

    visit(tree, False)
    return found


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_no_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for name, in_fn in _imports(tree):
        assert name not in FORBIDDEN, f"{path} imports {name}"
        if name == "triton":
            assert in_fn, f"{path} imports triton at module level"


def test_the_walk_sees_the_package():
    names = {os.path.basename(p) for p in _sources()}
    assert {"chip_smoke.py", "step_time.py", "gwt.py", "kernel.py", "train.py", "codec.py",
            "manager.py", "fault_tolerance.py", "interop.py", "build.py",
            "compression.py", "mesh.py", "ops.py", "ref.py", "standard.py",
            "hosts.py", "haar.py", "engine.py", "tokenizer.py", "store.py",
            "order.py", "build_corpus.py", "workers.py", "eval.py",
            "sink.py", "trace.py", "lowrank.py", "attention.py",
            "blocks.py", "layers.py", "lm.py", "qwen2_5_3b.py",
            "gemma2_9b.py", "gemma3_27b.py", "deepseek_67b.py", "kv.py",
            "serve.py", "lora.py", "moe.py", "qwen2_vl_72b.py",
            "qwen2_moe_a2_7b.py", "qwen3_moe_30b_a3b.py", "prng.py"} <= names
    serve = os.path.join(PKG, "serve")
    assert {os.path.join(serve, f) for f in ("kv.py", "engine.py")} \
        <= set(_sources())


def test_the_check_catches_what_it_forbids():
    tree = ast.parse("import jax.numpy\nfrom repro.core import haar\n"
                     "def f():\n    import triton\n")
    assert _imports(tree) == [("jax", False), ("repro", False),
                              ("triton", True)]
