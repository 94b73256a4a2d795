"""The port lacks nothing of the JAX package's public surface: every public
top-level function and class of ``src/repro/**/*.py`` has a counterpart of
the same name in the same module path under ``src/repro_torch/`` (defined,
assigned or imported there), and every script of ``examples/`` a module of
``repro_torch/examples/`` with its public names; or it stands in
``NOT_PORTED`` with the reason.  Read with ``ast``: nothing is imported.
"""

import ast
import glob
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "src", "repro")
PORT = os.path.join(REPO, "src", "repro_torch")

# "module path" (a whole module) or "module path:name" -> why the port has
# no counterpart of that name there.  "renamed: <module>:<name>" names the
# port's counterpart, which the last test checks exists.
NOT_PORTED = {
    "compat.py": "JAX version shims (mesh, shard_map, sharding "
                 "constraints, cost analysis) for XLA; the port has no "
                 "XLA",
    "runtime/context.py": "MeshContext routes kernels by backend and holds "
                          "the XLA mesh; the port dispatches by the "
                          "tensor's device and passes launch.mesh.DPContext",
    "launch/env.py": "TPU and XLA environment flags",
    "launch/dryrun.py": "compile-only dry run of the production TPU mesh "
                        "(512 fake devices)",
    "optim/engine.py:jit_update": "XLA's jit with donated buffers; the "
                                  "port's update writes the parameters and "
                                  "states in place",
    "distributed/compression.py:compressed_psum_mean":
        "renamed: distributed/compression.py:compressed_mean (a "
        "shard_map psum there, a process group here)",
    "distributed/compression.py:compressed_psum_mean_ef":
        "renamed: distributed/compression.py:compressed_mean_ef",
    "kernels/gwt_adam/kernel.py:gwt_adam_tile_fused":
        "renamed: kernels/gwt_adam/kernel.py:gwt_adam_fused (K1, CUDA C++)",
    "kernels/gwt_adam/kernel.py:gwt_adam_tile_fused_q8":
        "renamed: kernels/gwt_adam/kernel.py:gwt_adam_fused_q8 (K2)",
    "kernels/gwt_adam/kernel.py:fused_row_block":
        "the Pallas kernel's row tile; the CUDA kernels plan theirs in "
        "kernel.one_pass_plan",
    "kernels/gwt_adam/kernel.py:q8_row_block":
        "the Pallas q8 kernel's row tile (kernel.one_pass_plan here)",
    "launch/mesh.py:make_mesh":
        "renamed: launch/mesh.py:init_mesh (the ranks' mesh and DPContext)",
    "launch/mesh.py:make_mesh_context":
        "renamed: launch/mesh.py:init_mesh (MeshContext is XLA's)",
    "launch/mesh.py:make_production_mesh": "the TPU dry run's pod mesh",
    "models/layers.py:wsc": "GSPMD's with_sharding_constraint; the port "
                            "places tensors itself (distributed/sharding.py)",
    "models/lm.py:constrain_batch": "GSPMD's batch sharding constraint; the "
                                    "port splits the batch by rank",
}


def _public(path, with_bindings=False):
    """Public top-level function and class names of ``path``; with
    ``with_bindings`` also assigned and imported names."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif with_bindings and isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif with_bindings and isinstance(node, (ast.Import,
                                                 ast.ImportFrom)):
            out |= {a.asname or a.name.split(".")[0] for a in node.names}
    return {n for n in out if not n.startswith("_")}


def _modules(root):
    return sorted(os.path.relpath(p, root) for p in
                  glob.glob(os.path.join(root, "**", "*.py"), recursive=True))


def _missing(ref_root, port_root, table=NOT_PORTED):
    out = []
    for rel in _modules(ref_root):
        names = _public(os.path.join(ref_root, rel))
        if not names or rel in table:
            continue
        port = os.path.join(port_root, rel)
        have = _public(port, True) if os.path.exists(port) else set()
        out += [f"{rel}:{n}" for n in sorted(names - have)
                if f"{rel}:{n}" not in table]
    return out


def test_every_public_name_has_a_counterpart():
    assert _missing(REF, PORT) == []


def test_every_example_has_a_counterpart():
    examples = os.path.join(REPO, "examples")
    assert _modules(examples), "no examples found"
    for rel in _modules(examples):
        assert os.path.exists(os.path.join(PORT, "examples", rel)), rel
    assert _missing(examples, os.path.join(PORT, "examples")) == []


@pytest.mark.parametrize("key", sorted(NOT_PORTED))
def test_not_ported_entries_are_current(key):
    """Each entry names a module or name the reference has, and a renamed
    one a name the port has."""
    rel, _, name = key.partition(":")
    assert os.path.exists(os.path.join(REF, rel)), key
    if name:
        assert name in _public(os.path.join(REF, rel)), key
        assert name not in _public(os.path.join(PORT, rel), True), \
            f"{key} is ported under its own name now"
    reason = NOT_PORTED[key]
    if "renamed: " in reason:
        target = reason.split("renamed: ", 1)[1].split()[0].rstrip(")")
        trel, tname = target.split(":")
        assert tname in _public(os.path.join(PORT, trel), True), target


def test_the_walk_sees_both_packages():
    assert "core/haar.py" in _modules(REF)
    assert "core/haar.py" in _modules(PORT)
    assert _public(os.path.join(REF, "core", "haar.py")) >= {
        "haar_matrix", "lowpass", "pack", "unpack"}
    # a name the port lacks is reported, a whole module as its names
    missing = _missing(REF, PORT, table={})
    assert "optim/engine.py:jit_update" in missing
    assert "launch/env.py:apply" in missing
