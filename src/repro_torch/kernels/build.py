"""Build and loading of the port's hand-written CUDA kernels.

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface on first use, and loaded with ``ctypes``.  The
libraries go to ``build/torch_kernels/`` at the repository root, named by
the hash of their sources (shared headers included), so an edited source is
rebuilt.  :func:`build_all` starts one ``nvcc`` per library at once.  K1's
and K2's sources each build two libraries: the per-bucket entries, and the
grouped ones under ``-DGWT_ADAM_GROUPED`` (``DEFINES``), so the two table
sizes of their one-pass kernel compile side by side.
Nothing is compiled when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict, Tuple

KERNELS = Path(__file__).resolve().parent
BUILD_DIR = KERNELS.parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_GWT = KERNELS / "gwt_adam" / "csrc"
_HAAR = KERNELS / "haar_dwt" / "csrc"
# library name -> (source, headers it includes)
SOURCES: Dict[str, Tuple[Path, Tuple[Path, ...]]] = {
    "gwt_adam_fused": (_GWT / "gwt_adam_fused.cu",
                       (_GWT / "gwt_adam_common.cuh",)),
    "gwt_adam_fused_group": (_GWT / "gwt_adam_fused.cu",
                             (_GWT / "gwt_adam_common.cuh",)),
    "gwt_adam_fused_q8": (_GWT / "gwt_adam_fused_q8.cu",
                          (_GWT / "gwt_adam_common.cuh",
                           _GWT / "gwt_adam_q8.cuh")),
    "gwt_adam_fused_q8_group": (_GWT / "gwt_adam_fused_q8.cu",
                                (_GWT / "gwt_adam_common.cuh",
                                 _GWT / "gwt_adam_q8.cuh")),
    "gwt_adam_tile": (_GWT / "gwt_adam_tile.cu",
                      (_GWT / "gwt_adam_common.cuh",
                       _GWT / "gwt_adam_q8.cuh")),
    "haar_dwt": (_HAAR / "haar_dwt.cu", ()),
}

# library name (before any "@") -> the macros its source is built with
DEFINES: Dict[str, Tuple[str, ...]] = {
    "gwt_adam_fused_group": ("-DGWT_ADAM_GROUPED",),
    "gwt_adam_fused_q8_group": ("-DGWT_ADAM_GROUPED",),
}

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels under " + str(KERNELS))


def _target(name: str) -> Path:
    source, headers = SOURCES[name]
    h = hashlib.sha256(source.read_bytes())
    for header in headers:
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names=tuple(SOURCES), verbose: bool = False) -> Dict[str, Path]:
    """Compile the libraries of ``names`` that are not built yet, one
    ``nvcc`` process per source, all started together; returns their
    paths.  ``verbose`` adds ``-Xptxas -v`` and prints each report."""
    out = {name: _target(name) for name in names}
    todo = [n for n in names if verbose or not out[n].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for name in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, *DEFINES.get(name.split("@")[0], ()),
                   *(["-Xptxas", "-v"] if verbose else []), "-o", tmp,
                   str(SOURCES[name][0])]
            jobs.append((name, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for name, tmp, proc in jobs:
            _, err = proc.communicate()
            source = SOURCES[name][0].name
            if proc.returncode != 0:
                failed.append(f"{source} ({proc.returncode}):\n{err}")
            else:
                if verbose:
                    print(f"{source}:\n{err}", end="")
                os.replace(tmp, out[name])
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
    finally:
        for _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


def load(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The library ``name``, built if needed; ``declare`` sets its
    functions' ``argtypes`` and ``restype`` when it is first loaded."""
    if name not in _libs:
        lib = ctypes.CDLL(str(build_all((name,))[name]))
        declare(lib)
        _libs[name] = lib
    return _libs[name]
