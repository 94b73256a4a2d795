"""Build, binding and launch of the hand-written CUDA fused-write kernel
(``csrc/gwt_adam_fused.cu``), counterpart of the TPU kernel
``gwt_adam_tile_fused`` in ``repro/kernels/gwt_adam/kernel.py``.

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface on first use, and bound with ``ctypes``.  The
library goes to ``build/torch_kernels/`` at the repository root, named by
the hash of its source, so an edited source is rebuilt.  Nothing is
compiled when this module is imported.

``launches`` counts calls of :func:`gwt_adam_fused` that launched the
kernel; nothing else changes it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "gwt_adam_fused.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

launches = 0

_lib: Optional[ctypes.CDLL] = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"{SOURCE.name}")


def build(verbose: bool = False) -> Path:
    """Compile the kernel library if it is not built yet; returns its path.
    ``verbose`` adds ``-Xptxas -v`` and prints the compiler's report."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libgwt_adam_fused_{digest}.so"
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(SOURCE)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
        if verbose:
            print(r.stderr, end="")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ll, f, i = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
                        ctypes.c_int)
        lib.gwt_adam_fused.argtypes = [i, i, vp, vp, vp, vp, vp, vp, vp, vp,
                                       vp, ll, ll, f, f, f, f, f, f, i, i, vp]
        lib.gwt_adam_fused.restype = i
        lib.gwt_adam_fused_chunk.argtypes = []
        lib.gwt_adam_fused_chunk.restype = i
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, device: torch.device,
           dtype: torch.dtype, shape: Tuple[int, ...]) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def gwt_adam_fused(g: torch.Tensor, p: torch.Tensor, m: torch.Tensor,
                   v: torch.Tensor, prev_norm: torch.Tensor,
                   step_size: torch.Tensor, wd_coef: torch.Tensor, *,
                   level: int, gamma: float, use_limiter: bool,
                   weight_decay: bool, b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-6):
    """Fused-write update of a whole ``(L, rows, n)`` bucket on the card.

    ``g``, ``p``: the parameter dtype (f32 or bf16); ``m``, ``v``: f32
    ``(L, rows, n >> level)``; ``prev_norm``: f32 ``(L,)``; ``step_size``,
    ``wd_coef``: f32 scalars on the card.  ``p``, ``m``, ``v`` are updated
    in place.  Returns ``(p, m, v, new_norm)``; raises on any input the
    kernel does not take and on a failed launch."""
    global launches
    if g.ndim != 3:
        raise ValueError(f"g must be (L, rows, n), got {tuple(g.shape)}")
    if not 1 <= level <= 4:
        raise ValueError(f"level {level} outside the kernel's 1..4")
    L, rows, n = g.shape
    if n % (1 << level):
        raise ValueError(f"n={n} not divisible by 2^{level}")
    device = g.device
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {device}")
    if g.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {g.dtype}")
    na = rows * (n >> level)
    _check("g", g, device, g.dtype, (L, rows, n))
    _check("p", p, device, g.dtype, (L, rows, n))
    _check("m", m, device, torch.float32, (L, rows, n >> level))
    _check("v", v, device, torch.float32, (L, rows, n >> level))
    _check("prev_norm", prev_norm, device, torch.float32, (L,))
    _check("step_size", step_size, device, torch.float32, ())
    _check("wd_coef", wd_coef, device, torch.float32, ())
    lib = _load()
    chunk = lib.gwt_adam_fused_chunk()
    partials = torch.empty((L, -(-na // chunk)), dtype=torch.float32,
                           device=device)
    new_norm = torch.empty((L,), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.gwt_adam_fused(
        _DTYPES[g.dtype], level, g.data_ptr(), p.data_ptr(), m.data_ptr(),
        v.data_ptr(), prev_norm.data_ptr(), new_norm.data_ptr(),
        partials.data_ptr(), step_size.data_ptr(), wd_coef.data_ptr(),
        L, na, gamma, b1, 1 - b1, b2, 1 - b2, eps, int(use_limiter),
        int(weight_decay), stream)
    if err != 0:
        raise RuntimeError(f"gwt_adam_fused launch failed: CUDA error {err}")
    launches += 1
    return p, m, v, new_norm
