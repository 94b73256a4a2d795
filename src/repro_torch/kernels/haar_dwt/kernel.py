"""Binding and launch of the hand-written CUDA Haar DWT kernels
(``csrc/haar_dwt.cu``), counterparts of the TPU kernels in
``repro/kernels/haar_dwt/kernel.py``:

* :func:`haar_dwt_fwd` of ``haar_dwt_fwd`` (bands in the input dtype);
* :func:`haar_dwt_fwd_q` of ``haar_dwt_fwd_q`` (A_l in f32, details in the
  wire dtype);
* :func:`haar_dwt_inv` of ``haar_dwt_inv``.

The library is built and loaded by ``repro_torch.kernels.build``.
``launches_fwd``, ``launches_fwd_q`` and ``launches_inv`` count the calls of
each function that launched its kernel; nothing else changes them.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import build

launches_fwd = 0
launches_fwd_q = 0
launches_inv = 0

# dtype codes of csrc/haar_dwt.cu
_IN = {torch.float32: 0, torch.bfloat16: 1}
_WIRE = {torch.bfloat16: 1, torch.float16: 2, torch.float8_e4m3fn: 3}
_VP, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _declare(lib: ctypes.CDLL) -> None:
    for fn in (lib.haar_dwt_fwd, lib.haar_dwt_fwd_q, lib.haar_dwt_inv):
        fn.argtypes = [_I, _I, _VP, _VP, _VP, _LL, _I, _VP]
        fn.restype = _I
    lib.haar_dwt_max_level.argtypes = []
    lib.haar_dwt_max_level.restype = _I


def _lib() -> ctypes.CDLL:
    return build.load("haar_dwt", _declare)


def _ptrs(tensors: Sequence[torch.Tensor]):
    return (_VP * len(tensors))(*(t.data_ptr() for t in tensors))


def _aligned(*tensors: torch.Tensor) -> int:
    return int(all(t.data_ptr() % 16 == 0 for t in tensors))


def _check_input(name: str, x: torch.Tensor, level: int) -> Tuple[int, int]:
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got "
                         f"{name} on {x.device}")
    if x.ndim != 2:
        raise ValueError(f"{name} must be 2-D (m, n), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    top = _lib().haar_dwt_max_level()
    if not 1 <= level <= top:
        raise ValueError(f"level {level} outside the kernel's 1..{top}")
    return x.shape


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _bands(g: torch.Tensor, level: int, a_dtype: torch.dtype,
           d_dtype: torch.dtype) -> List[torch.Tensor]:
    m, n = g.shape
    if n % (1 << level):
        raise ValueError(f"n={n} not divisible by 2^{level}")
    return [torch.empty((m, n >> level), dtype=a_dtype, device=g.device)] + [
        torch.empty((m, n >> k), dtype=d_dtype, device=g.device)
        for k in range(level, 0, -1)]


def haar_dwt_fwd(g: torch.Tensor, level: int) -> Tuple[torch.Tensor, ...]:
    """``(A_l, D_l, ..., D_1)`` of a contiguous ``(m, n)`` f32 or bf16 CUDA
    tensor, every band in ``g``'s dtype."""
    global launches_fwd
    _check_input("g", g, level)
    if g.dtype not in _IN:
        raise ValueError(f"unsupported dtype {g.dtype}")
    out = _bands(g, level, g.dtype, g.dtype)
    err = _lib().haar_dwt_fwd(
        _IN[g.dtype], level, g.data_ptr(), out[0].data_ptr(), _ptrs(out[1:]),
        out[0].numel(), _aligned(g),
        torch.cuda.current_stream(g.device).cuda_stream)
    _launched("haar_dwt_fwd", err)
    launches_fwd += 1
    return tuple(out)


def haar_dwt_fwd_q(g: torch.Tensor, level: int, detail_dtype: torch.dtype
                   ) -> Tuple[torch.Tensor, ...]:
    """``(A_l f32, D_l..D_1 in detail_dtype)`` of a contiguous ``(m, n)``
    f32 CUDA tensor; ``detail_dtype`` is bf16, f16 or float8_e4m3fn."""
    global launches_fwd_q
    _check_input("g", g, level)
    if g.dtype != torch.float32:
        raise ValueError(f"g must be float32, got {g.dtype}")
    if detail_dtype not in _WIRE:
        raise ValueError(f"unsupported wire dtype {detail_dtype}")
    out = _bands(g, level, torch.float32, detail_dtype)
    err = _lib().haar_dwt_fwd_q(
        _WIRE[detail_dtype], level, g.data_ptr(), out[0].data_ptr(),
        _ptrs(out[1:]), out[0].numel(), _aligned(g),
        torch.cuda.current_stream(g.device).cuda_stream)
    _launched("haar_dwt_fwd_q", err)
    launches_fwd_q += 1
    return tuple(out)


def haar_dwt_inv(a: torch.Tensor, details: Sequence[torch.Tensor]
                 ) -> torch.Tensor:
    """``(A_l, [D_l..D_1]) -> (m, n)``: contiguous CUDA tensors of one dtype
    (f32 or bf16), the output in that dtype."""
    global launches_inv
    level = len(details)
    m, na = _check_input("a", a, level)
    if a.dtype not in _IN:
        raise ValueError(f"unsupported dtype {a.dtype}")
    for i, d in enumerate(details):
        want = (m, na << i)
        if d.dtype != a.dtype or tuple(d.shape) != want \
                or d.device != a.device or not d.is_contiguous():
            raise ValueError(
                f"detail {i} must be a contiguous {a.dtype} {want} tensor on "
                f"{a.device}, got {d.dtype} {tuple(d.shape)} on {d.device}")
    out = torch.empty((m, na << level), dtype=a.dtype, device=a.device)
    err = _lib().haar_dwt_inv(
        _IN[a.dtype], level, a.data_ptr(), _ptrs(details), out.data_ptr(),
        a.numel(), _aligned(a, *details),
        torch.cuda.current_stream(a.device).cuda_stream)
    _launched("haar_dwt_inv", err)
    launches_inv += 1
    return out
