"""Build, binding and launch of the hand-written CUDA GWT-Adam kernels,
counterparts of the TPU kernels of ``repro/kernels/gwt_adam/kernel.py``:

* ``gwt_adam_fused`` (K1, ``csrc/gwt_adam_fused.cu``, f32 moments):
  ``gwt_adam_tile_fused`` there, the fused write;
* ``gwt_adam_fused_q8`` (K2, ``csrc/gwt_adam_fused_q8.cu``, blocked-int8
  moments): ``gwt_adam_tile_fused_q8``;
* ``gwt_adam_tile`` (K4, ``csrc/gwt_adam_tile.cu``, f32 moments):
  ``gwt_adam_tile``, the staged update that returns G̃;
* ``gwt_adam_tile_q8`` (K5, the same source, blocked-int8 moments):
  ``gwt_adam_tile_q8``.

All are built and loaded by ``repro_torch.kernels.build`` (nvcc for
``sm_90a``, a plain C interface bound with ``ctypes``).

``launches``, ``launches_q8``, ``launches_tile`` and ``launches_tile_q8``
count the calls of :func:`gwt_adam_fused`, :func:`gwt_adam_fused_q8`,
:func:`gwt_adam_tile` and :func:`gwt_adam_tile_q8` that launched their
kernel; nothing else changes them.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

launches = 0
launches_q8 = 0
launches_tile = 0
launches_tile_q8 = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


_VP, _LL, _F, _I = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
                   ctypes.c_int)


def _declare(fn, argtypes, extras=()) -> None:
    fn.argtypes, fn.restype = argtypes, _I
    for extra in extras:
        extra.argtypes, extra.restype = [], _I


def _declare_tile(lib) -> None:
    _declare(lib.gwt_adam_tile,
             [_I, _I] + [_VP] * 7 + [_LL, _LL] + [_F] * 5 + [_VP],
             (lib.gwt_adam_tile_chunk, lib.gwt_adam_tile_qblock))
    _declare(lib.gwt_adam_tile_q8,
             [_I, _I] + [_VP] * 13 + [_LL, _LL] + [_F] * 5 + [_VP])


_DECLARE = {
    "gwt_adam_fused": lambda lib: _declare(
        lib.gwt_adam_fused,
        [_I, _I] + [_VP] * 9 + [_LL, _LL] + [_F] * 6 + [_I, _I, _VP],
        (lib.gwt_adam_fused_chunk,)),
    "gwt_adam_fused_q8": lambda lib: _declare(
        lib.gwt_adam_fused_q8,
        [_I, _I] + [_VP] * 13 + [_LL, _LL] + [_F] * 6 + [_I, _I, _VP],
        (lib.gwt_adam_fused_q8_chunk, lib.gwt_adam_fused_q8_qblock)),
    "gwt_adam_tile": _declare_tile,
}


def _load(name: str) -> ctypes.CDLL:
    return build.load(name, _DECLARE[name])


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


def _check_bucket(g: torch.Tensor, level: int) -> Tuple[int, int, int, int]:
    """Common checks of both kernels; returns ``(L, rows, n, na)``."""
    if g.ndim != 3:
        raise ValueError(f"g must be (L, rows, n), got {tuple(g.shape)}")
    if not 1 <= level <= 4:
        raise ValueError(f"level {level} outside the kernel's 1..4")
    L, rows, n = g.shape
    if n % (1 << level):
        raise ValueError(f"n={n} not divisible by 2^{level}")
    if g.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got "
                         f"{g.device}")
    if g.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {g.dtype}")
    return L, rows, n, rows * (n >> level)


def _check_scalars(device, L, prev_norm, step_size, wd_coef) -> None:
    _check("prev_norm", prev_norm, device, torch.float32, (L,))
    _check("step_size", step_size, device, torch.float32, ())
    _check("wd_coef", wd_coef, device, torch.float32, ())


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
    L, rows, n, na = _check_bucket(g, level)
    device = g.device
    _check("g", g, device, g.dtype, (L, rows, n))
    _check("p", p, device, g.dtype, (L, rows, n))
    _check("m", m, device, torch.float32, (L, rows, n >> level))
    _check("v", v, device, torch.float32, (L, rows, n >> level))
    _check_scalars(device, L, prev_norm, step_size, wd_coef)
    lib = _load("gwt_adam_fused")
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


def gwt_adam_fused_q8(g: torch.Tensor, p: torch.Tensor, qm: torch.Tensor,
                      sm: torch.Tensor, qv: torch.Tensor, sv: torch.Tensor,
                      salt_m: torch.Tensor, salt_v: torch.Tensor,
                      prev_norm: torch.Tensor, step_size: torch.Tensor,
                      wd_coef: torch.Tensor, *, level: int, block: int,
                      gamma: float, use_limiter: bool, weight_decay: bool,
                      b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6):
    """Fused-write update of an ``(L, rows, n)`` bucket over blocked-int8
    moments on the card.

    ``qm``, ``qv``: int8 ``(L, rows, n >> level)``; ``sm``, ``sv``: f32
    ``(L, ceil(rows * (n >> level) / block))``; ``salt_m``, ``salt_v``:
    uint32 ``(L,)``; the rest as for :func:`gwt_adam_fused`.  ``p`` and the
    codes and scales are updated in place.  Returns ``(p, qm, sm, qv, sv,
    new_norm)``; raises on any input the kernel does not take and on a
    failed launch."""
    global launches_q8
    L, rows, n, na = _check_bucket(g, level)
    device = g.device
    lib = _load("gwt_adam_fused_q8")
    if block != lib.gwt_adam_fused_q8_qblock():
        raise ValueError(f"the kernel quantizes in blocks of "
                         f"{lib.gwt_adam_fused_q8_qblock()}, not {block}")
    nb = -(-na // block)
    _check("g", g, device, g.dtype, (L, rows, n))
    _check("p", p, device, g.dtype, (L, rows, n))
    for name, q, s in (("m", qm, sm), ("v", qv, sv)):
        _check(f"q{name}", q, device, torch.int8, (L, rows, n >> level))
        _check(f"s{name}", s, device, torch.float32, (L, nb))
    _check("salt_m", salt_m, device, torch.uint32, (L,))
    _check("salt_v", salt_v, device, torch.uint32, (L,))
    _check_scalars(device, L, prev_norm, step_size, wd_coef)
    chunk = lib.gwt_adam_fused_q8_chunk()
    partials = torch.empty((L, -(-na // chunk)), dtype=torch.float32,
                           device=device)
    new_norm = torch.empty((L,), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.gwt_adam_fused_q8(
        _DTYPES[g.dtype], level, g.data_ptr(), p.data_ptr(), qm.data_ptr(),
        sm.data_ptr(), qv.data_ptr(), sv.data_ptr(), salt_m.data_ptr(),
        salt_v.data_ptr(), prev_norm.data_ptr(), new_norm.data_ptr(),
        partials.data_ptr(), step_size.data_ptr(), wd_coef.data_ptr(),
        L, na, gamma, b1, 1 - b1, b2, 1 - b2, eps, int(use_limiter),
        int(weight_decay), stream)
    if err != 0:
        raise RuntimeError(
            f"gwt_adam_fused_q8 launch failed: CUDA error {err}")
    launches_q8 += 1
    return p, qm, sm, qv, sv, new_norm


def _partials(lib, L: int, na: int, device) -> torch.Tensor:
    chunk = lib.gwt_adam_tile_chunk()
    return torch.empty((L, -(-na // chunk)), dtype=torch.float32,
                       device=device)


def gwt_adam_tile(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, *,
                  level: int, b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-6):
    """Staged update of an ``(L, rows, n)`` stack on the card (K4).

    ``g``: f32 or bf16; ``m``, ``v``: f32 ``(L, rows, n >> level)``.
    Returns new tensors ``(G̃ in g's dtype, m', v', partials)``:
    ``partials`` is f32 ``(L, S)``, leaf ``l``'s ``‖G̃‖²`` of the rounded G̃
    in ``S`` fixed-order pieces (their sum is the leaf's).  Raises on any
    input the kernel does not take and on a failed launch."""
    global launches_tile
    L, rows, n, na = _check_bucket(g, level)
    device = g.device
    _check("g", g, device, g.dtype, (L, rows, n))
    _check("m", m, device, torch.float32, (L, rows, n >> level))
    _check("v", v, device, torch.float32, (L, rows, n >> level))
    lib = _load("gwt_adam_tile")
    gt, m_out, v_out = (torch.empty_like(t) for t in (g, m, v))
    partials = _partials(lib, L, na, device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.gwt_adam_tile(
        _DTYPES[g.dtype], level, g.data_ptr(), m.data_ptr(), v.data_ptr(),
        gt.data_ptr(), m_out.data_ptr(), v_out.data_ptr(),
        partials.data_ptr(), L, na, b1, 1 - b1, b2, 1 - b2, eps, stream)
    if err != 0:
        raise RuntimeError(f"gwt_adam_tile launch failed: CUDA error {err}")
    launches_tile += 1
    return gt, m_out, v_out, partials


def gwt_adam_tile_q8(g: torch.Tensor, qm: torch.Tensor, sm: torch.Tensor,
                     qv: torch.Tensor, sv: torch.Tensor,
                     salt_m: torch.Tensor, salt_v: torch.Tensor, *,
                     level: int, block: int, b1: float = 0.9,
                     b2: float = 0.999, eps: float = 1e-6):
    """Staged update of an ``(L, rows, n)`` stack over blocked-int8
    moments on the card (K5).

    ``qm``, ``qv``: int8 ``(L, rows, n >> level)``; ``sm``, ``sv``: f32
    ``(L, ceil(rows * (n >> level) / block))``; ``salt_m``, ``salt_v``:
    uint32 ``(L,)``.  Returns new tensors ``(G̃, qm', sm', qv', sv',
    partials)``, ``partials`` as for :func:`gwt_adam_tile`; raises on any
    input the kernel does not take and on a failed launch."""
    global launches_tile_q8
    L, rows, n, na = _check_bucket(g, level)
    device = g.device
    lib = _load("gwt_adam_tile")
    if block != lib.gwt_adam_tile_qblock():
        raise ValueError(f"the kernel quantizes in blocks of "
                         f"{lib.gwt_adam_tile_qblock()}, not {block}")
    nb = -(-na // block)
    _check("g", g, device, g.dtype, (L, rows, n))
    for name, q, s in (("m", qm, sm), ("v", qv, sv)):
        _check(f"q{name}", q, device, torch.int8, (L, rows, n >> level))
        _check(f"s{name}", s, device, torch.float32, (L, nb))
    _check("salt_m", salt_m, device, torch.uint32, (L,))
    _check("salt_v", salt_v, device, torch.uint32, (L,))
    gt, qm_out, sm_out, qv_out, sv_out = (
        torch.empty_like(t) for t in (g, qm, sm, qv, sv))
    partials = _partials(lib, L, na, device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.gwt_adam_tile_q8(
        _DTYPES[g.dtype], level, g.data_ptr(), qm.data_ptr(), sm.data_ptr(),
        qv.data_ptr(), sv.data_ptr(), salt_m.data_ptr(), salt_v.data_ptr(),
        gt.data_ptr(), qm_out.data_ptr(), sm_out.data_ptr(),
        qv_out.data_ptr(), sv_out.data_ptr(), partials.data_ptr(), L, na, b1,
        1 - b1, b2, 1 - b2, eps, stream)
    if err != 0:
        raise RuntimeError(
            f"gwt_adam_tile_q8 launch failed: CUDA error {err}")
    launches_tile_q8 += 1
    return gt, qm_out, sm_out, qv_out, sv_out, partials
