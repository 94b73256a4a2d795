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

K1 and K2 have two designs each.  The one-pass design is one cooperative
launch that keeps the bucket's rounded G̃ in shared memory across a grid
barrier and reads every input once; the two-pass design (a norm pass, then
a write pass that recomputes) takes the buckets whose G̃ does not fit on
chip.  :func:`gwt_adam_fused` and :func:`gwt_adam_fused_q8` choose by
:func:`one_pass_fits`, before the launch, from the bucket's shape, dtype
and level and the card's capacity; :func:`gwt_adam_fused_two_pass` and
the other three ``*_one_pass`` / ``*_two_pass`` functions launch one design
(for comparisons of the two on the card).  Both designs give bitwise the
same results.

``launches``, ``launches_q8``, ``launches_tile`` and ``launches_tile_q8``
count the calls of the K1, K2, K4 and K5 entries that launched their
kernel; ``launches_one_pass``, ``launches_two_pass``,
``launches_q8_one_pass`` and ``launches_q8_two_pass`` count K1's and K2's
launches by design.  Nothing else changes them.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

launches = 0
launches_one_pass = 0
launches_two_pass = 0
launches_q8 = 0
launches_q8_one_pass = 0
launches_q8_two_pass = 0
launches_tile = 0
launches_tile_q8 = 0

# coefficients per chunk (kChunk of the CUDA sources: a two-pass block's
# share, a one-pass slot) and per quantization block (kQBlock)
CHUNK = 2048
QBLOCK = 64

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the fields the one-pass plan functions fill, in their order
PLAN_FIELDS = ("regs", "local_bytes", "static_smem", "max_dyn_smem", "sms",
               "blocks_per_sm", "slots", "smem", "grid")


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


def _declare_fused(lib, name: str, n_ptrs: int, extras) -> None:
    args = [_I, _I] + [_VP] * n_ptrs + [_LL, _LL] + [_F] * 6 + [_I, _I, _VP]
    _declare(getattr(lib, name), args, extras)
    _declare(getattr(lib, name + "_one_pass"), args)
    _declare(getattr(lib, name + "_one_pass_plan"), [_I, _I, _LL, _LL, _VP])


_DECLARE = {
    "gwt_adam_fused": lambda lib: _declare_fused(
        lib, "gwt_adam_fused", 9, (lib.gwt_adam_fused_chunk,)),
    "gwt_adam_fused_q8": lambda lib: _declare_fused(
        lib, "gwt_adam_fused_q8", 13,
        (lib.gwt_adam_fused_q8_chunk, lib.gwt_adam_fused_q8_qblock)),
    "gwt_adam_tile": _declare_tile,
}


def _load(name: str) -> ctypes.CDLL:
    lib = build.load(name, _DECLARE[name])
    if name.startswith("gwt_adam_fused"):
        chunk = getattr(lib, name + "_chunk")()
        if chunk != CHUNK:
            raise RuntimeError(f"{name} was built with chunks of {chunk} "
                               f"coefficients, this module assumes {CHUNK}")
    return lib


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
    """Common checks of all four kernels; returns ``(L, rows, n, na)``.
    The device is checked last, by :func:`_require_cuda`, so that every
    other refusal shows on any device."""
    if g.ndim != 3:
        raise ValueError(f"g must be (L, rows, n), got {tuple(g.shape)}")
    if not 1 <= level <= 4:
        raise ValueError(f"level {level} outside the kernel's 1..4")
    L, rows, n = g.shape
    if n % (1 << level):
        raise ValueError(f"n={n} not divisible by 2^{level}")
    if g.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {g.dtype}")
    return L, rows, n, rows * (n >> level)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _require_cuda(g: torch.Tensor) -> None:
    if g.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got "
                         f"{g.device}")


def _check_scalars(device, L, prev_norm, step_size, wd_coef) -> None:
    _check("prev_norm", prev_norm, device, torch.float32, (L,))
    _check("step_size", step_size, device, torch.float32, ())
    _check("wd_coef", wd_coef, device, torch.float32, ())


def one_pass_fits(shape: Tuple[int, int, int], dtype: torch.dtype,
                  level: int, sms: int, smem_per_block: int) -> bool:
    """Whether an ``(L, rows, n)`` bucket of ``dtype`` at ``level`` takes
    K1's or K2's one-pass design on a card with ``sms`` SMs whose blocks
    have ``smem_per_block`` bytes of dynamic shared memory for G̃ slots
    (the plan's ``max_dyn_smem``: the kernel's limit less its static shared
    memory and, for K2, its staging ring): the bucket's rounded G̃, in slots
    of ``CHUNK`` coefficients (``CHUNK * 2^level`` values), must fit one
    block per SM.  The limiter does not enter: without it the one-pass
    kernel still stages g by slots."""
    L, rows, n = shape
    na = rows * (n >> level)
    total = L * -(-na // CHUNK)
    if total == 0:
        return False
    slot = CHUNK * (1 << level) * dtype.itemsize
    return -(-total // sms) * slot <= smem_per_block


_plans: Dict[tuple, Dict[str, int]] = {}


def one_pass_plan(name: str, shape: Tuple[int, int, int],
                  dtype: torch.dtype, level: int) -> Dict[str, int]:
    """The one-pass plan of kernel ``name`` (``"gwt_adam_fused"`` or
    ``"gwt_adam_fused_q8"``) for a bucket, from the card: the kernel's
    registers per thread, spill bytes, static shared bytes and the dynamic
    shared bytes a block may give its G̃ slots (``max_dyn_smem``); the
    card's SMs; and, if the bucket fits, its blocks per SM, slots per
    block, dynamic shared bytes per block (slots and ring) and grid (0
    where it does not fit)."""
    L, rows, n = shape
    na = rows * (n >> level)
    key = (name, torch.cuda.current_device(), dtype, level,
           L * -(-na // CHUNK))
    if key not in _plans:
        lib = _load(name)
        plan_fn = getattr(lib, name + "_one_pass_plan")
        out = (ctypes.c_int * len(PLAN_FIELDS))()
        # one chunk always fits: the kernel's and the card's fields
        err = plan_fn(_DTYPES[dtype], level, 1, CHUNK,
                      ctypes.cast(out, _VP))
        if err != 0:
            raise RuntimeError(f"{name} one-pass plan failed: CUDA error "
                               f"{err}")
        info = dict(zip(PLAN_FIELDS, out))
        if one_pass_fits(shape, dtype, level, info["sms"],
                         info["max_dyn_smem"]):
            err = plan_fn(_DTYPES[dtype], level, L, na, ctypes.cast(out, _VP))
            if err != 0:
                raise RuntimeError(f"{name} one-pass plan of {shape} failed: "
                                   f"CUDA error {err}")
            info = dict(zip(PLAN_FIELDS, out))
        else:
            info.update(blocks_per_sm=0, slots=0, smem=0, grid=0)
        _plans[key] = info
    return _plans[key]


def _design(name: str, design: str, g: torch.Tensor, level: int) -> str:
    """``"one"`` or ``"two"``: ``design`` itself, or for ``"auto"`` the
    one the capacity rule names; raises if ``"one"`` does not fit."""
    fits = one_pass_plan(name, tuple(g.shape), g.dtype, level)["grid"] > 0
    if design == "auto":
        return "one" if fits else "two"
    if design == "one" and not fits:
        raise ValueError(f"a {tuple(g.shape)} {g.dtype} bucket at level "
                         f"{level} does not fit the one-pass design")
    return design


def _fused(design: str, g, p, m, v, prev_norm, step_size, wd_coef, *,
           level, gamma, use_limiter, weight_decay, b1=0.9, b2=0.999,
           eps=1e-6):
    global launches, launches_one_pass, launches_two_pass
    L, rows, n, na = _check_bucket(g, level)
    device = g.device
    _check("g", g, device, g.dtype, (L, rows, n))
    _check("p", p, device, g.dtype, (L, rows, n))
    _check("m", m, device, torch.float32, (L, rows, n >> level))
    _check("v", v, device, torch.float32, (L, rows, n >> level))
    _check_scalars(device, L, prev_norm, step_size, wd_coef)
    _require_cuda(g)
    design = _design("gwt_adam_fused", design, g, level)
    lib = _load("gwt_adam_fused")
    fn = lib.gwt_adam_fused_one_pass if design == "one" \
        else lib.gwt_adam_fused
    partials = torch.empty((L, -(-na // CHUNK)), dtype=torch.float32,
                           device=device)
    new_norm = torch.empty((L,), dtype=torch.float32, device=device)
    stream = _stream(device)
    err = fn(
        _DTYPES[g.dtype], level, g.data_ptr(), p.data_ptr(), m.data_ptr(),
        v.data_ptr(), prev_norm.data_ptr(), new_norm.data_ptr(),
        partials.data_ptr(), step_size.data_ptr(), wd_coef.data_ptr(),
        L, na, gamma, b1, 1 - b1, b2, 1 - b2, eps, int(use_limiter),
        int(weight_decay), stream)
    if err != 0:
        raise RuntimeError(f"gwt_adam_fused ({design}-pass) launch failed: "
                           f"CUDA error {err}")
    launches += 1
    if design == "one":
        launches_one_pass += 1
    else:
        launches_two_pass += 1
    return p, m, v, new_norm


def gwt_adam_fused(g: torch.Tensor, p: torch.Tensor, m: torch.Tensor,
                   v: torch.Tensor, prev_norm: torch.Tensor,
                   step_size: torch.Tensor, wd_coef: torch.Tensor, *,
                   level: int, gamma: float, use_limiter: bool,
                   weight_decay: bool, b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-6):
    """Fused-write update of a whole ``(L, rows, n)`` bucket on the card,
    one pass where the bucket fits (:func:`one_pass_fits`), else two.

    ``g``, ``p``: the parameter dtype (f32 or bf16); ``m``, ``v``: f32
    ``(L, rows, n >> level)``; ``prev_norm``: f32 ``(L,)``; ``step_size``,
    ``wd_coef``: f32 scalars on the card.  ``p``, ``m``, ``v`` are updated
    in place.  Returns ``(p, m, v, new_norm)``; raises on any input the
    kernel does not take and on a failed launch."""
    return _fused("auto", g, p, m, v, prev_norm, step_size, wd_coef,
                  level=level, gamma=gamma, use_limiter=use_limiter,
                  weight_decay=weight_decay, b1=b1, b2=b2, eps=eps)


def gwt_adam_fused_one_pass(*args, **kw):
    """:func:`gwt_adam_fused` through the one-pass design; raises if the
    bucket does not fit it."""
    return _fused("one", *args, **kw)


def gwt_adam_fused_two_pass(*args, **kw):
    """:func:`gwt_adam_fused` through the two-pass design."""
    return _fused("two", *args, **kw)


def _fused_q8(design: str, g, p, qm, sm, qv, sv, salt_m, salt_v, prev_norm,
              step_size, wd_coef, *, level, block, gamma, use_limiter,
              weight_decay, b1=0.9, b2=0.999, eps=1e-6):
    global launches_q8, launches_q8_one_pass, launches_q8_two_pass
    L, rows, n, na = _check_bucket(g, level)
    device = g.device
    if block != QBLOCK:
        raise ValueError(f"the kernel quantizes in blocks of {QBLOCK}, not "
                         f"{block}")
    nb = -(-na // block)
    _check("g", g, device, g.dtype, (L, rows, n))
    _check("p", p, device, g.dtype, (L, rows, n))
    for name, q, s in (("m", qm, sm), ("v", qv, sv)):
        _check(f"q{name}", q, device, torch.int8, (L, rows, n >> level))
        _check(f"s{name}", s, device, torch.float32, (L, nb))
    _check("salt_m", salt_m, device, torch.uint32, (L,))
    _check("salt_v", salt_v, device, torch.uint32, (L,))
    _check_scalars(device, L, prev_norm, step_size, wd_coef)
    _require_cuda(g)
    design = _design("gwt_adam_fused_q8", design, g, level)
    lib = _load("gwt_adam_fused_q8")
    if lib.gwt_adam_fused_q8_qblock() != QBLOCK:
        raise RuntimeError(f"gwt_adam_fused_q8 was built with blocks of "
                           f"{lib.gwt_adam_fused_q8_qblock()}, this module "
                           f"assumes {QBLOCK}")
    fn = lib.gwt_adam_fused_q8_one_pass if design == "one" \
        else lib.gwt_adam_fused_q8
    partials = torch.empty((L, -(-na // CHUNK)), dtype=torch.float32,
                           device=device)
    new_norm = torch.empty((L,), dtype=torch.float32, device=device)
    stream = _stream(device)
    err = fn(
        _DTYPES[g.dtype], level, g.data_ptr(), p.data_ptr(), qm.data_ptr(),
        sm.data_ptr(), qv.data_ptr(), sv.data_ptr(), salt_m.data_ptr(),
        salt_v.data_ptr(), prev_norm.data_ptr(), new_norm.data_ptr(),
        partials.data_ptr(), step_size.data_ptr(), wd_coef.data_ptr(),
        L, na, gamma, b1, 1 - b1, b2, 1 - b2, eps, int(use_limiter),
        int(weight_decay), stream)
    if err != 0:
        raise RuntimeError(f"gwt_adam_fused_q8 ({design}-pass) launch "
                           f"failed: CUDA error {err}")
    launches_q8 += 1
    if design == "one":
        launches_q8_one_pass += 1
    else:
        launches_q8_two_pass += 1
    return p, qm, sm, qv, sv, new_norm


def gwt_adam_fused_q8(g: torch.Tensor, p: torch.Tensor, qm: torch.Tensor,
                      sm: torch.Tensor, qv: torch.Tensor, sv: torch.Tensor,
                      salt_m: torch.Tensor, salt_v: torch.Tensor,
                      prev_norm: torch.Tensor, step_size: torch.Tensor,
                      wd_coef: torch.Tensor, *, level: int, block: int,
                      gamma: float, use_limiter: bool, weight_decay: bool,
                      b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6):
    """Fused-write update of an ``(L, rows, n)`` bucket over blocked-int8
    moments on the card, one pass where the bucket fits
    (:func:`one_pass_fits`), else two.

    ``qm``, ``qv``: int8 ``(L, rows, n >> level)``; ``sm``, ``sv``: f32
    ``(L, ceil(rows * (n >> level) / block))``; ``salt_m``, ``salt_v``:
    uint32 ``(L,)``; the rest as for :func:`gwt_adam_fused`.  ``p`` and the
    codes and scales are updated in place.  Returns ``(p, qm, sm, qv, sv,
    new_norm)``; raises on any input the kernel does not take and on a
    failed launch."""
    return _fused_q8("auto", g, p, qm, sm, qv, sv, salt_m, salt_v,
                     prev_norm, step_size, wd_coef, level=level, block=block,
                     gamma=gamma, use_limiter=use_limiter,
                     weight_decay=weight_decay, b1=b1, b2=b2, eps=eps)


def gwt_adam_fused_q8_one_pass(*args, **kw):
    """:func:`gwt_adam_fused_q8` through the one-pass design; raises if
    the bucket does not fit it."""
    return _fused_q8("one", *args, **kw)


def gwt_adam_fused_q8_two_pass(*args, **kw):
    """:func:`gwt_adam_fused_q8` through the two-pass design."""
    return _fused_q8("two", *args, **kw)


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
    _require_cuda(g)
    lib = _load("gwt_adam_tile")
    gt, m_out, v_out = (torch.empty_like(t) for t in (g, m, v))
    partials = _partials(lib, L, na, device)
    stream = _stream(device)
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
    if block != QBLOCK:
        raise ValueError(f"the kernel quantizes in blocks of {QBLOCK}, not "
                         f"{block}")
    nb = -(-na // block)
    _check("g", g, device, g.dtype, (L, rows, n))
    for name, q, s in (("m", qm, sm), ("v", qv, sv)):
        _check(f"q{name}", q, device, torch.int8, (L, rows, n >> level))
        _check(f"s{name}", s, device, torch.float32, (L, nb))
    _check("salt_m", salt_m, device, torch.uint32, (L,))
    _check("salt_v", salt_v, device, torch.uint32, (L,))
    _require_cuda(g)
    lib = _load("gwt_adam_tile")
    if lib.gwt_adam_tile_qblock() != QBLOCK:
        raise RuntimeError(f"gwt_adam_tile was built with blocks of "
                           f"{lib.gwt_adam_tile_qblock()}, this module "
                           f"assumes {QBLOCK}")
    gt, qm_out, sm_out, qv_out, sv_out = (
        torch.empty_like(t) for t in (g, qm, sm, qv, sv))
    partials = _partials(lib, L, na, device)
    stream = _stream(device)
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
