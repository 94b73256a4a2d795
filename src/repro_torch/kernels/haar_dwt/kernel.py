"""Binding and launch of the hand-written CUDA Haar DWT kernels
(``csrc/haar_dwt.cu``), counterparts of the TPU kernels in
``repro/kernels/haar_dwt/kernel.py``:

* :func:`haar_dwt_fwd_group` and :func:`haar_dwt_fwd` of ``haar_dwt_fwd``
  (bands in the input dtype, "K6");
* :func:`haar_dwt_fwd_q_group` and :func:`haar_dwt_fwd_q` of
  ``haar_dwt_fwd_q`` (A_l in f32, details in the wire dtype, "K3");
* :func:`haar_dwt_inv` of ``haar_dwt_inv`` ("K7").

The forward takes a group of leaves in one launch (up to
``GROUP_LEAVES``; a larger group is split into several launches); the
single-leaf entries are groups of one.  All bands of a group live in one
``torch.empty`` buffer, each band a view at an offset that is a multiple of
16 bytes (:func:`group_layout`).

The library is built and loaded by ``repro_torch.kernels.build``.
``launches_fwd``, ``launches_fwd_q`` and ``launches_inv`` count the
launches of each kernel, ``leaves_fwd`` and ``leaves_fwd_q`` the leaves the
forward launches covered; nothing else changes them.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build

launches_fwd = 0
launches_fwd_q = 0
launches_inv = 0
leaves_fwd = 0
leaves_fwd_q = 0

# dtype codes of csrc/haar_dwt.cu
_IN = {torch.float32: 0, torch.bfloat16: 1}
_WIRE = {torch.bfloat16: 1, torch.float16: 2, torch.float8_e4m3fn: 3}
_VP, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# kMaxLevel of csrc/haar_dwt.cu (_declare checks it), its kGroupLeaves
# (the plan reports the library's own), the bands' alignment
MAX_LEVEL = 6
GROUP_LEAVES = 32
ALIGN = 16
PLAN_FIELDS = ("tile", "group_leaves", "blocks_per_sm", "sms", "smem")
# FwdLeaf of csrc/haar_dwt.cu, one entry of a launch's leaf table: input,
# A_l and D_l..D_1 addresses, coefficients, first tile, input 16-byte
# aligned
LEAF = np.dtype([("g", "<u8"), ("a", "<u8"), ("d", "<u8", (MAX_LEVEL,)),
                 ("count", "<i8"), ("first_tile", "<i4"), ("vec", "<i4")])


def _declare(lib: ctypes.CDLL) -> None:
    lib.haar_dwt_fwd_group.argtypes = [_I, _I, _I, _I, _VP, _I, _I, _VP]
    lib.haar_dwt_fwd_group.restype = _I
    lib.haar_dwt_fwd_plan.argtypes = [_I, _I, _I, _I, _VP]
    lib.haar_dwt_fwd_plan.restype = _I
    lib.haar_dwt_inv.argtypes = [_I, _I, _VP, _VP, _VP, _LL, _I, _VP]
    lib.haar_dwt_inv.restype = _I
    lib.haar_dwt_max_level.argtypes = []
    lib.haar_dwt_max_level.restype = _I
    if lib.haar_dwt_max_level() != MAX_LEVEL:
        raise RuntimeError(f"{lib._name}: kMaxLevel "
                           f"{lib.haar_dwt_max_level()} != {MAX_LEVEL}")


def _lib() -> ctypes.CDLL:
    return build.load("haar_dwt", _declare)


_plans: Dict[tuple, Dict[str, int]] = {}


def fwd_plan(codes: Tuple[int, int, int], level: int,
             device: torch.device) -> Dict[str, int]:
    """The grouped forward's plan for dtype codes ``(in, A, details)`` at
    ``level`` on ``device``, from the card (``PLAN_FIELDS``: coefficients
    per tile, leaves per launch, co-resident blocks per SM, SMs, dynamic
    shared bytes per block); asked once per library, codes, level and
    device."""
    lib = _lib()
    key = (lib._name, codes, level, device.index)
    if key not in _plans:
        out = (ctypes.c_int * len(PLAN_FIELDS))()
        with torch.cuda.device(device):
            err = lib.haar_dwt_fwd_plan(*codes, level, ctypes.cast(out, _VP))
        if err != 0:
            raise RuntimeError(f"haar_dwt_fwd_plan failed: CUDA error {err}")
        _plans[key] = dict(zip(PLAN_FIELDS, out))
    return _plans[key]


@dataclasses.dataclass(frozen=True)
class GroupLayout:
    """Where a group's bands lie in its one buffer, and its launches.

    * ``nbytes``: the buffer's size;
    * ``bands[i]``: leaf i's ``A_l, D_l, ..., D_1`` as ``(byte offset,
      shape)``, each offset a multiple of ``ALIGN``;
    * ``launches``: per launch, its leaves as ``(leaf index, first
      tile)``, at most ``capacity`` of them, first tiles from 0;
    * ``tiles``: per launch, its tiles."""

    nbytes: int
    bands: Tuple[Tuple[Tuple[int, Tuple[int, int]], ...], ...]
    launches: Tuple[Tuple[Tuple[int, int], ...], ...]
    tiles: Tuple[int, ...]


def group_layout(shapes: Sequence[Tuple[int, int]], level: int,
                 a_size: int, d_size: int, tile: int,
                 capacity: int = GROUP_LEAVES) -> GroupLayout:
    """The layout of a group of ``(m, n)`` leaves at ``level``: A_l of
    ``a_size`` bytes an element, the details of ``d_size``, ``tile``
    coefficients a tile."""
    at, bands = 0, []
    for m, n in shapes:
        leaf = []
        for k, size in [(level, a_size)] + [(k, d_size)
                                            for k in range(level, 0, -1)]:
            leaf.append((at, (m, n >> k)))
            at += -(-(m * (n >> k) * size) // ALIGN) * ALIGN
        bands.append(tuple(leaf))
    launches, tiles = [], []
    for lo in range(0, len(shapes), capacity):
        first, rows = 0, []
        for i in range(lo, min(lo + capacity, len(shapes))):
            m, n = shapes[i]
            rows.append((i, first))
            first += -(-(m * (n >> level)) // tile)
        launches.append(tuple(rows))
        tiles.append(first)
    return GroupLayout(at, tuple(bands), tuple(launches), tuple(tiles))


def _aligned(*tensors: torch.Tensor) -> int:
    return int(all(t.data_ptr() % 16 == 0 for t in tensors))


def _require_cuda(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got "
                         f"{name} on {x.device}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_input(name: str, x: torch.Tensor, level: int) -> Tuple[int, int]:
    _require_cuda(name, x)
    if x.ndim != 2:
        raise ValueError(f"{name} must be 2-D (m, n), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if not 1 <= level <= MAX_LEVEL:
        raise ValueError(f"level {level} outside the kernel's 1..{MAX_LEVEL}")
    return x.shape


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


# (shapes, level, a dtype, d dtype, tile, leaves a launch) -> (layout, each
# band's (dtype, shape, stride, element offset), each launch's leaf table
# with the bands' byte offsets from the buffer)
_layouts: Dict[tuple, tuple] = {}


def _layout(shapes, level, a_dtype, d_dtype, tile, capacity):
    key = (shapes, level, a_dtype, d_dtype, tile, capacity)
    if key not in _layouts:
        sizes = (a_dtype.itemsize, d_dtype.itemsize)
        lay = group_layout(shapes, level, *sizes, tile, capacity)
        views = [[(dt, (m, w), (w, 1), at // dt.itemsize)
                  for dt, (at, (m, w)) in zip(
                      [a_dtype] + [d_dtype] * level, leaf)]
                 for leaf in lay.bands]
        tables = []
        for rows in lay.launches:
            t = np.zeros(len(rows), LEAF)
            for e, (i, first) in zip(t, rows):
                (a, (m, w)), *ds = lay.bands[i]
                e["a"], e["count"], e["first_tile"] = a, m * w, first
                e["d"][:level] = [at for at, _ in ds]
            tables.append(t)
        _layouts[key] = (lay, views, tables)
    return _layouts[key]


def _fwd_group(name: str, gs: Sequence[torch.Tensor], level: int,
               a_dtype: torch.dtype, d_dtype: torch.dtype):
    """The bands of every leaf of ``gs`` (views of one new buffer), and a
    generator that issues the group's launches one by one, yielding each
    one's leaves after it; the caller counts them."""
    if not gs:
        return [], iter(())
    dev = gs[0].device
    for i, g in enumerate(gs):
        m, n = _check_input(f"gs[{i}]", g, level)
        if g.device != dev:
            raise ValueError(f"gs[{i}] is on {g.device}, gs[0] on {dev}")
        if n % (1 << level):
            raise ValueError(f"n={n} not divisible by 2^{level}")
        if g.numel() == 0:
            raise ValueError(f"gs[{i}] is empty")
    codes = (_IN[gs[0].dtype], _IN[a_dtype],
             _IN[d_dtype] if d_dtype == a_dtype else _WIRE[d_dtype])
    plan = fwd_plan(codes, level, dev)
    lay, views, tables = _layout(tuple(tuple(g.shape) for g in gs), level,
                                 a_dtype, d_dtype, plan["tile"],
                                 plan["group_leaves"])
    buf = torch.empty(lay.nbytes, dtype=torch.uint8, device=dev)
    typed = {dt: buf.view(dt) for dt in (a_dtype, d_dtype)}
    out = [tuple(typed[dt].as_strided(shape, stride, at)
                 for dt, shape, stride, at in leaf) for leaf in views]

    def launches():
        base, stream = buf.data_ptr(), _stream(dev)
        waves = plan["blocks_per_sm"] * plan["sms"]
        for rows, tiles, table in zip(lay.launches, lay.tiles, tables):
            table = table.copy()
            table["a"] += base
            table["d"][:, :level] += base
            ptrs = [gs[i].data_ptr() for i, _ in rows]
            table["g"] = ptrs
            table["vec"] = [p % 16 == 0 for p in ptrs]
            _launched(name, _lib().haar_dwt_fwd_group(
                *codes, level, table.ctypes.data, len(rows),
                min(tiles, waves), stream))
            yield len(rows)

    return out, launches()


def haar_dwt_fwd_group(gs: Sequence[torch.Tensor], level: int
                       ) -> List[Tuple[torch.Tensor, ...]]:
    """``(A_l, D_l, ..., D_1)`` of each contiguous ``(m, n)`` CUDA tensor
    of ``gs`` (all f32 or all bf16), every band in that dtype, in one
    launch per ``GROUP_LEAVES`` leaves."""
    global launches_fwd, leaves_fwd
    for i, g in enumerate(gs):
        if g.dtype not in _IN or g.dtype != gs[0].dtype:
            raise ValueError(f"unsupported dtype {g.dtype} of gs[{i}] (f32 "
                             f"or bf16, one for the group)")
    dtype = gs[0].dtype if gs else torch.float32
    out, launches = _fwd_group("haar_dwt_fwd_group", gs, level, dtype, dtype)
    for n in launches:
        launches_fwd += 1
        leaves_fwd += n
    return out


def haar_dwt_fwd_q_group(gs: Sequence[torch.Tensor], level: int,
                         detail_dtype: torch.dtype
                         ) -> List[Tuple[torch.Tensor, ...]]:
    """``(A_l f32, D_l..D_1 in detail_dtype)`` of each contiguous ``(m, n)``
    f32 CUDA tensor of ``gs``, in one launch per ``GROUP_LEAVES`` leaves;
    ``detail_dtype`` is bf16, f16 or float8_e4m3fn."""
    global launches_fwd_q, leaves_fwd_q
    for i, g in enumerate(gs):
        if g.dtype != torch.float32:
            raise ValueError(f"gs[{i}] must be float32, got {g.dtype}")
    if detail_dtype not in _WIRE:
        raise ValueError(f"unsupported wire dtype {detail_dtype}")
    out, launches = _fwd_group("haar_dwt_fwd_q_group", gs, level,
                               torch.float32, detail_dtype)
    for n in launches:
        launches_fwd_q += 1
        leaves_fwd_q += n
    return out


def haar_dwt_fwd(g: torch.Tensor, level: int) -> Tuple[torch.Tensor, ...]:
    """``(A_l, D_l, ..., D_1)`` of a contiguous ``(m, n)`` f32 or bf16 CUDA
    tensor, every band in ``g``'s dtype: a group of one."""
    return haar_dwt_fwd_group([g], level)[0]


def haar_dwt_fwd_q(g: torch.Tensor, level: int, detail_dtype: torch.dtype
                   ) -> Tuple[torch.Tensor, ...]:
    """``(A_l f32, D_l..D_1 in detail_dtype)`` of a contiguous ``(m, n)``
    f32 CUDA tensor: a group of one."""
    return haar_dwt_fwd_q_group([g], level, detail_dtype)[0]


def _ptrs(tensors: Sequence[torch.Tensor]):
    return (_VP * len(tensors))(*(t.data_ptr() for t in tensors))


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
        a.numel(), _aligned(a, *details), _stream(a.device))
    _launched("haar_dwt_inv", err)
    launches_inv += 1
    return out
