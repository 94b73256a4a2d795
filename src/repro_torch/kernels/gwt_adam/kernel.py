"""Build, binding and launch of the hand-written CUDA GWT-Adam kernels,
counterparts of the TPU kernels of ``repro/kernels/gwt_adam/kernel.py``:

* ``gwt_adam_fused`` (K1, ``csrc/gwt_adam_fused.cu``, f32 or bf16
  moments): ``gwt_adam_tile_fused`` there, the fused write;
* ``gwt_adam_fused_q8`` (K2, ``csrc/gwt_adam_fused_q8.cu``, blocked-int8
  moments): ``gwt_adam_tile_fused_q8``;
* ``gwt_adam_fused_group`` and ``gwt_adam_fused_q8_group``: K1 and K2 over
  a group of buckets, several in one launch (below);
* ``gwt_adam_tile`` (K4, ``csrc/gwt_adam_tile.cu``, f32 or bf16 moments):
  ``gwt_adam_tile``, the staged update that returns G̃;
* ``gwt_adam_tile_q8`` (K5, the same source, blocked-int8 moments):
  ``gwt_adam_tile_q8``.

All are built and loaded by ``repro_torch.kernels.build`` (nvcc for
``sm_90a``, a plain C interface bound with ``ctypes``); the grouped entries
are libraries of their own (``gwt_adam_fused_group``,
``gwt_adam_fused_q8_group``: K1's and K2's sources built with a table of
``GROUP_BUCKETS``), compiled beside the per-bucket ones.  K1 and K4 take the
moments in either dtype, both of one dtype (code ``mdtype``, as
``_DTYPES``): they read them as f32 and write the new ones rounded to
nearest even into that dtype, as the plain versions do.

K1 and K2 have two designs each.  The one-pass design is one cooperative
launch that keeps the bucket's rounded G̃ in shared memory across a grid
barrier and reads every input once; the two-pass design (a norm pass, a
scale pass of one warp per leaf, then a streaming write pass that
recomputes: three launches with the limiter, the write pass alone without)
takes the buckets whose G̃ does not fit on chip.  :func:`gwt_adam_fused` and :func:`gwt_adam_fused_q8` choose by
:func:`one_pass_fits`, before the launch, from the bucket's shape, dtype
and level and the card's capacity; :func:`gwt_adam_fused_two_pass` and
the other three ``*_one_pass`` / ``*_two_pass`` functions launch one design
(for comparisons of the two on the card).  Both designs give bitwise the
same results.

**Grouped launches.**  The one-pass kernel takes a table of up to
``GROUP_BUCKETS`` buckets that share their dtype codes, level and scalar
hyperparameters, and deals all their chunks to one grid: a per-bucket
launch is a group of one.  On the H100 a one-pass launch costs about
0.014 ms whatever its size, so at small buckets (a LoRA fine-tune's
adapters, 2.7-5.7% of their bound at llama-60m, four launches a step) it
is bound by launch latency and by the wrapper's host time, not by the 10
(bf16 moments 8, f32 ``p`` under bf16 ``g`` 14) bytes an element K1 must
move or K2's 7.06.  :func:`group_plan` packs a step's buckets in order
into launches (a new launch where the next bucket would pass the capacity
or the table's cap; a bucket beyond capacity alone, for the two-pass
design); :func:`gwt_adam_fused_group` and :func:`gwt_adam_fused_q8_group`
take one such launch as a list of per-bucket calls, refuse a set that does
not fit one launch, and launch it with one allocation of chunk partials
and norms.  Each bucket's outputs are bitwise those of its own
launch: a chunk never crosses a leaf, and a leaf's norm adds its own chunk
partials in a fixed order.

Counters.  ``launches`` and ``launches_q8`` count K1's and K2's launches:
one for each per-bucket call, whatever its design's kernel launches, and
one for each grouped call; ``launches_one_pass``,
``launches_two_pass``, ``launches_q8_one_pass`` and
``launches_q8_two_pass`` split them by design (a grouped launch is one
pass).  ``launches_group`` and ``launches_q8_group`` count the grouped
calls, ``buckets_group`` and ``buckets_q8_group`` the
buckets those launches covered.  ``launches_tile`` and
``launches_tile_q8`` count K4's and K5's launches.  Each counter rises
after its launch succeeded; nothing else changes them.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build

launches = 0
launches_one_pass = 0
launches_two_pass = 0
launches_group = 0
buckets_group = 0
launches_q8 = 0
launches_q8_one_pass = 0
launches_q8_two_pass = 0
launches_q8_group = 0
buckets_q8_group = 0
launches_tile = 0
launches_tile_q8 = 0

# coefficients per chunk (kChunk of the CUDA sources: a two-pass block's
# share, a one-pass slot), per quantization block (kQBlock), and buckets a
# grouped launch takes (kGroupBuckets)
CHUNK = 2048
QBLOCK = 64
GROUP_BUCKETS = 16

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# K1's and K2's codes of (g's dtype, p's dtype): with_params of the sources.
# The third is a LoRA adapter of a bf16 model: f32 parameters whose gradient
# the step casts to bf16; G~ and the limited step are rounded to bf16.
_PARAM_CODES = {(torch.float32, torch.float32): 0,
                (torch.bfloat16, torch.bfloat16): 1,
                (torch.bfloat16, torch.float32): 2}
# the fields the one-pass plan functions fill, in their order
PLAN_FIELDS = ("regs", "local_bytes", "static_smem", "max_dyn_smem", "sms",
               "blocks_per_sm", "slots", "smem", "grid")
# a bucket's record in a grouped launch's table (kRecord int64 fields of
# the sources): the tensors' device addresses, then L, na and the bucket's
# first chunk in the launch
RECORDS = {
    "gwt_adam_fused": ("g", "p", "m", "v", "prev_norm", "new_norm",
                       "partials", "step_size", "wd_coef", "L", "na",
                       "first"),
    "gwt_adam_fused_q8": ("g", "p", "qm", "sm", "qv", "sv", "salt_m",
                          "salt_v", "prev_norm", "new_norm", "partials",
                          "step_size", "wd_coef", "L", "na", "first")}


_VP, _LL, _F, _I = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
                   ctypes.c_int)


def _declare(fn, argtypes, extras=()) -> None:
    fn.argtypes, fn.restype = argtypes, _I
    for extra in extras:
        extra.argtypes, extra.restype = [], _I


def _declare_tile(lib) -> None:
    _declare(lib.gwt_adam_tile,
             [_I, _I, _I] + [_VP] * 7 + [_LL, _LL] + [_F] * 5 + [_VP],
             (lib.gwt_adam_tile_chunk, lib.gwt_adam_tile_qblock))
    _declare(lib.gwt_adam_tile_q8,
             [_I, _I] + [_VP] * 13 + [_LL, _LL] + [_F] * 5 + [_VP])


def _extras(lib, name: str) -> tuple:
    """The size functions of K1's (``name``) or K2's library ``lib``."""
    return (getattr(lib, name + "_chunk"),) + ((
        getattr(lib, name + "_qblock"),) if name.endswith("q8") else ())


def _declare_fused(lib, name: str, n_ptrs: int, codes=(_I, _I)) -> None:
    """K1's (``codes``: dtype, moment dtype, level) and K2's (dtype, level)
    per-bucket entries; the two-pass entry takes one pointer more, the
    scale."""
    def args(n):
        return list(codes) + [_VP] * n + [_LL, _LL] + [_F] * 6 \
            + [_I, _I, _VP]
    _declare(getattr(lib, name), args(n_ptrs + 1), _extras(lib, name))
    _declare(getattr(lib, name + "_one_pass"), args(n_ptrs))
    _declare(getattr(lib, name + "_one_pass_plan"),
             list(codes) + [_LL, _LL, _VP])


def _declare_group(lib, name: str, codes=(_I, _I)) -> None:
    """The grouped entries of K1 (``name``) or K2, in library
    ``name + "_group"``."""
    _declare(getattr(lib, name + "_group"),
             list(codes) + [_VP, _I] + [_F] * 6 + [_I, _I, _VP],
             _extras(lib, name) + (getattr(lib, name + "_group_buckets"),))
    _declare(getattr(lib, name + "_group_plan"),
             list(codes) + [_VP, _I, _VP])


_K1_CODES = (_I, _I, _I)
_DECLARE = {
    "gwt_adam_fused": lambda lib: _declare_fused(
        lib, "gwt_adam_fused", 9, _K1_CODES),
    "gwt_adam_fused_group": lambda lib: _declare_group(
        lib, "gwt_adam_fused", _K1_CODES),
    "gwt_adam_fused_q8": lambda lib: _declare_fused(
        lib, "gwt_adam_fused_q8", 13),
    "gwt_adam_fused_q8_group": lambda lib: _declare_group(
        lib, "gwt_adam_fused_q8"),
    "gwt_adam_tile": _declare_tile,
}


def _load(name: str) -> ctypes.CDLL:
    """Library ``name``: K1's and K2's per-bucket entries
    (``gwt_adam_fused``, ``gwt_adam_fused_q8``), their grouped ones (the
    same names with ``_group``: the sources built with another table
    size), or K4's and K5's (``gwt_adam_tile``)."""
    lib = build.load(name, _DECLARE[name])
    if name.startswith("gwt_adam_fused"):
        k = name.removesuffix("_group")
        sizes = (("chunk", CHUNK),) + ((("qblock", QBLOCK),)
                                       if k.endswith("q8") else ()) + ((
            ("group_buckets", GROUP_BUCKETS),) if k != name else ())
        for what, want in sizes:
            got = getattr(lib, f"{k}_{what}")()
            if got != want:
                raise RuntimeError(f"{name} was built with {what} {got}, "
                                   f"this module assumes {want}")
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


def _check_params(g: torch.Tensor, p: torch.Tensor) -> int:
    """K1's and K2's ``p``: of g's dtype, or f32 under a bf16 ``g``;
    returns the pair's code (``_PARAM_CODES``)."""
    code = _PARAM_CODES.get((g.dtype, p.dtype))
    if code is None:
        raise ValueError(f"p has dtype {p.dtype}, expected {g.dtype}"
                         + (" or torch.float32" if g.dtype == torch.bfloat16
                            else ""))
    _check("p", p, g.device, p.dtype, tuple(g.shape))
    return code


def _check_moments(device, m, v, shape) -> torch.dtype:
    """K1's and K4's moments: f32 or bf16, both of one dtype; returns it."""
    if m.dtype not in _DTYPES:
        raise ValueError(f"m has dtype {m.dtype}, expected float32 or "
                         f"bfloat16")
    _check("m", m, device, m.dtype, shape)
    _check("v", v, device, m.dtype, shape)
    return m.dtype


def _check_scalars(device, L, prev_norm, step_size, wd_coef) -> None:
    _check("prev_norm", prev_norm, device, torch.float32, (L,))
    _check("step_size", step_size, device, torch.float32, ())
    _check("wd_coef", wd_coef, device, torch.float32, ())


def _fits(chunks: int, dtype: torch.dtype, level: int, sms: int,
          smem_per_block: int) -> bool:
    """Whether ``chunks`` chunks of G̃ of ``dtype`` at ``level`` fit one
    block per SM: one slot of ``CHUNK * 2^level`` values each."""
    slot = CHUNK * (1 << level) * dtype.itemsize
    return chunks > 0 and -(-chunks // sms) * slot <= smem_per_block


def _chunks(shape: Tuple[int, int, int], level: int) -> int:
    L, rows, n = shape
    return L * -(-(rows * (n >> level)) // CHUNK)


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
    return _fits(_chunks(shape, level), dtype, level, sms, smem_per_block)


def group_plan(buckets: Sequence[tuple], sms: int,
               smem_per_block: int) -> List[List[int]]:
    """The launches of a group of buckets, as lists of their indices.

    ``buckets``: ``(shape, dtype, level, key)`` in the order they are to be
    launched, ``shape`` ``(L, rows, n)`` as the kernel takes it, ``key``
    anything that must also be equal for two buckets to share a launch
    (the wrappers' dtype codes).  Packed in order: a bucket joins the
    current launch if it shares its dtype, level and key, the launch holds
    fewer than ``GROUP_BUCKETS``, and the launch's chunks with its own still
    fit one block per SM (:func:`one_pass_fits`'s rule, summed over the
    launch); otherwise it starts the next.  A bucket that does not fit alone
    is a launch of its own (the two-pass design), and so ends the launch
    before it."""
    out: List[List[int]] = []
    cur: List[int] = []
    cur_key, cur_chunks = None, 0
    for i, (shape, dtype, level, key) in enumerate(buckets):
        chunks = _chunks(shape, level)
        if not _fits(chunks, dtype, level, sms, smem_per_block):
            if cur:
                out.append(cur)
            out.append([i])
            cur, cur_key, cur_chunks = [], None, 0
            continue
        k = (dtype, level, key)
        if cur and k == cur_key and len(cur) < GROUP_BUCKETS and _fits(
                cur_chunks + chunks, dtype, level, sms, smem_per_block):
            cur.append(i)
            cur_chunks += chunks
        else:
            if cur:
                out.append(cur)
            cur, cur_key, cur_chunks = [i], k, chunks
    if cur:
        out.append(cur)
    return out


_plans: Dict[tuple, Dict[str, int]] = {}


def one_pass_plan(name: str, shape: Tuple[int, int, int],
                  dtype: torch.dtype, level: int,
                  mdtype: torch.dtype = torch.float32,
                  pdtype: torch.dtype = None) -> Dict[str, int]:
    """The one-pass plan of kernel ``name`` (``"gwt_adam_fused"`` with
    moments of ``mdtype``, or ``"gwt_adam_fused_q8"``, which ignores it)
    for a bucket of gradients of ``dtype`` and parameters of ``pdtype``
    (``dtype`` where not given), from the card: the kernel's
    registers per thread, spill bytes, static shared bytes and the dynamic
    shared bytes a block may give its G̃ slots (``max_dyn_smem``); the
    card's SMs; and, if the bucket fits, its blocks per SM, slots per
    block, dynamic shared bytes per block (slots and ring) and grid (0
    where it does not fit)."""
    L, rows, n = shape
    na = rows * (n >> level)
    # the kernels (registers, shared memory) differ by parameter dtype,
    # K1's by moment dtype too
    codes = _codes(name, dtype, pdtype or dtype, mdtype)
    key = (name, torch.cuda.current_device(), codes, level,
           L * -(-na // CHUNK))
    if key not in _plans:
        lib = _load(name)
        plan_fn = getattr(lib, name + "_one_pass_plan")
        out = (ctypes.c_int * len(PLAN_FIELDS))()
        # one chunk always fits: the kernel's and the card's fields
        err = plan_fn(*codes, level, 1, CHUNK, ctypes.cast(out, _VP))
        if err != 0:
            raise RuntimeError(f"{name} one-pass plan failed: CUDA error "
                               f"{err}")
        info = dict(zip(PLAN_FIELDS, out))
        if one_pass_fits(shape, dtype, level, info["sms"],
                         info["max_dyn_smem"]):
            err = plan_fn(*codes, level, L, na, ctypes.cast(out, _VP))
            if err != 0:
                raise RuntimeError(f"{name} one-pass plan of {shape} failed: "
                                   f"CUDA error {err}")
            info = dict(zip(PLAN_FIELDS, out))
        else:
            info.update(blocks_per_sm=0, slots=0, smem=0, grid=0)
        _plans[key] = info
    return _plans[key]


def capacity(name: str, dtype: torch.dtype, level: int,
             mdtype: torch.dtype = torch.float32,
             pdtype: torch.dtype = None) -> Tuple[int, int]:
    """The card's SMs and the dynamic shared bytes a block of kernel
    ``name`` may give its G̃ slots, for buckets of those dtypes at
    ``level``: :func:`group_plan`'s ``sms`` and ``smem_per_block``."""
    info = one_pass_plan(name, (1, 1, CHUNK << level), dtype, level, mdtype,
                         pdtype)
    return info["sms"], info["max_dyn_smem"]


def group_launch_plan(name: str, shapes: Sequence[Tuple[int, int, int]],
                      dtype: torch.dtype, level: int,
                      mdtype: torch.dtype = torch.float32,
                      pdtype: torch.dtype = None) -> Dict[str, int]:
    """The one-pass plan (``PLAN_FIELDS``) of one grouped launch over
    buckets of ``shapes`` (``(L, rows, n)``), from the card; raises where
    they do not fit one launch."""
    sizes = np.array([(L, rows * (n >> level)) for L, rows, n in shapes],
                     dtype=np.int64)
    out = (ctypes.c_int * len(PLAN_FIELDS))()
    err = getattr(_load(name + "_group"), name + "_group_plan")(
        *_codes(name, dtype, pdtype or dtype, mdtype), level,
        sizes.ctypes.data, len(shapes), ctypes.cast(out, _VP))
    if err != 0:
        raise RuntimeError(f"{name} group plan of {list(shapes)} failed: "
                           f"CUDA error {err}")
    return dict(zip(PLAN_FIELDS, out))


def _codes(name: str, dtype: torch.dtype, pdtype: torch.dtype,
           mdtype: Optional[torch.dtype]) -> Tuple[int, ...]:
    """The C entries' leading dtype codes: K1's (p, moments), K2's (p)."""
    pcode = _PARAM_CODES[(dtype, pdtype)]
    return (pcode,) if name.endswith("q8") else (pcode, _DTYPES[mdtype])


class _Call(NamedTuple):
    """One bucket's checked K1 or K2 call."""
    name: str                 # the library
    tensors: tuple            # g, p and the moments' tensors, in C order
    prev_norm: torch.Tensor
    step_size: torch.Tensor
    wd_coef: torch.Tensor
    codes: Tuple[int, ...]    # the C entries' dtype codes
    mdtype: torch.dtype       # K1's moment dtype (the plan's key)
    level: int
    L: int
    na: int
    hyper: tuple              # gamma, use_limiter, weight_decay, b1, b2, eps

    @property
    def g(self) -> torch.Tensor:
        return self.tensors[0]

    @property
    def outputs(self) -> tuple:
        """p and the moments' tensors: what the launch updates in place."""
        return self.tensors[1:6] if self.name.endswith("q8") \
            else self.tensors[1:]


def _k1_call(g, p, m, v, prev_norm, step_size, wd_coef, *, level, gamma,
             use_limiter, weight_decay, b1=0.9, b2=0.999, eps=1e-6) -> _Call:
    """K1's checks of one bucket, on any device."""
    L, rows, n, na = _check_bucket(g, level)
    device = g.device
    _check("g", g, device, g.dtype, (L, rows, n))
    pcode = _check_params(g, p)
    mdtype = _check_moments(device, m, v, (L, rows, n >> level))
    _check_scalars(device, L, prev_norm, step_size, wd_coef)
    return _Call("gwt_adam_fused", (g, p, m, v), prev_norm, step_size,
                 wd_coef, (pcode, _DTYPES[mdtype]), mdtype, level, L, na,
                 (gamma, bool(use_limiter), bool(weight_decay), b1, b2, eps))


def _k2_call(g, p, qm, sm, qv, sv, salt_m, salt_v, prev_norm, step_size,
             wd_coef, *, level, block, gamma, use_limiter, weight_decay,
             b1=0.9, b2=0.999, eps=1e-6) -> _Call:
    """K2's checks of one bucket, on any device."""
    L, rows, n, na = _check_bucket(g, level)
    device = g.device
    if block != QBLOCK:
        raise ValueError(f"the kernel quantizes in blocks of {QBLOCK}, not "
                         f"{block}")
    nb = -(-na // block)
    _check("g", g, device, g.dtype, (L, rows, n))
    pcode = _check_params(g, p)
    for name, q, s in (("m", qm, sm), ("v", qv, sv)):
        _check(f"q{name}", q, device, torch.int8, (L, rows, n >> level))
        _check(f"s{name}", s, device, torch.float32, (L, nb))
    _check("salt_m", salt_m, device, torch.uint32, (L,))
    _check("salt_v", salt_v, device, torch.uint32, (L,))
    _check_scalars(device, L, prev_norm, step_size, wd_coef)
    return _Call("gwt_adam_fused_q8", (g, p, qm, sm, qv, sv, salt_m, salt_v),
                 prev_norm, step_size, wd_coef, (pcode,), torch.float32,
                 level, L, na,
                 (gamma, bool(use_limiter), bool(weight_decay), b1, b2, eps))


def _design(design: str, c: _Call) -> str:
    """``"one"`` or ``"two"``: ``design`` itself, or for ``"auto"`` the
    one the capacity rule names; raises if ``"one"`` does not fit."""
    g, p = c.tensors[:2]
    fits = one_pass_plan(c.name, tuple(g.shape), g.dtype, c.level,
                         c.mdtype, pdtype=p.dtype)["grid"] > 0
    if design == "auto":
        return "one" if fits else "two"
    if design == "one" and not fits:
        raise ValueError(f"a {tuple(g.shape)} {g.dtype} bucket at level "
                         f"{c.level} does not fit the one-pass design")
    return design


def _coeffs(hyper: tuple) -> tuple:
    """The C entries' trailing scalars but the stream."""
    gamma, use_limiter, weight_decay, b1, b2, eps = hyper
    return (gamma, b1, 1 - b1, b2, 1 - b2, eps, int(use_limiter),
            int(weight_decay))


def _count(q8: bool, design: str, buckets: int = 0) -> None:
    """One K1 (``q8``: K2) launch of ``design``; ``buckets`` > 0: a
    grouped launch over that many buckets."""
    global launches, launches_one_pass, launches_two_pass, launches_group
    global buckets_group, launches_q8, launches_q8_one_pass
    global launches_q8_two_pass, launches_q8_group, buckets_q8_group
    if q8:
        launches_q8 += 1
        if design == "one":
            launches_q8_one_pass += 1
        else:
            launches_q8_two_pass += 1
        if buckets:
            launches_q8_group += 1
            buckets_q8_group += buckets
    else:
        launches += 1
        if design == "one":
            launches_one_pass += 1
        else:
            launches_two_pass += 1
        if buckets:
            launches_group += 1
            buckets_group += buckets


def _launch(design: str, c: _Call):
    """One bucket's launch of ``design`` (``"auto"``: by the rule)."""
    _require_cuda(c.g)
    design = _design(design, c)
    device = c.g.device
    lib = _load(c.name)
    partials = torch.empty((c.L, -(-c.na // CHUNK)), dtype=torch.float32,
                           device=device)
    # the two-pass entry takes the (L,) leaf scales too
    scratch = (partials,) if design == "one" else (
        partials, torch.empty((c.L,), dtype=torch.float32, device=device))
    fn = getattr(lib, c.name + ("_one_pass" if design == "one" else ""))
    new_norm = torch.empty((c.L,), dtype=torch.float32, device=device)
    err = fn(*c.codes, c.level, *(t.data_ptr() for t in c.tensors),
             c.prev_norm.data_ptr(), new_norm.data_ptr(),
             *(t.data_ptr() for t in scratch), c.step_size.data_ptr(),
             c.wd_coef.data_ptr(), c.L, c.na, *_coeffs(c.hyper),
             _stream(device))
    if err != 0:
        raise RuntimeError(f"{c.name} ({design}-pass) launch failed: "
                           f"CUDA error {err}")
    _count(c.name.endswith("q8"), design)
    return (*c.outputs, new_norm)


class GroupLayout(NamedTuple):
    """Where a grouped launch's scratch lies in its one f32 buffer of
    ``floats`` values: bucket k's ``(L,)`` new norms at ``norms[k]`` and
    its ``(L, S)`` chunk partials at ``partials[k]`` (element offsets),
    and its first chunk in the launch, ``first[k]``."""
    floats: int
    norms: Tuple[int, ...]
    partials: Tuple[int, ...]
    first: Tuple[int, ...]


def group_layout(sizes: Sequence[Tuple[int, int]]) -> GroupLayout:
    """The layout of a grouped launch over buckets of ``(L, na)``: the
    norms of every bucket, then the partials of every bucket, in order."""
    at, norms, partials, first, chunks = 0, [], [], [], 0
    for L, _ in sizes:
        norms.append(at)
        at += L
    for L, na in sizes:
        partials.append(at)
        first.append(chunks)
        at += L * -(-na // CHUNK)
        chunks += L * -(-na // CHUNK)
    return GroupLayout(at, tuple(norms), tuple(partials), tuple(first))


# (name, (L, na) of each bucket) -> (layout, the table with L, na and the
# first chunks filled)
_layouts: Dict[tuple, Tuple[GroupLayout, np.ndarray]] = {}


def _layout(name: str, sizes: Tuple[Tuple[int, int], ...]):
    key = (name, sizes)
    if key not in _layouts:
        lay = group_layout(sizes)
        fields = RECORDS[name]
        table = np.zeros((len(sizes), len(fields)), dtype=np.int64)
        at = {f: i for i, f in enumerate(fields)}
        table[:, at["L"]] = [L for L, _ in sizes]
        table[:, at["na"]] = [na for _, na in sizes]
        table[:, at["first"]] = lay.first
        _layouts[key] = (lay, table)
    return _layouts[key]


def _launch_group(cs: Sequence[_Call]):
    """One grouped one-pass launch over the buckets ``cs`` (checked, one
    device, codes and scalars shared, fitting one launch)."""
    c0 = cs[0]
    device = c0.g.device
    lib = _load(c0.name + "_group")
    lay, template = _layout(c0.name, tuple((c.L, c.na) for c in cs))
    buf = torch.empty((lay.floats,), dtype=torch.float32, device=device)
    base = buf.data_ptr()
    table = template.copy()
    # RECORDS' order: the tensors, then prev_norm, new_norm, partials,
    # step_size, wd_coef
    n_t = len(c0.tensors)
    for row, c, norm, part in zip(table, cs, lay.norms, lay.partials):
        row[:n_t] = [t.data_ptr() for t in c.tensors]
        row[n_t:n_t + 5] = (c.prev_norm.data_ptr(), base + 4 * norm,
                            base + 4 * part, c.step_size.data_ptr(),
                            c.wd_coef.data_ptr())
    err = getattr(lib, c0.name + "_group")(
        *c0.codes, c0.level, table.ctypes.data, len(cs),
        *_coeffs(c0.hyper), _stream(device))
    if err != 0:
        raise RuntimeError(f"{c0.name} grouped launch of {len(cs)} buckets "
                           f"failed: CUDA error {err}")
    _count(c0.name.endswith("q8"), "one", len(cs))
    return [(*c.outputs, buf[norm:norm + c.L])
            for c, norm in zip(cs, lay.norms)]


def _group(cs: Sequence[_Call]) -> list:
    """A grouped call: every bucket of ``cs`` checked, then all of them in
    one grouped one-pass launch.  The caller names the set (the launches of
    :func:`group_plan`); a set that does not fit one launch is refused."""
    if not cs:
        return []
    c0 = cs[0]
    for i, c in enumerate(cs):
        if c.g.device != c0.g.device:
            raise ValueError(f"bucket {i} is on {c.g.device}, bucket 0 on "
                             f"{c0.g.device}")
        if (c.codes, c.level) != (c0.codes, c0.level):
            raise ValueError(f"bucket {i} has codes {c.codes} at level "
                             f"{c.level}, bucket 0 {c0.codes} at level "
                             f"{c0.level}: a group shares them")
        if c.hyper != c0.hyper:
            raise ValueError(f"bucket {i} has hyperparameters {c.hyper}, "
                             f"bucket 0 {c0.hyper}: a group shares them")
    _require_cuda(c0.g)
    if len(cs) > GROUP_BUCKETS:
        raise ValueError(f"{len(cs)} buckets: a launch takes at most "
                         f"{GROUP_BUCKETS}")
    g0, p0 = c0.tensors[:2]
    sms, smem = capacity(c0.name, g0.dtype, c0.level, c0.mdtype, p0.dtype)
    chunks = [_chunks(tuple(c.g.shape), c.level) for c in cs]
    for i, n in enumerate(chunks):
        if not _fits(n, g0.dtype, c0.level, sms, smem):
            raise ValueError(f"bucket {i} {tuple(cs[i].g.shape)} does not "
                             f"fit the one-pass design")
    if not _fits(sum(chunks), g0.dtype, c0.level, sms, smem):
        raise ValueError(f"{len(cs)} buckets of {sum(chunks)} chunks do not "
                         f"fit one launch: group_plan splits them")
    return _launch_group(cs)


def gwt_adam_fused(g: torch.Tensor, p: torch.Tensor, m: torch.Tensor,
                   v: torch.Tensor, prev_norm: torch.Tensor,
                   step_size: torch.Tensor, wd_coef: torch.Tensor, *,
                   level: int, gamma: float, use_limiter: bool,
                   weight_decay: bool, b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-6):
    """Fused-write update of a whole ``(L, rows, n)`` bucket on the card,
    one pass where the bucket fits (:func:`one_pass_fits`), else two.

    ``g``, ``p``: one dtype (f32 or bf16), or bf16 ``g`` with f32 ``p``
    (G̃ and the limited step rounded to bf16); ``m``, ``v``: f32 or
    bf16 (one dtype) ``(L, rows, n >> level)``; ``prev_norm``: f32
    ``(L,)``; ``step_size``,
    ``wd_coef``: f32 scalars on the card.  ``p``, ``m``, ``v`` are updated
    in place.  Returns ``(p, m, v, new_norm)``; raises on any input the
    kernel does not take and on a failed launch."""
    return _launch("auto", _k1_call(
        g, p, m, v, prev_norm, step_size, wd_coef, level=level, gamma=gamma,
        use_limiter=use_limiter, weight_decay=weight_decay, b1=b1, b2=b2,
        eps=eps))


def gwt_adam_fused_one_pass(*args, **kw):
    """:func:`gwt_adam_fused` through the one-pass design; raises if the
    bucket does not fit it."""
    return _launch("one", _k1_call(*args, **kw))


def gwt_adam_fused_two_pass(*args, **kw):
    """:func:`gwt_adam_fused` through the two-pass design."""
    return _launch("two", _k1_call(*args, **kw))


def gwt_adam_fused_group(calls: Sequence[Tuple[tuple, dict]]) -> list:
    """K1 over a group of buckets in one launch.

    ``calls``: per bucket the ``(args, kwargs)`` of a
    :func:`gwt_adam_fused` call, one launch of :func:`group_plan`.  Every
    bucket is checked as that call checks it; the group must share the
    dtype codes (g's, p's and the moments' dtypes), the level and the
    hyperparameters (``gamma``, ``use_limiter``, ``weight_decay``, ``b1``,
    ``b2``, ``eps``), lie on one CUDA device, and fit one one-pass launch
    at the card's capacity, at most ``GROUP_BUCKETS`` buckets.  Returns
    each bucket's ``(p, m, v, new_norm)``, bitwise :func:`gwt_adam_fused`'s;
    raises on any input refused and on a failed launch."""
    return _group([_k1_call(*a, **kw) for a, kw in calls])


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
    return _launch("auto", _k2_call(
        g, p, qm, sm, qv, sv, salt_m, salt_v, prev_norm, step_size, wd_coef,
        level=level, block=block, gamma=gamma, use_limiter=use_limiter,
        weight_decay=weight_decay, b1=b1, b2=b2, eps=eps))


def gwt_adam_fused_q8_one_pass(*args, **kw):
    """:func:`gwt_adam_fused_q8` through the one-pass design; raises if
    the bucket does not fit it."""
    return _launch("one", _k2_call(*args, **kw))


def gwt_adam_fused_q8_two_pass(*args, **kw):
    """:func:`gwt_adam_fused_q8` through the two-pass design."""
    return _launch("two", _k2_call(*args, **kw))


def gwt_adam_fused_q8_group(calls: Sequence[Tuple[tuple, dict]]) -> list:
    """K2 over a group of buckets in one launch, as
    :func:`gwt_adam_fused_group` (the group shares g's and p's dtypes, the
    level, the block and the hyperparameters).  ``calls``: per bucket the ``(args, kwargs)`` of a
    :func:`gwt_adam_fused_q8` call.  Returns each bucket's ``(p, qm, sm,
    qv, sv, new_norm)``, bitwise :func:`gwt_adam_fused_q8`'s."""
    return _group([_k2_call(*a, **kw) for a, kw in calls])


def _partials(lib, L: int, na: int, device) -> torch.Tensor:
    chunk = lib.gwt_adam_tile_chunk()
    return torch.empty((L, -(-na // chunk)), dtype=torch.float32,
                       device=device)


def gwt_adam_tile(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, *,
                  level: int, b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-6):
    """Staged update of an ``(L, rows, n)`` stack on the card (K4).

    ``g``: f32 or bf16; ``m``, ``v``: f32 or bf16 (one dtype) ``(L, rows,
    n >> level)``.  Returns new tensors ``(G̃ in g's dtype, m', v' in the
    moments' dtype, partials)``:
    ``partials`` is f32 ``(L, S)``, leaf ``l``'s ``‖G̃‖²`` of the rounded G̃
    in ``S`` fixed-order pieces (their sum is the leaf's).  Raises on any
    input the kernel does not take and on a failed launch."""
    global launches_tile
    L, rows, n, na = _check_bucket(g, level)
    device = g.device
    _check("g", g, device, g.dtype, (L, rows, n))
    mdtype = _check_moments(device, m, v, (L, rows, n >> level))
    _require_cuda(g)
    lib = _load("gwt_adam_tile")
    gt, m_out, v_out = (torch.empty_like(t) for t in (g, m, v))
    partials = _partials(lib, L, na, device)
    stream = _stream(device)
    err = lib.gwt_adam_tile(
        _DTYPES[g.dtype], _DTYPES[mdtype], level, g.data_ptr(), m.data_ptr(),
        v.data_ptr(), gt.data_ptr(), m_out.data_ptr(), v_out.data_ptr(),
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
