#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. build every hand-written CUDA kernel from ``src/repro_torch/.../csrc``
   (K1, K2, K4/K5 in one source, and K3/K6/K7 in one source; and the
   parent's K4/K5 and K3/K6/K7 where ``tools/parent_kernels.py`` wrote
   them), one ``nvcc`` per source, started together, printing
   ``-Xptxas -v``; print K1's and
   K2's one-pass plans (registers, shared memory, co-resident blocks, chunk
   slots) at the main buckets;
2. K1 (f32 moments) at the three LLaMA-60M bucket shapes, a FIRST-mode-sized
   leaf and a shape whose leaves end in a ragged chunk, levels 1-3, bf16 and
   f32 parameters, in every CASE (limiter with a zero and a non-zero
   history, a clipping case, weight decay, limiter off), each at two seed
   sets (the seeds earlier runs used, and new ones): the entry takes the
   design the capacity rule names (one pass where the bucket's G̃ fits on
   chip, else two; f32 (2, 4096, 1376) is beyond it and the one-pass entry
   refuses it), its two runs are bitwise equal, the one pass equals the
   two-pass kernel bitwise, and p, m, v and the norm are bitwise equal to
   the plain PyTorch version, which sums ‖G̃‖² in the kernels' order;
3. K2 (blocked-int8 moments) the same way: p, codes, scales and the norm
   bitwise equal to the plain version;
4. small-input check: a few steps of llama-60m-smoke, f32 and int8 state,
   from the same parameters and batches on the card and on the CPU give
   the same losses;
5. the f32 main path: ``repro_torch.launch.train.main`` trains full-width
   llama-60m with GWT-2 for 20 steps; K1 must launch exactly 3 times per
   step, all through the one-pass design (K2 never), the losses be finite
   and the last logged one below the first;
6. the int8 main path: the same with ``--state-codec int8``; K2 must
   launch 3 times per step through the one-pass design (K1 never); the
   state must be the JAX package's 48,273,508 bytes;
7. resume on the card: full width, int8, train 20 steps checkpointing at
   10, resume a fresh run from step 10; the result must be bitwise equal
   to the 20 straight steps of phase 6 (parameters, codes, scales, norms);
8. time K1 and K2 per launch at the main buckets, both designs in the same
   call: device time (CUDA events around each launch, L2 flushed before
   it), time per call back to back, the plain version's, the bound; and
   the int8 path's generic decode/encode of the embedding's moments;
9. profile a few full-width steps of each path: ``optimizer.update`` vs the
   rest, device busy share, top kernels;
10. K3 (``haar_dwt_fwd_q``), K6 (``haar_dwt_fwd``) and K7 (``haar_dwt_inv``)
    against their plain versions on the card, bitwise, at the flattened
    LLaMA-60M leaf shapes and an odd-row shape, levels 1-3, every wire dtype;
    the fp8 inputs reach past 464 and +-inf, so the NaN-on-overflow rule is
    exercised; two runs must be bitwise equal; then K3's and K6's grouped
    entries over the 10 DP leaves, a mixed group (odd rows, an odd
    coefficient count, an unaligned leaf base) and 40 leaves (two
    launches), each leaf bitwise to its plain version, the launch and leaf
    counters exact;
11. the compressed data-parallel path: the launcher with ``--dp-reduce
    compressed`` (bf16 details, 20 steps) under a one-rank NCCL process
    group, so the gradient gather runs on the card; K3 must launch once per
    step for all 10 compressible leaves (20 launches, 200 leaves), K7 10
    times per step and K1 3 times (one pass), the wire bytes be the JAX
    package's 208,449,536 against 333,516,800, the losses finite and
    falling; then a shorter run with fp8 details and error feedback (K7 20
    times per step: the residue's reconstruction too); then one reduction
    of a full-width gradient grouped and leaf by leaf, bitwise equal, with
    each one's peak memory;
12. time K3, K6 and K7 per launch beside their bounds, plain versions and
    the parent revision's (in turns), K3 and K6 as one grouped launch over
    the DP group beside ten single launches, the grouped wrapper's host
    time, and profile the data-parallel step beside the plain f32 step;
13. K4 (``gwt_adam_tile``) and K5 (``gwt_adam_tile_q8``) against their plain
    versions at the staged path's leaf shapes, odd rows, and an L = 3 stack
    with an odd coefficient count per leaf (unaligned leaf bases, a ragged
    chunk, a partial quantization block), levels 1-3, f32 and bf16
    gradients, both seed sets: G̃, m', v' (K5: G̃, codes, scales) and the
    ‖G̃‖² partials (``ref.chunk_ssq``) bitwise, two runs bitwise;
14. the staged path, ``gwt(fused_write=False)``, at full width through the
    ``TrainLoop``, f32 and int8, 20 steps each: K4 must launch 140 times
    (7 leaves x 20 steps), K1, K2 and K5 never, the loss fall and stay
    within ``TOL_STAGED_LOSS`` of the fused path's in the same call; the
    unrolled engine (``bucketed=False``) equal to the bucketed staged path,
    bitwise, over 3 full-width steps;
15. peak device memory of one ``optimizer.update``, fused write against
    staged, at full width and on the JAX benchmark's 4 x 256 x 2048 f32
    bucket;
16. the launcher's other choices at full width, 20 steps each (``--optimizer
    adam``, ``adam_mini``, ``muon``, ``sgd``; ``gwt --host adam_mini``,
    ``--host muon``): losses finite and falling, no GWT kernel launched,
    state bytes, step time and peak memory printed;
17. time K4 and K5 per launch beside their bounds, their plain versions, a
    ``copy_`` of the same bytes and, where ``tools/parent_kernels.py``
    wrote the parent revision's sources into ``build/parent_kernels/``, the
    parent's K4 and K5 (built in phase 1, timed in turns with the current
    ones), and profile the staged step beside the fused one;
18. the corpus path: build a byte corpus of ``src/repro/**/*.py`` with
    ``repro_torch.data.build_corpus`` (printing its hash and split sizes)
    and train full-width llama-60m GWT-2 on it for 20 steps with
    ``--data corpus --workers 2 --eval-every 10 --eval-batches 4``: K1
    must launch exactly 3 times per step, all one-pass, K2 never; the
    losses be finite and falling; evals at steps 10 and 20, finite and
    falling.  The same steps with ``--workers 0`` and no eval must give
    bitwise-equal losses, parameters and state; 10 steps + checkpoint +
    resume must equal the 20 straight steps bitwise; a resume against a
    corpus of another hash must be refused.  Prints the step time beside
    phase 5's synthetic step, the watchdog's dispatch and blocked
    s/step, and one eval's wall time, with the card's name and power
    limit.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``.  Without a CUDA device it
exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM (NVIDIA data sheet and Hopper white paper): HBM3 bandwidth, the
# f32 and int32 rates outside the tensor cores, the peaks a bound is taken
# against
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 33.5e12

# the three GWT buckets of llama-60m after row merging, and the leaves each
# stands for; plus a FIRST-mode-sized leaf (a (8, 1376, 514) weight, whose
# last axis is not divisible by 4, arrives transposed as (8, 514, 1376))
MAIN_SHAPES = [("mixer wq/wk/wv/wo", (4, 4096, 512)),
               ("ffn w_gate/w_up", (2, 4096, 1376)),
               ("ffn w_down", (1, 11008, 512))]
FIRST_SHAPE = ("FIRST-mode (8,1376,514) leaf", (1, 4112, 1376))
# 37 * 86 = 3182 coefficients per leaf: 49.7 blocks of 64
PARTIAL_SHAPE = ("partial last block", (3, 37, 344))
LEVEL = 2
QBLOCK = 64
STEPS = 20
MAIN_ARGS = ["--arch", "llama-60m", "--steps", str(STEPS), "--batch", "16",
             "--seq", "256", "--log-every", "5", "--seed", "0"]
STATE_BYTES_INT8 = 48_273_508   # the JAX package's engine.state_bytes
# the compressible leaves of llama-60m as the reduction flattens them for
# K3 and K7, with their counts (10 launches per step); plus one odd-row shape
DP_SHAPES = [((32000, 512), 1), ((11008, 512), 1), ((4096, 1376), 2),
             ((4096, 512), 4), ((8, 512), 2)]
ODD_SHAPE = (37, 344)
# tree_wire_bytes of llama-60m in the JAX package: compressed with bf16
# details, and the exact f32 reduction
WIRE_BF16, WIRE_EXACT = 208_449_536, 333_516_800
DP_EF_STEPS = 10
# cycles the card spins before each timed DWT launch (about 0.5 ms at the
# H100's clock), longer than the host takes to queue the launch
SPIN_CYCLES = 1_000_000
# float8_e4m3fn codes the JAX package gives (ml_dtypes, no saturation)
FP8_EDGES = [(448.0, 0x7E), (464.0, 0x7E), (464.03125, 0x7F), (465.0, 0x7F),
             (-465.0, 0xFF), (480.0, 0x7F), (1e30, 0x7F),
             (math.inf, 0x7F), (-math.inf, 0xFF), (math.nan, 0x7F),
             (-0.0, 0x80), (2.0 ** -9, 0x01), (2.0 ** -10, 0x00)]

# (case, use_limiter, prev_norm, weight decay coefficient)
CASES = [("limiter, prev 0", True, 0.0, 0.0),
         ("limiter, prev > 0", True, 1e9, 0.0),
         ("limiter clips", True, 1.0, 0.0),
         ("weight decay", True, 1e9, 1e-4),
         ("limiter off", False, 0.0, 0.0)]

def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def make_inputs(shape, seed, dev, level=LEVEL, dtype=torch.bfloat16):
    L, m, n = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    g = (r(L, m, n) * 0.01).to(dtype)
    p = (r(L, m, n) * 0.02).to(dtype)
    mm = r(L, m, n >> level) * 1e-3
    vv = torch.rand(L, m, n >> level, generator=gen, device=dev) * 1e-6
    return g, p, mm, vv


def make_q8_inputs(shape, seed, dev, level=LEVEL, dtype=torch.bfloat16):
    """K1's inputs with the moments encoded by the port's codec."""
    from repro_torch.optim import codec
    g, p, mm, vv = make_inputs(shape, seed, dev, level, dtype)
    L = shape[0]
    ids = torch.arange(L, device=dev)
    (qm, sm), (qv, sv) = (codec.quant_blocks(a.reshape(L, -1), ids + salt)
                          for a, salt in ((mm, 101), (vv, 202)))
    return g, p, qm.reshape(mm.shape), sm, qv.reshape(vv.shape), sv


def q8_salts(L, dev, step=3):
    from repro_torch.optim import codec
    key = codec.make_key(0, dev)
    ids = torch.arange(L, device=dev)
    return [codec.slot_salt(key, torch.tensor(step, device=dev), s, ids)
            for s in (0, 1)]


# Phases 2-3 hold K1 and K2 at every shape, level and dtype below, in every
# CASE, at both seed sets: the entry's design (one pass where the bucket
# fits, else two) must be the one the capacity rule names, two runs bitwise
# equal, the one-pass result bitwise equal to the two-pass kernel's, and
# every output bitwise equal to the plain version's, the norm included (the
# plain version sums ‖G̃‖² in the kernels' order: ref.chunk_ssq,
# ref.leaf_norm).
FUSED_SHAPES = MAIN_SHAPES + [FIRST_SHAPE, PARTIAL_SHAPE]
FUSED_LEVELS = (1, 2, 3)
FUSED_DTYPES = (torch.bfloat16, torch.float32)
# 0: the seeds earlier runs used (at level 2); 1: seeds no earlier run used,
# so a pass that depends on the seed shows
SEED_SETS = (0, 1)


def seed(case, n, level, seed_set):
    """Inputs of a phase 2-3 case."""
    return 1000 * case + n + 7 * (level - LEVEL) + 1_000_003 * seed_set


def check_designs(kernel, name, label, shape, level, dtype, runs, two,
                  counts, one_pass):
    """The entry took the design the capacity rule names (its design
    counters moved by ``counts``), its two runs are bitwise equal, and, on
    a bucket that fits, they equal the two-pass kernel's bitwise."""
    what = f"{name} {label} {shape} l={level} {dtype}"
    if counts != ((2, 0) if one_pass else (0, 2)):
        raise AssertionError(f"{what}: design counters moved by {counts}, "
                             f"the capacity rule says "
                             f"{'one' if one_pass else 'two'} pass(es)")
    for a, b in zip(*runs):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: two kernel runs differ")
    for a, b in zip(runs[0], two):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: one pass differs from two "
                                 f"passes in {int((a != b).sum())} of "
                                 f"{a.numel()} elements")


def refuses_one_pass(fn, what):
    try:
        fn()
    except ValueError as err:
        if "does not fit" not in str(err):
            raise
        return
    raise AssertionError(f"{what}: the one-pass entry took a bucket beyond "
                         f"capacity")


def check_fused(kernel, ref, dev, q8):
    """Phases 2 (K1) and 3 (``q8``: K2) at FUSED_SHAPES x FUSED_LEVELS x
    FUSED_DTYPES x CASES x SEED_SETS: p, m, v and the norm (K2: p, codes,
    scales and the norm) bitwise equal to the plain version, two runs
    bitwise, the designs as ``check_designs`` holds them.  Returns the
    worst absolute error over the outputs (0) and how many buckets took
    each design."""
    name = "K2" if q8 else "K1"
    lib = "gwt_adam_fused_q8" if q8 else "gwt_adam_fused"
    counter = ((lambda: (kernel.launches_q8_one_pass,
                         kernel.launches_q8_two_pass)) if q8 else
               (lambda: (kernel.launches_one_pass,
                         kernel.launches_two_pass)))
    outputs = ("p", "qm", "sm", "qv", "sv", "norm") if q8 \
        else ("p", "m", "v", "norm")
    taken = {"one": 0, "two": 0}
    step_size = torch.tensor(1e-3, device=dev)
    cases = 0
    for label, shape in FUSED_SHAPES:
        L, m, n = shape
        salts = q8_salts(L, dev)
        usalts = [s.to(torch.uint32) for s in salts]
        for level in FUSED_LEVELS:
            for dtype in FUSED_DTYPES:
                one = kernel.one_pass_plan(lib, shape, dtype,
                                           level)["grid"] > 0
                taken["one" if one else "two"] += 1
                for seed_set in SEED_SETS:
                    for ci, (case, use_lim, prev, wd) in enumerate(CASES):
                        sd = seed(ci, n, level, seed_set)
                        pn = torch.full((L,), prev, device=dev)
                        wd_coef = torch.tensor(wd, device=dev)
                        kw = dict(level=level, gamma=1.01,
                                  use_limiter=use_lim, weight_decay=wd != 0)
                        if q8:
                            inputs = make_q8_inputs(shape, sd, dev, level,
                                                    dtype)
                            kw["block"] = QBLOCK
                            want = ref.gwt_adam_fused_q8(
                                *inputs, *salts, pn, step_size, wd_coef,
                                **kw)
                            args = lambda: (*(t.clone() for t in inputs),
                                            *usalts, pn, step_size, wd_coef)
                            entry = kernel.gwt_adam_fused_q8
                            entries = (kernel.gwt_adam_fused_q8_two_pass,
                                       kernel.gwt_adam_fused_q8_one_pass)
                        else:
                            inputs = make_inputs(shape, sd, dev, level,
                                                 dtype)
                            want = ref.gwt_adam_fused(
                                *inputs, pn, step_size, wd_coef, **kw)
                            args = lambda: (*(t.clone() for t in inputs),
                                            pn, step_size, wd_coef)
                            entry = kernel.gwt_adam_fused
                            entries = (kernel.gwt_adam_fused_two_pass,
                                       kernel.gwt_adam_fused_one_pass)
                        before = counter()
                        runs = [entry(*args(), **kw) for _ in range(2)]
                        after = counter()
                        two = entries[0](*args(), **kw)
                        torch.cuda.synchronize()
                        check_designs(kernel, name, label, shape, level,
                                      dtype, runs, two,
                                      (after[0] - before[0],
                                       after[1] - before[1]), one)
                        check_bands(f"{name} {label} {shape} l={level} "
                                    f"{dtype} / {case} / seed set "
                                    f"{seed_set}", runs, want, outputs)
                        if use_lim and prev == 1.0 and not torch.allclose(
                                runs[0][-1], torch.full_like(runs[0][-1],
                                                             1.01)):
                            raise AssertionError(
                                f"{name} {label}: clipping case did not "
                                f"clip ({runs[0][-1].tolist()})")
                        cases += 1
                if not one:
                    refuses_one_pass(lambda: entries[1](*args(), **kw),
                                     f"{name} {label} {shape} {dtype}")
                print(f"{name} {label} {shape} l={level} {dtype}: "
                      f"{'one' if one else 'two'}-pass design, {len(CASES)} "
                      f"cases x {len(SEED_SETS)} seed sets; "
                      f"{', '.join(outputs)} bitwise equal to the plain "
                      f"version; two runs bitwise; "
                      + ("bitwise equal to the two-pass kernel" if one else
                         "beyond one-pass capacity: the one-pass entry "
                         "refuses it"))
    print(f"{name} vs plain: {cases} cases, {', '.join(outputs)} bitwise; "
          f"buckets by design {taken}")
    return 0.0, taken


def print_plans(kernel):
    """Phase 1: each one-pass kernel's registers, spill bytes and shared
    memory, and at the main path's buckets its blocks per SM, slots (chunk
    capacity) per block and grid."""
    for name in ("gwt_adam_fused", "gwt_adam_fused_q8"):
        for label, shape in MAIN_SHAPES + [FIRST_SHAPE]:
            for dtype in FUSED_DTYPES:
                plan = kernel.one_pass_plan(name, shape, dtype, LEVEL)
                print(f"one-pass plan {name} {shape} {dtype} l={LEVEL}: "
                      f"{plan['regs']} registers/thread, "
                      f"{plan['local_bytes']} B local (spills), "
                      f"{plan['static_smem']} B static shared, at most "
                      f"{plan['max_dyn_smem']} B dynamic shared per block, "
                      f"{plan['sms']} SMs; {plan['blocks_per_sm']} "
                      f"co-resident blocks/SM x {plan['slots']} chunk slots "
                      f"of {kernel.CHUNK * (1 << LEVEL) * dtype.itemsize} B "
                      f"= {plan['smem']} B per block, grid {plan['grid']}"
                      + ("" if plan["grid"] else " (two-pass: beyond "
                         "capacity)"))


# the leaves the staged path passes K4 at llama-60m, with their count per
# step (7 launches), and one odd shape
TILE_SHAPES = [("mixer wq/wk/wv/wo", (8, 512, 512), 4),
               ("ffn w_gate/w_up", (8, 512, 1376), 2),
               ("ffn w_down", (8, 1376, 512), 1)]
TILE_ODD = ("odd rows", (1, 37, 344), 0)
# (3, 101, 43 << l): 101 * 43 = 4343 coefficients per leaf at every level,
# odd, so the leaves after the first start unaligned; two whole chunks and
# a ragged third; 67 quantization blocks and a partial one of 55
TILE_ODD_NA = ("odd coefficients per leaf", 3, 101, 43)


def tile_inputs(shape, level, dtype, seed, dev):
    L, m, n = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = (torch.randn(L, m, n, generator=gen, device=dev) * 0.01).to(dtype)
    mm = torch.randn(L, m, n >> level, generator=gen, device=dev) * 1e-3
    vv = torch.rand(L, m, n >> level, generator=gen, device=dev) * 1e-6
    return g, mm, vv


def tile_q8_inputs(shape, level, dtype, seed, dev):
    """K4's inputs with the moments encoded by the port's codec, and the
    step's salts as K5 takes them."""
    from repro_torch.optim import codec
    g, mm, vv = tile_inputs(shape, level, dtype, seed, dev)
    L = shape[0]
    ids = torch.arange(L, device=dev)
    (qm, sm), (qv, sv) = (codec.quant_blocks(a.reshape(L, -1), ids + salt)
                          for a, salt in ((mm, 101), (vv, 202)))
    return (g, qm.reshape(mm.shape), sm, qv.reshape(vv.shape), sv), \
        q8_salts(L, dev)


def tile_cases():
    """Phase 13's (label, shape, level): the staged path's leaves, the odd
    rows and the odd coefficient counts, levels 1-3."""
    for level in (1, 2, 3):
        for label, shape, _ in TILE_SHAPES + [TILE_ODD]:
            yield label, shape, level
        label, L, m, a = TILE_ODD_NA
        yield label, (L, m, a << level), level


def check_tile(kernel, ref, dev):
    """Phase 13: K4 and K5 against their plain versions on the card at
    ``tile_cases()``, f32 and bf16 gradients, both seed sets: G̃, m', v'
    (K5: G̃, codes, scales) and the ‖G̃‖² partials (``ref.chunk_ssq`` of
    the plain G̃) bitwise, two runs bitwise.  Returns the number of cases
    each kernel ran."""
    n = 0
    for label, shape, level in tile_cases():
        for dtype in (torch.float32, torch.bfloat16):
            for seed_set in SEED_SETS:
                sd = 17 * level + shape[-1] + (dtype == torch.bfloat16) \
                    + 1_000_003 * seed_set
                what = f"{label} {shape} l={level} {dtype} / seed set " \
                    f"{seed_set}"
                g, mm, vv = tile_inputs(shape, level, dtype, sd, dev)
                want = ref.gwt_adam_tile(g, mm, vv, level=level)
                runs = [kernel.gwt_adam_tile(g, mm, vv, level=level)
                        for _ in range(2)]
                torch.cuda.synchronize()
                check_bands(f"K4 {what}", runs,
                            want[:3] + (ref.chunk_ssq(want[0], level),),
                            ("G̃", "m'", "v'", "partials"))
                args, salts = tile_q8_inputs(shape, level, dtype, sd, dev)
                kw = dict(level=level, block=QBLOCK)
                want = ref.gwt_adam_tile_q8(*args, *salts, **kw)
                usalts = [s.to(torch.uint32) for s in salts]
                runs = [kernel.gwt_adam_tile_q8(*args, *usalts, **kw)
                        for _ in range(2)]
                torch.cuda.synchronize()
                check_bands(f"K5 {what}", runs,
                            want[:5] + (ref.chunk_ssq(want[0], level),),
                            ("G̃", "qm'", "sm'", "qv'", "sv'", "partials"))
                n += 1
    print(f"K4/K5 vs plain: {n} cases each, G̃, m', v' (K5: G̃, codes, "
          f"scales) and the ‖G̃‖² partials bitwise, two runs bitwise")
    return n


def check_small_training(dev):
    """Phase 4: llama-60m-smoke, f32 and int8 state, same parameters and
    batches on the card and on the CPU; per-step losses within 1e-4
    relative."""
    from repro_torch import configs
    from repro_torch.core.gwt import gwt
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import lm
    from repro_torch.optim.base import flatten_with_paths, unflatten
    from repro_torch.optim.schedules import warmup_cosine

    cfg = configs.get_smoke("llama-60m")
    base = lm.init(cfg, torch.Generator().manual_seed(0), "cpu").tree()
    paths, leaves = flatten_with_paths(base)
    data = SyntheticLM(cfg.vocab, 32, 4, seed=0)
    for codec in ("f32", "int8"):
        losses = {}
        for device in ("cpu", "cuda"):
            tree = lm.LM(cfg, unflatten(paths, [l.detach().to(device).clone()
                                                for l in leaves])).tree()
            opt = gwt(warmup_cosine(0.01, 4), state_codec=codec)
            state = opt.init(tree)
            step = lm.make_train_step(cfg, opt)
            out = []
            for i in range(4):
                b = {k: torch.from_numpy(v).to(device)
                     for k, v in data.batch(i).items()}
                tree, state, met = step(tree, state, b)
                out.append(met["loss"])
            losses[device] = torch.stack(out).cpu().numpy()
        print(f"smoke {codec} losses cpu={losses['cpu'].tolist()} "
              f"cuda={losses['cuda'].tolist()}")
        np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


def time_ms(fn, iters):
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(shape, esize=2):
    """Least time for one launch: bytes that must move (read g, p, m, v,
    prev_norm and the two scalars once; write p, m, v, new_norm once) over
    HBM bandwidth, against the f32 operations over the f32 rate."""
    L, m, n = shape
    N, NA, B = L * m * n, L * m * (n >> LEVEL), 1 << LEVEL
    nbytes = 2 * N * esize + N * esize + 4 * NA * 4 + 2 * L * 4 + 8
    # per coefficient: forward and inverse butterflies 2*(4B-4), Adam and
    # the preconditioner 11, detail scaling B-1; per element: round and
    # square-sum 2, limit 1, step and write 2
    ops = NA * (2 * (4 * B - 4) + 11 + (B - 1)) + N * 5
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations", nbytes


def bound_q8(shape, esize=2):
    """Least time for one K2 launch.  Bytes: read g; read and write p; read
    and write both moments' int8 codes and their f32 scales; read prev_norm,
    the salts and the two scalars, write new_norm.  Operations: K1's f32
    work plus dequantization (2) and requantization (~9 per moment) in f32,
    and the rounding hash (~10 int32 operations per moment), each type over
    its own rate."""
    L, m, n = shape
    N, NA, B = L * m * n, L * m * (n >> LEVEL), 1 << LEVEL
    nb = L * -(-(m * (n >> LEVEL)) // QBLOCK)
    nbytes = 3 * N * esize + 2 * 2 * NA + 2 * 2 * nb * 4 + 4 * L * 4 + 8
    f32_ops = NA * (2 * (4 * B - 4) + 11 + (B - 1) + 2 + 2 * 9) + N * 5
    int_ops = NA * 2 * 10
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = f32_ops / F32_OPS_PER_S + int_ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations", nbytes


def time_fused(kernel, ref, dev, q8):
    """Phase 8: K1 (``q8``: K2) per launch at the main path's buckets, both
    designs in the same call: device time (CUDA events around each launch,
    L2 flushed before it; order one, two, two, one), time per call back to
    back (host included), the plain version's, the bound.  Returns one row
    per bucket."""
    rows = []
    flush = torch.empty(64 << 20, device=dev)   # 256 MB
    name = "K2" if q8 else "K1"
    for label, shape in MAIN_SHAPES:
        L = shape[0]
        pn = torch.full((L,), 1e9, device=dev)
        ss, wd = torch.tensor(1e-3, device=dev), torch.tensor(0.0,
                                                              device=dev)
        kw = dict(level=LEVEL, gamma=1.01, use_limiter=True,
                  weight_decay=False)
        if q8:
            inputs = make_q8_inputs(shape, 7, dev)
            salts = q8_salts(L, dev)
            args = (*inputs, *(s.to(torch.uint32) for s in salts), pn, ss,
                    wd)
            kw["block"] = QBLOCK
            plain = lambda: ref.gwt_adam_fused_q8(
                *inputs, *salts, pn, ss, wd, **kw)
            entry = {"one": kernel.gwt_adam_fused_q8_one_pass,
                     "two": kernel.gwt_adam_fused_q8_two_pass}
            counter = {"one": lambda: kernel.launches_q8_one_pass,
                       "two": lambda: kernel.launches_q8_two_pass}
            b_ms, b_by, nbytes = bound_q8(shape)
        else:
            g, p, mm, vv = make_inputs(shape, 7, dev)
            args = (g, p, mm, vv, pn, ss, wd)
            plain = lambda: ref.gwt_adam_fused(g, p, mm, vv, pn, ss, wd,
                                               **kw)
            entry = {"one": kernel.gwt_adam_fused_one_pass,
                     "two": kernel.gwt_adam_fused_two_pass}
            counter = {"one": lambda: kernel.launches_one_pass,
                       "two": lambda: kernel.launches_two_pass}
            b_ms, b_by, nbytes = bound(shape)
        call = {d: (lambda d=d: entry[d](*args, **kw)) for d in entry}
        t_plain = [time_ms(plain, 5)]
        t_dev = {"one": [], "two": []}
        for d in ("one", "two", "two", "one"):
            t_dev[d].append(device_ms(call[d], 20, counter[d], flush))
        t_call = {d: [time_ms(call[d], 50)] for d in ("one", "two")}
        t_plain.append(time_ms(plain, 5))
        row = {"bucket": label, "shape": list(shape), "per_step": 1,
               "ms": min(t_dev["one"]), "two_pass_ms": min(t_dev["two"]),
               "call_ms": min(t_call["one"]),
               "two_pass_call_ms": min(t_call["two"]),
               "plain_ms": min(t_plain), "bound_ms": b_ms, "bound_by": b_by,
               "bytes": nbytes}
        print(f"{name} time {label} {shape}: one pass {row['ms']:.4f} ms on "
              f"the device (runs {t_dev['one']}, {b_ms / row['ms']:.1%} of "
              f"bound), two passes {row['two_pass_ms']:.4f} ms (runs "
              f"{t_dev['two']}, {b_ms / row['two_pass_ms']:.1%}); per call "
              f"back to back {row['call_ms']:.4f} / "
              f"{row['two_pass_call_ms']:.4f} ms; plain "
              f"{row['plain_ms']:.4f} ms (runs {t_plain}); bound "
              f"{b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.2f} MB)")
        rows.append(row)
    return rows


def time_generic_wrap(dev):
    """The int8 path runs plain Adam on the 32000 x 512 embedding through
    the engine's generic decode -> update -> encode: time the decode and
    the encode (with the rounding hash) of its two moments, per step."""
    from repro_torch.optim import codec
    gen = torch.Generator(device=dev).manual_seed(3)
    shape = (1, 32000, 512)
    moments = [torch.randn(shape, generator=gen, device=dev) * 1e-3,
               torch.rand(shape, generator=gen, device=dev) * 1e-6]
    key = codec.make_key(0, dev)
    step = torch.tensor(5, dtype=torch.int32, device=dev)
    cdc = codec.get_codec("int8")
    enc = [cdc.encode(x, codec.slot_salt(key, step, i, 0))
           for i, x in enumerate(moments)]

    def decode():
        for e in enc:
            cdc.decode(e)

    def encode():
        for i, x in enumerate(moments):
            cdc.encode(x, codec.slot_salt(key, step, i, 0))

    t_dec = min(time_ms(decode, 5), time_ms(decode, 5))
    t_enc = min(time_ms(encode, 5), time_ms(encode, 5))
    print(f"generic int8 wrap of the embedding's m and v (2 x 16.4 M): "
          f"decode {t_dec:.3f} ms, encode {t_enc:.3f} ms per step")
    return t_dec, t_enc


def profile_step(dev, codec, steps=4, dp_reduce=None, fused_write=True):
    """Phase 9: where a full-width step's time goes.  First without the
    profiler: step time and ``optimizer.update``'s share (CUDA events around
    it).  Then under ``torch.profiler``: device kernel time per step (kernel
    durations; the profiler slows the host, not the kernels), launches per
    step, and the ops that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.core.gwt import gwt
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import lm
    from repro_torch.optim.schedules import warmup_cosine

    cfg = configs.get_config("llama-60m")
    tree = lm.init(cfg, torch.Generator(device=dev).manual_seed(1),
                   dev).tree()
    opt = gwt(warmup_cosine(0.01, 100), state_codec=codec,
              fused_write=fused_write)
    state = opt.init(tree)
    marks = []

    def timed_update(grads, st, params):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = opt.update(grads, st, params)
        b.record()
        marks.append((a, b))
        return out

    step = lm.make_train_step(cfg, opt._replace(update=timed_update),
                              dp_reduce=dp_reduce)
    data = SyntheticLM(cfg.vocab, 256, 16, seed=1)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in data.batch(i).items()}
               for i in range(2 * steps + 2)]

    def run(bs):
        nonlocal tree, state
        marks.clear()
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        for b in bs:
            tree, state, _ = step(tree, state, b)
        stop.record()
        torch.cuda.synchronize()
        return (start.elapsed_time(stop) / len(bs),
                sum(a.elapsed_time(b) for a, b in marks) / len(bs))

    run(batches[:2])
    step_ms, opt_ms = run(batches[2:2 + steps])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_step_ms, _ = run(batches[2 + steps:])
    kernel_us = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(kernel_us) / 1e3 / steps
    print(f"profile {codec} dp_reduce={dp_reduce} fused_write="
          f"{fused_write}: step {step_ms:.2f} ms, "
          f"optimizer.update {opt_ms:.2f} ms, rest of the step (data to model grads) "
          f"{step_ms - opt_ms:.2f} ms; device kernels {busy_ms:.2f} ms/step "
          f"= {busy_ms / step_ms:.1%} of the unprofiled step "
          f"({1 - busy_ms / step_ms:.1%} idle); {len(kernel_us) // steps} "
          f"kernel launches/step; step under the profiler "
          f"{prof_step_ms:.2f} ms")
    dev_time = lambda e: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0))
    ops = sorted(prof.key_averages(), key=lambda e: -dev_time(e))[:10]
    for e in ops:
        print(f"  {dev_time(e) / 1e3 / steps:8.3f} ms/step device "
              f"{e.count // steps:5d} calls/step  {e.key[:70]}")
    return {"step_ms": step_ms, "update_ms": opt_ms,
            "device_busy_ms": busy_ms,
            "launches_per_step": len(kernel_us) // steps}


def reset_counts(kernel, hk):
    kernel.launches = kernel.launches_q8 = 0
    kernel.launches_one_pass = kernel.launches_two_pass = 0
    kernel.launches_q8_one_pass = kernel.launches_q8_two_pass = 0
    kernel.launches_tile = kernel.launches_tile_q8 = 0
    hk.launches_fwd = hk.launches_fwd_q = hk.launches_inv = 0
    hk.leaves_fwd = hk.leaves_fwd_q = 0


def all_counts(kernel, hk):
    """Every wrapper's launch count; K1 and K2 also by design, K3 and K6
    also the leaves their grouped launches covered."""
    return {"K1": kernel.launches, "K2": kernel.launches_q8,
            "K1 one-pass": kernel.launches_one_pass,
            "K1 two-pass": kernel.launches_two_pass,
            "K2 one-pass": kernel.launches_q8_one_pass,
            "K2 two-pass": kernel.launches_q8_two_pass,
            "K3": hk.launches_fwd_q, "K4": kernel.launches_tile,
            "K5": kernel.launches_tile_q8, "K6": hk.launches_fwd,
            "K7": hk.launches_inv, "K3 leaves": hk.leaves_fwd_q,
            "K6 leaves": hk.leaves_fwd}


def fused_counts(k1=0, k2=0):
    """K1's and K2's counters when every bucket took the one-pass design."""
    return {"K1": k1, "K2": k2, "K1 one-pass": k1, "K1 two-pass": 0,
            "K2 one-pass": k2, "K2 two-pass": 0}


def run_main_path(train, kernel, hk, codec, extra=()):
    """Phases 5 and 6: the launcher at full width, launch counts set to 0
    just before and read just after."""
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernel, hk)
    t0 = time.perf_counter()
    res = train.main(MAIN_ARGS + ["--state-codec", codec, *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = all_counts(kernel, hk)
    peak = torch.cuda.max_memory_allocated()
    logged = [res.losses[i] for i in range(4, len(res.losses), 5)]
    print(f"main path {codec}: {STEPS} steps in {wall:.2f} s; logged losses "
          f"{logged}; launches {counts}; step {res.step_ms:.2f} ms; "
          f"{16 * 256 / (res.step_ms / 1e3):.0f} tokens/s; peak memory "
          f"{peak / 2**20:.1f} MiB")
    mine = "K1" if codec == "f32" else "K2"
    want = {k: 0 for k in counts}
    want.update(fused_counts(**{mine.lower(): 3 * STEPS}))
    if counts != want:
        raise AssertionError(f"{codec} path launched {counts} in {STEPS} "
                             f"steps, want {want}")
    if not np.all(np.isfinite(res.losses)):
        raise AssertionError(f"non-finite losses {res.losses}")
    if not logged[-1] < logged[0]:
        raise AssertionError(f"loss did not fall: {logged}")
    from repro_torch.optim.base import flatten_with_paths
    for name, t in zip(*flatten_with_paths(res.params)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"non-finite parameter {name}")
    return res, counts[mine], peak


def assert_bitwise(a, b, what):
    from repro_torch.optim.base import flatten_with_paths
    pa, la = flatten_with_paths(a)
    pb, lb = flatten_with_paths(b)
    if pa != pb:
        raise AssertionError(f"{what}: different leaves")
    for path, x, y in zip(pa, la, lb):
        if x.dtype != y.dtype or not torch.equal(x, y):
            raise AssertionError(f"{what}: {path} differs")


def check_resume(train, straight):
    """Phase 7: 20 int8 steps checkpointing at 10, then a fresh run resumed
    from step 10, against phase 6's 20 straight steps, bitwise."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ckpt = ["--state-codec", "int8", "--ckpt-dir", tmp,
                "--ckpt-every", "10"]
        first = train.main(MAIN_ARGS + ckpt)
        assert_bitwise(first.params, straight.params, "checkpointed run")
        shutil.rmtree(os.path.join(tmp, f"step_{STEPS:09d}"))
        resumed = train.main(MAIN_ARGS + ckpt + ["--resume"])
        if resumed.start_step != 10 or \
                first.losses[10:] != resumed.losses:
            raise AssertionError(f"resume from {resumed.start_step}: losses "
                                 f"{resumed.losses} vs {first.losses[10:]}")
        assert_bitwise(resumed.params, straight.params, "resumed params")
        assert_bitwise(resumed.opt_state, straight.opt_state,
                       "resumed optimizer state")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"resume: 10 steps + checkpoint + resume + 10 steps == {STEPS} "
          f"straight steps, bitwise (params, codes, scales, norms)")


def raw_bits(t):
    """A tensor's bit pattern as an integer tensor of its item size."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


def haar_input(shape, seed, dev, scale, edges):
    """f32 gradient-like input.  With ``edges`` row 0 carries values past
    the fp8 range and +-inf, each in its own level-3 group of 8 columns, so
    no butterfly meets inf - inf."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(*shape, generator=gen, device=dev) * scale
    if not edges:
        return g
    cols = [0, 8, 16, 24, 32, 40, 48, 56][:shape[1] // 8]
    edge = [464.0, 465.0, -465.0, 1e30, math.inf, 480.0, -1000.0, -math.inf]
    g[0, cols] = torch.tensor(edge[:len(cols)], device=dev)
    return g


def check_bands(what, got_runs, want, names=None):
    """A kernel's outputs (bands, moments, norms, ...; ``names``, else
    numbered) against the plain version's: bitwise (NaN codes included),
    and the two kernel runs bitwise."""
    for a, b in zip(*got_runs):
        if not torch.equal(raw_bits(a), raw_bits(b)):
            raise AssertionError(f"{what}: two kernel runs differ")
    names = names or [f"band {i}" for i in range(len(want))]
    if len(got_runs[0]) != len(want) or len(names) != len(want):
        raise AssertionError(f"{what}: {len(got_runs[0])} outputs, plain "
                             f"{len(want)}")
    for name, a, b in zip(names, got_runs[0], want):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{what} {name}: {a.dtype} {a.shape} vs "
                                 f"plain {b.dtype} {b.shape}")
        differ = int((raw_bits(a) != raw_bits(b)).sum())
        if differ:
            worst = (a.double() - b.double()).abs().max().item()
            raise AssertionError(f"{what} {name}: {differ} of {a.numel()} "
                                 f"elements differ from the plain version "
                                 f"(max |diff| {worst:.3g})")


def check_fp8_rule(hk, dev):
    """The plain fp8 cast gives the JAX package's codes on the edge values,
    and K3's fp8 details equal it on a dense sweep across the 448/464
    boundary, NaN and +-inf."""
    from repro_torch.kernels.haar_dwt import ref as href
    vals = torch.tensor([v for v, _ in FP8_EDGES], device=dev)
    codes = href.to_wire(vals, torch.float8_e4m3fn).view(torch.uint8)
    want = [c for _, c in FP8_EDGES]
    if codes.tolist() != want:
        raise AssertionError(f"plain fp8 codes {codes.tolist()} != JAX's "
                             f"{want}")
    # level 1 on pairs (e, 0): D_1 = e * f32(1/sqrt 2) sweeps 424..495
    e = torch.linspace(600.0, 700.0, 4094, device=dev)
    e = torch.cat([e, torch.tensor([math.nan, math.inf], device=dev)])
    g = torch.stack([e, torch.zeros_like(e)], -1).reshape(2, -1)
    g = torch.cat([g, -g])
    got = hk.haar_dwt_fwd_q(g, 1, torch.float8_e4m3fn)
    check_bands("K3 fp8 sweep", [got, got],
                href.haar_dwt_fwd_q(g, 1, torch.float8_e4m3fn))
    nan = int((got[1].view(torch.uint8) & 0x7F == 0x7F).sum())
    print(f"fp8 rule: edge codes = JAX's {[hex(c) for c in want]}; K3 sweep "
          f"across 448/464 bitwise with the plain cast ({nan} NaN codes of "
          f"{got[1].numel()})")


def check_haar(hk, dev):
    """Phase 10: K3, K6, K7 against their plain versions, bitwise.  Returns
    the worst absolute error, 0 (any difference raises)."""
    from repro_torch.kernels.haar_dwt import ref as href
    check_fp8_rule(hk, dev)
    wires = (torch.bfloat16, torch.float16, torch.float8_e4m3fn)
    n_checks = 0
    for shape in [s for s, _ in DP_SHAPES] + [ODD_SHAPE]:
        for level in (1, 2, 3):
            for wire in wires:
                scale = 200.0 if wire == torch.float8_e4m3fn else 1.0
                g = haar_input(shape, level + shape[0], dev, scale, True)
                want = href.haar_dwt_fwd_q(g, level, wire)
                runs = [hk.haar_dwt_fwd_q(g, level, wire) for _ in range(2)]
                check_bands(f"K3 {shape} l={level} {wire}", runs, want)
                n_checks += 1
            for dtype in (torch.float32, torch.bfloat16):
                g = haar_input(shape, 7 + level, dev, 1.0, False).to(dtype)
                want = href.haar_dwt_fwd(g, level)
                runs = [hk.haar_dwt_fwd(g, level) for _ in range(2)]
                check_bands(f"K6 {shape} l={level} {dtype}", runs, want)
                bands = runs[0]
                want = [href.haar_dwt_inv(bands[0], bands[1:])]
                runs = [[hk.haar_dwt_inv(bands[0], bands[1:])]
                        for _ in range(2)]
                check_bands(f"K7 {shape} l={level} {dtype}", runs, want)
                n_checks += 2
    torch.cuda.synchronize()
    print(f"K3/K6/K7 vs plain: {n_checks} cases bitwise (every band, NaN "
          f"codes included), two runs bitwise")
    check_haar_groups(hk, dev)
    return 0.0


def unaligned(x):
    """A contiguous copy of ``x`` one element past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    buf[1:].copy_(x.reshape(-1))
    return buf[1:].view(x.shape)


def group_cases(level):
    """(label, leaf shapes, indices of the leaves given unaligned) of phase
    10's grouped checks at ``level``: the data-parallel group; a mixed group
    with the odd-row shape, a leaf with an odd coefficient count (101 x 43,
    whose last tile is partial) given twice, once unaligned, and the
    smallest DP leaf; and 40 leaves, more than one launch takes."""
    dp = [shape for shape, count in DP_SHAPES for _ in range(count)]
    odd = (101, 43 << level)
    mixed = [ODD_SHAPE, odd, odd, (8, 512)]
    many = [(1 + i % 5, 8 * (3 + i % 11)) for i in range(40)]
    return [("DP group", dp, ()), ("mixed", mixed, (2,)),
            ("40 leaves", many, tuple(range(3, 40, 4)))]


def check_haar_groups(hk, dev):
    """Phase 10, grouped: K3 (bf16, f16, fp8 details) and K6 (bf16, f32)
    over each of ``group_cases`` at levels 1-3, every band of every leaf
    bitwise to the per-leaf plain version (the fp8 inputs reach past 464
    and +-inf), two runs bitwise, and the launch and leaf counters risen by
    the group's launches and leaves."""
    from repro_torch.kernels.haar_dwt import ref as href
    kinds = [("K3", torch.bfloat16), ("K3", torch.float16),
             ("K3", torch.float8_e4m3fn), ("K6", torch.bfloat16),
             ("K6", torch.float32)]
    for name, codes in [("K3 bf16", (0, 0, 1)), ("K3 fp8", (0, 0, 3)),
                        ("K6 bf16", (1, 1, 1)), ("K6 f32", (0, 0, 0))]:
        print(f"{name} grouped plan at level {LEVEL}: "
              f"{hk.fwd_plan(codes, LEVEL, dev)}")
    n_checks = 0
    for level in (1, 2, 3):
        cap = hk.fwd_plan((0, 0, 1), level, dev)["group_leaves"]
        for label, shapes, odd in group_cases(level):
            launches = -(-len(shapes) // cap)
            for name, kind in kinds:
                k3 = name == "K3"
                fp8 = kind == torch.float8_e4m3fn
                gs = [haar_input(shape, 31 * i + level, dev,
                                 200.0 if fp8 else 1.0, k3)
                      for i, shape in enumerate(shapes)]
                if not k3:
                    gs = [g.to(kind) for g in gs]
                gs = [unaligned(g) if i in odd else g
                      for i, g in enumerate(gs)]
                before = (hk.launches_fwd_q, hk.leaves_fwd_q,
                          hk.launches_fwd, hk.leaves_fwd)
                if k3:
                    runs = [hk.haar_dwt_fwd_q_group(gs, level, kind)
                            for _ in range(2)]
                    wants = [href.haar_dwt_fwd_q(g, level, kind) for g in gs]
                    rise = (2 * launches, 2 * len(gs), 0, 0)
                else:
                    runs = [hk.haar_dwt_fwd_group(gs, level)
                            for _ in range(2)]
                    wants = [href.haar_dwt_fwd(g, level) for g in gs]
                    rise = (0, 0, 2 * launches, 2 * len(gs))
                after = (hk.launches_fwd_q, hk.leaves_fwd_q,
                         hk.launches_fwd, hk.leaves_fwd)
                if tuple(a - b for a, b in zip(after, before)) != rise:
                    raise AssertionError(f"grouped {label}: counters rose "
                                         f"{before} -> {after}, want {rise}")
                for i, want in enumerate(wants):
                    check_bands(f"{name} group {label} leaf {i} "
                                f"{tuple(gs[i].shape)} l={level} {kind}",
                                [runs[0][i], runs[1][i]], want)
                n_checks += 1
    torch.cuda.synchronize()
    print(f"K3/K6 grouped vs per-leaf plain: {n_checks} groups bitwise "
          f"(10 DP leaves, mixed odd rows / odd coefficient count / "
          f"unaligned base, 40 leaves in {-(-40 // cap)} launches; "
          f"levels 1-3; K3 bf16/f16/fp8, K6 bf16/f32), two runs "
          f"bitwise, launch and leaf counters exact")


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def one_rank_env():
    """Inside, ``launch.mesh.init_dp`` joins a one-rank NCCL group."""
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_dp_path(train, kernel, hk, extra, steps):
    """Phase 11: the launcher with --dp-reduce under a one-rank NCCL
    process group; launch counts set to 0 just before and read just
    after: K3 once a step for all 10 compressible leaves."""
    args = [a if a != str(STEPS) else str(steps) for a in MAIN_ARGS]
    with one_rank_env():
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernel, hk)
        t0 = time.perf_counter()
        res = train.main(args + ["--dp-reduce", "compressed", *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = all_counts(kernel, hk)
        peak = torch.cuda.max_memory_allocated()
    ef = "--dp-error-feedback" in extra
    want = {k: 0 for k in counts}
    want.update(fused_counts(k1=3 * steps), K3=steps,
                K7=(20 if ef else 10) * steps)
    want["K3 leaves"] = 10 * steps
    logged = [res.losses[i] for i in range(4, len(res.losses), 5)]
    print(f"dp path {extra}: {steps} steps in {wall:.2f} s; logged losses "
          f"{logged}; launches {counts}; step {res.step_ms:.2f} ms; wire "
          f"bytes {res.wire_bytes}; peak memory {peak / 2**20:.1f} MiB")
    if counts != want:
        raise AssertionError(f"dp path launched {counts}, want {want}")
    if not np.all(np.isfinite(res.losses)) or not logged[-1] < logged[0]:
        raise AssertionError(f"dp path losses {res.losses}")
    if not extra and res.wire_bytes != (WIRE_BF16, WIRE_EXACT):
        raise AssertionError(f"wire bytes {res.wire_bytes}, the JAX package "
                             f"counts {(WIRE_BF16, WIRE_EXACT)}")
    from repro_torch.optim.base import flatten_with_paths
    for name, t in zip(*flatten_with_paths(res.params)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"non-finite parameter {name}")
    return res, counts, peak


def check_grouped_reduction(hk, dev):
    """Phase 11: one reduction of a full-width llama-60m gradient (seed 0
    parameters, the launcher's first batch) over a one-rank NCCL group,
    grouped (``compressed_means``: one K3 launch) and leaf by leaf
    (``compressed_mean``: one K3 launch a leaf): the means bitwise equal,
    with bf16 details and with fp8 details and error feedback (residues
    too).  Prints each one's peak ``max_memory_allocated`` above what the
    gradients and earlier phases hold; returns them."""
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed import compression as C
    from repro_torch.launch.mesh import init_dp
    from repro_torch.models import lm
    from repro_torch.optim.base import flatten_with_paths

    cfg = configs.get_config("llama-60m")
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0),
                     dev).tree()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             SyntheticLM(cfg.vocab, 256, 16, seed=0).batch(0).items()}
    leaves = flatten_with_paths(params)[1]
    grads, _ = lm._accumulate(cfg, params, leaves,
                              lm.contiguous_microbatches(batch, 1), 1)
    del params, leaves, batch
    gen = torch.Generator(device=dev).manual_seed(3)
    errs = [torch.randn(g.shape, generator=gen, device=dev) * 1e-4
            for g in grads]
    fp8 = torch.float8_e4m3fn
    ways = {
        "bf16": (lambda: C.compressed_means(grads, dp, 2, torch.bfloat16),
                 lambda: [C.compressed_mean(g, dp, 2, torch.bfloat16)
                          for g in grads]),
        "fp8+ef": (lambda: C.compressed_means_ef(grads, errs, dp, 2, fp8),
                   lambda: tuple(map(list, zip(*[
                       C.compressed_mean_ef(g, e, dp, 2, fp8)
                       for g, e in zip(grads, errs)])))),
    }
    peaks = {}
    with one_rank_env():
        dp = init_dp(dev)
        try:
            for label, (grouped, per_leaf) in ways.items():
                got = {}
                for way, fn in (("grouped", grouped), ("per leaf", per_leaf)):
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    before = hk.launches_fwd_q
                    got[way] = fn()
                    torch.cuda.synchronize()
                    peaks[f"{label} {way}"] = (
                        torch.cuda.max_memory_allocated() - base) / 2**20
                    want = 1 if way == "grouped" else 10
                    if hk.launches_fwd_q - before != want:
                        raise AssertionError(
                            f"{label} {way}: {hk.launches_fwd_q - before} "
                            f"K3 launches, want {want}")
                flat = lambda x: x if label == "bf16" else x[0] + x[1]
                for i, (a, b) in enumerate(zip(flat(got["grouped"]),
                                               flat(got["per leaf"]))):
                    if not torch.equal(raw_bits(a), raw_bits(b)):
                        raise AssertionError(f"{label}: grouped and per-leaf "
                                             f"reductions differ at {i}")
                del got
        finally:
            dp.close()
    print(f"grouped DP reduction == per-leaf reduction, bitwise, at full "
          f"width (bf16 means; fp8 means and residues with error "
          f"feedback); peak MiB above the gradients: "
          + ", ".join(f"{k} {v:.1f}" for k, v in peaks.items()))
    return peaks


def bound_haar(kind, shape, level=LEVEL, wire_bytes=2):
    """Least time for one launch at ``shape``: bytes over HBM bandwidth
    (each input read once, each output written once) against the
    butterflies' f32 operations (2 per element of each level's input)."""
    m, n = shape
    N = m * n
    if kind == "K3":      # f32 in, A_l f32, details in the wire dtype
        nbytes = 4 * N + 4 * (N >> level) + wire_bytes * (N - (N >> level))
    elif kind == "K6":    # bf16 in, bands in bf16
        nbytes = 2 * N + 2 * N
    else:                 # K7: f32 bands in, f32 out
        nbytes = 4 * N + 4 * N
    ops = sum(2 * (N >> k) for k in range(level))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations", nbytes


def device_ms(fn, iters, launches, flush):
    """Device time per call of ``fn``, one kernel launch, from CUDA events
    recorded just before and just after each of ``iters`` calls.  Before
    each call ``flush`` (a tensor larger than the 50 MB L2 cache) is
    overwritten, so the call reads its inputs from device memory, as the
    step's first touch of a gradient does; then the card spins for
    ``SPIN_CYCLES``, so the call's launch is queued behind the start event
    before that event fires and the span between the events holds the
    kernel's device time and none of the host's.  ``launches()`` reads the
    wrapper's launch counter: it must rise by exactly ``iters``."""
    fn()
    torch.cuda.synchronize()
    spans = []
    before = launches()
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        fn()
        stop.record()
        spans.append((start, stop))
    torch.cuda.synchronize()
    if launches() - before != iters:
        raise AssertionError(f"{launches() - before} kernel launches in "
                             f"{iters} timed calls")
    return sum(a.elapsed_time(b) for a, b in spans) / iters


class ParentHaar:
    """The parent revision's K3, K6 and K7 (``haar_dwt@parent``, one leaf
    a launch), called through that revision's C interface, with its own
    launch counter."""

    def __init__(self, build, hk):
        import ctypes
        self.ctypes, self.hk, self.launches = ctypes, hk, 0
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

        def declare(lib):
            for fn in (lib.haar_dwt_fwd, lib.haar_dwt_fwd_q,
                       lib.haar_dwt_inv):
                fn.argtypes = [i, i, vp, vp, vp, ll, i, vp]
                fn.restype = i
        self.lib = build.load(PARENT_HAAR, declare)

    def _call(self, fn, *args):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
        if err:
            raise RuntimeError(f"parent {fn.__name__}: CUDA error {err}")
        self.launches += 1

    def _ptrs(self, ts):
        return (self.ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))

    def _fwd(self, fn, code, g, level, a_dtype, d_dtype):
        m, n = g.shape
        out = [torch.empty((m, n >> level), dtype=a_dtype, device=g.device)]
        out += [torch.empty((m, n >> k), dtype=d_dtype, device=g.device)
                for k in range(level, 0, -1)]
        self._call(fn, code, level, g.data_ptr(), out[0].data_ptr(),
                   self._ptrs(out[1:]), out[0].numel(),
                   int(g.data_ptr() % 16 == 0))
        return tuple(out)

    def fwd_q(self, g, level, wire):
        return self._fwd(self.lib.haar_dwt_fwd_q, self.hk._WIRE[wire], g,
                         level, torch.float32, wire)

    def fwd(self, g, level):
        return self._fwd(self.lib.haar_dwt_fwd, self.hk._IN[g.dtype], g,
                         level, g.dtype, g.dtype)

    def inv(self, a, ds):
        m, na = a.shape
        out = torch.empty((m, na << len(ds)), dtype=a.dtype, device=a.device)
        self._call(self.lib.haar_dwt_inv, self.hk._IN[a.dtype], len(ds),
                   a.data_ptr(), self._ptrs(ds), out.data_ptr(), a.numel(),
                   int(all(t.data_ptr() % 16 == 0 for t in (a, *ds))))
        return out


def dp_leaves(dev, dtype=torch.float32, seed=0):
    """The 10 compressible leaves of llama-60m as the reduction hands them
    to K3 (``DP_SHAPES``, each as often as a step has it), random
    normal."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(*shape, generator=gen, device=dev).to(dtype)
            for shape, count in DP_SHAPES for _ in range(count)]


def host_us(fn, calls=100):
    """Host time per call of ``fn`` (the wrapper's Python, checks, ctypes
    call and launch), the card left to run behind."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def time_haar(hk, dev, parent):
    """Phase 12 at level 2: per launch at each leaf shape, the kernel's
    device time (CUDA events around each launch, L2 flushed before it; the
    parent revision's K3, K6 and K7 in turns with the built ones, built,
    parent, parent, built, when ``parent``), its time per call back to
    back (CUDA events: the host's wrapper time when the host is slower than
    the card, and inputs warm in L2 when they fit), the plain version's,
    the bound; one step's worth is the count-weighted sum.  Then K3 (bf16
    and fp8 details) and K6 (bf16) over the whole DP group as one grouped
    launch: device time, time per call, the wrapper's host time per call
    against ten single-leaf calls', the plain versions' and the bound (the
    sum over the leaves).  Returns ``(rows, groups)``."""
    from repro_torch.kernels import build
    from repro_torch.kernels.haar_dwt import ref as href
    old = ParentHaar(build, hk) if parent else None
    fp8 = torch.float8_e4m3fn
    # name: (kernel, parent's, plain, input dtype, kind, wire bytes, counter)
    q = lambda w: (lambda g: hk.haar_dwt_fwd_q(g, LEVEL, w),
                   old and (lambda g: old.fwd_q(g, LEVEL, w)),
                   lambda g: href.haar_dwt_fwd_q(g, LEVEL, w),
                   torch.float32, "K3", w.itemsize,
                   lambda: hk.launches_fwd_q)
    cases = {
        "K3 bf16": q(torch.bfloat16),
        "K3 fp8": q(fp8),
        "K6 bf16": (lambda g: hk.haar_dwt_fwd(g, LEVEL),
                    old and (lambda g: old.fwd(g, LEVEL)),
                    lambda g: href.haar_dwt_fwd(g, LEVEL),
                    torch.bfloat16, "K6", 2, lambda: hk.launches_fwd),
        "K7 f32": (lambda b: hk.haar_dwt_inv(b[0], b[1:]),
                   old and (lambda b: old.inv(b[0], b[1:])),
                   lambda b: href.haar_dwt_inv(b[0], b[1:]),
                   torch.float32, "K7", 4, lambda: hk.launches_inv),
    }
    rows = {name: [] for name in cases}
    flush = torch.empty(64 << 20, device=dev)   # 256 MB
    for shape, count in DP_SHAPES:
        g32 = torch.randn(*shape, device=dev)
        for name, (kern, prev, plain, dtype, kind, wb, counter) in \
                cases.items():
            x = g32.to(dtype)
            if kind == "K7":
                x = list(href.haar_dwt_fwd(g32, LEVEL))
            t_plain = [time_ms(lambda: plain(x), 5)]
            t_call = [time_ms(lambda: kern(x), 50), time_ms(lambda: kern(x),
                                                             50)]
            t_dev, t_parent = [], []
            for which in ("built", "parent", "parent", "built") if old \
                    else ("built", "built"):
                if which == "built":
                    t_dev.append(device_ms(lambda: kern(x), 20, counter,
                                           flush))
                else:
                    t_parent.append(device_ms(lambda: prev(x), 20,
                                              lambda: old.launches, flush))
            t_plain.append(time_ms(lambda: plain(x), 5))
            b_ms, b_by, nbytes = bound_haar(kind, shape, wire_bytes=wb)
            row = {"shape": list(shape), "per_step": count,
                   "ms": min(t_dev), "call_ms": min(t_call),
                   "parent_ms": min(t_parent) if old else None,
                   "plain_ms": min(t_plain), "bound_ms": b_ms,
                   "bound_by": b_by, "bytes": nbytes}
            print(f"{name} time {shape}: kernel {row['ms']:.4f} ms on the "
                  f"device (runs {t_dev}), {b_ms / row['ms']:.1%} of bound; "
                  f"parent's "
                  + (f"{row['parent_ms']:.4f} ms (runs {t_parent})" if old
                     else "not built (tools/parent_kernels.py not run)")
                  + f"; {row['call_ms']:.4f} ms per call (runs {t_call}), "
                  f"plain {row['plain_ms']:.4f} ms, bound {b_ms:.4f} ms by "
                  f"{b_by} ({nbytes / 1e6:.2f} MB)")
            rows[name].append(row)
    groups = {}
    for name in ("K3 bf16", "K3 fp8", "K6 bf16"):
        kern, _, plain, dtype, kind, wb, counter = cases[name]
        gs = dp_leaves(dev, dtype)
        if kind == "K3":
            wire = torch.bfloat16 if wb == 2 else fp8
            group = lambda: hk.haar_dwt_fwd_q_group(gs, LEVEL, wire)
        else:
            group = lambda: hk.haar_dwt_fwd_group(gs, LEVEL)
        singles = lambda: [kern(g) for g in gs]
        t_dev = [device_ms(group, 20, counter, flush) for _ in range(2)]
        t_call = [time_ms(group, 50) for _ in range(2)]
        t_plain = min(time_ms(lambda: [plain(g) for g in gs], 5)
                      for _ in range(2))
        host = [host_us(group), host_us(singles, 20)]
        step = {k: sum(r[k] * r["per_step"] for r in rows[name])
                for k in ("ms", "bound_ms", "bytes")}
        parent_step = sum(r["parent_ms"] * r["per_step"]
                          for r in rows[name]) if old else None
        groups[name] = {
            "ms": min(t_dev), "call_ms": min(t_call), "plain_ms": t_plain,
            "bound_ms": step["bound_ms"], "bytes": step["bytes"],
            "ten_launches_ms": step["ms"], "parent_ten_launches_ms":
            parent_step, "host_us_per_call": host[0],
            "host_us_ten_single_calls": host[1]}
        print(f"{name} DP group (10 leaves, one launch): kernel "
              f"{min(t_dev):.4f} ms on the device (runs {t_dev}), "
              f"{step['bound_ms'] / min(t_dev):.1%} of its bound "
              f"{step['bound_ms']:.4f} ms; as 10 single launches "
              f"{step['ms']:.4f} ms ({step['bound_ms'] / step['ms']:.1%}); "
              f"parent's 10 launches "
              + (f"{parent_step:.4f} ms" if old else "not built")
              + f"; {min(t_call):.4f} ms per call back to back; host "
              f"{host[0]:.1f} us per grouped call against {host[1]:.1f} us "
              f"for 10 single calls; plain {t_plain:.4f} ms")
    return rows, groups


def staged_loop(opt, steps, seed=0):
    """llama-60m at full width through the ``TrainLoop`` with ``opt``, from
    the launcher's parameters and batches (seed 0, batch 16 x seq 256):
    what ``train.main`` runs, with an optimizer the launcher does not
    offer.  Returns ``(params, state, losses, step_ms)``."""
    from repro_torch import configs
    from repro_torch.data.pipeline import make_source
    from repro_torch.models import lm
    from repro_torch.runtime.fault_tolerance import TrainLoop
    dev = torch.device("cuda")
    cfg = configs.get_config("llama-60m")
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(seed),
                     dev).tree()
    state = opt.init(params)
    loop = TrainLoop(lm.make_train_step(cfg, opt),
                     make_source("synthetic", cfg.vocab, 256, 16, seed=seed),
                     device=dev, log_every=5, log=lambda line: None)
    params, state, losses = loop.run(params, state, num_steps=steps)
    torch.cuda.synchronize()
    step_ms = None if loop.steady_step_s is None \
        else loop.steady_step_s * 1e3
    return params, state, losses, step_ms


def gwt_opt(steps, **kw):
    from repro_torch.core.gwt import gwt
    from repro_torch.optim.schedules import warmup_cosine
    return gwt(warmup_cosine(0.01, steps), level=LEVEL, alpha=0.25, **kw)


# The staged path against the fused path of the same call, loss by loss.
# Both round G̃ to bf16 before the limiter (the fused kernels as their
# plain versions do); they differ in the order the per-leaf norm is summed
# (K1's block tree against torch.linalg.vector_norm), so a limiter scale
# can land one f32 spacing apart and bf16(scale) one bf16 spacing apart
# on a clipped step, which moves every element of that leaf's update by
# up to 2^-8 of itself; 20 steps carry that into the loss.  int8 adds
# stochastic requantization, where a one-spacing moment change flips a
# code.
TOL_STAGED_LOSS = {"f32": 5e-3, "int8": 5e-2}


def run_staged_path(kernel, hk, codec, fused):
    """The staged path, ``gwt(fused_write=False)``, at full width for
    ``STEPS`` steps, counts set to 0 just before and read just after: K4
    must launch once per GWT leaf per step (7 x 20 = 140), K1, K2 and K5
    never; the loss must fall and stay within ``TOL_STAGED_LOSS`` of the
    fused path's run ``fused`` (same parameters and batches)."""
    opt = gwt_opt(STEPS, fused_write=False, state_codec=codec)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernel, hk)
    t0 = time.perf_counter()
    params, state, losses, step_ms = staged_loop(opt, STEPS)
    wall = time.perf_counter() - t0
    counts = all_counts(kernel, hk)
    peak = torch.cuda.max_memory_allocated() - base
    logged = [losses[i] for i in range(4, len(losses), 5)]
    gap = max(abs(a - b) for a, b in zip(losses, fused.losses))
    print(f"staged path {codec}: {STEPS} steps in {wall:.2f} s; logged "
          f"losses {logged}; launches {counts}; step {step_ms:.2f} ms "
          f"(fused path {fused.step_ms:.2f} ms); peak memory of the run "
          f"{peak / 2**20:.1f} MiB above what earlier phases hold; max "
          f"|loss - fused path's| {gap:.3g} (<= {TOL_STAGED_LOSS[codec]})")
    want = {k: 0 for k in counts}
    want.update(fused_counts(), K4=7 * STEPS)
    if counts != want:
        raise AssertionError(f"staged {codec} path launched {counts}, "
                             f"want {want}")
    if not np.all(np.isfinite(losses)) or not logged[-1] < logged[0]:
        raise AssertionError(f"staged {codec} losses {losses}")
    if gap > TOL_STAGED_LOSS[codec]:
        raise AssertionError(f"staged {codec} losses {losses} vs fused "
                             f"{fused.losses}")
    return {"losses": losses, "step_ms": step_ms, "peak_mib": peak / 2**20,
            "launches": counts, "max_loss_gap": gap}, params, state


def check_unrolled(steps=3):
    """The unrolled engine, ``gwt(bucketed=False)`` (every leaf through its
    rule's ``update``), a few full-width steps from the same parameters and
    batches as the bucketed staged path: parameters and state bitwise."""
    a = staged_loop(gwt_opt(steps, fused_write=False), steps)
    b = staged_loop(gwt_opt(steps, bucketed=False), steps)
    assert_bitwise(a[0], b[0], "unrolled vs bucketed staged params")
    assert_bitwise(a[1], b[1], "unrolled vs bucketed staged state")
    if a[2] != b[2]:
        raise AssertionError(f"unrolled losses {b[2]} vs staged {a[2]}")
    print(f"unrolled engine (bucketed=False): {steps} full-width steps "
          f"bitwise equal to the bucketed staged path (params, state, "
          f"losses {a[2]})")


def update_peak(opt, params, grads):
    """Bytes allocated at the peak of one ``opt.update`` (after a first
    update, so plans and salt tables exist), and that peak above what was
    allocated just before the call.  Garbage is collected first: device
    tensors in reference cycles that a collection frees during the update
    would otherwise lower its reading, down to 0 extra bytes."""
    state = opt.init(params)
    params, state = opt.update(grads, state, params)
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    opt.update(grads, state, params)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return peak, peak - before


def check_update_memory(dev):
    """Peak device memory of one ``optimizer.update``, fused write against
    the staged path: llama-60m at full width (bf16), and the JAX
    benchmark's bucket, 4 f32 leaves of 256 x 2048 at level 2 (its
    ``staged`` model charges the staged path with p and prev_norm held
    across the G̃ boundary; XLA's CPU buffer assignment gave 25,690,544 B
    against 35,651,636 B, 0.72x).  Returns a dict of the readings."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.optim.base import tree_map
    out = {}
    cfg = configs.get_config("llama-60m")
    gen = torch.Generator(device=dev).manual_seed(5)
    trees = {"llama-60m": lm.init(cfg, gen, dev).tree(),
             "bucket 4x256x2048 f32": {
                 f"w{i}": torch.randn(256, 2048, generator=gen, device=dev)
                 for i in range(4)}}
    for name, params in trees.items():
        row = {}
        for flow, kw in (("fused", {}), ("staged", {"fused_write": False})):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            copy = tree_map(torch.clone, params)
            ggen = torch.Generator(device=dev).manual_seed(7)
            grads = tree_map(lambda p: (torch.randn(
                p.shape, generator=ggen, device=dev) * 1e-2).to(p.dtype),
                params)
            peak, extra = update_peak(gwt_opt(100, **kw), copy, grads)
            row[flow] = {"peak_bytes": peak - base, "extra_bytes": extra}
            del copy, grads
        ratio = row["fused"]["peak_bytes"] / row["staged"]["peak_bytes"]
        ratio_extra = row["fused"]["extra_bytes"] / \
            row["staged"]["extra_bytes"]
        print(f"update peak memory {name}: fused {row['fused']} vs staged "
              f"{row['staged']} bytes (peak: parameters, gradients, state "
              f"and temporaries of the update; extra: above what was "
              f"allocated just before it); fused/staged {ratio:.3f} peak, "
              f"{ratio_extra:.3f} extra; the README's 0.72x is XLA's CPU "
              f"buffer assignment")
        row["ratio"], row["ratio_extra"] = ratio, ratio_extra
        out[name] = row
    return out


# the launcher's other choices: (label, arguments)
CHOICES = [("adam", ["--optimizer", "adam"]),
           ("adam_mini", ["--optimizer", "adam_mini"]),
           ("muon", ["--optimizer", "muon"]),
           ("sgd", ["--optimizer", "sgd"]),
           ("gwt --host adam_mini", ["--optimizer", "gwt", "--host",
                                     "adam_mini"]),
           ("gwt --host muon", ["--optimizer", "gwt", "--host", "muon"])]


def run_choices(train, kernel, hk):
    """Each of the launcher's other choices at full width for ``STEPS``
    steps, f32 matmuls (TF32 stays off): losses finite and falling, and no
    GWT kernel launched (none of these hosts runs the Adam kernels).  Peak
    memory is the run's own, above what earlier phases still hold.
    Returns ``{label: readings}``."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; Newton-Schulz must run "
                             "in f32")
    from repro_torch.optim.engine import state_bytes
    out = {}
    for label, args in CHOICES:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernel, hk)
        res = train.main(MAIN_ARGS + args)
        torch.cuda.synchronize()
        counts = all_counts(kernel, hk)
        peak = torch.cuda.max_memory_allocated() - base
        logged = [res.losses[i] for i in range(4, len(res.losses), 5)]
        row = {"state_bytes": state_bytes(res.opt_state),
               "step_ms": res.step_ms, "peak_mib": peak / 2**20,
               "losses": logged}
        print(f"launcher {label}: logged losses {logged}; state "
              f"{row['state_bytes']} B = {row['state_bytes'] / 2**20:.2f} "
              f"MiB; step {res.step_ms:.2f} ms; peak {row['peak_mib']:.1f} "
              f"MiB; launches {counts}")
        if any(counts.values()):
            raise AssertionError(f"{label} launched {counts}")
        if not np.all(np.isfinite(res.losses)) or not logged[-1] < logged[0]:
            raise AssertionError(f"{label} losses {res.losses}")
        out[label] = row
    return out


def bound_tile(shape, level=LEVEL, esize=2, q8=False):
    """Least time for one K4 (``q8``: K5) launch on ``shape``.  Bytes: read
    g, write G̃ (``esize`` each), read and write m and v (f32; K5: int8
    codes and one f32 scale per 64), the partials (and K5's salts).
    Operations: K1's per-coefficient f32 work without the write, the
    rounding and squaring of G̃, and K5's dequantization, requantization
    (f32) and rounding hash (int32), each type over its own rate."""
    L, m, n = shape
    N, NA, B = L * m * n, L * m * (n >> level), 1 << level
    parts = L * -(-(m * (n >> level)) // 2048)
    f32_ops = NA * (2 * (4 * B - 4) + 11 + (B - 1)) + N * 3
    int_ops = 0
    if q8:
        nb = L * -(-(m * (n >> level)) // QBLOCK)
        nbytes = 2 * N * esize + 2 * 2 * NA + 2 * 2 * nb * 4 + 2 * L * 4 \
            + parts * 4
        f32_ops += NA * (2 + 2 * 9)
        int_ops = NA * 2 * 10
    else:
        nbytes = 2 * N * esize + 4 * NA * 4 + parts * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = f32_ops / F32_OPS_PER_S + int_ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations", nbytes


# the parent revision's kernel sources, written by tools/parent_kernels.py
# before a chip call; phase 17 times its K4/K5 and phase 12 its K3/K6/K7
# beside the kernels as built.  A checkout without them (no git history to
# take them from) skips those comparisons.
PARENT_DIR = Path(REPO) / "build" / "parent_kernels"
PARENT_LIB = "gwt_adam_tile@parent"
PARENT_HAAR = "haar_dwt@parent"


def register_parent(build, lib="gwt_adam_tile") -> bool:
    """Adds the parent's library ``lib`` to ``build.SOURCES`` as
    ``lib@parent`` (phase 1 then builds it with the others); False where
    tools/parent_kernels.py has not written the sources."""
    src, headers = build.SOURCES[lib]
    if not (PARENT_DIR / src.name).exists():
        return False
    build.SOURCES[f"{lib}@parent"] = (PARENT_DIR / src.name, tuple(
        PARENT_DIR / h.name for h in headers))
    return True


@contextlib.contextmanager
def library(build, lib, name, declare):
    """Inside, the wrappers of library ``lib`` launch library ``name``'s
    kernels (the same C interface)."""
    saved = build.load(lib, declare)
    build._libs[lib] = build.load(name, declare)
    try:
        yield
    finally:
        build._libs[lib] = saved


def tile_library(kernel, build, name):
    """Inside, the K4/K5 wrappers launch library ``name``'s kernels."""
    return library(build, "gwt_adam_tile", name, kernel._declare_tile)


def copy_ms(nbytes: int, flush: torch.Tensor, dev) -> float:
    """Device time of one ``copy_`` that reads and writes ``nbytes`` in all,
    timed as ``device_ms`` times a kernel (L2 flushed before each of 20)."""
    a = torch.empty(nbytes // 8, device=dev)
    b = torch.empty_like(a)
    spans = []
    for _ in range(20):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        b.copy_(a)
        e1.record()
        spans.append((e0, e1))
    torch.cuda.synchronize()
    return sum(x.elapsed_time(y) for x, y in spans) / len(spans)


def time_tile(kernel, ref, build, dev, parent):
    """Phase 17: K4 and K5 per launch at the staged path's leaf shapes
    (level 2, bf16 gradients): device time (CUDA events around each launch,
    L2 flushed before it) of the kernels as built and, if ``parent``, of
    the parent revision's in the same call, in turns (built, parent,
    parent, built); one ``copy_`` of the bytes the bound counts; time per
    call back to back; the plain version's; the bound.  Returns ``{"K4":
    rows, "K5": rows}``."""
    rows = {"K4": [], "K5": []}
    flush = torch.empty(64 << 20, device=dev)   # 256 MB
    for label, shape, count in TILE_SHAPES:
        g, mm, vv = tile_inputs(shape, LEVEL, torch.bfloat16, 3, dev)
        args, salts = tile_q8_inputs(shape, LEVEL, torch.bfloat16, 3, dev)
        usalts = [s.to(torch.uint32) for s in salts]
        cases = {
            "K4": (lambda: kernel.gwt_adam_tile(g, mm, vv, level=LEVEL),
                   lambda: ref.gwt_adam_tile(g, mm, vv, level=LEVEL),
                   lambda: kernel.launches_tile, False),
            "K5": (lambda: kernel.gwt_adam_tile_q8(
                       *args, *usalts, level=LEVEL, block=QBLOCK),
                   lambda: ref.gwt_adam_tile_q8(*args, *salts, level=LEVEL,
                                                block=QBLOCK),
                   lambda: kernel.launches_tile_q8, True)}
        for name, (kern, plain, counter, q8) in cases.items():
            t_plain = [time_ms(plain, 5)]
            t_call = [time_ms(kern, 50), time_ms(kern, 50)]
            t_dev, t_parent = [], []
            for which in (("built", "parent", "parent", "built") if parent
                          else ("built", "built")):
                if which == "built":
                    t_dev.append(device_ms(kern, 20, counter, flush))
                else:
                    with tile_library(kernel, build, PARENT_LIB):
                        t_parent.append(device_ms(kern, 20, counter, flush))
            t_plain.append(time_ms(plain, 5))
            b_ms, b_by, nbytes = bound_tile(shape, q8=q8)
            t_copy = [copy_ms(nbytes, flush, dev) for _ in range(2)]
            row = {"leaf": label, "shape": list(shape), "per_step": count,
                   "ms": min(t_dev), "call_ms": min(t_call),
                   "parent_ms": min(t_parent) if parent else None,
                   "copy_ms": min(t_copy), "plain_ms": min(t_plain),
                   "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
            print(f"{name} time {label} {shape}: kernel {row['ms']:.4f} ms "
                  f"on the device (runs {t_dev}), {b_ms / row['ms']:.1%} of "
                  f"bound; parent's "
                  + (f"{row['parent_ms']:.4f} ms (runs {t_parent})" if parent
                     else "not built (tools/parent_kernels.py not run)")
                  + f"; copy_ of the same bytes {row['copy_ms']:.4f} ms; "
                  f"{row['call_ms']:.4f} ms per call (runs {t_call}), plain "
                  f"{row['plain_ms']:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
                  f"({nbytes / 1e6:.2f} MB)")
            rows[name].append(row)
    return rows


def tile_entry(name, launches, rows, **extra):
    """K4's or K5's line: one step's worth, with the parent's design and
    the same-byte copy timed in the same call."""
    parent = None if rows[0]["parent_ms"] is None else \
        sum(r["parent_ms"] * r["per_step"] for r in rows)
    return step_entry(name, "gwt_adam/csrc/gwt_adam_tile.cu",
                      "src/repro/kernels/gwt_adam/kernel.py:"
                      + ("214" if name.endswith("q8") else "261"),
                      launches, 0.0, rows, parent_ms=parent,
                      copy_ms=sum(r["copy_ms"] * r["per_step"] for r in rows),
                      **extra)


def haar_entry(name, replaces, launches, max_abs_err, rows, **extra):
    return step_entry(name, "haar_dwt/csrc/haar_dwt.cu", replaces, launches,
                      max_abs_err, rows, **extra)


def group_entry(name, replaces, launches, max_abs_err, rows, group,
                **extra):
    """K3's or K6's line: ``ms``, ``call_ms``, ``plain_ms`` and
    ``bound_ms`` of one grouped launch over the DP group (one step's
    split), beside the same step as ten single-leaf launches and the
    parent revision's ten, timed in the same call."""
    entry = haar_entry(name, replaces, launches, max_abs_err, rows,
                       **extra)
    entry.update(ms=group["ms"], call_ms=group["call_ms"],
                 plain_ms=group["plain_ms"], bound_ms=group["bound_ms"],
                 group=group)
    return entry


def step_entry(name, source, replaces, launches, max_abs_err, rows,
               **extra):
    """One step's worth of a kernel launched per leaf: each shape's time
    times its launches per step."""
    def step(key):
        return sum(r[key] * r["per_step"] for r in rows)
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/" + source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs_err,
            "ms": step("ms"), "call_ms": step("call_ms"),
            "plain_ms": step("plain_ms"), "bound_ms": step("bound_ms"),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in rows) else "operations",
            "library_ms": None, "per_launch": rows, **extra}


def fused_entry(name, source, replaces, launches, max_abs_err, rows,
                **extra):
    """K1's or K2's line: one step's worth of the one-pass design (``ms``,
    ``call_ms``) beside the two-pass design's, timed in the same call."""
    return step_entry(name, source, replaces, launches, max_abs_err, rows,
                      two_pass_ms=sum(r["two_pass_ms"] for r in rows),
                      two_pass_call_ms=sum(r["two_pass_call_ms"]
                                           for r in rows), **extra)


# Phase 18: the corpus path.  A byte corpus of the JAX package's sources
# (frozen, so its content hash is the same in every revision), built by the
# port's build_corpus, and a second build with another held-out tail (the
# same text and vocab, another hash) for the refused resume.
CORPUS_GLOB = os.path.join("src", "repro", "**", "*.py")
CORPUS_EVAL_FRACTIONS = (0.05, 0.1)
CORPUS_EVAL = ["--eval-every", "10", "--eval-batches", "4"]
EVAL_TIMING_RUNS = 5


def build_corpora(tmp):
    """The phase's corpus and the one with another eval tail; prints each
    one's hash and split sizes."""
    from repro_torch.data import build_corpus
    out = []
    for frac in CORPUS_EVAL_FRACTIONS:
        d = os.path.join(tmp, f"corpus_{frac}")
        t0 = time.perf_counter()
        index = build_corpus.build(os.path.join(REPO, CORPUS_GLOB), d,
                                   tokenizer_kind="byte",
                                   eval_fraction=frac)
        tr = index["splits"]["train"]["n_tokens"]
        ev = index["splits"]["eval"]["n_tokens"]
        print(f"corpus {CORPUS_GLOB} (byte, eval fraction {frac}): hash "
              f"{index['corpus_hash']}; train {tr} tokens "
              f"({(tr - 1) // 256} windows of 257), eval {ev} tokens "
              f"({(ev - 1) // 256} windows); built in "
              f"{time.perf_counter() - t0:.2f} s")
        out.append((d, index["corpus_hash"]))
    return out


def time_eval(res, corpus, dev):
    """Wall time of one eval as the launcher runs it (4 batches of 16 x
    256 of the eval split, a host fetch at the end), on the trained
    parameters: the first call and the best of the next ones."""
    from repro_torch import configs
    from repro_torch.data.eval import make_lm_evaluator
    from repro_torch.data.pipeline import make_source
    from repro_torch.data.store import TokenStore
    from repro_torch.models import lm
    cfg = configs.get_config("llama-60m")    # the launcher's vocab rule
    cfg = cfg.with_(vocab=max(cfg.vocab, TokenStore(corpus).vocab_size))
    batch, seq = (int(MAIN_ARGS[MAIN_ARGS.index(flag) + 1])
                  for flag in ("--batch", "--seq"))
    ev = make_lm_evaluator(cfg, lm, make_source(
        "corpus", cfg.vocab, seq, batch, corpus_dir=corpus, split="eval"),
        n_batches=4, device=dev)
    walls, losses = [], []
    for _ in range(1 + EVAL_TIMING_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(ev(res.params)["loss"])
        walls.append(time.perf_counter() - t0)
    if len(set(losses)) != 1 or losses[0] != res.evals[-1][1]:
        raise AssertionError(f"eval of the final parameters {losses} != "
                             f"the launcher's step-20 eval {res.evals[-1]}")
    return walls[0] * 1e3, min(walls[1:]) * 1e3


def run_corpus_path(train, kernel, hk, dev, synthetic, card):
    """Phase 18: full-width llama-60m GWT-2 on the byte corpus through K1,
    with 2 data workers and eval every 10 steps (launch counts set to 0
    just before and read just after); the same steps with the prefetch
    thread and no eval, bitwise; 10 steps + checkpoint + resume, bitwise;
    a resume against the other corpus refused.  Returns the K1 entry's
    ``corpus_path`` record."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_corpus_")
    try:
        (corpus, digest), (other, _) = build_corpora(tmp)
        args = MAIN_ARGS + ["--data", "corpus", "--corpus-dir", corpus]
        reset_counts(kernel, hk)
        t0 = time.perf_counter()
        res = train.main(args + ["--workers", "2"] + CORPUS_EVAL)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = all_counts(kernel, hk)
        want = {k: 0 for k in counts}
        want.update(fused_counts(k1=3 * STEPS))
        if counts != want:
            raise AssertionError(f"corpus path launched {counts} in {STEPS} "
                                 f"steps, want {want}")
        logged = [res.losses[i] for i in range(4, len(res.losses), 5)]
        if not np.all(np.isfinite(res.losses)) or not logged[-1] < logged[0]:
            raise AssertionError(f"corpus path losses {res.losses}")
        steps = [s for s, _ in res.evals]
        evals = [v for _, v in res.evals]
        if steps != [10, 20] or not np.all(np.isfinite(evals)):
            raise AssertionError(f"evals {res.evals}, want finite ones at "
                                 f"steps 10 and 20")
        if not evals[1] < evals[0]:
            raise AssertionError(f"eval loss did not fall: {res.evals}")
        plain = train.main(args + ["--workers", "0"])
        if plain.losses != res.losses:
            raise AssertionError(f"workers 0 without eval: {plain.losses} vs "
                                 f"{res.losses}")
        assert_bitwise(plain.params, res.params, "workers 0 without eval")
        assert_bitwise(plain.opt_state, res.opt_state,
                       "workers 0 without eval (state)")
        ckpt = ["--ckpt-dir", os.path.join(tmp, "ckpt"), "--ckpt-every",
                "10", "--workers", "2"] + CORPUS_EVAL
        first = train.main(args + ckpt)
        shutil.rmtree(os.path.join(tmp, "ckpt", f"step_{STEPS:09d}"))
        resumed = train.main(args + ckpt + ["--resume", "--workers", "0"])
        if resumed.start_step != 10 or first.losses[10:] != resumed.losses \
                or list(resumed.evals) != list(res.evals[1:]):
            raise AssertionError(f"resume from {resumed.start_step}: losses "
                                 f"{resumed.losses} vs {first.losses[10:]}, "
                                 f"evals {resumed.evals}")
        assert_bitwise(resumed.params, res.params, "resumed params")
        assert_bitwise(resumed.opt_state, res.opt_state, "resumed state")
        foreign = MAIN_ARGS + ["--data", "corpus", "--corpus-dir", other]
        try:
            train.main(foreign + ckpt + ["--resume"])
        except SystemExit as e:
            if "corpus_hash" not in str(e):
                raise
            refused = str(e)
        else:
            raise AssertionError("a resume on another corpus was not refused")
        eval_first_ms, eval_ms = time_eval(res, corpus, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wd, wd32 = res.watchdog, synthetic.watchdog
    record = {
        "corpus": CORPUS_GLOB, "corpus_hash": digest, "launches": counts,
        "losses": res.losses, "evals": [list(e) for e in res.evals],
        "step_ms": res.step_ms, "step_ms_workers_0_no_eval": plain.step_ms,
        "synthetic_step_ms": synthetic.step_ms,
        "dispatch_s_per_step": wd["dispatch_s_per_step"],
        "blocked_s_per_step": wd["blocked_s_per_step"],
        "synthetic_dispatch_s_per_step": wd32["dispatch_s_per_step"],
        "synthetic_blocked_s_per_step": wd32["blocked_s_per_step"],
        "watchdog_incidents": wd["incidents"],
        "eval_ms": eval_ms, "eval_first_ms": eval_first_ms,
        "wall_s": wall}
    print(f"corpus path: {STEPS} steps in {wall:.2f} s, workers 2, eval "
          f"every 10; logged losses {logged}; evals {res.evals}; launches "
          f"{counts}")
    print(f"corpus path: workers 0 without eval == workers 2 with eval, "
          f"bitwise (losses, params, state); 10 steps + checkpoint + resume "
          f"(workers 0) == {STEPS} straight, bitwise; other corpus refused "
          f"({refused.split(':')[0]})")
    print(f"corpus path numbers ({card}): step {res.step_ms:.2f} ms with "
          f"workers 2 and eval, {plain.step_ms:.2f} ms with workers 0 and no "
          f"eval, synthetic f32 step {synthetic.step_ms:.2f} ms (phase 5); "
          f"watchdog dispatch {wd['dispatch_s_per_step'] * 1e3:.2f} ms/step, "
          f"blocked {wd['blocked_s_per_step'] * 1e3:.2f} ms/step (synthetic "
          f"{wd32['dispatch_s_per_step'] * 1e3:.2f} / "
          f"{wd32['blocked_s_per_step'] * 1e3:.2f}), {wd['incidents']} "
          f"incidents; eval (4 x 16 x 256) {eval_ms:.2f} ms, first call "
          f"{eval_first_ms:.2f} ms")
    return record


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA "
              "card only", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.gwt_adam import kernel, ref
    from repro_torch.kernels.haar_dwt import kernel as hk
    from repro_torch.launch import train
    from repro_torch.optim.engine import state_bytes

    dev = torch.device("cuda")
    card = smi()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}; card: {card}")

    t0 = time.perf_counter()
    parent = register_parent(build)
    parent_haar = register_parent(build, "haar_dwt")
    if parent or parent_haar:
        print(f"parent kernels (K4/K5 for phase 17: {parent}, K3/K6/K7 for "
              f"phase 12: {parent_haar}): revision "
              f"{(PARENT_DIR / 'REVISION').read_text().strip()}")
    libs = build.build_all(tuple(build.SOURCES), verbose=True)
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{[os.path.relpath(p, REPO) for p in libs.values()]}")
    print_plans(kernel)

    err_k1, designs_k1 = check_fused(kernel, ref, dev, q8=False)
    err_k2, designs_k2 = check_fused(kernel, ref, dev, q8=True)
    err_haar = check_haar(hk, dev)
    tile_cases_run = check_tile(kernel, ref, dev)
    check_small_training(dev)

    res32, launches_k1, peak32 = run_main_path(train, kernel, hk, "f32")
    res8, launches_k2, peak8 = run_main_path(train, kernel, hk, "int8")
    mib8 = state_bytes(res8.opt_state)
    mib32 = state_bytes(res32.opt_state)
    print(f"optimizer state: f32 {mib32} B = {mib32 / 2**20:.2f} MiB, int8 "
          f"{mib8} B = {mib8 / 2**20:.2f} MiB")
    if mib8 != STATE_BYTES_INT8:
        raise AssertionError(f"int8 state is {mib8} bytes, the JAX package "
                             f"counts {STATE_BYTES_INT8}")
    check_resume(train, res8)
    res_dp, dp_counts, peak_dp = run_dp_path(train, kernel, hk, [], STEPS)
    res_ef, ef_counts, _ = run_dp_path(
        train, kernel, hk, ["--dp-detail-dtype", "float8_e4m3fn",
                            "--dp-error-feedback"], DP_EF_STEPS)
    reduction_peaks = check_grouped_reduction(hk, dev)

    staged32, _, _ = run_staged_path(kernel, hk, "f32", res32)
    staged8, _, _ = run_staged_path(kernel, hk, "int8", res8)
    check_unrolled()
    memory = check_update_memory(dev)
    choices = run_choices(train, kernel, hk)

    rows_k1 = time_fused(kernel, ref, dev, q8=False)
    rows_k2 = time_fused(kernel, ref, dev, q8=True)
    rows_haar, groups_haar = time_haar(hk, dev, parent_haar)
    wrap_dec, wrap_enc = time_generic_wrap(dev)
    prof32 = profile_step(dev, "f32")
    prof8 = profile_step(dev, "int8")
    prof_dp = profile_step(dev, "f32", dp_reduce="compressed")
    rows_tile = time_tile(kernel, ref, build, dev, parent)
    prof_staged = profile_step(dev, "f32", fused_write=False)
    corpus_path = run_corpus_path(train, kernel, hk, dev, res32, card)
    print(f"staged step vs fused step (same call): launcher-equivalent "
          f"loop {staged32['step_ms']:.2f} vs {res32.step_ms:.2f} ms; "
          f"profiled {prof_staged['step_ms']:.2f} vs "
          f"{prof32['step_ms']:.2f} ms, update {prof_staged['update_ms']:.2f} "
          f"vs {prof32['update_ms']:.2f} ms, device "
          f"{prof_staged['device_busy_ms']:.2f} vs "
          f"{prof32['device_busy_ms']:.2f} ms")
    print(f"dp step vs plain step (same call): launcher {res_dp.step_ms:.2f} "
          f"vs {res32.step_ms:.2f} ms; profiled {prof_dp['step_ms']:.2f} vs "
          f"{prof32['step_ms']:.2f} ms; device {prof_dp['device_busy_ms']:.2f}"
          f" vs {prof32['device_busy_ms']:.2f} ms; kernel launches per step "
          f"{prof_dp['launches_per_step']} vs {prof32['launches_per_step']}; "
          f"peak memory of the DP run {peak_dp / 2**20:.1f} MiB")
    entries = [
        fused_entry("gwt_adam_fused", "gwt_adam/csrc/gwt_adam_fused.cu",
                    "src/repro/kernels/gwt_adam/kernel.py:404",
                    launches_k1, err_k1, rows_k1, step_ms=res32.step_ms,
                    peak_mib=peak32 / 2**20, profile=prof32,
                    phase_2_buckets_by_design=designs_k1,
                    corpus_path=corpus_path),
        fused_entry("gwt_adam_fused_q8",
                    "gwt_adam/csrc/gwt_adam_fused_q8.cu",
                    "src/repro/kernels/gwt_adam/kernel.py:554",
                    launches_k2, err_k2, rows_k2, step_ms=res8.step_ms,
                    peak_mib=peak8 / 2**20, state_bytes=mib8,
                    profile=prof8, phase_3_buckets_by_design=designs_k2,
                    embedding_wrap_ms={
                        "decode": wrap_dec, "encode": wrap_enc}),
        group_entry("haar_dwt_fwd_q",
                    "src/repro/kernels/haar_dwt/kernel.py:124",
                    dp_counts["K3"], err_haar, rows_haar["K3 bf16"],
                    groups_haar["K3 bf16"],
                    fp8_per_launch=rows_haar["K3 fp8"],
                    fp8_group=groups_haar["K3 fp8"],
                    leaves=dp_counts["K3 leaves"], step_ms=res_dp.step_ms,
                    wire_bytes=res_dp.wire_bytes, profile=prof_dp,
                    peak_mib=peak_dp / 2**20,
                    reduction_peak_mib=reduction_peaks,
                    ef_fp8_launches=ef_counts),
        group_entry("haar_dwt_fwd", "src/repro/kernels/haar_dwt/kernel.py:93",
                    dp_counts["K6"], err_haar, rows_haar["K6 bf16"],
                    groups_haar["K6 bf16"]),
        haar_entry("haar_dwt_inv", "src/repro/kernels/haar_dwt/kernel.py:144",
                   dp_counts["K7"], err_haar, rows_haar["K7 f32"],
                   parent_ms=None if not parent_haar else sum(
                       r["parent_ms"] * r["per_step"]
                       for r in rows_haar["K7 f32"])),
        tile_entry("gwt_adam_tile", staged32["launches"]["K4"],
                   rows_tile["K4"], phase_13_cases=tile_cases_run,
                   staged_f32=staged32, staged_int8=staged8,
                   profile=prof_staged, update_memory=memory,
                   launcher_choices=choices),
        tile_entry("gwt_adam_tile_q8", staged32["launches"]["K5"],
                   rows_tile["K5"], phase_13_cases=tile_cases_run),
    ]
    print(json.dumps({"kernels": entries}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
