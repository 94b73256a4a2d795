#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. build every hand-written CUDA kernel from ``src/repro_torch/.../csrc``
   (K1, K2, and K3/K6/K7 in one source), one ``nvcc`` per source, started
   together;
2. K1 (f32 moments) against its plain PyTorch version on the card at the
   three LLaMA-60M bucket shapes (and one FIRST-mode-sized leaf): limiter
   with a zero and a non-zero history, a clipping case, weight decay; two
   runs from equal inputs must be bitwise equal;
3. K2 (blocked-int8 moments) the same way, plus a shape whose leaves end in
   a partial quantization block: parameters, codes and scales bitwise
   equal to the plain version, the norm within 2 f32 spacings;
4. small-input check: a few steps of llama-60m-smoke, f32 and int8 state,
   from the same parameters and batches on the card and on the CPU give
   the same losses;
5. the f32 main path: ``repro_torch.launch.train.main`` trains full-width
   llama-60m with GWT-2 for 20 steps; K1 must launch exactly 3 times per
   step (K2 never), the losses be finite and the last logged one below the
   first;
6. the int8 main path: the same with ``--state-codec int8``; K2 must
   launch 3 times per step (K1 never); the state must be the JAX
   package's 48,273,508 bytes;
7. resume on the card: full width, int8, train 20 steps checkpointing at
   10, resume a fresh run from step 10; the result must be bitwise equal
   to the 20 straight steps of phase 6 (parameters, codes, scales, norms);
8. time each kernel per launch (CUDA events) beside its bound and its
   plain version's time, and the int8 path's generic decode/encode of the
   embedding's moments;
9. profile a few full-width steps of each path: ``optimizer.update`` vs the
   rest, device busy share, top kernels;
10. K3 (``haar_dwt_fwd_q``), K6 (``haar_dwt_fwd``) and K7 (``haar_dwt_inv``)
    against their plain versions on the card, bitwise, at the flattened
    LLaMA-60M leaf shapes and an odd-row shape, levels 1-3, every wire dtype;
    the fp8 inputs reach past 464 and +-inf, so the NaN-on-overflow rule is
    exercised; two runs must be bitwise equal;
11. the compressed data-parallel path: the launcher with ``--dp-reduce
    compressed`` (bf16 details, 20 steps) under a one-rank NCCL process
    group, so the gradient gather runs on the card; K3 and K7 must launch
    10 times per step and K1 3 times, the wire bytes be the JAX package's
    208,449,536 against 333,516,800, the losses finite and falling; then a
    shorter run with fp8 details and error feedback (K7 20 times per step:
    the residue's reconstruction too);
12. time K3, K6 and K7 per launch beside their bounds and plain versions,
    and profile the data-parallel step beside the plain f32 step.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``.  Without a CUDA device it
exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

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

# Tolerances of the kernel against the plain version on the card.  Both
# round at the same points and neither contracts FMAs, so m and v agree
# bitwise and G̃ agrees bitwise before the limiter; the per-leaf norm is
# summed in another order (kernel: per-block tree; plain: per-stripe
# torch.sum), so the norm may differ by a few f32 spacings, and through
# bf16(scale) a written p element by one bf16 spacing of |p|.
TOL_MV_F32_SPACINGS = 2
TOL_NORM_F32_SPACINGS = 64
TOL_P_BF16_SPACINGS = 1
# K2 rounds like its plain version at every step, and codes and scales are
# exact functions of bitwise-equal f32 moments: p, codes and scales must be
# bitwise equal; only the norm's summation order differs
TOL_NORM_Q8_F32_SPACINGS = 2


def spacings(got: torch.Tensor, want: torch.Tensor, mant_bits: int) -> float:
    """max |got - want| in units of the last place of max |want|."""
    diff = (got.double() - want.double()).abs().max().item()
    top = want.double().abs().max().item()
    if top == 0:
        return 0.0 if diff == 0 else math.inf
    return diff / 2.0 ** (math.floor(math.log2(top)) - mant_bits)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def make_inputs(shape, seed, dev):
    L, m, n = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    g = (r(L, m, n) * 0.01).to(torch.bfloat16)
    p = (r(L, m, n) * 0.02).to(torch.bfloat16)
    mm = r(L, m, n >> LEVEL) * 1e-3
    vv = torch.rand(L, m, n >> LEVEL, generator=gen, device=dev) * 1e-6
    return g, p, mm, vv


def check_kernel(kernel, ops, ref, dev):
    """Phase 2.  Returns the worst absolute error over p, m and v."""
    worst_abs = 0.0
    step_size = torch.tensor(1e-3, device=dev)
    for label, shape in MAIN_SHAPES + [FIRST_SHAPE]:
        L, m, n = shape
        bm = ops.fused_row_block(m, n, LEVEL)
        for ci, (case, use_lim, prev, wd) in enumerate(CASES):
            g, p, mm, vv = make_inputs(shape, 1000 * ci + n, dev)
            pn = torch.full((L,), prev, device=dev)
            wd_coef = torch.tensor(wd, device=dev)
            kw = dict(level=LEVEL, gamma=1.01, use_limiter=use_lim,
                      weight_decay=wd != 0)
            want = ref.gwt_adam_fused(g, p, mm, vv, pn, step_size, wd_coef,
                                      bm=bm, **kw)
            runs = []
            for _ in range(2):
                args = (g.clone(), p.clone(), mm.clone(), vv.clone())
                runs.append(kernel.gwt_adam_fused(*args, pn, step_size,
                                                  wd_coef, **kw))
            torch.cuda.synchronize()
            for a, b in zip(*runs):
                if not torch.equal(a, b):
                    raise AssertionError(f"{label} / {case}: two kernel "
                                         "runs differ")
            got = runs[0]
            err = {"p": spacings(got[0], want[0], 7),
                   "m": spacings(got[1], want[1], 23),
                   "v": spacings(got[2], want[2], 23),
                   "norm": spacings(got[3], want[3], 23)}
            n_p = int((got[0] != want[0]).sum())
            print(f"K1 {label} {shape} {case}: spacings p={err['p']:.3g} "
                  f"(bf16; {n_p} of {got[0].numel()} elements differ) "
                  f"m={err['m']:.3g} v={err['v']:.3g} norm={err['norm']:.3g} "
                  f"(f32); bitwise repeat ok")
            if err["m"] > TOL_MV_F32_SPACINGS or \
                    err["v"] > TOL_MV_F32_SPACINGS or \
                    err["norm"] > TOL_NORM_F32_SPACINGS or \
                    err["p"] > TOL_P_BF16_SPACINGS:
                raise AssertionError(f"{label} / {case}: kernel disagrees "
                                     f"with the plain version: {err}")
            if use_lim and prev == 1.0 and not torch.allclose(
                    got[3], torch.full_like(got[3], 1.01)):
                raise AssertionError(f"{label}: clipping case did not clip "
                                     f"({got[3].tolist()})")
            for a, b in zip(got[:3], want[:3]):
                worst_abs = max(worst_abs, (a.double() - b.double()).abs()
                                .max().item())
    print(f"K1 vs plain: tolerances m,v <= {TOL_MV_F32_SPACINGS} f32, "
          f"norm <= {TOL_NORM_F32_SPACINGS} f32, p <= "
          f"{TOL_P_BF16_SPACINGS} bf16 spacings at the largest magnitude; "
          f"worst |err| over p,m,v = {worst_abs:.3g}")
    return worst_abs


def make_q8_inputs(shape, seed, dev):
    """K1's inputs with the moments encoded by the port's codec."""
    from repro_torch.optim import codec
    g, p, mm, vv = make_inputs(shape, seed, dev)
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


def check_kernel_q8(kernel, ops, ref, dev):
    """Phase 3.  Returns the worst absolute error over p, codes, scales."""
    worst_abs = 0.0
    step_size = torch.tensor(1e-3, device=dev)
    for label, shape in MAIN_SHAPES + [FIRST_SHAPE, PARTIAL_SHAPE]:
        L, m, n = shape
        bm = ops.q8_row_block(m, n, LEVEL, QBLOCK) or m
        salts = q8_salts(L, dev)
        for ci, (case, use_lim, prev, wd) in enumerate(CASES):
            inputs = make_q8_inputs(shape, 1000 * ci + n, dev)
            pn = torch.full((L,), prev, device=dev)
            wd_coef = torch.tensor(wd, device=dev)
            kw = dict(level=LEVEL, block=QBLOCK, gamma=1.01,
                      use_limiter=use_lim, weight_decay=wd != 0)
            want = ref.gwt_adam_fused_q8(*inputs, *salts, pn, step_size,
                                         wd_coef, bm=bm, **kw)
            runs = [kernel.gwt_adam_fused_q8(
                *(t.clone() for t in inputs),
                *(s.to(torch.uint32) for s in salts), pn, step_size,
                wd_coef, **kw) for _ in range(2)]
            torch.cuda.synchronize()
            for a, b in zip(*runs):
                if not torch.equal(a, b):
                    raise AssertionError(f"K2 {label} / {case}: two kernel "
                                         "runs differ")
            got = runs[0]
            names = ("p", "qm", "sm", "qv", "sv")
            differ = {k: int((a != b).sum())
                      for k, a, b in zip(names, got[:5], want[:5])}
            norm_err = spacings(got[5], want[5], 23)
            print(f"K2 {label} {shape} {case}: elements differing from the "
                  f"plain version {differ}; norm {norm_err:.3g} f32 "
                  f"spacings; bitwise repeat ok")
            if any(differ.values()) or norm_err > TOL_NORM_Q8_F32_SPACINGS:
                raise AssertionError(f"K2 {label} / {case}: kernel disagrees "
                                     f"with the plain version: {differ}, "
                                     f"norm {norm_err}")
            if use_lim and prev == 1.0 and not torch.allclose(
                    got[5], torch.full_like(got[5], 1.01)):
                raise AssertionError(f"K2 {label}: clipping case did not "
                                     f"clip ({got[5].tolist()})")
            for a, b in zip(got[:5], want[:5]):
                worst_abs = max(worst_abs, (a.double() - b.double()).abs()
                                .max().item())
    print(f"K2 vs plain: p, codes and scales bitwise, norm <= "
          f"{TOL_NORM_Q8_F32_SPACINGS} f32 spacings; worst |err| over p, "
          f"codes, scales = {worst_abs:.3g}")
    return worst_abs


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


def time_kernel(kernel, ops, ref, dev):
    rows = []
    for label, shape in MAIN_SHAPES:
        L, m, n = shape
        g, p, mm, vv = make_inputs(shape, 7, dev)
        pn = torch.full((L,), 1e9, device=dev)
        ss, wd = torch.tensor(1e-3, device=dev), torch.tensor(0.0,
                                                              device=dev)
        kw = dict(level=LEVEL, gamma=1.01, use_limiter=True,
                  weight_decay=False)
        bm = ops.fused_row_block(m, n, LEVEL)
        plain = lambda: ref.gwt_adam_fused(g, p, mm, vv, pn, ss, wd, bm=bm,
                                           **kw)
        kern = lambda: kernel.gwt_adam_fused(g, p, mm, vv, pn, ss, wd, **kw)
        # plain, kernel, kernel, plain: compare only inside one call
        t_plain = [time_ms(plain, 5)]
        t_kern = [time_ms(kern, 50), time_ms(kern, 50)]
        t_plain.append(time_ms(plain, 5))
        b_ms, b_by, nbytes = bound(shape)
        row = {"bucket": label, "shape": list(shape),
               "ms": min(t_kern), "plain_ms": min(t_plain),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
        print(f"K1 time {label} {shape}: kernel {row['ms']:.4f} ms "
              f"(runs {t_kern}), plain {row['plain_ms']:.4f} ms "
              f"(runs {t_plain}), bound {b_ms:.4f} ms by {b_by} "
              f"({nbytes / 1e6:.1f} MB), {b_ms / row['ms']:.1%} of bound")
        rows.append(row)
    return rows


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


def time_kernel_q8(kernel, ops, ref, dev):
    rows = []
    for label, shape in MAIN_SHAPES:
        L, m, n = shape
        inputs = make_q8_inputs(shape, 7, dev)
        salts = q8_salts(L, dev)
        usalts = [s.to(torch.uint32) for s in salts]
        pn = torch.full((L,), 1e9, device=dev)
        ss, wd = torch.tensor(1e-3, device=dev), torch.tensor(0.0,
                                                              device=dev)
        kw = dict(level=LEVEL, block=QBLOCK, gamma=1.01, use_limiter=True,
                  weight_decay=False)
        bm = ops.q8_row_block(m, n, LEVEL, QBLOCK) or m
        plain = lambda: ref.gwt_adam_fused_q8(*inputs, *salts, pn, ss, wd,
                                              bm=bm, **kw)
        kern = lambda: kernel.gwt_adam_fused_q8(*inputs, *usalts, pn, ss,
                                                wd, **kw)
        # plain, kernel, kernel, plain: compare only inside one call
        t_plain = [time_ms(plain, 5)]
        t_kern = [time_ms(kern, 50), time_ms(kern, 50)]
        t_plain.append(time_ms(plain, 5))
        b_ms, b_by, nbytes = bound_q8(shape)
        row = {"bucket": label, "shape": list(shape),
               "ms": min(t_kern), "plain_ms": min(t_plain),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
        print(f"K2 time {label} {shape}: kernel {row['ms']:.4f} ms "
              f"(runs {t_kern}), plain {row['plain_ms']:.4f} ms "
              f"(runs {t_plain}), bound {b_ms:.4f} ms by {b_by} "
              f"({nbytes / 1e6:.2f} MB), {b_ms / row['ms']:.1%} of bound")
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


def profile_step(dev, codec, steps=4, dp_reduce=None):
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
    opt = gwt(warmup_cosine(0.01, 100), state_codec=codec)
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
    print(f"profile {codec} dp_reduce={dp_reduce}: step {step_ms:.2f} ms, "
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
            "device_busy_ms": busy_ms}


def run_main_path(train, kernel, hk, codec, extra=()):
    """Phases 5 and 6: the launcher at full width, launch counts set to 0
    just before and read just after."""
    torch.cuda.reset_peak_memory_stats()
    kernel.launches = kernel.launches_q8 = 0
    hk.launches_fwd = hk.launches_fwd_q = hk.launches_inv = 0
    t0 = time.perf_counter()
    res = train.main(MAIN_ARGS + ["--state-codec", codec, *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"K1": kernel.launches, "K2": kernel.launches_q8}
    haar = hk.launches_fwd + hk.launches_fwd_q + hk.launches_inv
    peak = torch.cuda.max_memory_allocated()
    logged = [res.losses[i] for i in range(4, len(res.losses), 5)]
    print(f"main path {codec}: {STEPS} steps in {wall:.2f} s; logged losses "
          f"{logged}; launches {counts}; step {res.step_ms:.2f} ms; "
          f"{16 * 256 / (res.step_ms / 1e3):.0f} tokens/s; peak memory "
          f"{peak / 2**20:.1f} MiB")
    mine, other = ("K1", "K2") if codec == "f32" else ("K2", "K1")
    if counts[mine] != 3 * STEPS or counts[other] != 0 or haar:
        raise AssertionError(f"{codec} path launched {counts} and {haar} "
                             f"DWT kernels in {STEPS} steps, want "
                             f"{mine}={3 * STEPS}, {other}=0, no DWT")
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


def check_bands(what, got_runs, want):
    """Kernel bands against the plain version's: bitwise (NaN codes
    included), and the two kernel runs bitwise."""
    for a, b in zip(*got_runs):
        if not torch.equal(raw_bits(a), raw_bits(b)):
            raise AssertionError(f"{what}: two kernel runs differ")
    for i, (a, b) in enumerate(zip(got_runs[0], want)):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{what} band {i}: {a.dtype} {a.shape} vs "
                                 f"plain {b.dtype} {b.shape}")
        differ = int((raw_bits(a) != raw_bits(b)).sum())
        if differ:
            raise AssertionError(f"{what} band {i}: {differ} of {a.numel()} "
                                 f"elements differ from the plain version")


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
    return 0.0


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_dp_path(train, kernel, hk, extra, steps):
    """Phase 11: the launcher with --dp-reduce under a one-rank NCCL
    process group; launch counts set to 0 just before and read just
    after."""
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    args = [a if a != str(STEPS) else str(steps) for a in MAIN_ARGS]
    try:
        kernel.launches = kernel.launches_q8 = 0
        hk.launches_fwd = hk.launches_fwd_q = hk.launches_inv = 0
        t0 = time.perf_counter()
        res = train.main(args + ["--dp-reduce", "compressed", *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"K1": kernel.launches, "K2": kernel.launches_q8,
                  "K3": hk.launches_fwd_q, "K6": hk.launches_fwd,
                  "K7": hk.launches_inv}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    ef = "--dp-error-feedback" in extra
    want = {"K1": 3 * steps, "K2": 0, "K3": 10 * steps, "K6": 0,
            "K7": (20 if ef else 10) * steps}
    logged = [res.losses[i] for i in range(4, len(res.losses), 5)]
    print(f"dp path {extra}: {steps} steps in {wall:.2f} s; logged losses "
          f"{logged}; launches {counts}; step {res.step_ms:.2f} ms; wire "
          f"bytes {res.wire_bytes}")
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
    return res, counts


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


def time_haar(hk, dev):
    """Phase 12: per launch at each leaf shape (level 2): the kernel's
    device time (CUDA events around each launch, L2 flushed before it) and its time per
    call back to back (CUDA events: the host's wrapper time when the host
    is slower than the card, and inputs warm in L2 when they fit) vs the
    plain version vs the bound; one step's worth is the count-weighted
    sum."""
    from repro_torch.kernels.haar_dwt import ref as href
    cases = {
        "K3 bf16": (lambda g: hk.haar_dwt_fwd_q(g, LEVEL, torch.bfloat16),
                    lambda g: href.haar_dwt_fwd_q(g, LEVEL, torch.bfloat16),
                    torch.float32, "K3", 2),
        "K3 fp8": (lambda g: hk.haar_dwt_fwd_q(g, LEVEL,
                                               torch.float8_e4m3fn),
                   lambda g: href.haar_dwt_fwd_q(g, LEVEL,
                                                 torch.float8_e4m3fn),
                   torch.float32, "K3", 1),
        "K6 bf16": (lambda g: hk.haar_dwt_fwd(g, LEVEL),
                    lambda g: href.haar_dwt_fwd(g, LEVEL),
                    torch.bfloat16, "K6", 2),
        "K7 f32": (lambda b: hk.haar_dwt_inv(b[0], b[1:]),
                   lambda b: href.haar_dwt_inv(b[0], b[1:]),
                   torch.float32, "K7", 4),
    }
    rows = {name: [] for name in cases}
    flush = torch.empty(64 << 20, device=dev)   # 256 MB
    for shape, count in DP_SHAPES:
        g32 = torch.randn(*shape, device=dev)
        for name, (kern, plain, dtype, kind, wb) in cases.items():
            x = g32.to(dtype)
            if kind == "K7":
                x = list(href.haar_dwt_fwd(g32, LEVEL))
            counter = {"K3": lambda: hk.launches_fwd_q,
                       "K6": lambda: hk.launches_fwd,
                       "K7": lambda: hk.launches_inv}[kind]
            t_plain = [time_ms(lambda: plain(x), 5)]
            t_call = [time_ms(lambda: kern(x), 50), time_ms(lambda: kern(x),
                                                             50)]
            t_dev = [device_ms(lambda: kern(x), 20, counter, flush)
                     for _ in range(2)]
            t_plain.append(time_ms(lambda: plain(x), 5))
            b_ms, b_by, nbytes = bound_haar(kind, shape, wire_bytes=wb)
            row = {"shape": list(shape), "per_step": count,
                   "ms": min(t_dev), "call_ms": min(t_call),
                   "plain_ms": min(t_plain), "bound_ms": b_ms,
                   "bound_by": b_by, "bytes": nbytes}
            print(f"{name} time {shape}: kernel {row['ms']:.4f} ms on the "
                  f"device (runs {t_dev}), {row['call_ms']:.4f} ms per call "
                  f"(runs {t_call}), plain {row['plain_ms']:.4f} ms, bound "
                  f"{b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.2f} MB), "
                  f"{b_ms / row['ms']:.1%} of bound")
            rows[name].append(row)
    return rows


def haar_entry(name, replaces, launches, max_abs_err, rows, **extra):
    """One step's worth of a DWT kernel: each shape's time times its launches
    per step."""
    def step(key):
        return sum(r[key] * r["per_step"] for r in rows)
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/haar_dwt/csrc/haar_dwt.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs_err,
            "ms": step("ms"), "call_ms": step("call_ms"),
            "plain_ms": step("plain_ms"), "bound_ms": step("bound_ms"),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in rows) else "operations",
            "library_ms": None, "per_launch": rows, **extra}


def kernel_entry(name, source, replaces, launches, max_abs_err, rows,
                 **extra):
    """One kernel's line: one step's worth, the launches of one step
    summed."""
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/" + source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs_err,
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in rows) else "operations",
            "library_ms": None, "per_launch": rows, **extra}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA "
              "card only", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.gwt_adam import kernel, ops, ref
    from repro_torch.kernels.haar_dwt import kernel as hk
    from repro_torch.launch import train
    from repro_torch.optim.engine import state_bytes

    dev = torch.device("cuda")
    card = smi()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}; card: {card}")

    t0 = time.perf_counter()
    libs = build.build_all(verbose=True)
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{[os.path.relpath(p, REPO) for p in libs.values()]}")

    err_k1 = check_kernel(kernel, ops, ref, dev)
    err_k2 = check_kernel_q8(kernel, ops, ref, dev)
    err_haar = check_haar(hk, dev)
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
    res_dp, dp_counts = run_dp_path(train, kernel, hk, [], STEPS)
    res_ef, ef_counts = run_dp_path(
        train, kernel, hk, ["--dp-detail-dtype", "float8_e4m3fn",
                            "--dp-error-feedback"], DP_EF_STEPS)

    rows_k1 = time_kernel(kernel, ops, ref, dev)
    rows_k2 = time_kernel_q8(kernel, ops, ref, dev)
    rows_haar = time_haar(hk, dev)
    wrap_dec, wrap_enc = time_generic_wrap(dev)
    prof32 = profile_step(dev, "f32")
    prof8 = profile_step(dev, "int8")
    prof_dp = profile_step(dev, "f32", dp_reduce="compressed")
    print(f"dp step vs plain step (same call): launcher {res_dp.step_ms:.2f} "
          f"vs {res32.step_ms:.2f} ms; profiled {prof_dp['step_ms']:.2f} vs "
          f"{prof32['step_ms']:.2f} ms")
    entries = [
        kernel_entry("gwt_adam_fused", "gwt_adam/csrc/gwt_adam_fused.cu",
                     "src/repro/kernels/gwt_adam/kernel.py:404",
                     launches_k1, err_k1, rows_k1, step_ms=res32.step_ms,
                     peak_mib=peak32 / 2**20, profile=prof32),
        kernel_entry("gwt_adam_fused_q8",
                     "gwt_adam/csrc/gwt_adam_fused_q8.cu",
                     "src/repro/kernels/gwt_adam/kernel.py:554",
                     launches_k2, err_k2, rows_k2, step_ms=res8.step_ms,
                     peak_mib=peak8 / 2**20, state_bytes=mib8,
                     profile=prof8, embedding_wrap_ms={
                         "decode": wrap_dec, "encode": wrap_enc}),
        haar_entry("haar_dwt_fwd_q",
                   "src/repro/kernels/haar_dwt/kernel.py:124",
                   dp_counts["K3"], err_haar, rows_haar["K3 bf16"],
                   fp8_per_launch=rows_haar["K3 fp8"], step_ms=res_dp.step_ms,
                   wire_bytes=res_dp.wire_bytes, profile=prof_dp,
                   ef_fp8_launches=ef_counts),
        haar_entry("haar_dwt_fwd", "src/repro/kernels/haar_dwt/kernel.py:93",
                   dp_counts["K6"], err_haar, rows_haar["K6 bf16"]),
        haar_entry("haar_dwt_inv", "src/repro/kernels/haar_dwt/kernel.py:144",
                   dp_counts["K7"], err_haar, rows_haar["K7 f32"]),
    ]
    print(json.dumps({"kernels": entries}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
