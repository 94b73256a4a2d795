#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. build the hand-written CUDA kernel from ``src/repro_torch/.../csrc``;
2. hold the kernel against its plain PyTorch version on the card at the
   three LLaMA-60M bucket shapes (and one FIRST-mode-sized leaf): limiter
   with a zero and a non-zero history, a clipping case, weight decay; and
   require two runs from equal inputs to be bitwise equal;
3. small-input check: a few steps of llama-60m-smoke (f32) from the same
   parameters and batches on the card and on the CPU give the same losses;
4. the main path: ``repro_torch.launch.train.main`` trains full-width
   llama-60m with GWT-2 for 20 steps; the kernel's launch count must be
   exactly 3 per step, the losses finite and the last logged one below the
   first;
5. time the kernel per launch (CUDA events) beside its bound and the plain
   version's time;
6. profile a few full-width steps: optimizer update vs the rest, device
   busy share, top kernels.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``.  Without a CUDA device it
exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM (NVIDIA data sheet): HBM3 bandwidth and f32 rate outside the
# tensor cores, the peaks a bound is taken against
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# the three GWT buckets of llama-60m after row merging, and the leaves each
# stands for; plus a FIRST-mode-sized leaf (a (8, 1376, 514) weight, whose
# last axis is not divisible by 4, arrives transposed as (8, 514, 1376))
MAIN_SHAPES = [("mixer wq/wk/wv/wo", (4, 4096, 512)),
               ("ffn w_gate/w_up", (2, 4096, 1376)),
               ("ffn w_down", (1, 11008, 512))]
FIRST_SHAPE = ("FIRST-mode (8,1376,514) leaf", (1, 4112, 1376))
LEVEL = 2

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


def check_small_training(dev):
    """Phase 3: llama-60m-smoke (f32), same parameters and batches on the
    card and on the CPU; per-step losses within 1e-4 relative."""
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
    losses = {}
    for device in ("cpu", "cuda"):
        tree = lm.LM(cfg, unflatten(paths, [l.detach().to(device).clone()
                                            for l in leaves])).tree()
        opt = gwt(warmup_cosine(0.01, 4))
        state = opt.init(tree)
        step = lm.make_train_step(cfg, opt)
        out = []
        for i in range(4):
            b = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch(i).items()}
            tree, state, met = step(tree, state, b)
            out.append(met["loss"])
        losses[device] = torch.stack(out).cpu().numpy()
    print(f"smoke f32 losses cpu={losses['cpu'].tolist()} "
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


def profile_step(dev, steps=4):
    """Phase 6: where a full-width step's time goes.  First without the
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
    opt = gwt(warmup_cosine(0.01, 100))
    state = opt.init(tree)
    marks = []

    def timed_update(grads, st, params):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = opt.update(grads, st, params)
        b.record()
        marks.append((a, b))
        return out

    step = lm.make_train_step(cfg, opt._replace(update=timed_update))
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
    print(f"profile: step {step_ms:.2f} ms, optimizer.update "
          f"{opt_ms:.2f} ms, rest of the step (data to model grads) "
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA "
              "card only", file=sys.stderr)
        return 2
    from repro_torch.kernels.gwt_adam import kernel, ops, ref
    from repro_torch.launch import train
    from repro_torch.optim.base import flatten_with_paths

    dev = torch.device("cuda")
    card = smi()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}; card: {card}")

    t0 = time.perf_counter()
    lib = kernel.build(verbose=True)
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{os.path.relpath(lib, REPO)}")

    worst_abs = check_kernel(kernel, ops, ref, dev)
    check_small_training(dev)

    steps = 20
    torch.cuda.reset_peak_memory_stats()
    kernel.launches = 0
    t0 = time.perf_counter()
    res = train.main(["--arch", "llama-60m", "--steps", str(steps),
                      "--batch", "16", "--seq", "256", "--log-every", "5",
                      "--seed", "0"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.launches
    peak = torch.cuda.max_memory_allocated()
    logged = [res.losses[i] for i in range(4, steps, 5)]
    print(f"main path: {steps} steps in {wall:.2f} s; logged losses "
          f"{logged}; K1 launches {launches}; step {res.step_ms:.2f} ms; "
          f"{16 * 256 / (res.step_ms / 1e3):.0f} tokens/s; peak memory "
          f"{peak / 2**20:.1f} MiB")
    if launches != 3 * steps:
        raise AssertionError(f"K1 launched {launches} times in {steps} "
                             f"steps, want {3 * steps}")
    if not np.all(np.isfinite(res.losses)):
        raise AssertionError(f"non-finite losses {res.losses}")
    if not logged[-1] < logged[0]:
        raise AssertionError(f"loss did not fall: {logged}")
    for name, t in zip(*flatten_with_paths(res.params)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"non-finite parameter {name}")

    rows = time_kernel(kernel, ops, ref, dev)
    profile_step(dev)
    entry = {"name": "gwt_adam_fused", "route": "cuda",
             "source": "src/repro_torch/kernels/gwt_adam/csrc/"
                       "gwt_adam_fused.cu",
             "replaces": "src/repro/kernels/gwt_adam/kernel.py:404",
             "launches": launches, "max_abs_err": worst_abs,
             # one step's worth: the three bucket launches summed
             "ms": sum(r["ms"] for r in rows),
             "plain_ms": sum(r["plain_ms"] for r in rows),
             "bound_ms": sum(r["bound_ms"] for r in rows),
             "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                        for r in rows) else "operations",
             "library_ms": None, "per_launch": rows,
             "step_ms": res.step_ms, "peak_mib": peak / 2**20}
    print(json.dumps({"kernels": [entry]}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
