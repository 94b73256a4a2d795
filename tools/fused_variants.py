"""Time edited copies of the one-pass K1/K2 sources on the card, beside the
sources as they are and a copy moving the same bytes.

    python tools/fused_variants.py [--variants base,phase_a_only,...]
                                   [--parent]

Each variant is a set of text edits to ``kernels/gwt_adam/csrc``; its copy
goes to ``build/fused_variants/<name>/`` and is compiled by
``repro_torch.kernels.build`` under another library name.  For each of the main path's buckets
(bf16, level 2, limiter on) it prints the one-pass device time per launch
of K1 and K2 (``chip_smoke.device_ms``: CUDA events around each launch, L2
flushed before it, best of two runs of 20), their registers and
co-resident blocks per SM, and the device time of one ``copy_`` that reads
and writes as many bytes as K1's bound counts.  A variant that stops
before the grid barrier (``phase_a_only``) times phase A alone; its
parameters are not written, so only its time means anything.  With
``--parent`` the sources ``tools/parent_kernels.py`` wrote are timed too,
as the variant ``parent`` (its one-pass entries called through that
revision's C interface, which has no grouped entries), and K1's and K2's two-pass designs, as built
and the parent's (through the parent's C interface), at qwen2.5-3b's four
two-pass buckets, in the order parent, new, new, parent (best of each;
CUDA events as above, 5 launches a run), beside the bounds.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.gwt_adam import kernel  # noqa: E402

CSRC = REPO / "src/repro_torch/kernels/gwt_adam/csrc"
LIBS = ("gwt_adam_fused", "gwt_adam_fused_q8")
_COMMON = "gwt_adam_common.cuh"
# name -> {file: [(old, new), ...]}
VARIANTS = {
    "base": {},
    "phase_a_only": {_COMMON: [(
        "  cooperative_groups::this_grid().sync();\n", "  return;\n")]},
    "lookahead_2": {_COMMON: [(
        "constexpr int kLookahead = 1;", "constexpr int kLookahead = 2;")]},
    # phase A's rounds rolled (K1's moments then go through local memory)
    "rounds_rolled": {_COMMON: [(
        "#pragma unroll\n    for (int r = 0; r < kRounds; ++r) {\n"
        "      const int cl = 2 * (t + r * kThreads);\n      const bool v0",
        "#pragma unroll 1\n    for (int r = 0; r < kRounds; ++r) {\n"
        "      const int cl = 2 * (t + r * kThreads);\n      const bool v0")]},
    "phase_b_32_bytes": {_COMMON: [("64 / kPairBytes", "32 / kPairBytes")]},
}


def make(name: str, edits, csrc: Path = CSRC) -> Path:
    """A copy of ``csrc`` with ``edits`` in ``build/fused_variants/name``."""
    out = REPO / "build/fused_variants" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    for fname, reps in edits.items():
        path = out / fname
        text = path.read_text()
        for old, new in reps:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in {fname}")
            text = text.replace(old, new)
        path.write_text(text)
    return out


def one_pass_ms(lib: str, shape, flush, dev, parent=None) -> float:
    """K1's or K2's one-pass device time per launch at ``shape`` (bf16,
    level 2, limiter on), through the wrappers, or with ``parent``
    (a :class:`ParentTwoPass`) through the parent's C entry."""
    L, rows, n = shape
    na = rows * (n >> cs.LEVEL)
    pn = torch.full((L,), 1e9, device=dev)
    ss, wd = torch.tensor(1e-3, device=dev), torch.tensor(0.0, device=dev)
    kw = dict(level=cs.LEVEL, gamma=1.01, use_limiter=True,
              weight_decay=False)
    if lib == "gwt_adam_fused_q8":
        inputs = cs.make_q8_inputs(shape, 7, dev)
        salts = [s.to(torch.uint32) for s in cs.q8_salts(L, dev)]
        tensors, codes = (*inputs, *salts), (1, cs.LEVEL)
        fn = lambda: kernel.gwt_adam_fused_q8_one_pass(
            *inputs, *salts, pn, ss, wd, block=cs.QBLOCK, **kw)
        count = lambda: kernel.launches_q8_one_pass
    else:
        tensors, codes = cs.make_inputs(shape, 7, dev), (1, 0, cs.LEVEL)
        fn = lambda: kernel.gwt_adam_fused_one_pass(*tensors, pn, ss, wd,
                                                    **kw)
        count = lambda: kernel.launches_one_pass
    if parent is not None:
        new_norm = torch.empty(L, device=dev)
        partials = torch.empty((L, -(-na // kernel.CHUNK)), device=dev)
        ptrs = tuple(t.data_ptr() for t in (*tensors, pn, new_norm, ss, wd))
        fn = lambda: parent.one_pass(lib, codes, ptrs, partials, L, na)
        count = lambda: parent.launches
    return min(cs.device_ms(fn, 20, count, flush) for _ in range(2))


class ParentTwoPass:
    """The parent revision's K1/K2 two-pass and one-pass entries
    (``gwt_adam_fused@parent``, ``gwt_adam_fused_q8@parent``), called
    through that revision's C interface: the partials buffer and no scale
    buffer, unless the parent already takes one (the one-pass entry takes
    the partials alone).  The wrappers of ``kernel.py`` need entries a
    parent may lack (the grouped ones), so the parent is timed here."""

    def __init__(self):
        vp, ll, f, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, \
            ctypes.c_int
        self.launches = 0
        self.libs = {}
        for lib, n_ptrs, codes in (("gwt_adam_fused", 9, (i, i, i)),
                                   ("gwt_adam_fused_q8", 13, (i, i))):
            src = build.SOURCES[f"{lib}@parent"][0].read_text()
            scale = "float* partials, float* scale" in src
            n = n_ptrs + scale

            def declare(l, lib=lib, n=n, codes=codes, n_ptrs=n_ptrs):
                tail = [ll, ll] + [f] * 6 + [i, i, vp]
                for name, k in ((lib, n), (lib + "_one_pass", n_ptrs)):
                    fn = getattr(l, name)
                    fn.argtypes = list(codes) + [vp] * k + tail
                    fn.restype = i
                fn = getattr(l, lib + "_one_pass_plan")
                fn.argtypes = list(codes) + [ll, ll, vp]
                fn.restype = i
            self.libs[lib] = (build.load(f"{lib}@parent", declare), scale)

    def plan(self, lib, codes, L, na):
        """The parent's one-pass plan (``kernel.PLAN_FIELDS``)."""
        out = (ctypes.c_int * len(kernel.PLAN_FIELDS))()
        err = getattr(self.libs[lib][0], lib + "_one_pass_plan")(
            *codes, L, na, ctypes.cast(out, ctypes.c_void_p))
        if err:
            raise RuntimeError(f"parent {lib} plan: CUDA error {err}")
        return dict(zip(kernel.PLAN_FIELDS, out))

    def one_pass(self, lib, codes, ptrs, partials, L, na):
        handle, _ = self.libs[lib]
        head, tail = ptrs[:-2], ptrs[-2:]   # ..., new_norm | step, wd
        err = getattr(handle, lib + "_one_pass")(
            *codes, *head, partials.data_ptr(), *tail, L, na, 1.01, 0.9,
            1 - 0.9, 0.999, 1 - 0.999, 1e-6, 1, 0,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent {lib} one pass: CUDA error {err}")
        self.launches += 1

    def __call__(self, lib, codes, ptrs, partials, scale, L, na):
        handle, takes_scale = self.libs[lib]
        extra = (scale.data_ptr(),) if takes_scale else ()
        head, tail = ptrs[:-2], ptrs[-2:]   # ..., new_norm | step, wd
        err = getattr(handle, lib)(
            *codes, *head, partials.data_ptr(), *extra, *tail, L, na, 1.01,
            0.9, 1 - 0.9, 0.999, 1 - 0.999, 1e-6, 1, 0,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent {lib}: CUDA error {err}")
        self.launches += 1


def dense_two_pass(flush, dev, parent) -> None:
    """K1's and K2's two-pass designs, as built and the parent's, at
    qwen2.5-3b's two-pass buckets (bf16, level 2, limiter on)."""
    ss, wd = torch.tensor(1e-3, device=dev), torch.tensor(0.0, device=dev)
    kw = dict(level=cs.LEVEL, gamma=1.01, use_limiter=True,
              weight_decay=False)
    total = {}
    for label, shape in cs.QWEN_BUCKETS:
        if cs.one_pass(kernel, shape, torch.bfloat16):
            continue
        L, rows, n = shape
        na = rows * (n >> cs.LEVEL)
        pn = torch.full((L,), 1e9, device=dev)
        new_norm = torch.empty(L, device=dev)
        partials = torch.empty((L, -(-na // kernel.CHUNK)), device=dev)
        scale = torch.empty(L, device=dev)
        for q8 in (False, True):
            if q8:
                inputs = cs.make_q8_inputs(shape, 7, dev)
                salts = [t.to(torch.uint32) for t in cs.q8_salts(L, dev)]
                lib, codes = "gwt_adam_fused_q8", (1, cs.LEVEL)
                new = lambda: kernel.gwt_adam_fused_q8_two_pass(
                    *inputs, *salts, pn, ss, wd, block=cs.QBLOCK, **kw)
                count = lambda: kernel.launches_q8_two_pass
                b_ms = cs.bound_q8(shape)[0]
                tensors = (*inputs, *salts)
            else:
                inputs = cs.make_inputs(shape, 7, dev)
                lib, codes = "gwt_adam_fused", (1, 0, cs.LEVEL)
                new = lambda: kernel.gwt_adam_fused_two_pass(
                    *inputs, pn, ss, wd, **kw)
                count = lambda: kernel.launches_two_pass
                b_ms = cs.bound(shape)[0]
                tensors = inputs
            ptrs = tuple(t.data_ptr() for t in (*tensors, pn, new_norm, ss,
                                                 wd))
            old = lambda: parent(lib, codes, ptrs, partials, scale, L, na)
            runs = {"parent": [], "new": []}
            for name in ("parent", "new", "new", "parent"):
                fn, cnt = (old, lambda: parent.launches) if name == \
                    "parent" else (new, count)
                runs[name].append(cs.device_ms(fn, 5, cnt, flush))
            k = "K2" if q8 else "K1"
            best = {name: min(r) for name, r in runs.items()}
            for name, ms in best.items():
                total[(k, name)] = total.get((k, name), 0.0) + ms
            total[(k, "bound")] = total.get((k, "bound"), 0.0) + b_ms
            print(f"two passes {k} {label} {shape}: new {best['new']:.4f} "
                  f"ms, parent {best['parent']:.4f} ms, bound {b_ms:.4f} ms "
                  f"(runs {runs})", flush=True)
            del inputs, tensors, new, old
            torch.cuda.empty_cache()
    for k in ("K1", "K2"):
        print(f"two passes {k}, the four buckets (one step): new "
              f"{total[(k, 'new')]:.4f} ms, parent "
              f"{total[(k, 'parent')]:.4f} ms, bound "
              f"{total[(k, 'bound')]:.4f} ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--parent", action="store_true",
                    help="also time the sources tools/parent_kernels.py "
                    "wrote (as the variant 'parent')")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fused_variants: no CUDA device", file=sys.stderr)
        return 2
    names = args.variants.split(",")
    dev = torch.device("cuda")
    print(cs.smi())
    sources = dict(build.SOURCES)
    for name in names:
        out = make(name, VARIANTS[name])
        for lib in LIBS:
            src, headers = sources[lib]
            build.SOURCES[f"{lib}@{name}"] = (
                out / src.name, tuple(out / h.name for h in headers))
    if args.parent:
        if not all(cs.register_parent(build, lib) for lib in LIBS):
            raise SystemExit("no parent sources: run tools/parent_kernels.py")
        names.append("parent")
    build.build_all(tuple(f"{lib}@{n}" for n in names for lib in LIBS))
    parent = ParentTwoPass() if args.parent else None
    flush = torch.empty(64 << 20, device=dev)   # 256 MB, past the L2
    for label, shape in cs.MAIN_SHAPES:
        nbytes = cs.bound(shape)[2]
        print(f"{label} {shape}: bound K1 {cs.bound(shape)[0]:.4f} ms, K2 "
              f"{cs.bound_q8(shape)[0]:.4f} ms; copy of {nbytes / 1e6:.1f} "
              f"MB (read + write) {cs.copy_ms(nbytes, flush, dev):.4f} ms")
        for name in names:
            row = []
            for lib in LIBS:
                if name == "parent":
                    ms = one_pass_ms(lib, shape, flush, dev, parent)
                    L, rows, n = shape
                    plan = parent.plan(lib, (1, cs.LEVEL) if lib.endswith(
                        "q8") else (1, 0, cs.LEVEL), L, rows * (n >> cs.LEVEL))
                    row.append(f"{'K2' if lib.endswith('q8') else 'K1'} "
                               f"{ms:.4f} ms ({plan['regs']} registers, "
                               f"{plan['blocks_per_sm']} blocks/SM)")
                    continue
                build.SOURCES[lib] = build.SOURCES[f"{lib}@{name}"]
                build._libs.pop(lib, None)
                kernel._plans.clear()
                ms = one_pass_ms(lib, shape, flush, dev)
                plan = kernel.one_pass_plan(lib, shape, torch.bfloat16,
                                            cs.LEVEL)
                row.append(f"{'K2' if lib.endswith('q8') else 'K1'} "
                           f"{ms:.4f} ms ({plan['regs']} registers, "
                           f"{plan['blocks_per_sm']} blocks/SM)")
            print(f"  {name:20s} " + "  ".join(row))
    for lib in LIBS:
        build.SOURCES[lib] = sources[lib]
        build._libs.pop(lib, None)
    kernel._plans.clear()
    if args.parent:
        dense_two_pass(flush, dev, parent)
    return 0


if __name__ == "__main__":
    sys.exit(main())
