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
as the variant ``parent``.
"""

from __future__ import annotations

import argparse
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


def one_pass_ms(lib: str, shape, flush, dev) -> float:
    L = shape[0]
    pn = torch.full((L,), 1e9, device=dev)
    ss, wd = torch.tensor(1e-3, device=dev), torch.tensor(0.0, device=dev)
    kw = dict(level=cs.LEVEL, gamma=1.01, use_limiter=True,
              weight_decay=False)
    if lib == "gwt_adam_fused_q8":
        inputs = cs.make_q8_inputs(shape, 7, dev)
        salts = [s.to(torch.uint32) for s in cs.q8_salts(L, dev)]
        fn = lambda: kernel.gwt_adam_fused_q8_one_pass(
            *inputs, *salts, pn, ss, wd, block=cs.QBLOCK, **kw)
        count = lambda: kernel.launches_q8_one_pass
    else:
        args = cs.make_inputs(shape, 7, dev)
        fn = lambda: kernel.gwt_adam_fused_one_pass(*args, pn, ss, wd, **kw)
        count = lambda: kernel.launches_one_pass
    return min(cs.device_ms(fn, 20, count, flush) for _ in range(2))


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
    flush = torch.empty(64 << 20, device=dev)   # 256 MB, past the L2
    for label, shape in cs.MAIN_SHAPES:
        nbytes = cs.bound(shape)[2]
        print(f"{label} {shape}: bound K1 {cs.bound(shape)[0]:.4f} ms, K2 "
              f"{cs.bound_q8(shape)[0]:.4f} ms; copy of {nbytes / 1e6:.1f} "
              f"MB (read + write) {cs.copy_ms(nbytes, flush, dev):.4f} ms")
        for name in names:
            row = []
            for lib in LIBS:
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
