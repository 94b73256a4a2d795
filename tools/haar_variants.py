"""Time edited copies of the forward DWT source (K3/K6, ``haar_dwt.cu``) on
the card, beside the source as it is and, where ``tools/parent_kernels.py``
wrote it, the parent revision's one-leaf-a-launch K3/K6.

    python tools/haar_variants.py [--variants base,register,...]

Each variant is a set of text edits to ``kernels/haar_dwt/csrc``, copied to
``build/fused_variants/haar_<name>/`` by ``tools/fused_variants.make`` and
built under the library name ``haar_dwt@<name>``.  ``register`` sends
every tile straight from and to device memory (several coefficients a
thread, all of a thread's loads before its arithmetic) instead of through
the bulk copies and the shared-memory ring; ``fp8_nosat`` takes the
software non-saturating fp8 conversion instead of the hardware's and the
NaN rule; the others change the ring's stages or the tile's bytes, and
``empty`` returns at once (its launch alone, timed and not checked).  Every library is first held bitwise against
the plain versions on ``chip_smoke.check_haar_groups``'s cases (the DP
group, odd rows, an odd coefficient count, an unaligned leaf, 40 leaves;
levels 1-3; K3 bf16/f16/fp8, K6 bf16/f32); then, at level 2, each one's
device time (``chip_smoke.device_ms``: CUDA events around each launch, L2
flushed before it), best of two runs of 20 taken in turns (all libraries,
then in reverse order): K3 (bf16 and fp8 details) and K6 (bf16) over the
DP group as one grouped launch, and K3 (bf16) and K6 at each DP leaf as a
single launch (and K3 with fp8 details), with one step's worth of those.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO / "tools"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from fused_variants import make  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.haar_dwt import kernel as hk  # noqa: E402

CSRC = REPO / "src/repro_torch/kernels/haar_dwt/csrc"
_SRC = "haar_dwt.cu"


def _set(name: str, old: str, new: str):
    return (f"constexpr {name} = {old};", f"constexpr {name} = {new};")


_FP8_NOSAT = (
    "  const __nv_fp8_storage_t b =\n"
    "      __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);\n"
    "  return Fp8{fabsf(x) <= 464.0f\n"
    "                 ? b\n"
    "                 : (__nv_fp8_storage_t)(__float_as_uint(x) >> 31 ? 0xff\n"
    "                                                                  : 0x7f)};",
    "  return Fp8{__nv_cvt_float_to_fp8(x, __NV_NOSAT, __NV_E4M3)};")
_EMPTY = [("  using P = Fwd<TIn, TA, TD, LEVEL>;\n  extern __shared__",
           "  using P = Fwd<TIn, TA, TD, LEVEL>;\n"
           "  if (grp.n_tiles >= 0) return;\n  extern __shared__")]

# name -> {file: [(old, new), ...]}
VARIANTS = {
    "base": {},
    "register": {_SRC: [_set("bool kBulkCopies", "true", "false")]},
    "stages_3": {_SRC: [_set("int kStages", "2", "3")]},
    "stages_4": {_SRC: [_set("int kStages", "2", "4")]},
    "tile_8k": {_SRC: [_set("int kTileBytes", "16384", "8192")]},
    "tile_4k": {_SRC: [_set("int kTileBytes", "16384", "4096")]},
    # the software non-saturating fp8 conversion: the same codes
    "fp8_nosat": {_SRC: [_FP8_NOSAT]},
    # returns at once: the launch alone (timed, not checked)
    "empty": {_SRC: _EMPTY},
}
TIMING_ONLY = {"empty"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("haar_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(cs.smi())
    libs = []
    for name in args.variants.split(","):
        out = make(f"haar_{name}", VARIANTS[name], CSRC)
        lib = f"haar_dwt@{name}"
        build.SOURCES[lib] = (out / _SRC, ())
        libs.append(lib)
    parent = cs.register_parent(build, "haar_dwt")
    build.build_all(tuple(libs) + ((cs.PARENT_HAAR,) if parent else ()))
    for lib in libs:
        with cs.library(build, "haar_dwt", lib, hk._declare):
            print(f"{lib}: plan K3 bf16 l=2 "
                  f"{hk.fwd_plan((0, 0, 1), cs.LEVEL, dev)}, K6 bf16 "
                  f"{hk.fwd_plan((1, 1, 1), cs.LEVEL, dev)}")
            if lib.split("@")[1] not in TIMING_ONLY:
                cs.check_haar_groups(hk, dev)
    old = cs.ParentHaar(build, hk) if parent else None
    flush = torch.empty(64 << 20, device=dev)   # 256 MB, past the L2
    g32 = cs.dp_leaves(dev)
    g16 = [g.bfloat16() for g in g32]
    groups = {
        "K3 bf16 group": (lambda: hk.haar_dwt_fwd_q_group(
            g32, cs.LEVEL, torch.bfloat16), lambda: hk.launches_fwd_q),
        "K3 fp8 group": (lambda: hk.haar_dwt_fwd_q_group(
            g32, cs.LEVEL, torch.float8_e4m3fn), lambda: hk.launches_fwd_q),
        "K6 bf16 group": (lambda: hk.haar_dwt_fwd_group(g16, cs.LEVEL),
                          lambda: hk.launches_fwd),
    }
    runs = {lib: {k: [] for k in groups} for lib in libs}
    for lib in libs + libs[::-1]:
        with cs.library(build, "haar_dwt", lib, hk._declare):
            if hk.fwd_plan((0, 0, 1), cs.LEVEL, dev)["group_leaves"] \
                    < len(g32):
                continue   # the group takes more than one launch
            for key, (fn, counter) in groups.items():
                runs[lib][key].append(cs.device_ms(fn, 20, counter, flush))
    for key in groups:
        print(f"{key} (10 DP leaves, one launch):")
        for lib in libs:
            if runs[lib][key]:
                print(f"  {lib:24s} {min(runs[lib][key]):.4f} ms "
                      f"(runs {runs[lib][key]})")
    fp8 = torch.float8_e4m3fn
    step = {lib: [0.0, 0.0, 0.0]
            for lib in libs + (["parent"] if old else [])}
    for shape, count in cs.DP_SHAPES:
        g = torch.randn(*shape, device=dev)
        gb = g.bfloat16()
        single = {lib: ([], [], []) for lib in step}
        for lib in list(step) + list(step)[::-1]:
            if lib == "parent":
                for j, fn in enumerate((
                        lambda: old.fwd_q(g, cs.LEVEL, torch.bfloat16),
                        lambda: old.fwd(gb, cs.LEVEL),
                        lambda: old.fwd_q(g, cs.LEVEL, fp8))):
                    single[lib][j].append(cs.device_ms(
                        fn, 20, lambda: old.launches, flush))
                continue
            with cs.library(build, "haar_dwt", lib, hk._declare):
                single[lib][0].append(cs.device_ms(
                    lambda: hk.haar_dwt_fwd_q(g, cs.LEVEL, torch.bfloat16),
                    20, lambda: hk.launches_fwd_q, flush))
                single[lib][1].append(cs.device_ms(
                    lambda: hk.haar_dwt_fwd(gb, cs.LEVEL), 20,
                    lambda: hk.launches_fwd, flush))
                single[lib][2].append(cs.device_ms(
                    lambda: hk.haar_dwt_fwd_q(g, cs.LEVEL, fp8), 20,
                    lambda: hk.launches_fwd_q, flush))
        print(f"{shape} x{count}: bound K3 "
              f"{cs.bound_haar('K3', shape)[0]:.4f} ms, K6 "
              f"{cs.bound_haar('K6', shape)[0]:.4f} ms")
        for lib, runs_ in single.items():
            best = [min(r) for r in runs_]
            for j in range(3):
                step[lib][j] += best[j] * count
            print(f"  {lib:24s} K3 bf16 {best[0]:.4f} ms  K6 {best[1]:.4f} "
                  f"ms  K3 fp8 {best[2]:.4f} ms")
    for lib, (t3, t6, t8) in step.items():
        print(f"10 single launches {lib:24s} K3 bf16 {t3:.4f} ms  K6 "
              f"{t6:.4f} ms  K3 fp8 {t8:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
