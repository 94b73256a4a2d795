"""Time edited copies of the staged kernels' source (K4/K5,
``gwt_adam_tile.cu``) on the card, beside the source as it is and, where
``tools/parent_kernels.py`` wrote them, the parent revision's K4/K5.

    python tools/tile_variants.py [--variants base,lookahead_1_round,...]

Each variant is a set of text edits to ``kernels/gwt_adam/csrc``, copied
to ``build/fused_variants/tile_<name>/`` by ``tools/fused_variants.make``
and built under the library name ``gwt_adam_tile@<name>``.  Every library
is first held bitwise against the plain versions (G̃, moments or codes
and scales, and the ‖G̃‖² partials) on an L = 3 stack with an odd
coefficient count per leaf, levels 1-3, bf16 and f32; then, at the staged
path's leaves (bf16, level 2), each one's K4 and K5 device time per launch
(``chip_smoke.device_ms``: CUDA events around each launch, L2 flushed
before it), best of two runs of 20 taken in turns (all libraries, then in
reverse order), and one step's worth.
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
from repro_torch.kernels.gwt_adam import kernel, ref  # noqa: E402

_TILE = "gwt_adam_tile.cu"
_LOAD_ORDER = """#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int cl = 2 * (t + r * kThreads);
    if (cl < n) copy_pair_async<T, B>(slot + cl * B, gc + cl * B, cl + 1 < n);
    cp_async_commit();
  }
  const typename Mo::Chunk ck = mo.chunk(entry, leaf, na, j0);
  typename Mo::Regs regs[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int cl = 2 * (t + r * kThreads);
    mo.load(ck, cl, cl < n, cl + 1 < n, regs[r]);
  }
  if constexpr (Mo::kRingBytes > 0) {
    // the staging was copied by other threads: wait for it, then one
    // barrier before the rounds (none inside them)
    cp_async_wait_n(kRounds - 1);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int cl = 2 * (t + r * kThreads);
    const bool v0 = cl < n, v1 = cl + 1 < n;
    cp_async_wait_n(kRounds - 1 - r);  // this round's pairs have landed
"""


def _lookahead(rounds: int):
    """The chunk's loads issued ``rounds`` rounds ahead of the compute,
    instead of all before it."""
    return _LOAD_ORDER, f"""  constexpr int kAhead = {rounds};
#pragma unroll
  for (int r = 0; r < kAhead; ++r) {{
    const int cl = 2 * (t + r * kThreads);
    if (cl < n) copy_pair_async<T, B>(slot + cl * B, gc + cl * B, cl + 1 < n);
    cp_async_commit();
  }}
  const typename Mo::Chunk ck = mo.chunk(entry, leaf, na, j0);
  typename Mo::Regs regs[kRounds];
#pragma unroll
  for (int r = 0; r < kAhead; ++r) {{
    const int cl = 2 * (t + r * kThreads);
    mo.load(ck, cl, cl < n, cl + 1 < n, regs[r]);
  }}
  if constexpr (Mo::kRingBytes > 0) {{
    cp_async_wait_n(kAhead - 1);
    __syncthreads();
  }}
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {{
    const int cl = 2 * (t + r * kThreads);
    const bool v0 = cl < n, v1 = cl + 1 < n;
    if (r + kAhead < kRounds) {{
      const int cn = 2 * (t + (r + kAhead) * kThreads);
      if (cn < n)
        copy_pair_async<T, B>(slot + cn * B, gc + cn * B, cn + 1 < n);
      mo.load(ck, cn, cn < n, cn + 1 < n, regs[r + kAhead]);
    }}
    cp_async_commit();
    cp_async_wait_n(kAhead);
"""


def _min_blocks(blocks: int):
    return ("__global__ void __launch_bounds__(kThreads)\ntile(",
            f"__global__ void __launch_bounds__(kThreads, {blocks})\ntile(")


# name -> {file: [(old, new), ...]}
VARIANTS = {
    "base": {},
    "lookahead_1_round": {_TILE: [_lookahead(1)]},
    "lookahead_2_rounds": {_TILE: [_lookahead(2)]},
    "min_blocks_6": {_TILE: [_min_blocks(6)]},
}


def check(dev) -> None:
    """The current K4/K5 library bitwise against the plain versions."""
    for level in (1, 2, 3):
        for dtype in (torch.bfloat16, torch.float32):
            shape = (3, 101, 43 << level)
            g, mm, vv = cs.tile_inputs(shape, level, dtype, 5, dev)
            want = ref.gwt_adam_tile(g, mm, vv, level=level)
            got = kernel.gwt_adam_tile(g, mm, vv, level=level)
            cs.check_bands(f"K4 {shape} l={level} {dtype}", [got, got],
                           want[:3] + (ref.chunk_ssq(want[0], level),))
            args, salts = cs.tile_q8_inputs(shape, level, dtype, 5, dev)
            want = ref.gwt_adam_tile_q8(*args, *salts, level=level,
                                        block=cs.QBLOCK)
            got = kernel.gwt_adam_tile_q8(
                *args, *(s.to(torch.uint32) for s in salts), level=level,
                block=cs.QBLOCK)
            cs.check_bands(f"K5 {shape} l={level} {dtype}", [got, got],
                           want[:5] + (ref.chunk_ssq(want[0], level),))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tile_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(cs.smi())
    src, headers = build.SOURCES["gwt_adam_tile"]
    libs = []
    for name in args.variants.split(","):
        out = make(f"tile_{name}", VARIANTS[name])
        lib = f"gwt_adam_tile@{name}"
        build.SOURCES[lib] = (out / src.name,
                              tuple(out / h.name for h in headers))
        libs.append(lib)
    if cs.register_parent(build):
        libs.append(cs.PARENT_LIB)
    build.build_all(tuple(libs))
    for lib in libs:
        with cs.tile_library(kernel, build, lib):
            check(dev)
    print(f"{', '.join(libs)}: bitwise equal to the plain versions")
    flush = torch.empty(64 << 20, device=dev)   # 256 MB, past the L2
    step = {lib: [0.0, 0.0] for lib in libs}
    for label, shape, count in cs.TILE_SHAPES:
        g, mm, vv = cs.tile_inputs(shape, cs.LEVEL, torch.bfloat16, 3, dev)
        q8, salts = cs.tile_q8_inputs(shape, cs.LEVEL, torch.bfloat16, 3,
                                      dev)
        usalts = [s.to(torch.uint32) for s in salts]
        k4 = lambda: kernel.gwt_adam_tile(g, mm, vv, level=cs.LEVEL)
        k5 = lambda: kernel.gwt_adam_tile_q8(*q8, *usalts, level=cs.LEVEL,
                                             block=cs.QBLOCK)
        runs = {lib: ([], []) for lib in libs}
        for lib in libs + libs[::-1]:
            with cs.tile_library(kernel, build, lib):
                runs[lib][0].append(cs.device_ms(
                    k4, 20, lambda: kernel.launches_tile, flush))
                runs[lib][1].append(cs.device_ms(
                    k5, 20, lambda: kernel.launches_tile_q8, flush))
        print(f"{label} {shape}: bound K4 "
              f"{cs.bound_tile(shape)[0]:.4f} ms, K5 "
              f"{cs.bound_tile(shape, q8=True)[0]:.4f} ms")
        for lib in libs:
            t4, t5 = min(runs[lib][0]), min(runs[lib][1])
            step[lib][0] += t4 * count
            step[lib][1] += t5 * count
            print(f"  {lib:32s} K4 {t4:.4f} ms  K5 {t5:.4f} ms")
    for lib, (t4, t5) in step.items():
        print(f"per staged step {lib:32s} K4 {t4:.4f} ms  K5 {t5:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
