"""The traced sub-window's reading, on a hand-made list of events: busy
time and window from the second step on, and the host's dispatch a step
less its waits on the card inside CUDA runtime calls."""

import pytest

from gpubench.tests.helpers import ROOT  # noqa: F401  (the import path)
from gpubench import trace

MS = 1_000_000   # ns


def _events():
    ev = []
    # three steps of 10 ms on the host; the sub-window starts at the second
    for i, t in enumerate((0, 10, 20)):
        ev.append((trace.STEP, "mark", t * MS, (t + 10) * MS))
        # 5 launches of 0.1 ms, the last of step 2 blocked 3 ms on a full
        # queue; one synchronise of 2 ms in step 3
        for j in range(5):
            a = (t + 1 + j) * MS
            extra = 3 * MS if (i == 1 and j == 4) else 0
            ev.append(("cudaLaunchKernel", "host", a, a + MS // 10 + extra))
        ev.append(("aten::mm", "host", t * MS, (t + 6) * MS))
        ev.append(("gemm", "kernel", (t + 2) * MS, (t + 9) * MS))
    ev.append(("cudaStreamSynchronize", "host", 25 * MS, 27 * MS))
    return ev


def test_busy_window_and_gaps_from_the_second_step():
    got = trace.read(_events())
    assert got["window_s"] == pytest.approx(19e-3)     # 10 ms .. 29 ms
    assert got["busy_s"] == pytest.approx(14e-3)       # two 7 ms kernels
    assert got["idle_gaps"][0][1] == pytest.approx(3e-3)
    assert got["device_ops"] == [["gemm", pytest.approx(14e-3)]]


def test_dispatch_leaves_out_the_waits_on_the_card():
    got = trace.read(_events())
    # step 2: 10 ms less the 3 ms the blocked launch took beyond the
    # launches' median; step 3: 10 ms less the 2 ms synchronise
    assert got["dispatch_s"] == pytest.approx((7e-3 + 8e-3) / 2)


def test_driver_and_runtime_calls_are_told_from_host_ops():
    assert trace.RUNTIME.match("cudaLaunchKernel")
    assert trace.RUNTIME.match("cuLaunchKernel")
    assert not trace.RUNTIME.match("cutlass_gemm")
    assert not trace.RUNTIME.match("aten::cumsum")
