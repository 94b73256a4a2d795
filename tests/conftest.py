"""Test fixtures + shared multi-device / property-test machinery.

NOTE: no XLA_FLAGS here — unit tests must see the real single CPU device;
multi-device tests run their code in subprocesses via
:func:`run_in_devices`, which owns the ``XLA_FLAGS`` fake-device request
(previously copy-pasted per test file).

Backend-sweep tier (ROADMAP multi-backend item): the ``kernel_impl``
fixture parametrizes kernel/engine equivalence tests over
``impl ∈ {jnp, interpret}``.  The ``interpret`` leg (Pallas interpreter —
slow on CPU) carries the ``slow`` marker and is skipped by default so
tier-1 stays fast; run it with ``pytest --runslow`` (``pallas`` itself
needs TPU hardware and is covered by the same entry points via
``REPRO_KERNEL_IMPL`` once available).
"""

import itertools
import os
import subprocess
import sys
import textwrap

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_env(n: int, **extra) -> dict:
    """Subprocess environment seeing ``n`` simulated host-platform CPU
    devices: ``PYTHONPATH=src``, CPU platform pinned, inherited
    ``XLA_FLAGS`` dropped (the fake-device request must be THIS process's
    choice, not leakage).  The single shared recipe behind
    :func:`run_in_devices` and the launcher-driving tests."""
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    if n > 1:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
    env.update(extra)
    return env


def run_in_devices(n: int, code: str, timeout: int = 560, env=None):
    """Run ``code`` in a subprocess that sees ``n`` simulated host-platform
    CPU devices (its own ``XLA_FLAGS``; the calling test process keeps its
    single real device).  ``code`` is dedented; cwd is the repo root with
    ``PYTHONPATH=src``.  Returns the ``CompletedProcess`` — asserting on
    a sentinel in ``r.stdout`` is the caller's job (include
    ``r.stdout + r.stderr`` in the assert message for debuggability)."""
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, cwd=REPO,
                          env=device_env(n, **(env or {})), timeout=timeout)


# ---------------------------------------------------------------------------
# hypothesis with a deterministic fallback: property tests run everywhere,
# with full random draws where hypothesis is installed (requirements-dev)
# and a fixed sample grid (endpoints + midpoint per strategy) without it.
# Import as ``from conftest import given, settings, st``.
# ---------------------------------------------------------------------------

try:
    from hypothesis import given, settings, strategies as st  # noqa: F401
except ImportError:
    class _IntRange:
        def __init__(self, lo, hi):
            self.lo, self.hi = lo, hi

        def samples(self):
            return sorted({self.lo, (self.lo + self.hi) // 2, self.hi})

    class _FloatRange(_IntRange):
        def samples(self):
            return [self.lo, (self.lo + self.hi) / 2.0, self.hi]

    class st:  # noqa: N801 - mimics hypothesis.strategies
        integers = staticmethod(_IntRange)
        floats = staticmethod(_FloatRange)

    def settings(**_kw):
        return lambda f: f

    def given(*strategies):
        def deco(f):
            def wrapper():
                for args in itertools.product(
                        *(s.samples() for s in strategies)):
                    f(*args)
            wrapper.__name__ = f.__name__
            wrapper.__doc__ = f.__doc__
            return wrapper
        return deco


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="also run tests marked slow (backend-sweep tier)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: backend-sweep / long-running tier (needs --runslow)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow tier: use --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(scope="session")
def key():
    return jax.random.key(0)


@pytest.fixture(params=["jnp",
                        pytest.param("interpret", marks=pytest.mark.slow)])
def kernel_impl(request):
    """Fused-kernel backend under test (jnp fast tier; interpret slow)."""
    return request.param
