import os
import sys
import types
from pathlib import Path

# NOTE: no xla_force_host_platform_device_count here — smoke tests must see
# exactly 1 device (the 512-device flag belongs to launch/dryrun.py only).
# Multi-device tests spawn subprocesses (tests/_subproc.py helpers).
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np
import pytest


# ---------------------------------------------------------------------------
# hypothesis fallback shim
# ---------------------------------------------------------------------------
# The property tests only use @settings(max_examples=..., deadline=None) and
# @given(...) over st.integers(lo, hi) / st.sampled_from(seq) strategies —
# no strategy combinators (|, maps, flatmaps). When hypothesis is not
# installed, install a deterministic-examples stand-in: each @given test runs
# against `max_examples` seeded draws (always including the strategy
# endpoints), so the suite collects and exercises the same properties with a
# fixed corpus instead of failing at import time.
try:
    import hypothesis  # noqa: F401
except ImportError:
    def _make_hypothesis_shim():
        class _Strategy:
            def __init__(self, draw, endpoints=()):
                self.draw = draw          # fn(rng) -> value
                self.endpoints = endpoints

        class _St(types.ModuleType):
            @staticmethod
            def integers(min_value, max_value):
                return _Strategy(
                    lambda rng: int(rng.integers(min_value, max_value + 1)),
                    endpoints=(min_value, max_value))

            @staticmethod
            def sampled_from(elements):
                seq = list(elements)
                return _Strategy(
                    lambda rng: seq[int(rng.integers(0, len(seq)))],
                    endpoints=tuple(seq[:2]))

        def settings(max_examples=10, **_kw):
            def deco(fn):
                fn._shim_max_examples = max_examples
                return fn
            return deco

        def given(*strategies):
            def deco(fn):
                def runner():
                    n = getattr(runner, "_shim_max_examples",
                                getattr(fn, "_shim_max_examples", 10))
                    n = min(n, 12)        # bounded corpus for CPU CI
                    rng = np.random.default_rng(0xC0FFEE)
                    for i in range(n):
                        if i < min(len(s.endpoints) for s in strategies):
                            vals = [s.endpoints[i] for s in strategies]
                        else:
                            vals = [s.draw(rng) for s in strategies]
                        fn(*vals)
                # plain zero-arg function: pytest must not see the property
                # args as fixtures, so no functools.wraps/__wrapped__ here.
                runner.__name__ = fn.__name__
                runner.__doc__ = fn.__doc__
                runner.__module__ = fn.__module__
                runner.hypothesis = types.SimpleNamespace(inner_test=fn)
                return runner
            return deco

        mod = types.ModuleType("hypothesis")
        mod.given = given
        mod.settings = settings
        mod.strategies = _St("hypothesis.strategies")
        mod.__version__ = "0.0-shim"
        sys.modules["hypothesis"] = mod
        sys.modules["hypothesis.strategies"] = mod.strategies

    _make_hypothesis_shim()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without them")
