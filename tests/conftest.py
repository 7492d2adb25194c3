"""Shared pytest config.

Multi-device coverage: the whole suite runs under 8 virtual XLA host
devices (set here, before any test imports jax and the CPU backend
initializes), so pipeline/SPMD equivalence tests run in-process in tier-1
instead of shelling out per test.  Respects an explicit XLA_FLAGS device
count from the environment (CI sets the same value).

Tier-1 must *collect* without optional dev deps: several test modules use
hypothesis property tests.  When hypothesis is absent (the bare container),
install a stub module whose ``@given`` turns each property test into a
skip, so the plain unit tests in the same modules still run.  Install
``requirements-dev.txt`` to run the real property tests.
"""
import os
import sys
import types

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, "src"))

from repro.launch.devices import force_host_device_count

force_host_device_count(8)

import pytest


def _install_hypothesis_stub():
    try:
        import hypothesis  # noqa: F401
        return
    except ImportError:
        pass

    mod = types.ModuleType("hypothesis")
    st = types.ModuleType("hypothesis.strategies")

    def _strategy_stub(*_a, **_k):
        return None

    for name in ("floats", "integers", "booleans", "sampled_from", "lists",
                 "tuples", "text", "one_of", "just", "fixed_dictionaries",
                 "dictionaries"):
        setattr(st, name, _strategy_stub)

    def given(*_a, **_k):
        def deco(fn):
            # no functools.wraps: pytest must see (*args, **kwargs), not the
            # property-test signature (it would treat params as fixtures)
            def skipper(*args, **kwargs):
                pytest.skip("hypothesis not installed "
                            "(pip install -r requirements-dev.txt)")
            skipper.__name__ = fn.__name__
            skipper.__doc__ = fn.__doc__
            skipper.__module__ = fn.__module__
            return skipper
        return deco

    def settings(*_a, **_k):
        return lambda fn: fn

    mod.given = given
    mod.settings = settings
    mod.strategies = st
    mod.assume = lambda *_a, **_k: True
    mod.__is_repro_stub__ = True
    sys.modules["hypothesis"] = mod
    sys.modules["hypothesis.strategies"] = st


_install_hypothesis_stub()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-device equivalence tests (minutes)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def eight_devices():
    """The 8 virtual host devices the pipeline/SPMD tests mesh over."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices; XLA_FLAGS was fixed before this "
                    "conftest could set the virtual device count")
    return jax.devices()[:8]
