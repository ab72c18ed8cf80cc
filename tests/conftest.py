"""Shared test configuration: markers, per-test timeout, hypothesis caps.

Per-test timeout: ``PYTEST_PER_TEST_TIMEOUT=<seconds>`` arms a SIGALRM
around each test body (no external pytest-timeout dependency), so a hung
test fails fast with a TimeoutError instead of stalling the CI pipeline.
0 / unset disables it; platforms without SIGALRM (windows) skip arming.

Hypothesis budget: a ``ci`` profile caps ``max_examples`` (override with
``HYPOTHESIS_MAX_EXAMPLES``); ``HYPOTHESIS_PROFILE=ci`` selects it —
scripts/ci.sh exports both so the property suites stay inside the CI
time budget while local runs keep the per-test defaults.
"""

import os
import signal

import pytest

_TIMEOUT_S = int(os.environ.get("PYTEST_PER_TEST_TIMEOUT", "0") or "0")

try:
    from hypothesis import settings as _hyp_settings

    _hyp_settings.register_profile(
        "ci",
        max_examples=int(os.environ.get("HYPOTHESIS_MAX_EXAMPLES", "20")),
        deadline=None,
        derandomize=True,
    )
    if os.environ.get("HYPOTHESIS_PROFILE"):
        _hyp_settings.load_profile(os.environ["HYPOTHESIS_PROFILE"])
except ImportError:  # property suites skip via importorskip anyway
    pass


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test (compile-heavy)")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the test skips itself without one)"
    )


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    if _TIMEOUT_S > 0 and hasattr(signal, "SIGALRM"):
        def _on_alarm(signum, frame):
            raise TimeoutError(
                f"{item.nodeid} exceeded the per-test timeout "
                f"({_TIMEOUT_S}s, PYTEST_PER_TEST_TIMEOUT)"
            )

        old = signal.signal(signal.SIGALRM, _on_alarm)
        signal.alarm(_TIMEOUT_S)
        try:
            yield
        finally:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, old)
    else:
        yield
