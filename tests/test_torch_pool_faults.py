"""The port's hardened characterization pool: retries, rebuilds,
quarantine -- the cases of tests/test_pool_faults.py against
`repro_torch.core.transforms`.

Every parallel scenario arms the fault plan through the ``REPRO_FAULTS``
environment (inherited by the spawn workers -- the parent stays
disarmed) and bounds the blast radius with ``REPRO_FAULTS_ONCE_DIR`` so a
retried task landing on a fresh worker cannot re-fire the fault forever.
The invariant under every scenario is the same: the surviving result is
bit-identical to a clean serial run, ``backend="python"`` on the CPU,
which is itself held to the reference package's python backend on the
same circuits.
"""

import pytest

from repro.core.circuits import benchmark_suite as r_benchmark_suite
from repro.core.transforms import characterize_suite as r_characterize_suite
from repro_torch.core.circuits import benchmark_suite
from repro_torch.core.transforms import (
    CharacterizationError,
    PoolPolicy,
    characterize_suite,
)
from repro_torch.runtime import faults

CPU = "cpu"
CIRCUITS = ["adder", "bar", "max"]
RECIPES = [(), ("Rw",), ("Rf",), ("Ba", "Rw")]
FAST = PoolPolicy(backoff_s=0.01, backoff_cap_s=0.1)


@pytest.fixture(autouse=True)
def _disarmed():
    """The parent process stays disarmed even when REPRO_FAULTS is set
    for the spawn workers (disable() pins the parent's env check)."""
    faults.disable()
    yield
    faults.disable()


@pytest.fixture(scope="module")
def suite_circuits():
    return benchmark_suite("tiny", only=CIRCUITS)


@pytest.fixture(scope="module")
def clean(suite_circuits):
    """The port's clean serial run, equal to the reference's."""
    out = characterize_suite(suite_circuits, RECIPES, n_jobs=1, backend="python", device=CPU)
    ref = r_characterize_suite(r_benchmark_suite("tiny", only=CIRCUITS), RECIPES, n_jobs=1,
                               backend="python")
    assert list(out) == list(ref)
    for name in ref:
        assert list(out[name]) == list(ref[name])
        assert {r: s.to_dict() for r, s in out[name].items()} == {
            r: s.to_dict() for r, s in ref[name].items()
        }
    return out


def _arm(monkeypatch, tmp_path, spec):
    monkeypatch.setenv("REPRO_FAULTS", spec)
    monkeypatch.setenv("REPRO_FAULTS_SEED", "0")
    once = tmp_path / "once"
    monkeypatch.setenv("REPRO_FAULTS_ONCE_DIR", str(once))
    return once


def _pool(suite_circuits, policy=FAST, **kw):
    return characterize_suite(suite_circuits, RECIPES, n_jobs=2, backend="python",
                              policy=policy, device=CPU, **kw)


def test_worker_raise_is_retried_to_parity(suite_circuits, clean, monkeypatch, tmp_path):
    once = _arm(monkeypatch, tmp_path, "pool.task:raise")
    assert _pool(suite_circuits) == clean
    assert len(list(once.iterdir())) == 1  # the fault fired exactly once


def test_worker_hard_exit_rebuilds_pool(suite_circuits, clean, monkeypatch, tmp_path):
    """os._exit in a worker breaks the whole ProcessPoolExecutor; the
    scheduler must rebuild it and re-dispatch every in-flight task."""
    _arm(monkeypatch, tmp_path, "pool.task:exit")
    assert _pool(suite_circuits) == clean


def test_hung_worker_hits_deadline_and_recovers(suite_circuits, clean, monkeypatch, tmp_path):
    _arm(monkeypatch, tmp_path, "pool.task:hang:::1:30")
    # The deadline clock starts at submit, so it absorbs the spawn of a
    # worker.  The port's worker imports torch (about 2 s on an idle CPU
    # host, where the reference's worker takes 0.3 s), so the reference's
    # 1.0 s would expire every first attempt; 10 s sits well above the
    # spawn, on a loaded host too, and well below the 30 s hang.
    policy = PoolPolicy(task_deadline_s=10.0, backoff_s=0.01, backoff_cap_s=0.1)
    assert _pool(suite_circuits, policy) == clean


def test_poisoned_task_quarantines_circuit_only(suite_circuits, clean, monkeypatch, tmp_path):
    # Every 'bar' task raises, forever: retries exhaust, bar is
    # quarantined, and the rest of the suite still matches the clean run.
    _arm(monkeypatch, tmp_path, "pool.task:raise:bar::inf")
    failures = {}
    out = _pool(suite_circuits, failures=failures)
    assert set(failures) == {"bar"}
    err = failures["bar"]
    assert isinstance(err, CharacterizationError) and err.circuit == "bar"
    assert out == {n: clean[n] for n in CIRCUITS if n != "bar"}
    assert list(out) == [n for n in CIRCUITS if n != "bar"]


def test_poisoned_task_raises_without_quarantine_optin(suite_circuits, monkeypatch, tmp_path):
    _arm(monkeypatch, tmp_path, "pool.task:raise:bar::inf")
    with pytest.raises(CharacterizationError, match="bar"):
        _pool(suite_circuits)


def test_front_half_failure_quarantines_serially(suite_circuits, clean):
    """The per-circuit front loop (fingerprint, cache probe, runner
    construction) quarantines too -- exercised in process via the
    cha.backend point on the serial path."""
    rule = faults.FaultRule("cha.backend", "raise", match=":bar")
    with faults.injected(rule):
        failures = {}
        out = characterize_suite(suite_circuits, RECIPES, n_jobs=1, backend="python",
                                 failures=failures, device=CPU)
    assert set(failures) == {"bar"}
    assert out == {n: clean[n] for n in CIRCUITS if n != "bar"}

    with faults.injected(rule):
        with pytest.raises(CharacterizationError, match="bar"):
            characterize_suite(suite_circuits, RECIPES, n_jobs=1, backend="python",
                               device=CPU)
