"""Unit contract of the port's fault-injection registry
(`repro_torch.runtime.faults`), the cases of tests/test_faults.py.

The load-bearing guarantee is the first one: with no plan armed, every
injection point is a strict no-op.  Where the registry's behaviour is
seed-keyed (probabilistic firing, corrupt truncation) or parsed from the
environment, the port is also held to the reference module on the same
inputs, so a chaos plan replays the same way in either package.
"""

import dataclasses
import os
import subprocess
import sys

import pytest

from repro.runtime import faults as rfaults
from repro_torch.runtime import faults

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(autouse=True)
def _disarmed():
    """Every test starts and ends with no plan armed, in both packages."""
    faults.disable()
    rfaults.disable()
    yield
    faults.disable()
    rfaults.disable()


# ---------------------------------------------------------------------------
# disabled means invisible
# ---------------------------------------------------------------------------


def test_disabled_inject_is_noop_for_every_point():
    assert not faults.enabled()
    for point in faults.POINTS:
        faults.inject(point, detail="anything")  # must not raise/hang/exit


def test_disabled_corrupt_returns_payload_unchanged():
    payload = b"x" * 257
    for point in faults.POINTS:
        assert faults.corrupt(point, payload) is payload


def test_disabled_corrupt_file_leaves_file_alone(tmp_path):
    p = tmp_path / "f.bin"
    p.write_bytes(b"y" * 100)
    for point in faults.POINTS:
        faults.corrupt_file(point, p)
    assert p.read_bytes() == b"y" * 100


def test_unknown_point_or_action_fails_loudly():
    with pytest.raises(ValueError, match="unknown fault point"):
        faults.FaultRule("no.such.point", "raise")
    with pytest.raises(ValueError, match="unknown fault action"):
        faults.FaultRule("pool.task", "explode")


# ---------------------------------------------------------------------------
# armed behavior: match / after / count, determinism
# ---------------------------------------------------------------------------


def test_raise_fires_and_counts():
    with faults.injected(faults.FaultRule("pool.task", "raise")) as plan:
        with pytest.raises(faults.FaultError):
            faults.inject("pool.task", "adder:Rw")
        # count=1 exhausted: the second hit passes through
        faults.inject("pool.task", "adder:Rw")
        assert plan.fired["pool.task"] == 1
        assert plan.hits[0] == 2
    # context manager restored the disarmed state
    faults.inject("pool.task", "adder:Rw")


def test_match_filters_on_detail_substring():
    rule = faults.FaultRule("pool.task", "raise", match="sine", count=None)
    with faults.injected(rule):
        faults.inject("pool.task", "adder:Rw")  # no match -> no fire
        with pytest.raises(faults.FaultError):
            faults.inject("pool.task", "sine:Ba")


def test_after_skips_leading_hits():
    rule = faults.FaultRule("sweep.shard", "raise", after=2, count=1)
    with faults.injected(rule):
        faults.inject("sweep.shard", "s0")
        faults.inject("sweep.shard", "s1")
        with pytest.raises(faults.FaultError):
            faults.inject("sweep.shard", "s2")
        faults.inject("sweep.shard", "s3")  # count spent


def _firing_pattern(mod, seed, n=32):
    rule = mod.FaultRule("service.process", "raise", count=None, prob=0.5)
    fired = []
    with mod.injected(rule, seed=seed):
        for _ in range(n):
            try:
                mod.inject("service.process", "1")
                fired.append(False)
            except mod.FaultError:
                fired.append(True)
    return fired


def test_probabilistic_rule_is_seed_deterministic():
    a, b = _firing_pattern(faults, 7), _firing_pattern(faults, 7)
    assert a == b
    assert _firing_pattern(faults, 8) != a  # different seed, different pattern
    assert any(a) and not all(a)
    # the same seed fires on the same hits as the reference registry
    assert a == _firing_pattern(rfaults, 7)


def test_corrupt_truncates_deterministically():
    data = bytes(range(256)) * 4
    with faults.injected(faults.FaultRule("cache.store", "corrupt", count=None), seed=3):
        out1 = faults.corrupt("cache.store", data)
        out2 = faults.corrupt("cache.store", data)
    assert out1 == out2
    assert 0 < len(out1) < len(data)
    assert data.startswith(out1)
    with rfaults.injected(rfaults.FaultRule("cache.store", "corrupt", count=None), seed=3):
        assert rfaults.corrupt("cache.store", data) == out1  # the reference's cut


def test_corrupt_file_truncates_in_place(tmp_path):
    p = tmp_path / "arrays.npz"
    p.write_bytes(b"z" * 1000)
    with faults.injected(faults.FaultRule("journal.write", "corrupt")):
        faults.corrupt_file("journal.write", p)
    assert 0 < p.stat().st_size < 1000
    q = tmp_path / "ref.npz"
    q.write_bytes(b"z" * 1000)
    with rfaults.injected(rfaults.FaultRule("journal.write", "corrupt")):
        rfaults.corrupt_file("journal.write", q)
    assert p.stat().st_size == q.stat().st_size


# ---------------------------------------------------------------------------
# env parsing (the spawn-worker / subprocess arming path)
# ---------------------------------------------------------------------------


def test_parse_rules_full_syntax():
    spec = "pool.task:exit::1:1; sweep.shard:raise:adder; pool.task:hang:::inf:2.5"
    rules = faults.parse_rules(spec)
    assert len(rules) == 3
    assert rules[0] == faults.FaultRule("pool.task", "exit", after=1, count=1)
    assert rules[1].match == "adder" and rules[1].count == 1
    assert rules[2].count is None and rules[2].hang_s == 2.5
    # field for field what the reference parses from the same string
    assert [dataclasses.astuple(r) for r in rules] == [
        dataclasses.astuple(r) for r in rfaults.parse_rules(spec)
    ]


def test_parse_rules_rejects_garbage():
    with pytest.raises(ValueError):
        faults.parse_rules("pool.task")
    with pytest.raises(ValueError):
        faults.parse_rules("typo.point:raise")


def test_env_arming_in_subprocess(tmp_path):
    """The env path is what spawn pool workers and kill-9 subprocesses
    inherit; exercise it end to end in a real child process."""
    code = (
        "import sys\n"
        "from repro_torch.runtime import faults\n"
        "assert faults.enabled()\n"
        "try:\n"
        "    faults.inject('pool.task', 'adder:Rw')\n"
        "    raise SystemExit('fault did not fire')\n"
        "except faults.FaultError:\n"
        "    pass\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "print('armed-ok')\n"
    )
    env = dict(os.environ, REPRO_FAULTS="pool.task:raise", REPRO_FAULTS_SEED="5")
    env["PYTHONPATH"] = os.pathsep.join([SRC, env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "armed-ok" in out.stdout


def test_once_dir_bounds_global_fires(tmp_path, monkeypatch):
    """With REPRO_FAULTS_ONCE_DIR, a count=2 rule fires exactly twice
    even if the per-process hit counters would allow more (fresh
    processes restart their counters; the claim files do not)."""
    monkeypatch.setenv("REPRO_FAULTS_ONCE_DIR", str(tmp_path))
    fired = 0
    for _ in range(3):
        # each iteration simulates a fresh worker process: new plan state
        with faults.injected(faults.FaultRule("pool.task", "raise", count=2)):
            try:
                faults.inject("pool.task", "adder:Rw")
            except faults.FaultError:
                fired += 1
    assert fired == 2
    assert len(list(tmp_path.iterdir())) == 2


def test_points_registry_documents_every_point():
    for point, desc in faults.POINTS.items():
        assert isinstance(desc, str) and len(desc) > 10, point
    assert list(faults.POINTS) == list(rfaults.POINTS)  # the same registry
