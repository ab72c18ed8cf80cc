"""The port's chaos matrix (`repro_torch.launch.chaos`) on the CPU.

It carries the 13 scenarios of the reference's scripts/chaos.py -- the
same names, fault points and actions -- and each must recover with
parity on ``--device cpu``, one parametrised case per scenario.  The
matrix must cover every point of `repro_torch.runtime.faults.POINTS`;
an uncovered point exits 1.
"""

import pathlib
import runpy

import pytest

from repro_torch.launch import chaos
from repro_torch.runtime import faults

REPO = pathlib.Path(__file__).resolve().parents[1]
NAMES = [s.__name__ for s in chaos._SCENARIOS]


@pytest.fixture(autouse=True)
def _disarmed():
    faults.disable()
    yield
    faults.disable()


def test_list_names_the_reference_scenarios(capsys):
    ref = runpy.run_path(str(REPO / "scripts" / "chaos.py"), run_name="reference_chaos")
    want = [(s.__name__, s.point, s.action) for s in ref["_SCENARIOS"]]
    assert len(want) == 13
    assert [(s.__name__, s.point, s.action) for s in chaos._SCENARIOS] == want
    assert chaos.main(["--list"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"{n}  [{p} x {a}]" for n, p, a in want]
    assert (chaos.CIRCUITS, chaos.RECIPES, chaos.SEED) == (
        ref["CIRCUITS"], ref["RECIPES"], ref["SEED"]
    )
    assert [t.name for t in chaos.TOPOS] == [t.name for t in ref["TOPOS"]]


def test_matrix_covers_every_point(monkeypatch, capsys):
    assert {s.point for s in chaos._SCENARIOS} >= set(faults.POINTS)
    # a registry point no scenario covers is a gap: exit 1 before any run
    monkeypatch.setitem(faults.POINTS, "new.point", "an uncovered injection point")
    assert chaos.main(["--device", "cpu"]) == 1
    assert "matrix gap: uncovered points {'new.point'}" in capsys.readouterr().out


@pytest.mark.parametrize("name", NAMES)
def test_scenario_recovers_on_cpu(name, capsys):
    assert chaos.main(["-k", name, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "chaos matrix: 1/1 scenarios recovered with parity" in out
    assert f"ok   {name} " in out and "skipped" not in out
