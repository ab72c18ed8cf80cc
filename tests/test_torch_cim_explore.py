"""The port's paper CLI (`repro_torch.launch.cim_explore`) on the CPU,
against the reference's examples/cim_explore.py.

For each of the nine circuits at tiny scale, the port's CLI (fused torch
back half, plain torch versions of K1) prints the same Table-I row, the
same best-vs-worst saving and the same lines as the reference CLI with
``--backend python`` (only the wall time differs), and its best and worst
implementations are the reference's, fp64 metrics at ``rtol=1e-12``.  The
same holds under a latency bound that sends two circuits to the
admissibility fallback tier.  The model-sweep summaries equal ones
computed from the port's ``explore_suite(model_sweep=...)`` over tables
equal to the reference's generators (the reference's variant path is
jitted and does not run under every jax), and a warm ``--cache`` rerun
prints the same rows without characterizing anything.
"""

import contextlib
import io
import pathlib
import re
import runpy
import sys

import numpy as np
import pytest

from repro.core import explorer as RE
from repro.core import sram as RS
from repro_torch.core import circuits as PC
from repro_torch.core import explorer as PE
from repro_torch.core import interop
from repro_torch.core import transforms as PT
from repro_torch.core.sram import TOPOLOGY_LIBRARY, EnergyModel, ModelTable
from repro_torch.launch import cim_explore

REPO = pathlib.Path(__file__).resolve().parents[1]
CIRCUITS = list(PC._GENERATORS)
METRICS = ("latency_ns", "energy_nj", "power_mw", "throughput_gops", "tops_per_watt")
#: sine (42 ns) meets it; max (52 ns) and log2 (67 ns) have no admissible
#: implementation at tiny scale and take the fits-only tier
LATENCY_NS = 45.0


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """One characterization cache per package, shared by this module."""
    return str(tmp_path_factory.mktemp("port_cha")), str(tmp_path_factory.mktemp("ref_cha"))


def wall_free(text: str) -> str:
    """The CLI's stdout without the per-circuit wall time."""
    return re.sub(r"implementations, [0-9.]+s\) ===", "implementations) ===", text)


def run_port(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        results = cim_explore.main([*argv, "--device", "cpu"])
    return buf.getvalue(), results


def run_reference(argv, monkeypatch):
    """examples/cim_explore.py with ``--backend python`` in process; the
    results its `explore_suite` call returned are kept for the fp64
    comparison."""
    got = {}
    real = RE.explore_suite

    def keep(*a, **kw):
        got.update(real(*a, **kw))
        return got

    monkeypatch.setattr(RE, "explore_suite", keep)
    monkeypatch.setattr(sys, "argv", ["cim_explore.py", *argv, "--backend", "python"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(str(REPO / "examples" / "cim_explore.py"), run_name="__main__")
    return buf.getvalue(), got


def assert_same_evaluation(a, b):
    assert (a.recipe, a.topo.name) == (b.recipe, b.topo.name)
    for k in METRICS:
        np.testing.assert_allclose(getattr(a.metrics, k), getattr(b.metrics, k), rtol=1e-12)


def assert_matches_reference(argv, caches, monkeypatch):
    port_cache, ref_cache = caches
    out, res = run_port([*argv, "--cache", port_cache])
    ref_out, ref = run_reference([*argv, "--cache", ref_cache], monkeypatch)
    assert wall_free(out) == wall_free(ref_out)
    assert list(res) == list(ref)
    for name in ref:
        assert res[name].table_row() == ref[name].table_row()
        (b, w), (rb, rw) = PE.best_worst(res[name]), RE.best_worst(ref[name])
        assert_same_evaluation(b, rb)
        assert_same_evaluation(w, rw)
        np.testing.assert_allclose(1 - b.metrics.energy_nj / w.metrics.energy_nj,
                                   1 - rb.metrics.energy_nj / rw.metrics.energy_nj, rtol=1e-12)
    return res


@pytest.mark.parametrize("circuit", CIRCUITS)
def test_table_row_matches_reference_cli(circuit, caches, monkeypatch):
    res = assert_matches_reference(["--circuit", circuit, "--scale", "tiny"], caches, monkeypatch)
    assert list(res) == [circuit] and res[circuit].backend == "torch"


def test_latency_bound_fallback_matches_reference_cli(caches, monkeypatch):
    argv = ["--all", "--scale", "tiny", "--max-latency-ns", str(LATENCY_NS)]
    res = assert_matches_reference(argv, caches, monkeypatch)
    late = {n for n, r in res.items() if r.best.metrics.latency_ns > LATENCY_NS}
    assert late == {"max", "log2"}  # the fallback tier fired, and only there


def reference_table(kind):
    """The reference CLI's table for ``kind`` at 8 variants, sigma 0.2."""
    if kind == "corners":
        return RS.ModelTable.corners(RS.EnergyModel(), spread=0.2)
    if kind == "sensitivity":
        return RS.ModelTable.sensitivity(RS.EnergyModel(), rel=0.2)
    if kind == "mc":
        return RS.ModelTable.monte_carlo(RS.EnergyModel(), n=8, sigma=0.2, seed=0)
    return RS.ModelTable.bitcell_sigma_per_macro(RS.TOPOLOGY_LIBRARY, n=8, sigma=0.2, seed=0)


@pytest.mark.parametrize("kind", ["corners", "sensitivity", "mc", "correlated"])
def test_model_sweep_summary(kind, caches):
    ref = reference_table(kind)
    fields = {f: getattr(ref, f) for f in interop.model_table_fields()}
    table = interop.model_table_from_arrays(ref.names, fields, ref.topology_names)
    if kind == "correlated":  # keyed on the swept library, as the reference's
        assert table.topology_names == tuple(t.name for t in TOPOLOGY_LIBRARY)
    suite = PC.benchmark_suite("tiny", only=["adder"])
    cha = PT.characterize_suite(suite, cache=caches[0], device="cpu")
    want = PE.explore_suite(suite, cha=cha, model_sweep=table, device="cpu")["adder"].variation
    out, res = run_port(["--circuit", "adder", "--scale", "tiny", "--model-sweep", kind,
                         "--model-variants", "8", "--model-sigma", "0.2",
                         "--cache", caches[0]])
    assert res["adder"].variation.winners == want.winners
    lines = out.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("  model sweep"))
    assert lines[start:] == cim_explore.yield_summary(want)
    # the CLI's table is the reference generator's, field for field
    got = cim_explore.model_table(kind, 8, 0.2)
    assert got.names == table.names and got.topology_names == table.topology_names
    for f in interop.model_table_fields():
        np.testing.assert_array_equal(getattr(got, f), getattr(table, f))


def test_warm_cache_rerun_prints_same_rows(tmp_path, monkeypatch):
    argv = ["--circuit", "sqrt", "--scale", "tiny", "--cache", str(tmp_path)]
    cold, _ = run_port(argv)

    def no_characterization(*a, **kw):
        raise AssertionError("a warm --cache run characterized a circuit")

    monkeypatch.setattr(PT, "RecipeRunner", no_characterization)
    monkeypatch.setattr(PT, "transform_fns", no_characterization)
    warm, _ = run_port(argv)
    assert wall_free(warm) == wall_free(cold)


def test_model_table_of_no_sweep_is_none():
    assert cim_explore.model_table(None, 8, 0.2) is None
    assert isinstance(cim_explore.model_table("mc", 4, 0.1), ModelTable)
    assert cim_explore.model_table("corners", 4, 0.1).model(0) == EnergyModel()
