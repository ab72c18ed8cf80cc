"""The port's Algorithm I end to end (`repro_torch.core.explorer`) against
the reference package, plus the port's standing rules.

At tiny scale (a few circuits, a handful of recipes), on the CPU:

  * the port's front half (device backend, plain torch versions of K1)
    gives the same `AigStats` as the reference's python backend, and its
    fused torch back half the same winners and metrics as the reference's
    scalar ``explore_suite(backend="python")``, in both energy modes and
    both schedule disciplines;
  * a 16-variant Monte-Carlo sweep gives the same per-variant winners as
    16 scalar reference runs, one per variant model, and the yield,
    quantile and CVaR figures recomputed from those runs in numpy;
  * the adder's winner, run through the port's CiM engine, adds;
  * no file of the port (nor ``chip_smoke.py``) imports jax or the
    reference package, and every entry point raises without a card
    unless ``device="cpu"`` is passed.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from repro.core import circuits as RC
from repro.core import explorer as RE
from repro.core import mapping as RM
from repro.core import sram as RS
from repro.core.transforms import characterize_suite as r_characterize_suite
from repro_torch.ckpt.manager import CheckpointManager as PCheckpointManager
from repro_torch.core import batch as PB
from repro_torch.core import circuits as PC
from repro_torch.core import explorer as PE
from repro_torch.core import interop
from repro_torch.core import transforms as PT
from repro_torch.core.sweep_runner import run_sweep as p_run_sweep
from repro_torch.core.sram import TOPOLOGY_LIBRARY as P_LIBRARY
from repro_torch.core.sram import EnergyModel as PEnergyModel
from repro_torch.kernels import aig_sim as PA
from repro_torch.kernels import ops as POPS
from repro_torch.configs import smoke_config as p_smoke_config
from repro_torch.launch import chaos, cim_explore
from repro_torch.launch import serve as p_serve
from repro_torch.launch import train as p_train
from repro_torch.models.model import Model as PModel
from repro_torch.serve.engine import ServeEngine as PServeEngine
from repro_torch.serve.explore_service import ExplorationService

CPU = "cpu"
REPO = pathlib.Path(__file__).resolve().parents[1]
CIRCUITS = ("adder", "bar", "sqrt")
RECIPES = [("Rw",), ("Rf", "Rs"), ("Rs", "Rw", "Ba"), ("Ba", "Rf")]


@pytest.fixture(scope="module")
def suites():
    """Both packages' tiny suites and characterizations: the port's via
    its device backend on the CPU, the reference's via python."""
    ref_suite = RC.benchmark_suite("tiny", only=CIRCUITS)
    suite = PC.benchmark_suite("tiny", only=CIRCUITS)
    ref_cha = r_characterize_suite(ref_suite, RECIPES, n_jobs=1, backend="python")
    cha = PT.characterize_suite(suite, RECIPES, backend="device", device=CPU)
    return ref_suite, suite, ref_cha, cha


def port_table(table):
    fields = {f: getattr(table, f) for f in interop.model_table_fields()}
    return interop.model_table_from_arrays(table.names, fields, table.topology_names)


def test_front_half_stats_match_reference(suites):
    ref_suite, suite, ref_cha, cha = suites
    for name in CIRCUITS:
        assert suite[name].fingerprint() == ref_suite[name].fingerprint()
        assert list(cha[name]) == list(ref_cha[name])
        for r in ref_cha[name]:
            assert cha[name][r].to_dict() == ref_cha[name][r].to_dict()


def assert_same_evaluation(a, b):
    assert (a.recipe, a.topo.name) == (b.recipe, b.topo.name)
    assert a.schedule.total_cycles == b.schedule.total_cycles
    assert a.schedule.fits == b.schedule.fits
    for k in ("latency_ns", "energy_nj", "power_mw", "throughput_gops", "tops_per_watt"):
        np.testing.assert_allclose(getattr(a.metrics, k), getattr(b.metrics, k), rtol=1e-12)


@pytest.mark.parametrize("discipline", ["list", "levels"])
@pytest.mark.parametrize("mode", ["physical", "paper"])
def test_explore_suite_matches_reference_scalar(suites, mode, discipline):
    ref_suite, suite, ref_cha, cha = suites
    ref = RE.explore_suite(
        ref_suite, recipes=RECIPES, mode=mode, discipline=discipline, cha=ref_cha,
        backend="python", n_jobs=1,
    )
    for fused in (True, False):
        got = PE.explore_suite(
            suite, recipes=RECIPES, mode=mode, discipline=discipline, cha=cha,
            fused=fused, device=CPU,
        )
        for name in CIRCUITS:
            assert_same_evaluation(got[name].best, ref[name].best)
            assert got[name].table_row() == ref[name].table_row()
            assert got[name].opt_gate_recipe == ref[name].opt_gate_recipe
            assert got[name].n_evaluations == 12 * (len(RECIPES) + 1)
    # the port's own scalar back half agrees too
    py = PE.explore_suite(suite, recipes=RECIPES, mode=mode, discipline=discipline,
                          cha=cha, backend="python", device=CPU)
    for name in CIRCUITS:
        assert_same_evaluation(py[name].best, ref[name].best)


def test_explore_and_request_match_reference(suites):
    ref_suite, suite, ref_cha, cha = suites
    rtl, ref_rtl = suite["sqrt"], ref_suite["sqrt"]
    got = PE.explore(rtl, recipes=RECIPES, cha=cha["sqrt"], max_latency_ns=40.0, device=CPU)
    ref = RE.explore(ref_rtl, recipes=RECIPES, cha=ref_cha["sqrt"], max_latency_ns=40.0,
                     backend="python")
    assert_same_evaluation(got.best, ref.best)
    for a, b in zip(PE.best_worst(got), RE.best_worst(ref)):
        assert_same_evaluation(a, b)
    got = PE.explore_request(rtl, recipes=RECIPES, cha=cha["sqrt"], max_memory_kb=16,
                             device=CPU)
    ref = RE.explore(ref_rtl, [t for t in RS.TOPOLOGY_LIBRARY if t.total_kb <= 16],
                     recipes=RECIPES, cha=ref_cha["sqrt"], backend="python")
    assert_same_evaluation(got.best, ref.best)
    with pytest.raises(ValueError, match="memory"):
        PE.explore_request(rtl, recipes=RECIPES, cha=cha["sqrt"], max_memory_kb=1, device=CPU)


@pytest.mark.parametrize("max_lat", [None, 30.0])
def test_monte_carlo_sweep_matches_per_variant_reference_runs(suites, max_lat):
    ref_suite, suite, ref_cha, cha = suites
    table = RS.ModelTable.monte_carlo(n=16, sigma=0.1, seed=0)
    got = PE.explore_suite(suite, recipes=RECIPES, cha=cha, model_sweep=port_table(table),
                           max_latency_ns=max_lat, device=CPU)
    runs = [
        RE.explore_suite(ref_suite, recipes=RECIPES, cha=ref_cha, model=table.model(v),
                         max_latency_ns=max_lat, backend="python", n_jobs=1)
        for v in range(16)
    ]
    for name in CIRCUITS:
        var = got[name].variation
        best = [run[name].best for run in runs]
        assert [(r, t.name) for r, t in var.winners] == [(b.recipe, b.topo.name) for b in best]
        keys = [(b.recipe, b.topo.name) for b in best]
        assert var.best_yield == np.mean([k == keys[0] for k in keys])
        # latency yield: the nominal winner re-evaluated under each variant
        nominal = best[0]
        sched = RM.schedule_stats(nominal.stats, nominal.topo)
        ok = [
            sched.fits
            and (max_lat is None
                 or RS.evaluate(sched, nominal.topo, table.model(v)).latency_ns <= max_lat)
            for v in range(16)
        ]
        assert var.latency_yield == np.mean(ok)
        e = np.array([b.metrics.energy_nj for b in best])
        np.testing.assert_allclose(var.winner_energy_nj, e, rtol=1e-12)
        for q, val in var.energy_quantiles.items():
            assert val == pytest.approx(float(np.quantile(e, q)), rel=1e-12)
        srt = np.sort(e)
        assert var.cvar(0.9) == pytest.approx(srt[-2:].mean(), rel=1e-12)
        assert var.cvar(0.0) == pytest.approx(e.mean(), rel=1e-12)
        assert var.grid.n_variants == 16


def test_winner_netlist_on_cim_engine_adds(suites):
    """The whole slice in miniature: Algorithm I's adder winner, lowered
    and run through the port's CiM engine, computes sums and carries."""
    _, suite, _, cha = suites
    res = PE.explore(suite["adder"], recipes=RECIPES, cha=cha["adder"], device=CPU)
    best = PT.RecipeRunner(suite["adder"], backend="device", device=CPU).run(res.best.recipe)
    n = best.n_pis // 2
    rng = np.random.default_rng(0)
    xs, ys = rng.integers(0, 1 << n, size=(2, 200))
    bits = np.array([[(x >> i) & 1 for x in xs] for i in range(n)]
                    + [[(y >> i) & 1 for y in ys] for i in range(n)], dtype=np.uint8)
    out = POPS.cim_evaluate(best.to_gate_netlist(), bits, device=CPU)
    got = [sum(int(out[i, v]) << i for i in range(n + 1)) for v in range(200)]
    assert got == [int(x) + int(y) for x, y in zip(xs, ys)]


def _imports(path: pathlib.Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods.add(node.module)
    return mods


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    bad = {
        f"{f.relative_to(REPO)}: {m}"
        for f in files
        for m in _imports(f)
        if m.split(".")[0] in ("jax", "jaxlib", "repro")
    }
    assert not bad, sorted(bad)


ENTRY_POINTS = {
    "explore": lambda s: PE.explore(s["adder"], recipes=[("Rw",)]),
    "explore_suite": lambda s: PE.explore_suite(s, recipes=[("Rw",)]),
    "explore_request": lambda s: PE.explore_request(s["adder"], recipes=[("Rw",)]),
    "characterize_suite": lambda s: PT.characterize_suite(s, [("Rw",)], backend="device"),
    "eval_tts": lambda s: PA.eval_tts(s["adder"], [((2 * s["adder"].n_nodes - 2,), [1, 2])]),
    "node_signatures": lambda s: PA.node_signatures(
        s["adder"], np.ones((s["adder"].n_pis, 1), dtype=np.uint64)
    ),
    "cim_evaluate": lambda s: POPS.cim_evaluate(
        s["adder"].to_gate_netlist(), np.zeros((s["adder"].n_pis, 4), np.uint8)
    ),
    "evaluate_select_suite": lambda s: PB.evaluate_select_suite(
        PB.SuiteTable.from_cha({"a": {(): s["adder"].characterize()}}),
        PB.TopologyTable.from_topologies(P_LIBRARY), PEnergyModel(),
    ),
    "ExplorationService": lambda s: ExplorationService(recipes=[("Rw",)], start=False),
    "run_sweep": lambda s: p_run_sweep(s, recipes=[("Rw",)]),
    "CheckpointManager.restore": lambda s: _saved_checkpoint().restore({"a": 0}),
    "cim_explore.main": lambda s: cim_explore.main(["--circuit", "adder", "--scale", "tiny"]),
    "chaos.main": lambda s: chaos.main(["-k", "disabled_is_noop"]),
    "Model": lambda s: PModel(p_smoke_config("minicpm-2b")),
    "ServeEngine": lambda s: PServeEngine(
        PModel(p_smoke_config("minicpm-2b"), device="cpu"), batch=1, max_seq=8),
    "serve.main llm": lambda s: p_serve.main(["llm", "--preset", "smoke"]),
    "serve.main (bare)": lambda s: p_serve.main([]),
    "train.main": lambda s: p_train.main(["--preset", "smoke", "--steps", "1"]),
}


def _saved_checkpoint():
    import tempfile

    m = PCheckpointManager(tempfile.mkdtemp(), async_save=False)
    m.save(0, {"a": np.arange(3)})
    return m


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_raise_without_a_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    suite = PC.benchmark_suite("tiny", only=("adder",))
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[entry](suite)
