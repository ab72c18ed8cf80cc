"""The port's fp64 back half (`repro_torch.core.batch`) against the
reference package, plus the interop converters.

The reference's jitted back half needs ``jax.experimental.enable_x64``,
which current jax no longer has, so the ground truth here is the
reference's *scalar* path (`repro.core.mapping.schedule_stats` +
`repro.core.sram.evaluate`, one cell at a time) and its numpy
`select_best_batch` -- the same reference the JAX package's own tests
hold its jitted engine to.  Where `repro.core.batch.jax_available()`
holds, one test also compares with the jitted engine directly.

Workloads and model tables are made from a seed with numpy in the
reference package and carried into the port through
`repro_torch.core.interop`.  Cycles and fits must be exact, fp64 metrics
agree at ``rtol=1e-12`` (the same expressions; only the summation order
of the per-op energies may differ), and winners must be identical.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import batch as RB
from repro.core import mapping as RM
from repro.core import sram as RS
from repro.core.aig import AigStats as RAigStats
from repro.core.transforms import CharacterizationCache as RCache
from repro.core.transforms import characterize_suite as r_characterize_suite
from repro.core import circuits as RC
from repro_torch.core import batch as PB
from repro_torch.core import interop
from repro_torch.core import transforms as PT
from repro_torch.core.aig import Aig as PAig
from repro_torch.core.sram import TOPOLOGY_LIBRARY as P_LIBRARY

CPU = "cpu"
METRIC_KEYS = ("latency_ns", "energy_nj", "power_mw", "throughput_gops", "tops_per_watt")


def stats_from_levels(levels) -> RAigStats:
    ops = [dict(nand=a, nor=b, inv=c) for a, b, c in levels]
    return RAigStats(
        n_pis=8, n_pos=4, n_ands=0, n_levels=len(ops), ops_per_level=ops,
        nand_count=sum(l[0] for l in levels),
        nor_count=sum(l[1] for l in levels),
        inv_count=sum(l[2] for l in levels),
    )


def random_items(rng, n_recipes=6, max_levels=9, max_ops=2000):
    items = []
    for i in range(n_recipes):
        n = int(rng.integers(1, max_levels + 1))
        levels = [tuple(int(x) for x in rng.integers(0, max_ops, size=3)) for _ in range(n)]
        items.append(((str(i),), stats_from_levels(levels)))
    return items


def port_items(items):
    return [(r, interop.stats_from_dict(s.to_dict())) for r, s in items]


def port_table(table: RS.ModelTable):
    fields = {f: getattr(table, f) for f in interop.model_table_fields()}
    return interop.model_table_from_arrays(table.names, fields, table.topology_names)


def port_topos(topos):
    return interop.topologies_from_tuples((t.rows, t.cols, t.n_macros) for t in topos)


def scalar_reference(suite_items, topos, table, mode, discipline):
    """(C, V, T, R) metrics and (C, T, R) schedules, one reference scalar
    evaluation per cell."""
    c, v, t, r = len(suite_items), len(table), len(topos), len(suite_items[0])
    out = {k: np.zeros((c, v, t, r)) for k in METRIC_KEYS}
    sched = {k: np.zeros((c, t, r), dtype=np.int64) for k in ("cycles", "active")}
    fits = np.zeros((c, t, r), dtype=bool)
    for ci, items in enumerate(suite_items):
        for ti, topo in enumerate(topos):
            for ri, (_, stats) in enumerate(items):
                s = RM.schedule_stats(stats, topo, discipline=discipline)
                sched["cycles"][ci, ti, ri] = s.total_cycles
                sched["active"][ci, ti, ri] = s.active_macro_cycles
                fits[ci, ti, ri] = s.fits
                for vi in range(v):
                    m = RS.evaluate(s, topo, table.model(vi, topology=ti), mode=mode)
                    for k in METRIC_KEYS:
                        out[k][ci, vi, ti, ri] = getattr(m, k)
    return out, sched, fits


def reference_winners(ref, fits, feasible=None, max_latency=None):
    c, v = ref["energy_nj"].shape[:2]
    feas = None
    if feasible is not None:
        feas = np.broadcast_to(feasible[:, :, None], fits.shape).reshape(c, 1, -1)
    return RB.select_best_batch(
        ref["energy_nj"].reshape(c, v, -1),
        fits.reshape(c, 1, -1),
        latency=ref["latency_ns"].reshape(c, v, -1),
        max_latency=max_latency,
        feasible=feas,
    )


@pytest.fixture(scope="module")
def suite_items():
    rng = np.random.default_rng(42)
    return [random_items(rng), random_items(rng)]


def port_suite(suite_items):
    works = {
        f"c{i}": PB.WorkloadTable.from_stats(port_items(items))
        for i, items in enumerate(suite_items)
    }
    return PB.SuiteTable.from_workloads(works)


def assert_suite_matches(grid, sel, ref, sched, fits, winners):
    np.testing.assert_array_equal(grid.cycles, sched["cycles"])
    np.testing.assert_array_equal(grid.active_macro_cycles, sched["active"])
    np.testing.assert_array_equal(grid.fits, fits)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(getattr(grid, k), ref[k], rtol=1e-12, equal_nan=True)
    np.testing.assert_array_equal(sel.winner_idx.astype(np.int64), winners)
    c, v = winners.shape
    for k in METRIC_KEYS:
        want = np.take_along_axis(ref[k].reshape(c, v, -1), winners[..., None], -1)[..., 0]
        np.testing.assert_allclose(sel.winner_metrics[k], want, rtol=1e-12)


@pytest.mark.parametrize("max_lat", [None, 40.0])
@pytest.mark.parametrize("discipline", ["list", "levels"])
@pytest.mark.parametrize("mode", ["physical", "paper"])
def test_fused_suite_matches_reference_scalar_path(suite_items, mode, discipline, max_lat):
    topos = RS.TOPOLOGY_LIBRARY
    table = RS.ModelTable.monte_carlo(n=5, sigma=0.3, seed=7)
    feasible = np.ones((2, len(topos)), dtype=bool)
    feasible[1, :3] = False
    ref, sched, fits = scalar_reference(suite_items, topos, table, mode, discipline)
    winners = reference_winners(ref, fits, feasible, max_lat)
    grid, sel = PB.evaluate_select_suite(
        port_suite(suite_items), PB.TopologyTable.from_topologies(port_topos(topos)),
        port_table(table), mode=mode, discipline=discipline, feasible=feasible,
        max_latency_ns=max_lat, device=CPU,
    )
    assert sel.winner_idx.dtype == np.int32
    assert_suite_matches(grid, sel, ref, sched, fits, winners)
    # the host-selection path picks the same winners from the same grid
    host = PB.evaluate_suite(
        port_suite(suite_items), PB.TopologyTable.from_topologies(port_topos(topos)),
        port_table(table), mode=mode, discipline=discipline, feasible=feasible, device=CPU,
    )
    np.testing.assert_array_equal(host.best_indices(max_lat), winners)


def salted_table(n_topos, n=6, seed=3, nan_frac=0.15):
    """Monte-Carlo table whose ``p_ctrl_mw`` carries a (V, T) axis salted
    with NaN / +inf (variant 0 stays finite)."""
    table = RS.ModelTable.monte_carlo(n=n, sigma=0.2, seed=seed)
    rng = np.random.default_rng(seed + 1)
    p = np.broadcast_to(table.p_ctrl_mw[:, None], (n, n_topos)).copy()
    salt = rng.random((n, n_topos))
    salt[0] = 1.0
    p[salt < nan_frac / 2] = np.nan
    p[(salt >= nan_frac / 2) & (salt < nan_frac)] = np.inf
    return dataclasses.replace(
        table, p_ctrl_mw=p, topology_names=tuple(t.name for t in RS.TOPOLOGY_LIBRARY)
    )


def test_nan_salted_model_grid_matches_reference(suite_items):
    topos = RS.TOPOLOGY_LIBRARY
    table = salted_table(len(topos))
    ref, sched, fits = scalar_reference(suite_items, topos, table, "physical", "list")
    assert not np.isfinite(ref["energy_nj"]).all()
    winners = reference_winners(ref, fits)
    grid, sel = PB.evaluate_select_suite(
        port_suite(suite_items), PB.TopologyTable.from_topologies(port_topos(topos)),
        port_table(table), device=CPU,
    )
    assert_suite_matches(grid, sel, ref, sched, fits, winners)
    assert np.isfinite(sel.winner_energy_nj).all()


def test_exact_ties_break_to_lowest_flat_index(suite_items):
    """Duplicate topology columns tie exactly; the lowest flat index wins,
    as in the reference's numpy filter."""
    topos = [RS.TOPOLOGY_LIBRARY[4]] * 3
    table = RS.ModelTable.monte_carlo(n=3, seed=1)
    ref, sched, fits = scalar_reference(suite_items, topos, table, "physical", "list")
    winners = reference_winners(ref, fits)
    grid, sel = PB.evaluate_select_suite(
        port_suite(suite_items), PB.TopologyTable.from_topologies(port_topos(topos)),
        port_table(table), device=CPU,
    )
    assert_suite_matches(grid, sel, ref, sched, fits, winners)
    n_r = len(suite_items[0])
    assert (winners < n_r).all()  # column 0 won every tie
    e = np.asarray(grid.energy_nj)
    np.testing.assert_array_equal(e[:, :, 0], e[:, :, 2])  # the ties are exact


def test_all_infeasible_falls_through():
    rng = np.random.default_rng(9)
    items = random_items(rng, n_recipes=4, max_ops=10_000_000)
    topos = RS.TOPOLOGY_LIBRARY[:4]
    table = RS.ModelTable.monte_carlo(n=4, sigma=0.2, seed=2)
    feasible = np.zeros((1, 4), dtype=bool)
    ref, sched, fits = scalar_reference([items], topos, table, "physical", "list")
    assert not fits.any()
    winners = reference_winners(ref, fits, feasible)
    grid, sel = PB.evaluate_select_batch(
        PB.WorkloadTable.from_stats(port_items(items)),
        PB.TopologyTable.from_topologies(port_topos(topos)),
        port_table(table), feasible=feasible[0], device=CPU,
    )
    np.testing.assert_array_equal(sel.winner_idx.astype(np.int64), winners[0])


def test_all_non_finite_raises(suite_items):
    table = dataclasses.replace(
        RS.ModelTable.monte_carlo(n=3, sigma=0.1, seed=0), f_clk_hz=np.full(3, np.nan)
    )
    topos = PB.TopologyTable.from_topologies(P_LIBRARY)
    with pytest.raises(ValueError, match="finite"):
        PB.evaluate_select_suite(port_suite(suite_items), topos, port_table(table), device=CPU)
    with pytest.raises(ValueError, match="finite"):
        PB.evaluate_select_batch(
            PB.WorkloadTable.from_stats(port_items(suite_items[0])), topos,
            port_table(table), device=CPU,
        )
    energy = np.full((2, 5), np.nan)
    with pytest.raises(ValueError, match="finite"):
        RB.select_best_batch(energy, np.ones(5, bool))
    with pytest.raises(ValueError, match="finite"):
        PB.select_best_batch_device(energy, np.ones(5, bool), device=CPU)


def test_select_best_batch_device_matches_reference_numpy():
    rng = np.random.default_rng(5)
    energy = np.round(rng.random((3, 4, 40)) * 8) / 8  # many exact ties
    energy[rng.random(energy.shape) < 0.1] = np.nan
    energy[rng.random(energy.shape) < 0.05] = np.inf
    fits = rng.random((3, 1, 40)) < 0.6
    feas = rng.random((3, 1, 40)) < 0.7
    lat = rng.random((3, 4, 40)) * 100
    for max_lat in (None, 50.0):
        want = RB.select_best_batch(energy, fits, latency=lat, max_latency=max_lat, feasible=feas)
        got = PB.select_best_batch_device(
            energy, fits, latency=lat, max_latency=max_lat, feasible=feas, device=CPU
        )
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            PB.select_best_batch(energy, fits, latency=lat, max_latency=max_lat, feasible=feas),
            want,
        )


def test_correlated_per_op_table_matches_reference(suite_items):
    """A (V, T, 3) per-op correlated table flows through the same pass."""
    topos = RS.TOPOLOGY_LIBRARY
    table = RS.ModelTable.bitcell_sigma_per_macro(
        topos, n=3, sigma=0.4, seed=8, fields=("e_op_fj", "e_op_marginal_fj", "bitcell_um2")
    )
    assert table.e_op_marginal_fj.shape == (3, 12, 3)
    ref, sched, fits = scalar_reference(suite_items, topos, table, "physical", "list")
    winners = reference_winners(ref, fits)
    ptopos = PB.TopologyTable.from_topologies(port_topos(topos))
    grid, sel = PB.evaluate_select_suite(port_suite(suite_items), ptopos, port_table(table), device=CPU)
    assert_suite_matches(grid, sel, ref, sched, fits, winners)
    np.testing.assert_allclose(
        ptopos.area_mm2(port_table(table)),
        RB.TopologyTable.from_topologies(topos).area_mm2(table),
        rtol=1e-12,
    )


def test_lazy_grid_views_and_sizes(suite_items):
    topos = PB.TopologyTable.from_topologies(P_LIBRARY)
    table = port_table(RS.ModelTable.monte_carlo(n=4, sigma=0.2, seed=3))
    grid, sel = PB.evaluate_select_suite(port_suite(suite_items), topos, table, device=CPU)
    c, v, t, r = 2, 4, len(P_LIBRARY), len(suite_items[0])
    assert grid.size == c * v * t * r  # no materialization needed
    eager = PB.evaluate_suite(port_suite(suite_items), topos, table, device=CPU)
    cell = grid.cell(1, 2, 3, 4)
    assert cell.energy_nj == eager.energy_nj[1, 2, 3, 4]
    vg = grid.variation("c1")
    np.testing.assert_array_equal(vg.best_indices(), sel.winner_idx[1].astype(np.int64))
    g0 = vg.grid(0)
    assert g0.size == t * r
    assert g0.best_index() == int(sel.winner_idx[1, 0])
    assert sel.payload_bytes < eager.energy_nj.nbytes


def test_matches_jitted_reference_engine_where_it_runs(suite_items):
    if not RB.jax_available():
        pytest.skip(
            "the reference's jitted back half does not run under this jax "
            "(jax.experimental.enable_x64 is gone)"
        )
    topos = RS.TOPOLOGY_LIBRARY
    table = RS.ModelTable.monte_carlo(n=4, sigma=0.2, seed=11)
    rsuite = RB.SuiteTable.from_workloads(
        {f"c{i}": RB.WorkloadTable.from_stats(items) for i, items in enumerate(suite_items)}
    )
    rgrid, rsel = RB.evaluate_select_suite(rsuite, RB.TopologyTable.from_topologies(topos), table)
    grid, sel = PB.evaluate_select_suite(
        port_suite(suite_items), PB.TopologyTable.from_topologies(port_topos(topos)),
        port_table(table), device=CPU,
    )
    np.testing.assert_array_equal(sel.winner_idx, np.asarray(rsel.winner_idx))
    for k in METRIC_KEYS:
        np.testing.assert_allclose(getattr(grid, k), np.asarray(getattr(rgrid, k)), rtol=1e-12)


# ---------------------------------------------------------------------------
# interop: the reference's plain forms into the port
# ---------------------------------------------------------------------------


def test_interop_round_trips():
    ref_aig = RC.gen_sqrt(8)
    aig = interop.aig_from_dict(ref_aig.to_dict())
    assert aig.to_dict() == ref_aig.to_dict()
    assert aig.fingerprint() == ref_aig.fingerprint()
    assert isinstance(aig, PAig)
    stats = ref_aig.characterize()
    assert interop.stats_from_dict(stats.to_dict()).to_dict() == stats.to_dict()
    cha = interop.cha_from_dicts({"s": {("Rw",): stats.to_dict()}})
    assert cha["s"][("Rw",)].to_dict() == stats.to_dict()
    table = RS.ModelTable.bitcell_sigma_per_macro(RS.TOPOLOGY_LIBRARY, n=3, sigma=0.2, seed=1)
    pt = port_table(table)
    assert pt.names == table.names and pt.topology_names == table.topology_names
    for f in interop.model_table_fields():
        np.testing.assert_array_equal(getattr(pt, f), getattr(table, f))
    with pytest.raises(ValueError, match="missing"):
        interop.model_table_from_arrays(table.names, {})
    grid = RS.topology_grid(rows=(128, 256), cols=(128, 512), macro_counts=(1, 3))
    topos = list(RS.TOPOLOGY_LIBRARY) + list(grid)
    ported = port_topos(topos)
    # library geometries come back as the library entries themselves
    n_lib = len(RS.TOPOLOGY_LIBRARY)
    assert [t.name for t in ported[:n_lib]] == [t.name for t in RS.TOPOLOGY_LIBRARY]

    def shape(t):
        return (t.rows, t.cols, t.n_macros, t.total_bits, t.ops_per_cycle_per_macro)

    assert [shape(t) for t in ported] == [shape(t) for t in topos]


def test_characterization_cache_is_shared_between_packages(tmp_path):
    """A cache directory written by one package is read by the other as
    all hits, in both directions."""
    recipes = [("Rw",), ("Rs", "Ba")]
    ref_suite = {"sqrt": RC.gen_sqrt(8)}
    port_suite_ = {"sqrt": interop.aig_from_dict(ref_suite["sqrt"].to_dict())}

    ref_cache = RCache(tmp_path / "from_ref")
    ref_cha = r_characterize_suite(ref_suite, recipes, cache=ref_cache, n_jobs=1, backend="python")
    port_cache = PT.CharacterizationCache(tmp_path / "from_ref")
    port_cha = PT.characterize_suite(
        port_suite_, recipes, cache=port_cache, n_jobs=1, backend="device", device=CPU
    )
    assert (port_cache.hits, port_cache.misses) == (1, 0)
    want = {n: {r: s.to_dict() for r, s in m.items()} for n, m in ref_cha.items()}
    assert {n: {r: s.to_dict() for r, s in m.items()} for n, m in port_cha.items()} == want

    port_cache = PT.CharacterizationCache(tmp_path / "from_port")
    PT.characterize_suite(port_suite_, recipes, cache=port_cache, n_jobs=1, backend="device",
                          device=CPU)
    ref_cache = RCache(tmp_path / "from_port")
    again = r_characterize_suite(ref_suite, recipes, cache=ref_cache, n_jobs=1, backend="python")
    assert (ref_cache.hits, ref_cache.misses) == (1, 0)
    assert {n: {r: s.to_dict() for r, s in m.items()} for n, m in again.items()} == want
