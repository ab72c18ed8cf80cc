"""The port's tables (`repro_torch.core.batch.schedule_batch` /
`schedule_suite` / `table2_batch`) and `CheckpointManager.restore_or_none`
/ ``restore(shardings=)`` against the reference, on the CPU.

The reference's ``schedule_batch`` and ``schedule_suite`` are jitted and
need ``jax.experimental.enable_x64``, which jax 0.9 no longer has, so
they are held, as the reference's own tests hold them, to the scalar
`repro.core.mapping.schedule_stats` one cell at a time: cycles, active
macro-cycles and fits exact.  ``table2_batch`` is numpy in both packages:
the port's equals the reference's ``table2_batch`` bit for bit and its
scalar ``sram.table2_metrics`` at ``rtol=1e-12``.  Workloads, model
tables and topologies are made in the reference package (from seeds
with numpy) and carried over by `repro_torch.core.interop`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import batch as RB
from repro.core import mapping as RM
from repro.core import sram as RS
from repro.core.aig import AigStats as RAigStats
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.core import batch as PB
from repro_torch.core import interop
from repro_torch.core import sram as PS

CPU = "cpu"


def stats_from_levels(levels) -> RAigStats:
    ops = [dict(nand=a, nor=b, inv=c) for a, b, c in levels]
    return RAigStats(
        n_pis=8, n_pos=4, n_ands=0, n_levels=len(ops), ops_per_level=ops,
        nand_count=sum(l[0] for l in levels),
        nor_count=sum(l[1] for l in levels),
        inv_count=sum(l[2] for l in levels),
    )


# The reference's structural edge cases (`tests/test_batch.py`): empty
# levels, single-type levels, wide levels, deep-narrow shapes, misfits.
SYNTH = [
    ((), stats_from_levels([(3, 1, 0), (0, 0, 1)])),
    (("a",), stats_from_levels([(0, 0, 0), (5, 0, 0), (0, 7, 2)])),
    (("b",), stats_from_levels([(400, 130, 65)] * 7)),
    (("c",), stats_from_levels([(1, 0, 0)] * 40)),
    (("d",), stats_from_levels([(9000, 9000, 500)])),  # doesn't fit 4KB
]


def port_items(items):
    return [(r, interop.stats_from_dict(s.to_dict())) for r, s in items]


def port_topos(topos):
    return interop.topologies_from_tuples((t.rows, t.cols, t.n_macros) for t in topos)


def port_table(table: RS.ModelTable):
    fields = {f: getattr(table, f) for f in interop.model_table_fields()}
    return interop.model_table_from_arrays(table.names, fields, table.topology_names)


def scalar_schedule(items, topos, discipline) -> dict:
    """``(T, R)`` schedules, one reference ``schedule_stats`` per cell."""
    out = {k: np.zeros((len(topos), len(items)), dtype=np.int64)
           for k in ("cycles", "active_macro_cycles")}
    out["fits"] = np.zeros((len(topos), len(items)), dtype=bool)
    for ti, topo in enumerate(topos):
        for ri, (_, stats) in enumerate(items):
            s = RM.schedule_stats(stats, topo, discipline=discipline)
            out["cycles"][ti, ri] = s.total_cycles
            out["active_macro_cycles"][ti, ri] = s.active_macro_cycles
            out["fits"][ti, ri] = s.fits
    return out


def same_schedule(got: dict, want: dict) -> None:
    assert set(got) == {"cycles", "active_macro_cycles", "fits"}
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == (bool if k == "fits" else np.int64)
        np.testing.assert_array_equal(got[k], w, err_msg=k)


# ---------------------------------------------------------------------------
# schedule_batch / schedule_suite
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("discipline", ["list", "levels"])
def test_schedule_batch_matches_scalar(discipline):
    """`tests/test_batch.py::test_schedule_batch_matches_scalar` on the port."""
    work = PB.WorkloadTable.from_stats(port_items(SYNTH))
    topos = PB.TopologyTable.from_topologies(port_topos(RS.TOPOLOGY_LIBRARY))
    got = PB.schedule_batch(work, topos, discipline=discipline, device=CPU)
    same_schedule(got, scalar_schedule(SYNTH, RS.TOPOLOGY_LIBRARY, discipline))


@pytest.mark.parametrize("discipline", ["list", "levels"])
def test_row_budget_gates_feasibility(discipline):
    """`tests/test_mapping_roofline.py::test_row_budget_gates_feasibility`:
    2000 NAND2 in one level fit an 8 x 1024 macro's bits but not its rows
    (3 * 4 + 2 = 14 > 8); the batched check is the scalar one."""
    starved = RS.SramTopology.from_geometry(8, 1024, 1)
    topos = [starved, RS.SramTopology(8, 1)]
    items = [(("wide",), stats_from_levels([(2000, 0, 0)])),
             (("deep",), stats_from_levels([(64, 0, 0)] * 10))]
    got = PB.schedule_batch(PB.WorkloadTable.from_stats(port_items(items)),
                            PB.TopologyTable.from_topologies(port_topos(topos)),
                            discipline=discipline, device=CPU)
    assert not got["fits"][0, 0] and got["fits"][0, 1]
    same_schedule(got, scalar_schedule(items, topos, discipline))


@pytest.mark.parametrize("discipline", ["list", "levels"])
def test_schedule_suite_equals_schedule_batch_per_circuit(discipline):
    """`tests/test_suite.py::test_suite_padding_is_masked`: circuits of
    different depths share one padded level axis, and no padded level
    leaks into a shorter circuit's schedule."""
    rng = np.random.default_rng(5)

    def items(depth):
        return [((str(r),), stats_from_levels(
            [tuple(int(x) for x in rng.integers(0, 3000, 3)) for _ in range(depth + r)]))
            for r in range(4)]

    suite_items = {"shallow": items(2), "deep": items(70), "mid": items(9)}
    works = {n: PB.WorkloadTable.from_stats(port_items(it)) for n, it in suite_items.items()}
    suite = PB.SuiteTable.from_workloads(works)
    assert suite.ops.shape[2] > works["shallow"].ops.shape[1]
    topos = PB.TopologyTable.from_topologies(port_topos(RS.TOPOLOGY_LIBRARY))
    got = PB.schedule_suite(suite, topos, discipline=discipline, device=CPU)
    assert got["cycles"].shape == (3, len(RS.TOPOLOGY_LIBRARY), 4)
    for i, (name, it) in enumerate(suite_items.items()):
        one = PB.schedule_batch(works[name], topos, discipline=discipline, device=CPU)
        same_schedule({k: v[i] for k, v in got.items()}, one)
        same_schedule(one, scalar_schedule(it, RS.TOPOLOGY_LIBRARY, discipline))


def test_schedule_tables_default_to_the_card():
    work = PB.WorkloadTable.from_stats(port_items(SYNTH))
    topos = PB.TopologyTable.from_topologies(port_topos(RS.TOPOLOGY_LIBRARY[:2]))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PB.schedule_batch(work, topos)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PB.schedule_suite(PB.SuiteTable.from_workloads({"a": work}), topos)
    with pytest.raises(ValueError, match="unknown discipline"):
        PB.schedule_batch(work, topos, discipline="greedy", device=CPU)


# ---------------------------------------------------------------------------
# table2_batch
# ---------------------------------------------------------------------------


def both_topology_tables(topos):
    return RB.TopologyTable.from_topologies(topos), PB.TopologyTable.from_topologies(
        port_topos(topos))


def same_table2(got: dict, want: dict, shape) -> None:
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].shape == shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("frac", [0.0, 0.5, 1.0])
def test_table2_batch_matches_the_reference_and_the_scalar(frac):
    """`tests/test_batch.py::test_table2_batch_matches_scalar` on the port,
    and bit-equal to the reference's numpy ``table2_batch``."""
    topos = [RS.SramTopology(8, 1), RS.SramTopology(8, 3), RS.SramTopology(16, 3),
             *RS.TOPOLOGY_LIBRARY]
    r_tt, p_tt = both_topology_tables(topos)
    got = PB.table2_batch(p_tt, PS.EnergyModel(), nor_fraction=frac)
    same_table2(got, RB.table2_batch(r_tt, RS.EnergyModel(), nor_fraction=frac), (len(topos),))
    for i, topo in enumerate(topos):
        for k, v in RS.table2_metrics(topo, RS.EnergyModel(), nor_fraction=frac).items():
            np.testing.assert_allclose(got[k][i], v, rtol=1e-12, err_msg=k)
    if frac == 0.5:  # the defaults: the nominal model, half NOR
        same_table2(PB.table2_batch(p_tt), got, (len(topos),))


@pytest.mark.parametrize("kind", ["monte_carlo", "sensitivity", "v1", "per_macro",
                                  "per_macro_e_op"])
def test_table2_batch_over_model_tables(kind):
    """`tests/test_variation.py` (``test_table2_batch_over_model_table``,
    ``test_v1_table_bit_identical_to_uniform_sweep``, the correlated
    tables): ``(V, T)`` outputs for every table kind, with ``(V,)``,
    ``(V, 1)``, ``(V, T)`` and ``(V, T, 3)`` fields, each variant's row
    the single-model call on ``table.model(v)``."""
    lib = RS.TOPOLOGY_LIBRARY
    table = {
        "monte_carlo": lambda: RS.ModelTable.monte_carlo(n=6, sigma=0.1, seed=2),
        "sensitivity": lambda: RS.ModelTable.sensitivity(
            fields=("bitcell_um2", "periphery_overhead", "f_clk_hz"), rel=0.1),
        "v1": lambda: as_v1_table(RS.ModelTable.monte_carlo(n=4, sigma=0.2, seed=9)),
        "per_macro": lambda: RS.ModelTable.bitcell_sigma_per_macro(lib, n=4, sigma=0.2, seed=0),
        "per_macro_e_op": lambda: RS.ModelTable.bitcell_sigma_per_macro(
            lib, n=3, fields=("e_op_fj", "p_ctrl_mw", "pipeline_utilization"), seed=4),
    }[kind]()
    r_tt, p_tt = both_topology_tables(lib)
    pt = port_table(table)
    got = PB.table2_batch(p_tt, pt, nor_fraction=0.3)
    same_table2(got, RB.table2_batch(r_tt, table, nor_fraction=0.3), (len(table), len(lib)))
    for v in range(len(table)):
        if pt.n_topologies is None:  # uniform: one model per variant
            row = PB.table2_batch(p_tt, pt.model(v), nor_fraction=0.3)
            for k, arr in row.items():
                np.testing.assert_array_equal(got[k][v], arr, err_msg=k)
        for t, topo in enumerate(lib):
            ref = RS.table2_metrics(topo, table.model(v, topology=t), nor_fraction=0.3)
            for k, x in ref.items():
                np.testing.assert_allclose(got[k][v, t], x, rtol=1e-12, err_msg=(k, v, t))


def as_v1_table(table: RS.ModelTable) -> RS.ModelTable:
    """The same table with every scalar field reshaped (V,) -> (V, 1)."""
    kw = {}
    for f in dataclasses.fields(RS.EnergyModel):
        arr = getattr(table, f.name)
        if f.name not in ("e_op_fj", "e_op_marginal_fj"):
            arr = arr[:, None]
        kw[f.name] = arr
    return RS.ModelTable(names=table.names, **kw)


def test_table2_batch_refusals():
    """The reference's `_check_topo_axis` refusals
    (`tests/test_variation.py:392`, `:484`): an empty (falsy) table, a
    per-topology axis of another width, a same-width table generated for
    another topology order."""
    lib = port_topos(RS.TOPOLOGY_LIBRARY)
    rogue = object.__new__(PS.ModelTable)
    object.__setattr__(rogue, "names", ())
    for f in dataclasses.fields(PS.EnergyModel):
        shape = (0, 3) if f.name in ("e_op_fj", "e_op_marginal_fj") else (0,)
        object.__setattr__(rogue, f.name, np.zeros(shape))
    assert not rogue  # falsy: an `or EnergyModel()` would have dropped it
    with pytest.raises(ValueError, match="empty ModelTable"):
        PB.table2_batch(PB.TopologyTable.from_topologies(lib[:3]), rogue)
    table_12 = port_table(RS.ModelTable.bitcell_sigma_per_macro(RS.TOPOLOGY_LIBRARY, n=2))
    with pytest.raises(ValueError, match="per-topology axis"):
        PB.table2_batch(PB.TopologyTable.from_topologies(lib[:5]), table_12)
    with pytest.raises(ValueError, match="generated for"):
        PB.table2_batch(PB.TopologyTable.from_topologies(lib[::-1]), table_12)


# ---------------------------------------------------------------------------
# CheckpointManager.restore_or_none / restore(shardings=)
# ---------------------------------------------------------------------------


def test_restore_or_none(tmp_path):
    """None on a directory with no checkpoint (where `restore` raises
    `FileNotFoundError`); the latest step's tree once one is written."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    like = dict(w=torch.zeros(3, 4), step=0)
    assert mgr.restore_or_none(like, device=CPU) is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(like, device=CPU)
    rng = np.random.default_rng(0)
    for step in (1, 2):
        tree = dict(w=torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32)),
                    step=torch.tensor(step, dtype=torch.int32))
        mgr.save(step, tree)
    got, meta = mgr.restore_or_none(like, device=CPU)
    assert torch.equal(got["w"], tree["w"]) and int(got["step"]) == 2


def test_restore_with_shardings_lays_each_leaf_onto_its_mesh(tmp_path):
    """``shardings``: a tree of ``(DeviceMesh, placements)`` keyed like the
    template (None: the leaf whole on ``device``).  Each leaf is read whole
    and cut to this rank's shard with no collective, so it runs here on
    rank 0 of the dry-run's fake group: the local shards are the written
    array's slices, the global shapes and placements the asked ones."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import fake_world

    fake_world()
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
    rng = np.random.default_rng(1)
    tree = dict(p=dict(a=torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32)),
                       b=torch.from_numpy(rng.standard_normal((2, 8))).to(torch.bfloat16)),
                step=torch.tensor(7, dtype=torch.int32))
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(7, tree)
    places = dict(p=dict(a=(mesh, (Shard(0), Shard(1))), b=(mesh, (Replicate(), Shard(1)))),
                  step=None)
    like = dict(p=dict(a=torch.zeros(4, 6), b=torch.zeros(2, 8)), step=0)
    got, _ = mgr.restore_or_none(like, shardings=places, device=CPU)
    a, b = got["p"]["a"], got["p"]["b"]
    assert isinstance(a, DTensor) and isinstance(b, DTensor)
    assert a.placements == (Shard(0), Shard(1)) and a.shape == (4, 6)
    assert torch.equal(a.to_local(), tree["p"]["a"][:2, :3])  # rank 0: first data, first model
    assert b.placements == (Replicate(), Shard(1)) and b.dtype == torch.bfloat16
    assert torch.equal(b.to_local(), tree["p"]["b"][:, :4])
    assert not isinstance(got["step"], DTensor) and int(got["step"]) == 7
