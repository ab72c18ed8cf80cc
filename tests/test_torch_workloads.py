"""The port's workload lowering (`repro_torch.core.workloads`) and its config
zoo against the reference package, on the CPU.

  * the three primitive tiles are the reference's, gate for gate
    (`Aig.to_dict`, `AigStats.to_dict`), and compute their integer
    arithmetic exactly;
  * the zoo (`repro_torch.configs`, `repro_torch.models.config`) is the
    reference's at published size: every `CONFIG`, `smoke_config`,
    ``n_params`` / ``n_active_params`` and the cell lists;
  * `lower_config` and `conservation_report` give the reference's integer
    counts for every (arch, shape) cell;
  * `evaluate_lowered(device="cpu")` (the fused torch back half) picks
    the winners of the reference's scalar path (`mapping.schedule_stats` +
    `sram.evaluate` + numpy `select_best_batch`, summed per layer as the
    reference's `evaluate_lowered` sums), fp64 within ``rtol=1e-12``, in
    both modes and both disciplines, on a topology subset, under a
    non-default `EnergyModel` and another ``n_units``.

The reference's own `evaluate_lowered` runs its jitted back half; the
comparison against it runs only where that back half can run.
"""

import dataclasses

import numpy as np
import pytest

from repro import configs as RCF
from repro.core import batch as RB
from repro.core import mapping as RM
from repro.core import sram as RS
from repro.core import workloads as RW
from repro.models.config import SHAPES as R_SHAPES
from repro_torch import configs as PCF
from repro_torch.core import interop
from repro_torch.core import sram as PS
from repro_torch.core import workloads as PW
from repro_torch.models.config import SHAPES

CPU = "cpu"
RTOL = 1e-12
#: a non-default energy model, built field for field in both packages
MODEL_FIELDS = dict(f_clk_hz=8e8, e_op_marginal_fj=(6.0, 10.0, 4.0),
                    p_ctrl_mw=4.1, e_col_cycle_fj=0.5, alpha_mw_per_level=1.3)
TOPO_SUBSET = (1, 4, 7, 10)


def _pack(vals, nbits):
    """Per-vector integers -> bit-parallel uint64 PI rows (one word)."""
    vals = np.asarray(vals, dtype=np.uint64)
    bits = (vals[None, :] >> np.arange(nbits, dtype=np.uint64)[:, None]) & np.uint64(1)
    return (bits << np.arange(len(vals), dtype=np.uint64)[None, :]).sum(
        axis=1, dtype=np.uint64)[:, None]


def _unpack(po, nbits, n_vecs):
    words = np.asarray(po, dtype=np.uint64)[:nbits, 0]
    bits = (words[:, None] >> np.arange(n_vecs, dtype=np.uint64)[None, :]) & np.uint64(1)
    return (bits.astype(np.int64) << np.arange(nbits)[:, None]).sum(axis=0)


# ----------------------------- primitives ----------------------------------


@pytest.mark.parametrize("name", [p[0] for p in PW.PRIMITIVES])
def test_tiles_and_stats_equal_the_reference(name):
    assert PW.PRIMITIVES == RW.PRIMITIVES
    assert PW.primitive_aigs()[name].to_dict() == RW.primitive_aigs()[name].to_dict()
    assert (PW.primitive_stats()[name].to_dict()
            == RW.primitive_stats()[name].to_dict())


def test_mac_tile_exact():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, 64)
    b = rng.integers(0, 256, 64)
    acc = rng.integers(0, 65536, 64)
    mac = PW.primitive_aigs()["mac8"]
    po = mac.simulate(np.vstack([_pack(a, 8), _pack(b, 8), _pack(acc, 16)]))
    np.testing.assert_array_equal(_unpack(po, 16, 64), (a * b + acc) % 65536)


def test_add_and_max_tiles_exact():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 65536, 64)
    b = rng.integers(0, 65536, 64)
    po = PW.primitive_aigs()["add16"].simulate(np.vstack([_pack(a, 16), _pack(b, 16)]))
    np.testing.assert_array_equal(_unpack(po, 16, 64), (a + b) % 65536)

    a8 = rng.integers(0, 256, 64)
    b8 = rng.integers(0, 256, 64)
    po = PW.primitive_aigs()["max8"].simulate(np.vstack([_pack(a8, 8), _pack(b8, 8)]))
    np.testing.assert_array_equal(_unpack(po, 8, 64), np.maximum(a8, b8))


def test_primitive_suite_stacks_the_tiles():
    suite = PW.primitive_suite()
    stats = PW.primitive_stats()
    assert suite.circuits == tuple(stats)
    assert suite.recipes == ((),)
    for i, s in enumerate(stats.values()):
        assert suite.n_levels[i, 0] == s.n_levels
        np.testing.assert_array_equal(suite.ops[i, 0, : s.n_levels], s.ops_matrix())
        assert not suite.ops[i, 0, s.n_levels:].any()


# ------------------------------- the zoo -----------------------------------


def test_cell_lists_equal_the_reference():
    assert PCF.ARCH_IDS == RCF.ARCH_IDS
    assert PCF.SKIP_CELLS == RCF.SKIP_CELLS
    assert PCF.all_cells() == RCF.all_cells()
    assert PCF.runnable_cells() == RCF.runnable_cells()
    assert len(PCF.runnable_cells()) == 33
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in R_SHAPES.items()}


@pytest.mark.parametrize("arch", RCF.ARCH_IDS)
def test_configs_and_param_counts_equal_the_reference(arch):
    for get in ("get_config", "smoke_config"):
        cfg, ref = getattr(PCF, get)(arch), getattr(RCF, get)(arch)
        assert type(cfg).__module__ == "repro_torch.models.config"
        # the port's own fields (latent attention, the sigmoid router) sit at
        # their defaults in every zoo config; every other field is the reference's
        got, want = dataclasses.asdict(cfg), dataclasses.asdict(ref)
        own = {f.name: f.default for f in dataclasses.fields(cfg) if f.name not in want}
        assert set(own) == {"kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
                            "v_head_dim", "router_scoring", "routed_scale"}
        assert {k: got[k] for k in own} == own, (arch, get)
        assert {k: v for k, v in got.items() if k not in own} == want, (arch, get)
        assert cfg.n_params() == ref.n_params()
        assert cfg.n_active_params() == ref.n_active_params()
        assert cfg.layer_kinds == ref.layer_kinds
        assert cfg.padded_vocab == ref.padded_vocab


# ------------------------------ lowering -----------------------------------


def _lowering(lowered):
    return dict(
        arch=lowered.arch, shape=lowered.shape,
        layers=[(l.kind, l.count, dict(l.tiles)) for l in lowered.layers],
        prims={k: s.to_dict() for k, s in lowered.prims.items()},
        tiles=lowered.tiles_per_token(), macs=lowered.macs_per_token(),
        ops=lowered.ops_per_token(), ops_levels=lowered.ops_per_token_from_levels(),
    )


@pytest.mark.parametrize("arch,shape", RCF.all_cells())
def test_lowering_and_conservation_equal_the_reference(arch, shape):
    lowered = PW.lower_config(PCF.get_config(arch), SHAPES[shape])
    ref = RW.lower_config(RCF.get_config(arch), R_SHAPES[shape])
    assert _lowering(lowered) == _lowering(ref)
    rep = PW.conservation_report(lowered)
    assert rep == RW.conservation_report(ref)
    assert rep["ok"]
    tiles = lowered.tiles_per_token()
    assert tiles["mac8"] > tiles["add16"] + tiles["max8"] > 0


# ------------------------------- pricing -----------------------------------


def reference_tiles(topos, model, mode, discipline):
    """Per tile: (winner index, energy nJ, latency ns) from the reference's
    scalar back half over ``topos``, winner by numpy `select_best_batch`."""
    out = {}
    for name, stats in RW.primitive_stats().items():
        energy, latency, fits = [], [], []
        for topo in topos:
            sched = RM.schedule_stats(stats, topo, discipline=discipline)
            met = RS.evaluate(sched, topo, model, mode)
            energy.append(met.energy_nj)
            latency.append(met.latency_ns)
            fits.append(sched.fits)
        i = int(RB.select_best_batch(np.array([energy]), np.array([fits]))[0])
        out[name] = (i, energy[i], latency[i])
    return out


def reference_price(lowered, tiles, n_units):
    """The per-layer and per-token sums of the reference's
    `evaluate_lowered`, from the scalar path's tile metrics."""
    e_nj = {p: e for p, (_, e, _) in tiles.items()}
    t_ns = {p: t for p, (_, _, t) in tiles.items()}
    per_layer, total_e, total_t = [], 0.0, 0.0
    for layer in lowered.layers:
        le = sum(n * e_nj[p] for p, n in layer.tiles.items()) * 1e-9
        lt = sum(n * t_ns[p] for p, n in layer.tiles.items()) * 1e-9 / n_units
        per_layer.append(dict(kind=layer.kind, count=layer.count,
                              tiles={k: int(v) for k, v in layer.tiles.items()},
                              energy_per_token_j=le * layer.count,
                              latency_per_token_s=lt * layer.count))
        total_e += le * layer.count
        total_t += lt * layer.count
    return per_layer, total_e, total_t


def assert_result_matches(res, lowered, tiles, topo_names, n_units):
    """A port `SystemResult` against the reference's scalar path: winners
    identical, every fp64 number within ``RTOL``."""
    assert res.n_units == n_units
    assert dict(res.winners) == {p: topo_names[i] for p, (i, _, _) in tiles.items()}
    for p, (_, e, t) in tiles.items():
        np.testing.assert_allclose(res.tile_energy_nj[p], e, rtol=RTOL)
        np.testing.assert_allclose(res.tile_latency_ns[p], t, rtol=RTOL)
    per_layer, total_e, total_t = reference_price(lowered, tiles, n_units)
    assert [(l["kind"], l["count"], l["tiles"]) for l in res.per_layer] == [
        (l["kind"], l["count"], l["tiles"]) for l in per_layer]
    for got, want in zip(res.per_layer, per_layer):
        for k in ("energy_per_token_j", "latency_per_token_s"):
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL)
    np.testing.assert_allclose(res.energy_per_token_j, total_e, rtol=RTOL)
    np.testing.assert_allclose(res.latency_per_token_s, total_t, rtol=RTOL)
    assert res.tiles_per_token == lowered.tiles_per_token()


PRICING = {
    "physical-list": dict(mode="physical", discipline="list"),
    "physical-levels": dict(mode="physical", discipline="levels"),
    "paper-list": dict(mode="paper", discipline="list"),
    "paper-levels": dict(mode="paper", discipline="levels"),
    "topology-subset": dict(mode="physical", discipline="list", subset=TOPO_SUBSET),
    "energy-model": dict(mode="physical", discipline="levels", model=True),
    "n-units": dict(mode="paper", discipline="list", n_units=1024),
}


@pytest.mark.parametrize("case", list(PRICING))
@pytest.mark.parametrize("arch", ["mamba2-780m", "gemma3-27b"])
def test_evaluate_lowered_matches_the_reference_scalar_path(arch, case):
    kw = PRICING[case]
    ref_topos = list(RS.TOPOLOGY_LIBRARY)
    if "subset" in kw:
        ref_topos = [ref_topos[i] for i in kw["subset"]]
    topos = interop.topologies_from_tuples((t.rows, t.cols, t.n_macros) for t in ref_topos)
    ref_model = RS.EnergyModel(**MODEL_FIELDS) if kw.get("model") else RS.EnergyModel()
    model = PS.EnergyModel(**MODEL_FIELDS) if kw.get("model") else None
    n_units = kw.get("n_units", 8192)
    lowered = PW.lower_config(PCF.get_config(arch), SHAPES["decode_32k"])
    res = PW.evaluate_lowered(lowered, topologies=topos, model=model, mode=kw["mode"],
                              discipline=kw["discipline"], n_units=n_units, device=CPU)
    tiles = reference_tiles(ref_topos, ref_model, kw["mode"], kw["discipline"])
    assert [t.name for t in topos] == [t.name for t in ref_topos]
    assert_result_matches(res, lowered, tiles, [t.name for t in topos], n_units)
    assert (res.arch, res.shape) == (arch, "decode_32k")


def test_evaluate_lowered_matches_the_reference_jitted_path():
    """Against the reference's own `evaluate_lowered` (its jitted fused
    back half), where that back half runs."""
    if not RB.jax_available():
        pytest.skip("the reference's jitted back half does not run under this "
                    "jax (repro.core.batch.jax_available() is false)")
    cell = ("mamba2-780m", "decode_32k")
    ref = RW.evaluate_lowered(RW.lower_config(RCF.get_config(cell[0]), R_SHAPES[cell[1]]))
    got = PW.evaluate_lowered(PW.lower_config(PCF.get_config(cell[0]), SHAPES[cell[1]]),
                              device=CPU)
    assert dict(got.winners) == dict(ref.winners)
    np.testing.assert_allclose(got.energy_per_token_j, ref.energy_per_token_j, rtol=RTOL)
    np.testing.assert_allclose(got.latency_per_token_s, ref.latency_per_token_s, rtol=RTOL)
