"""The port's rCiM-vs-roofline comparison (`repro_torch.launch.system`)
against the reference package, on the CPU.

  * `token_cost` and `token_cost_from_dryrun` equal the reference's for
    every runnable zoo cell, and the baseline `AcceleratorModel` keeps the
    reference's modelling constants;
  * `sweep_roofline(device="cpu")` (fp64 torch) equals the arithmetic of
    the reference's `launch.roofline.roofline_terms` point by point: the
    broadcast of ``hbm_bw`` against ``link_bw``, zero link bandwidth as no
    collective time, the first bottleneck winning ties, and memory time
    falling as bandwidth rises;
  * `compare_system(device="cpu")` gives, for every runnable cell, the
    record the reference's `compare_system` builds (its keys and value
    types written out below from the reference's source, since the
    reference's call runs its jitted back half), each value equal to one
    built from the reference's scalar path, fp64 within ``rtol=1e-12``;
  * the CLI prints and returns that record, and every entry point raises
    without a card unless asked for the CPU.
"""

import contextlib
import dataclasses
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import configs as RCF
from repro.core import sram as RS
from repro.core import workloads as RW
from repro.launch import roofline as RR
from repro.launch import system as RSY
from repro.models.config import SHAPES as R_SHAPES
from repro_torch import configs as PCF
from repro_torch.core import workloads as PW
from repro_torch.launch import roofline as PR
from repro_torch.launch import system as PSY
from repro_torch.models.config import SHAPES
from test_torch_workloads import RTOL, reference_price, reference_tiles

CPU = "cpu"
REPO = pathlib.Path(__file__).resolve().parents[1]
HBM_SWEEP = (4e11, 8e11, 1.6e12)
#: the keys of the reference's `compare_system` record and of its parts
#: (`src/repro/launch/system.py`, `SystemResult.as_dict`, `baseline_cost`,
#: the ``bw_sweep`` arrays)
RECORD_KEYS = {
    "arch", "shape", "mode", "discipline", "macs_per_token", "tiles_per_token",
    "ops_per_token", "conserved", "rcim", "baseline",
    "energy_ratio_rcim_over_accel", "latency_ratio_rcim_over_accel", "bw_sweep",
}
RCIM_KEYS = {
    "arch", "shape", "n_units", "winners", "tile_energy_nj", "tile_latency_ns",
    "tiles_per_token", "per_layer", "energy_per_token_j", "latency_per_token_s",
}
BASELINE_KEYS = {
    "accel", "flops_per_token", "hbm_bytes_per_token", "link_bytes_per_token",
    "latency_per_token_s", "energy_per_token_j", "bottleneck", "compute_s",
    "memory_s", "collective_s",
}
SWEEP_KEYS = {"compute_s", "memory_s", "collective_s", "token_s", "bottleneck",
              "hbm_bw", "link_bw"}


def reference_terms(cost, hbm_bw, link_bw, peak_flops, monkeypatch):
    """`roofline_terms` of the reference at one bandwidth point (its rates
    are module constants, set here for the point)."""
    monkeypatch.setattr(RR, "PEAK_FLOPS", peak_flops)
    monkeypatch.setattr(RR, "HBM_BW", hbm_bw)
    monkeypatch.setattr(RR, "LINK_BW", link_bw)
    coll = RR.CollectiveStats(total_link_bytes=cost["link_bytes"])
    return RR.roofline_terms({"flops": cost["flops"], "bytes accessed": cost["hbm_bytes"]},
                             coll, n_chips=1, model_flops_total=1.0)


def assert_same(got, want, path="record"):
    """Same structure and value types; floats within ``RTOL``, the rest
    exact."""
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=path)
    else:
        assert got == want, path


# ----------------------------- the baseline ---------------------------------


def test_baseline_model_is_the_reference_modelling_constants():
    assert dataclasses.asdict(PSY.DEFAULT_ACCEL) == dataclasses.asdict(RSY.DEFAULT_ACCEL)
    assert (PR.PEAK_FLOPS, PR.HBM_BW, PR.LINK_BW) == (RR.PEAK_FLOPS, RR.HBM_BW, RR.LINK_BW)
    assert PSY.BOTTLENECKS == RSY.BOTTLENECKS


@pytest.mark.parametrize("arch,shape", RCF.runnable_cells())
def test_token_costs_equal_the_reference(arch, shape):
    cfg, ref_cfg = PCF.get_config(arch), RCF.get_config(arch)
    assert PSY.token_cost(cfg, SHAPES[shape]) == RSY.token_cost(ref_cfg, R_SHAPES[shape])
    assert PR.model_flops(cfg, SHAPES[shape]) == RR.model_flops(ref_cfg, R_SHAPES[shape])
    rng = np.random.default_rng(RCF.runnable_cells().index((arch, shape)))
    flops, hbm, link = rng.uniform(1e9, 1e14, 3)
    rec = dict(n_chips=int(rng.integers(1, 9)),
               roofline=dict(flops=flops, hbm_bytes=hbm, link_bytes=link))
    assert (PSY.token_cost_from_dryrun(rec, SHAPES[shape])
            == RSY.token_cost_from_dryrun(rec, R_SHAPES[shape]))


def test_collective_bytes_equal_the_reference():
    hlo = "\n".join([
        "ar = f32[1024,512] all-reduce(x), replica_groups=[2,4]<=[8]",
        "ag = bf16[64,128] all-gather(y), replica_groups={{0,1,2,3}}",
        "rs = f32[32] reduce-scatter(z), replica_groups=[4,2]<=[8]",
        "a2a = s8[4096] all-to-all(w)",
        "cp = (f32[16], u32[8]) collective-permute-start(v)",
        "cpd = f32[16] collective-permute-done(cp)",
    ])
    got, want = PR.collective_bytes(hlo, 8), RR.collective_bytes(hlo, 8)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.n_ops == 5


# ---------------------------- roofline sweep --------------------------------


def test_sweep_roofline_matches_roofline_terms(monkeypatch):
    rng = np.random.default_rng(7)
    cost = dict(flops=float(rng.uniform(1e10, 1e13)), hbm_bytes=float(rng.uniform(1e8, 1e10)),
                link_bytes=float(rng.uniform(1e7, 1e10)))
    hbm = rng.uniform(1e11, 4e12, 9)
    link = rng.uniform(1e10, 4e11, 9)
    peak = float(rng.uniform(1e14, 1e15))
    out = PSY.sweep_roofline(cost, hbm_bw=hbm, link_bw=link, peak_flops=peak, device=CPU)
    assert set(out) == SWEEP_KEYS
    assert out["bottleneck"].dtype == np.int64 and out["token_s"].dtype == np.float64
    for i in range(len(hbm)):
        ref = reference_terms(cost, hbm[i], link[i], peak, monkeypatch)
        for k in ("compute_s", "memory_s", "collective_s"):
            np.testing.assert_allclose(out[k][i], getattr(ref, k), rtol=RTOL)
        np.testing.assert_allclose(
            out["token_s"][i], max(ref.compute_s, ref.memory_s, ref.collective_s), rtol=RTOL)
        assert PSY.BOTTLENECKS[out["bottleneck"][i]] == ref.bottleneck
    np.testing.assert_array_equal(out["hbm_bw"], hbm)
    np.testing.assert_array_equal(out["link_bw"], link)


@pytest.mark.parametrize("hbm,link,shape", [
    (8e11, 5e10, (1,)),
    ([4e11, 8e11, 1.6e12, 3.2e12, 6.4e12], 5e10, (5,)),
    (8e11, [1e10, 2e10, 4e10, 8e10], (4,)),
    ([4e11, 8e11, 1.6e12], [1e10, 0.0, 4e10], (3,)),
])
def test_sweep_roofline_broadcasts_hbm_against_link(hbm, link, shape):
    cost = dict(flops=1e12, hbm_bytes=1e9, link_bytes=5e9)
    out = PSY.sweep_roofline(cost, hbm_bw=hbm, link_bw=link, device=CPU)
    for k in SWEEP_KEYS:
        assert out[k].shape == shape, k
    want_hbm, want_link = np.broadcast_arrays(np.atleast_1d(hbm), np.atleast_1d(link))
    np.testing.assert_array_equal(out["hbm_bw"], want_hbm)
    np.testing.assert_array_equal(out["link_bw"], want_link)
    np.testing.assert_array_equal(out["memory_s"], 1e9 / want_hbm)


def test_sweep_roofline_refuses_shapes_that_do_not_broadcast():
    with pytest.raises(ValueError):
        PSY.sweep_roofline(dict(flops=1.0, hbm_bytes=1.0, link_bytes=1.0),
                           hbm_bw=[1e11, 2e11], link_bw=[1e10, 2e10, 3e10], device=CPU)


def test_sweep_roofline_zero_link_bw_is_single_chip():
    cost = dict(flops=1e12, hbm_bytes=1e9, link_bytes=5e9)
    out = PSY.sweep_roofline(cost, hbm_bw=8e11, link_bw=0.0, device=CPU)
    assert out["collective_s"][0] == 0.0
    assert PSY.BOTTLENECKS[out["bottleneck"][0]] == "compute"
    out2 = PSY.sweep_roofline(cost, hbm_bw=8e11, link_bw=5e10, device=CPU)
    np.testing.assert_allclose(out2["collective_s"][0], 0.1, rtol=RTOL)
    assert PSY.BOTTLENECKS[out2["bottleneck"][0]] == "collective"


@pytest.mark.parametrize("flops,hbm_bytes,link_bytes,want", [
    (2e14, 1.6e12, 0.0, "compute"),     # compute == memory: the first wins
    (1e14, 1.6e12, 1e11, "memory"),     # memory == collective > compute
    (2e14, 1.6e12, 1e11, "compute"),    # all three equal
    (1e14, 1.6e12, 2e11, "collective"),
])
def test_sweep_roofline_bottleneck_ties_go_to_the_first(flops, hbm_bytes, link_bytes,
                                                         want, monkeypatch):
    cost = dict(flops=flops, hbm_bytes=hbm_bytes, link_bytes=link_bytes)
    out = PSY.sweep_roofline(cost, hbm_bw=8e11, link_bw=5e10, peak_flops=1e14, device=CPU)
    assert PSY.BOTTLENECKS[out["bottleneck"][0]] == want
    assert reference_terms(cost, 8e11, 5e10, 1e14, monkeypatch).bottleneck == want


def test_sweep_roofline_monotonicity():
    cost = PSY.token_cost(PCF.get_config("qwen1.5-4b"), SHAPES["decode_32k"])
    out1 = PSY.sweep_roofline(cost, hbm_bw=np.linspace(2e11, 2e12, 7), device=CPU)
    out2 = PSY.sweep_roofline(cost, hbm_bw=np.linspace(3e11, 3e12, 7), device=CPU)
    assert np.all(np.diff(out1["memory_s"]) < 0)  # more BW -> less time
    assert np.all(out1["token_s"] >= out1["memory_s"])
    assert np.all(out2["compute_s"] == out1["compute_s"])  # flops unchanged


# --------------------------- end-to-end compare -----------------------------


@pytest.fixture(scope="module")
def scalar_tiles():
    """The reference's scalar path over the 12 topologies, at
    `compare_system`'s defaults (physical mode, list discipline)."""
    topos = list(RS.TOPOLOGY_LIBRARY)
    return reference_tiles(topos, RS.EnergyModel(), "physical", "list"), [t.name for t in topos]


def reference_record(arch, shape, tiles, names, monkeypatch):
    """The reference's `compare_system` record, built from its lowering,
    its scalar back half and `roofline_terms` (its own call runs the
    jitted back half)."""
    accel = RSY.DEFAULT_ACCEL
    lowered = RW.lower_config(RCF.get_config(arch), R_SHAPES[shape])
    cons = RW.conservation_report(lowered)
    per_layer, total_e, total_t = reference_price(lowered, tiles, 8192)
    rcim = dict(
        arch=arch, shape=shape, n_units=8192,
        winners={p: names[i] for p, (i, _, _) in tiles.items()},
        tile_energy_nj={p: float(e) for p, (_, e, _) in tiles.items()},
        tile_latency_ns={p: float(t) for p, (_, _, t) in tiles.items()},
        tiles_per_token={k: int(v) for k, v in lowered.tiles_per_token().items()},
        per_layer=per_layer, energy_per_token_j=total_e, latency_per_token_s=total_t,
    )
    cost = RSY.token_cost(RCF.get_config(arch), R_SHAPES[shape], accel)
    terms = reference_terms(cost, accel.hbm_bw, accel.link_bw, accel.peak_flops, monkeypatch)
    base = dict(
        accel=accel.name, flops_per_token=cost["flops"],
        hbm_bytes_per_token=cost["hbm_bytes"], link_bytes_per_token=cost["link_bytes"],
        latency_per_token_s=max(terms.compute_s, terms.memory_s, terms.collective_s),
        energy_per_token_j=(cost["flops"] * accel.pj_per_flop
                            + cost["hbm_bytes"] * accel.pj_per_hbm_byte
                            + cost["link_bytes"] * accel.pj_per_link_byte) * 1e-12,
        bottleneck=terms.bottleneck, compute_s=terms.compute_s,
        memory_s=terms.memory_s, collective_s=terms.collective_s,
    )
    sweep = {k: [] for k in SWEEP_KEYS}
    for bw in HBM_SWEEP:
        t = reference_terms(cost, bw, accel.link_bw, accel.peak_flops, monkeypatch)
        for k in ("compute_s", "memory_s", "collective_s"):
            sweep[k].append(getattr(t, k))
        sweep["token_s"].append(max(t.compute_s, t.memory_s, t.collective_s))
        sweep["bottleneck"].append(RSY.BOTTLENECKS.index(t.bottleneck))
        sweep["hbm_bw"].append(bw)
        sweep["link_bw"].append(accel.link_bw)
    return dict(
        arch=arch, shape=shape, mode="physical", discipline="list",
        macs_per_token=int(lowered.macs_per_token()),
        tiles_per_token={k: int(v) for k, v in lowered.tiles_per_token().items()},
        ops_per_token={k: int(v) for k, v in cons["ops_per_token"].items()},
        conserved=bool(cons["ok"]), rcim=rcim, baseline=base,
        energy_ratio_rcim_over_accel=total_e / base["energy_per_token_j"],
        latency_ratio_rcim_over_accel=total_t / base["latency_per_token_s"],
        bw_sweep=sweep,
    )


@pytest.mark.parametrize("arch,shape", RCF.runnable_cells())
def test_compare_system_equals_the_reference_record(arch, shape, scalar_tiles, monkeypatch):
    rec = PSY.compare_system(arch, shape, hbm_bw_sweep=HBM_SWEEP, device=CPU)
    assert set(rec) == RECORD_KEYS
    assert set(rec["rcim"]) == RCIM_KEYS and set(rec["baseline"]) == BASELINE_KEYS
    assert set(rec["bw_sweep"]) == SWEEP_KEYS
    assert_same(rec, reference_record(arch, shape, *scalar_tiles, monkeypatch))
    assert rec["conserved"]
    mem = rec["bw_sweep"]["memory_s"]
    assert all(a > b for a, b in zip(mem, mem[1:]))
    assert json.loads(json.dumps(rec)) == rec


def test_main_prints_and_returns_the_record():
    argv = ["--arch", "gemma3-27b", "--shape", "decode_32k", "--device", "cpu",
            "--hbm-sweep", *map(str, HBM_SWEEP)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rec = PSY.main(argv)
    assert json.loads(buf.getvalue()) == rec
    assert rec == PSY.compare_system("gemma3-27b", "decode_32k", hbm_bw_sweep=list(HBM_SWEEP),
                                     device=CPU)


def test_module_runs_as_a_script_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.system", "--arch", "whisper-tiny",
         "--shape", "train_4k", "--device", "cpu", "--hbm-sweep", "4e11", "8e11"],
        capture_output=True, text=True, env=env, timeout=120, check=True,
    )
    rec = json.loads(out.stdout)
    assert (rec["arch"], rec["shape"], rec["conserved"]) == ("whisper-tiny", "train_4k", True)
    assert len(rec["bw_sweep"]["memory_s"]) == 2


ENTRY_POINTS = {
    "evaluate_lowered": lambda: PW.evaluate_lowered(
        PW.lower_config(PCF.get_config("mamba2-780m"), SHAPES["decode_32k"])),
    "sweep_roofline": lambda: PSY.sweep_roofline(dict(flops=1.0, hbm_bytes=1.0, link_bytes=0.0)),
    "baseline_cost": lambda: PSY.baseline_cost(dict(flops=1.0, hbm_bytes=1.0, link_bytes=0.0)),
    "compare_system": lambda: PSY.compare_system("mamba2-780m"),
    "main": lambda: PSY.main(["--arch", "mamba2-780m"]),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_raise_without_a_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[entry]()
