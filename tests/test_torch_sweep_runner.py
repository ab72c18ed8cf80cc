"""The port's journaled, resumable sweeps (`repro_torch.core.sweep_runner`
on `repro_torch.ckpt.manager`), on the CPU.

Ports tests/test_sweep_runner.py: a sweep killed mid-run — by an
injected crash or a real SIGKILL of the CLI — resumes from its journal
and assembles a `SelectionResult` equal field for field to an
uninterrupted fused suite pass over the same suite.  Torn journal
entries are evicted and redone, entries of another sweep are ignored,
quarantined circuits are reported, and a `KernelError` is never
quarantined.  Against the reference package:

  * each (circuit, variant) row of a Monte-Carlo sweep equals the
    reference's scalar Algorithm I under that variant's model (winner
    cell exact, metrics at ``rtol=1e-12``);
  * a journal written by either package's `CheckpointManager` loads in
    the other's (arrays and meta equal);
  * the port's `sweep_config_key` differs from the reference's for the
    same inputs, so neither adopts the other's shards.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro.core import circuits as RC
from repro.core import explorer as RE
from repro.core import sram as RS
from repro.core.transforms import characterize_suite as r_characterize_suite
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.core.batch import SuiteTable, TopologyTable, evaluate_select_suite
from repro_torch.core.circuits import benchmark_suite
from repro_torch.core.explorer import _opt_and_feasible, _restrict_cha
from repro_torch.core.sram import TOPOLOGY_LIBRARY
from repro_torch.core.sweep_runner import run_sweep, sweep_config_key
from repro_torch.core.transforms import characterize_suite
from repro_torch.core import interop
from repro_torch.kernels import aig_sim as PA
from repro_torch.kernels.build import KernelError, OperandError
from repro_torch.runtime import faults

CPU = "cpu"
CIRCUITS = ["adder", "bar", "max", "sqrt"]
RECIPES = [(), ("Rw",), ("Ba", "Rw"), ("Rf",)]
TOPOS = list(TOPOLOGY_LIBRARY[:5])
TOPOS_REF = list(RS.TOPOLOGY_LIBRARY[:5])
REPO = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True)
def _disarmed():
    faults.disable()
    yield
    faults.disable()


@pytest.fixture(scope="module")
def suite_circuits():
    return benchmark_suite("tiny", only=CIRCUITS)


@pytest.fixture(scope="module")
def cha_cache(tmp_path_factory, suite_circuits):
    """Warm on-disk characterization cache shared by every run in this
    module, so repeated runs skip the front half."""
    root = tmp_path_factory.mktemp("cha")
    characterize_suite(suite_circuits, RECIPES, cache=root, n_jobs=1, device=CPU)
    return root


def sweep(suite_circuits, cha_cache, **kw):
    kw.setdefault("journal_dir", None)
    kw.setdefault("shard_size", 2)
    return run_sweep(suite_circuits, sram_list=TOPOS, recipes=RECIPES, cache=cha_cache,
                     n_jobs=1, device=CPU, **kw)


def direct_selection(suite_circuits, cha_cache):
    """The uninterrupted reference: one unsharded fused suite call."""
    cha = characterize_suite(suite_circuits, RECIPES, cache=cha_cache, n_jobs=1, device=CPU)
    cha = {n: _restrict_cha(cha[n], RECIPES) for n in cha}
    feas = np.zeros((len(cha), len(TOPOS)), dtype=bool)
    for i, n in enumerate(cha):
        _, _, f = _opt_and_feasible(cha[n], TOPOS)
        feas[i] = [t in f for t in TOPOS]
    _, sel = evaluate_select_suite(
        SuiteTable.from_cha(cha), TopologyTable.from_topologies(TOPOS), None,
        feasible=feas, device=CPU,
    )
    return sel


@pytest.fixture(scope="module")
def direct(suite_circuits, cha_cache):
    return direct_selection(suite_circuits, cha_cache)


def assert_selection_equal(sel, ref, circuits=None, ref_names=None):
    """Field-for-field bit-identity (optionally on a circuit subset)."""
    rows = slice(None) if circuits is None else [ref_names.index(c) for c in circuits]
    assert sel.winner_idx.dtype == ref.winner_idx.dtype
    assert np.array_equal(sel.winner_idx, ref.winner_idx[rows])
    assert np.array_equal(sel.nominal_latency_ns, ref.nominal_latency_ns[rows])
    assert np.array_equal(sel.nominal_fits, ref.nominal_fits[rows])
    for k, v in ref.winner_metrics.items():
        assert np.array_equal(sel.winner_metrics[k], v[rows]), k
    if circuits is None:
        assert sel.payload_bytes == ref.payload_bytes


@pytest.mark.parametrize("shard_size", [1, 2, 3, None])
def test_sharded_parity_without_journal(suite_circuits, cha_cache, direct, shard_size):
    out = sweep(suite_circuits, cha_cache, shard_size=shard_size)
    assert out.circuits == tuple(CIRCUITS)
    assert out.shards_resumed == 0 and out.journal_dir is None
    assert_selection_equal(out.selection, direct)


def test_injected_crash_then_resume_bit_identical(tmp_path, suite_circuits, cha_cache, direct):
    journal = tmp_path / "j"
    with faults.injected(faults.FaultRule("sweep.shard", "raise", after=1)):
        with pytest.raises(faults.FaultError):
            sweep(suite_circuits, cha_cache, journal_dir=journal)
    assert len(CheckpointManager(str(journal)).steps()) == 1
    out = sweep(suite_circuits, cha_cache, journal_dir=journal)
    assert out.shards_resumed == 1 and out.shards_run == 1
    assert_selection_equal(out.selection, direct)


def test_resume_with_different_shard_size(tmp_path, suite_circuits, cha_cache, direct):
    journal = tmp_path / "j"
    with faults.injected(faults.FaultRule("sweep.shard", "raise", after=1)):
        with pytest.raises(faults.FaultError):
            sweep(suite_circuits, cha_cache, journal_dir=journal, shard_size=1)
    out = sweep(suite_circuits, cha_cache, journal_dir=journal, shard_size=3)
    assert out.shards_resumed == 1
    assert_selection_equal(out.selection, direct)


def test_corrupt_journal_entry_is_evicted_and_redone(tmp_path, suite_circuits, cha_cache, direct):
    journal = tmp_path / "j"
    out = sweep(suite_circuits, cha_cache, journal_dir=journal)
    assert out.shards_run == 2
    CheckpointManager(str(journal)).wait()
    wal = journal / "journal.wal"
    wal.write_bytes(wal.read_bytes()[:-5])  # tear the tail record
    out2 = sweep(suite_circuits, cha_cache, journal_dir=journal)
    assert out2.shards_resumed == 1 and out2.shards_run == 1
    assert_selection_equal(out2.selection, direct)


def test_torn_write_via_journal_fault_recovers(tmp_path, suite_circuits, cha_cache, direct):
    journal = tmp_path / "j"
    with faults.injected(faults.FaultRule("journal.write", "corrupt")):
        sweep(suite_circuits, cha_cache, journal_dir=journal)
        # publishes are async: keep the rule armed until they are on disk
        CheckpointManager(str(journal)).wait()
    out = sweep(suite_circuits, cha_cache, journal_dir=journal)
    assert out.shards_run == 1  # the torn shard was redone
    assert_selection_equal(out.selection, direct)


def test_mismatched_config_entries_are_ignored(tmp_path, suite_circuits, cha_cache, direct):
    journal = tmp_path / "j"
    other = [(), ("Rw",)]
    run_sweep(suite_circuits, journal_dir=journal, shard_size=2, sram_list=TOPOS,
              recipes=other, cache=cha_cache, n_jobs=1, device=CPU)
    out = sweep(suite_circuits, cha_cache, journal_dir=journal)
    assert out.shards_resumed == 0 and out.shards_run == 2
    assert_selection_equal(out.selection, direct)
    assert sweep_config_key(
        suite_circuits, RECIPES, TOPOS, None, "physical", "list", None
    ) != sweep_config_key(suite_circuits, other, TOPOS, None, "physical", "list", None)


def test_quarantined_circuit_is_reported_not_fatal(suite_circuits, cha_cache, direct):
    with faults.injected(faults.FaultRule("cha.backend", "raise", match=":bar")):
        out = sweep(suite_circuits, cha_cache)
    assert set(out.failures) == {"bar"}
    assert out.circuits == tuple(c for c in CIRCUITS if c != "bar")
    assert_selection_equal(out.selection, direct, circuits=out.circuits, ref_names=CIRCUITS)


def test_kernel_error_is_never_quarantined(tmp_path, suite_circuits, monkeypatch):
    def broken(*a, **kw):
        raise KernelError("eval_mega: CUDA error 700 at launch")

    monkeypatch.setattr(PA, "eval_tts", broken)
    failures_seen = []
    with pytest.raises(KernelError):
        out = run_sweep(suite_circuits, journal_dir=tmp_path / "j", sram_list=TOPOS,
                        recipes=RECIPES, cache=tmp_path / "cold", n_jobs=1, device=CPU)
        failures_seen.append(out.failures)
    assert not failures_seen


def test_operand_refusal_is_never_quarantined(tmp_path, suite_circuits, monkeypatch):
    """K1's packer handing the wrapper a chunk table it refuses: the real
    host check's `OperandError` raises out of the sweep."""
    pack = PA._pack_mega

    def corrupt(*a, **kw):
        batch = pack(*a, **kw)
        meta = batch.meta.copy()
        meta[0, 0] = -1
        return dataclasses.replace(batch, meta=meta)

    monkeypatch.setattr(PA, "_pack_mega", corrupt)
    failures_seen = []
    with pytest.raises(OperandError, match="negative"):
        out = run_sweep(suite_circuits, journal_dir=tmp_path / "j", sram_list=TOPOS,
                        recipes=RECIPES, cache=tmp_path / "cold", n_jobs=1, device=CPU)
        failures_seen.append(out.failures)
    assert not failures_seen


def port_table(table):
    fields = {f: getattr(table, f) for f in interop.model_table_fields()}
    return interop.model_table_from_arrays(table.names, fields, table.topology_names)


@pytest.mark.parametrize("max_lat", [None, 30.0])
def test_monte_carlo_rows_match_per_variant_reference_runs(tmp_path, suite_circuits, cha_cache,
                                                           max_lat):
    """Every (circuit, variant) row of a journaled, resumed 8-variant sweep
    against the reference's scalar Algorithm I under that variant."""
    table = RS.ModelTable.monte_carlo(n=8, sigma=0.1, seed=0)
    model = port_table(table)
    kw = dict(journal_dir=tmp_path / "j", model=model, max_latency_ns=max_lat)
    with faults.injected(faults.FaultRule("sweep.shard", "raise", after=1)):
        with pytest.raises(faults.FaultError):
            sweep(suite_circuits, cha_cache, **kw)
    out = sweep(suite_circuits, cha_cache, **kw)
    assert out.shards_resumed == 1
    sel = out.selection
    assert sel.winner_idx.shape == (len(CIRCUITS), 8)
    ref_suite = RC.benchmark_suite("tiny", only=CIRCUITS)
    ref_cha = r_characterize_suite(ref_suite, RECIPES, n_jobs=1, backend="python")
    n_r = len(RECIPES)
    for v in range(8):
        runs = RE.explore_suite(ref_suite, TOPOS_REF, recipes=RECIPES, cha=ref_cha,
                                model=table.model(v), max_latency_ns=max_lat,
                                backend="python", n_jobs=1)
        for c, name in enumerate(CIRCUITS):
            best = runs[name].best
            ti, ri = divmod(int(sel.winner_idx[c, v]), n_r)
            assert (RECIPES[ri], TOPOS[ti].name) == (tuple(best.recipe), best.topo.name)
            for k in ("energy_nj", "latency_ns", "power_mw"):
                np.testing.assert_allclose(sel.winner_metrics[k][c, v],
                                           getattr(best.metrics, k), rtol=1e-12)


# ---------------------------------------------------------------------------
# The journal across the two packages
# ---------------------------------------------------------------------------


def test_journal_reads_across_packages(tmp_path, suite_circuits, cha_cache, direct):
    from repro.ckpt import manager as RM  # imports jax

    arrays = {
        "winner_idx": np.arange(6, dtype=np.int32).reshape(2, 3),
        "nominal_latency_ns": np.linspace(1.0, 2.0, 6).reshape(2, 3),
        "nominal_fits": np.array([True, False]),
    }
    meta = dict(config="abc", circuits=["x", "y"], n_variants=3, sharded=False)
    # reference writes, port reads
    ref_dir = tmp_path / "ref"
    w = RM.CheckpointManager(str(ref_dir), keep_n=1 << 30, wal=True, defer_snapshot=True)
    w.save(0, arrays, meta=meta)
    w.wait()
    got, head = CheckpointManager(str(ref_dir)).load_arrays(0)
    assert head["meta"] == meta and sorted(got) == sorted(arrays)
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v)
    # port writes (device tensors and numpy), reference reads
    port_dir = tmp_path / "port"
    w = CheckpointManager(str(port_dir), keep_n=1 << 30, wal=True, defer_snapshot=True)
    w.save(0, {k: torch.from_numpy(v) for k, v in arrays.items()}, meta=meta)
    w.wait()
    got, head = RM.CheckpointManager(str(port_dir)).load_arrays(0)
    assert head["meta"] == meta
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v)
    # the two frames hold the same header (but for the publish time) and
    # the same payload bytes
    frames = []
    for path in (ref_dir / "journal.wal", port_dir / "journal.wal"):
        blob = path.read_bytes()
        assert blob.startswith(b"RJRNL1\n")
        hlen = int.from_bytes(blob[7:11], "little")
        head = json.loads(blob[11:11 + hlen])
        head.pop("time")
        frames.append((head, blob[11 + hlen:]))
    assert frames[0] == frames[1]
    # a whole journaled sweep of the port reads back in the reference's manager
    journal = tmp_path / "sweep"
    out = sweep(suite_circuits, cha_cache, journal_dir=journal)
    CheckpointManager(str(journal)).wait()
    ref_mgr = RM.CheckpointManager(str(journal))
    assert ref_mgr.steps() == [0, 1]
    rows = {}
    for step in ref_mgr.steps():
        got, head = ref_mgr.load_arrays(step)
        assert head["meta"]["config"] == out.config_key
        for i, name in enumerate(head["meta"]["circuits"]):
            rows[name] = {k: v[i] for k, v in got.items()}
    for c, name in enumerate(CIRCUITS):
        assert np.array_equal(rows[name]["winner_idx"], direct.winner_idx[c])
        assert np.array_equal(rows[name]["met_energy_nj"], direct.winner_metrics["energy_nj"][c])


def test_config_key_differs_from_the_reference(suite_circuits):
    from repro.core import sweep_runner as RSR

    ref_circuits = RC.benchmark_suite("tiny", only=CIRCUITS)
    for model_kw in ({}, {"ref": RS.ModelTable.monte_carlo(n=4, seed=1)}):
        ref_model = model_kw.get("ref")
        port_model = None if ref_model is None else port_table(ref_model)
        mine = sweep_config_key(suite_circuits, RECIPES, TOPOS, port_model, "physical",
                                "list", None)
        theirs = RSR.sweep_config_key(ref_circuits, RECIPES, TOPOS_REF, ref_model,
                                      "physical", "list", None)
        assert mine != theirs
        assert mine == sweep_config_key(suite_circuits, RECIPES, TOPOS, port_model,
                                        "physical", "list", None)


def test_restore_moves_arrays_to_the_device_asked_for(tmp_path, monkeypatch):
    tree = {"w": torch.arange(6, dtype=torch.float64).reshape(2, 3),
            "s": [torch.tensor(3, dtype=torch.int32), torch.ones(2, dtype=torch.bfloat16)]}
    m = CheckpointManager(str(tmp_path), async_save=False)
    m.save(7, tree, meta={"k": 1})
    back, meta = m.restore(tree, device=CPU)
    assert meta["meta"] == {"k": 1}
    for a, b in zip((back["w"], *back["s"]), (tree["w"], *tree["s"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        m.restore(tree)


@pytest.mark.parametrize("wal,n,layout", [(True, 64, "wal"), (False, 64, "file"),
                                          (False, 1100, "dir")])
def test_deferred_snapshot_restores_bit_equal_in_each_layout(tmp_path, wal, n, layout):
    """Host tensors saved with ``defer_snapshot`` (snapshotted on the
    writer thread) restore bit-equal in each on-disk layout, bfloat16 and
    fp8 through their unsigned integer views."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(n, n, generator=g)
    tree = {"f32": a, "bf16": (3 * a).to(torch.bfloat16), "fp8": a.to(torch.float8_e4m3fn),
            "s": [torch.tensor(7, dtype=torch.int32)]}
    m = CheckpointManager(str(tmp_path), wal=wal, defer_snapshot=True)
    m.save(0, tree, meta={"n": n})
    m.wait()
    step = tmp_path / "step_0"
    assert {"wal": not step.exists(), "file": step.is_file(), "dir": step.is_dir()}[layout]
    back, meta = m.restore(tree, device=CPU)
    assert meta["meta"] == {"n": n}
    for got, want in ((back["f32"], a), (back["bf16"], tree["bf16"]),
                      (back["fp8"], tree["fp8"]), (back["s"][0], tree["s"][0])):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.reshape(-1).view(torch.uint8), want.reshape(-1).view(torch.uint8))


def test_wal_restores_bfloat16_without_ml_dtypes(tmp_path):
    """numpy knows no ``bfloat16`` unless ``ml_dtypes`` (which jax
    imports) registered it.  The port runs without jax, so a bfloat16 or
    fp8 leaf of the log layout must restore through its unsigned view
    alone; checked in a fresh interpreter that imports only the port."""
    code = (
        "import sys, torch\n"
        "from repro_torch.ckpt.manager import CheckpointManager\n"
        "tree = {'b': torch.arange(6, dtype=torch.float32).to(torch.bfloat16),\n"
        "        'f': torch.ones(3).to(torch.float8_e5m2)}\n"
        f"m = CheckpointManager({str(tmp_path)!r}, async_save=False, wal=True)\n"
        "m.save(0, tree)\n"
        "back, _ = m.restore(tree, device='cpu')\n"
        "assert 'ml_dtypes' not in sys.modules\n"
        "assert all(torch.equal(back[k].view(torch.uint8), tree[k].view(torch.uint8))\n"
        "           for k in tree)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"), env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


# ---------------------------------------------------------------------------
# SIGKILL a subprocess sweep mid-shard, resume, compare.
# ---------------------------------------------------------------------------


CLI_ARGS = [
    "--circuits", "adder,bar,max", "--scale", "tiny",
    "--recipes", ";Rw", "--topos", "3", "--device", "cpu",
]


def _cli(journal, out, shard_size, cache, **popen_kw):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src"), env.get("PYTHONPATH", "")]
    )
    env.pop("REPRO_FAULTS", None)
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.core.sweep_runner",
         "--journal", str(journal), "--out", str(out),
         "--shard-size", str(shard_size), "--cache", str(cache), *CLI_ARGS],
        env=env, **popen_kw,
    )


def test_sigkill_mid_sweep_then_resume_bit_identical(tmp_path):
    journal = tmp_path / "j"
    cache = tmp_path / "cha"
    killed_out = tmp_path / "killed.npz"

    # Launch a 3-shard sweep and SIGKILL it the moment shard 0 publishes.
    proc = _cli(journal, killed_out, 1, cache, stdout=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 300
        line = ""
        while time.time() < deadline:
            line = proc.stdout.readline()
            if "shard 0 done" in line:
                break
        assert "shard 0 done" in line, "sweep never published a shard"
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == -signal.SIGKILL
    assert not killed_out.exists()
    published = len(CheckpointManager(str(journal)).steps())
    assert 1 <= published < 3

    # Resume to completion; run an uninterrupted single-shard reference.
    resumed_out = tmp_path / "resumed.npz"
    assert _cli(journal, resumed_out, 1, cache).wait(600) == 0
    ref_out = tmp_path / "ref.npz"
    assert _cli(tmp_path / "j2", ref_out, 3, cache).wait(600) == 0

    a, b = np.load(resumed_out), np.load(ref_out)
    assert int(a["shards_resumed"]) >= 1
    for key in b.files:
        if key in ("shards_run", "shards_resumed"):
            continue
        assert np.array_equal(a[key], b[key]), key


def test_exit_waits_for_in_flight_publishes(tmp_path):
    """A process that returns from a journaled sweep and exits at once
    exits cleanly with every shard on disk: the writer drains at exit
    (a daemon writer cut off mid-publish by interpreter shutdown lost
    that shard and could abort the process).  The last publish is held
    0.3 s by a hang rule, so it is still in flight at exit."""
    script = (
        "import sys\n"
        "from repro_torch.core.circuits import benchmark_suite\n"
        "from repro_torch.core.sram import TOPOLOGY_LIBRARY\n"
        "from repro_torch.core.sweep_runner import run_sweep\n"
        "c = benchmark_suite('tiny', only=['adder', 'bar', 'max'])\n"
        "run_sweep(c, sys.argv[1], 1, sram_list=TOPOLOGY_LIBRARY[:3],\n"
        "          recipes=[(), ('Rw',)], n_jobs=1, device='cpu')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"), env.get("PYTHONPATH", "")])
    env["REPRO_FAULTS"] = "journal.write:hang::2:1:0.3"
    journal = tmp_path / "j"
    proc = subprocess.run([sys.executable, "-c", script, str(journal)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert CheckpointManager(str(journal)).steps() == [0, 1, 2]
