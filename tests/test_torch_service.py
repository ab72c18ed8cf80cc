"""The port's exploration service (`repro_torch.serve.explore_service`)
and its bucketing helpers, on the CPU, against the reference package.

The reference `ExplorationService` needs the jitted back half, which
does not run under every jax; these tests hold the port against what the
reference runs everywhere:

  * its numpy bucketing helpers (`ceil_pow2`, `bucket_levels`,
    `pad_suite`, `bucket_suite`) on the same characterization;
  * its scalar Algorithm I (``explore(..., backend="python")``) over the
    budget-restricted topology pool, metrics at ``rtol=1e-12``;
  * and the port's own `explore_request` (itself held against the
    reference in tests/test_torch_explorer.py), bit-equal: the service's
    winner cell comes from the same fused pass.

The rest ports tests/test_service.py and tests/test_service_faults.py:
cache fast paths (re-ranking runs no back-half pass and launches no
kernel), structured errors, close/shutdown, a threaded submit/cancel
run, deadlines, worker supervision and the python degradation rung —
plus the port's own rule that a `KernelError` is never served degraded.
Passive (``start=False``) mode keeps the counter assertions
deterministic; tiny circuits and four recipes keep the file fast.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

from repro.core import batch as RB
from repro.core.aig import AigStats as RAigStats
from repro.core import circuits as RC
from repro.core import explorer as RE
from repro.core import sram as RS
from repro.core.transforms import characterize_suite as r_characterize_suite
from repro_torch.core import batch as PB
from repro_torch.core import transforms as PT
from repro_torch.core.aig import Aig
from repro_torch.core.circuits import gen_adder, gen_max
from repro_torch.core.explorer import explore_request
from repro_torch.core.sram import TOPOLOGY_LIBRARY, ModelTable
from repro_torch.kernels import aig_sim as PA
from repro_torch.kernels import cim_logic as PK
from repro_torch.kernels.build import KernelError, OperandError
from repro_torch.runtime import faults
from repro_torch.serve import explore_service as ES
from repro_torch.serve.explore_service import ExplorationService, ExploreRequest

CPU = "cpu"
TOPOS = TOPOLOGY_LIBRARY[:5]
RECIPES = [(), ("Rw",), ("Ba", "Rw"), ("Rf",)]
KB1 = sorted(t.total_kb for t in TOPOS)[1]  # excludes some topologies
CONSTRAINTS = {
    "plain": {},
    "budget+latency": dict(max_memory_kb=KB1, max_latency_ns=200.0),
    "loose-latency": dict(max_latency_ns=1e6),
    "tight-latency": dict(max_latency_ns=25.0),
    "whole-library": dict(max_memory_kb=max(t.total_kb for t in TOPOS)),
    "budget+loose-latency": dict(max_memory_kb=KB1, max_latency_ns=1e3),
}


@pytest.fixture(autouse=True)
def _disarmed():
    faults.disable()
    yield
    faults.disable()


@pytest.fixture(scope="module")
def adder():
    return gen_adder(6)


@pytest.fixture(scope="module")
def maxc():
    return gen_max(6, 2)


@pytest.fixture(scope="module")
def svc():
    s = ExplorationService(sram_list=TOPOS, recipes=RECIPES, start=False, device=CPU)
    yield s
    s.close()


@pytest.fixture(scope="module")
def ref_cha():
    """The reference's python-backend characterization of the same
    circuits, for its scalar Algorithm I."""
    ref = {"adder": RC.gen_adder(6), "max": RC.gen_max(6, 2)}
    return ref, r_characterize_suite(ref, RECIPES, n_jobs=1, backend="python")


def _service(**kw):
    return ExplorationService(sram_list=TOPOS, recipes=RECIPES, device=CPU, **kw)


def nan_table() -> ModelTable:
    """A model sweep whose every variant yields non-finite energies."""
    t = ModelTable.monte_carlo(n=3, seed=0)
    return dataclasses.replace(
        t,
        e_op_fj=np.full_like(t.e_op_fj, np.nan),
        e_op_marginal_fj=np.full_like(t.e_op_marginal_fj, np.nan),
        e_macro_cycle_fj=np.full_like(t.e_macro_cycle_fj, np.nan),
        e_col_cycle_fj=np.full_like(t.e_col_cycle_fj, np.nan),
        writeback_fj_nonresonant=np.full_like(t.writeback_fj_nonresonant, np.nan),
    )


def offline(rtl, **kw):
    return explore_request(rtl, TOPOS, RECIPES, device=CPU, **kw)


def offline_winner_cell(off):
    """The offline winner's device-grid cell: the service's metrics come
    from the same fused pass, so equality here is bit-exact."""
    ti = off.grid.topologies.index(off.best.topo)
    ri = off.grid.recipes.index(tuple(off.best.recipe))
    return off.grid.cell(ti, ri)


def assert_same_winner(w, off):
    cell = offline_winner_cell(off)
    assert (w.recipe, w.topology) == (tuple(off.best.recipe), off.best.topo)
    for k in ("energy_nj", "latency_ns", "power_mw", "area_mm2"):
        assert getattr(w, k) == getattr(cell, k), k
    assert w.fits == cell.fits
    assert w.inductor_nh == off.inductor_nh


# ------------------------- bucket-shape helpers ----------------------------


def test_ceil_pow2_and_bucket_levels_match_reference():
    assert [PB.ceil_pow2(n) for n in range(0, 1001)] == [
        RB.ceil_pow2(n) for n in range(0, 1001)
    ]
    assert [PB.bucket_levels(n) for n in range(1, 1001)] == [
        RB.bucket_levels(n) for n in range(1, 1001)
    ]
    assert PB.bucket_levels(PB.LEVEL_PAD + 1) == 2 * PB.LEVEL_PAD
    assert PB.PAD_CIRCUIT_PREFIX == RB.PAD_CIRCUIT_PREFIX


def test_pad_and_bucket_suite_match_reference(adder, maxc):
    circuits = {"a": adder, "m": maxc, "a5": gen_adder(5)}
    cha = PT.characterize_suite(circuits, RECIPES, n_jobs=1, device=CPU)
    # the reference's tables from the same stats, through their plain form
    ref_cha = {n: {r: RAigStats.from_dict(s.to_dict()) for r, s in per.items()}
               for n, per in cha.items()}
    suite, ref_suite = PB.SuiteTable.from_cha(cha), RB.SuiteTable.from_cha(ref_cha)
    np.testing.assert_array_equal(suite.ops, ref_suite.ops)
    padded, bucket = PB.bucket_suite(suite, len(TOPOS), 1)
    ref_padded, ref_bucket = RB.bucket_suite(ref_suite, len(TOPOS), 1)
    assert bucket == ref_bucket == (4, len(RECIPES), padded.ops.shape[2], len(TOPOS), 1)
    assert padded.circuits == ref_padded.circuits
    assert padded.recipes == ref_padded.recipes
    for k in ("ops", "n_levels", "op_totals", "gates"):
        np.testing.assert_array_equal(getattr(padded, k), getattr(ref_padded, k))
        assert getattr(padded, k).dtype == getattr(ref_padded, k).dtype
    np.testing.assert_array_equal(padded.ops[3], padded.ops[0])
    assert PB.pad_suite(padded) is padded
    for kw in (dict(n_circuits=8, pad_levels_to=256), dict(n_circuits=5)):
        a, b = PB.pad_suite(suite, **kw), RB.pad_suite(ref_suite, **kw)
        assert a.circuits == b.circuits
        np.testing.assert_array_equal(a.ops, b.ops)
        np.testing.assert_array_equal(a.n_levels, b.n_levels)
        assert a.bucket_shape(len(TOPOS), 3) == b.bucket_shape(len(TOPOS), 3)
    with pytest.raises(ValueError):
        PB.pad_suite(suite, n_circuits=1)
    # each real circuit's result is bit-identical to its unpadded run
    topos = PB.TopologyTable.from_topologies(TOPOS)
    _, sel = PB.evaluate_select_suite(suite, topos, device=CPU)
    _, psel = PB.evaluate_select_suite(padded, topos, device=CPU)
    np.testing.assert_array_equal(psel.winner_idx[:3], sel.winner_idx)
    for k, v in sel.winner_metrics.items():
        np.testing.assert_array_equal(psel.winner_metrics[k][:3], v)


# ------------------------------- parity ------------------------------------


@pytest.mark.parametrize("name", list(CONSTRAINTS))
def test_winner_parity_with_explore_request_and_reference_scalar(svc, adder, ref_cha, name):
    kw = CONSTRAINTS[name]
    resp = svc.explore(adder, **kw)
    assert resp.ok, resp.error
    assert resp.fingerprint == adder.fingerprint() and resp.bucket is not None
    off = offline(adder, **kw)
    assert_same_winner(resp.winner, off)
    assert resp.winner.meets_latency == (
        "max_latency_ns" not in kw or resp.winner.latency_ns <= kw["max_latency_ns"]
    )
    # the reference's scalar Algorithm I over the budget-restricted pool
    ref_circuits, rcha = ref_cha
    pool = [t for t in RS.TOPOLOGY_LIBRARY[:5]
            if "max_memory_kb" not in kw or t.total_kb <= kw["max_memory_kb"]]
    ref = RE.explore(ref_circuits["adder"], pool, recipes=RECIPES, cha=rcha["adder"],
                     max_latency_ns=kw.get("max_latency_ns"), backend="python")
    assert resp.winner.recipe == tuple(ref.best.recipe)
    assert resp.winner.topology.name == ref.best.topo.name
    for k in ("energy_nj", "latency_ns", "power_mw", "area_mm2"):
        np.testing.assert_allclose(getattr(resp.winner, k), getattr(ref.best.metrics, k),
                                   rtol=1e-12)
    np.testing.assert_allclose(resp.winner.inductor_nh, ref.inductor_nh, rtol=1e-12)


def test_variation_parity(svc, maxc):
    table = ModelTable.monte_carlo(n=4, seed=2)
    resp = svc.explore(ExploreRequest(maxc, model_sweep=table, max_latency_ns=500.0))
    assert resp.ok, resp.error
    off = offline(maxc, model_sweep=table, max_latency_ns=500.0)
    v, vo = resp.variation, off.variation
    assert v.n_variants == 4
    assert list(v.winners) == [(tuple(r), t) for r, t in vo.winners]
    assert v.winner_share == vo.winner_share
    assert v.best_yield == vo.best_yield
    assert v.latency_yield == vo.latency_yield
    np.testing.assert_array_equal(v.winner_energy_nj, vo.winner_energy_nj)
    assert v.energy_quantiles == vo.energy_quantiles
    assert v.cvar() == vo.cvar()
    assert_same_winner(resp.winner, off)  # off.grid is the nominal variant


# --------------------------- cache fast paths ------------------------------


def test_cha_cache_hit_skips_front_half(adder, maxc, monkeypatch):
    calls = []
    real = ES.characterize_suite

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ES, "characterize_suite", counting)
    s = _service(start=False)
    r1 = s.explore(adder)
    assert r1.ok and not r1.cha_cache_hit
    n_after_first = len(calls)
    assert n_after_first >= 1
    r2 = s.explore(adder, max_latency_ns=1e6)
    r3 = s.explore(adder, max_memory_kb=1e9)
    assert r2.ok and r2.cha_cache_hit
    assert r3.ok and r3.cha_cache_hit
    assert len(calls) == n_after_first
    r4 = s.explore(maxc)
    assert r4.ok and not r4.cha_cache_hit
    assert len(calls) == n_after_first + 1
    s.close()


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts of the kernels' plain-version calls (what a wrapper runs on
    a CPU tensor) while the test runs."""
    counts = {"eval_mega": 0, "sig_eval": 0, "cim": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)

        return wrapped

    monkeypatch.setattr(PA, "eval_mega_plain", counting("eval_mega", PA.eval_mega_plain))
    monkeypatch.setattr(PA, "sig_eval_plain", counting("sig_eval", PA.sig_eval_plain))
    monkeypatch.setattr(PK, "cim_plain", counting("cim", PK.cim_plain))
    return counts


def test_constraint_change_is_rerank_only(adder, kernel_calls):
    s = _service(start=False)
    assert s.explore(adder).ok
    assert kernel_calls["eval_mega"] > 0  # the cold request ran the front half
    plain = dict(kernel_calls)
    launches = dict(PA.LAUNCHES), dict(PA.TIER_LAUNCHES), dict(PK.LAUNCHES)
    evaluate_calls = s.stats()["evaluate_calls"]
    for kw in list(CONSTRAINTS.values())[1:]:
        r = s.explore(adder, **kw)
        assert r.ok, r.error
        assert r.cha_cache_hit and r.grid_cache_hit
    # masked-argmin re-ranks: no back-half pass, no kernel, no plain call
    assert s.stats()["evaluate_calls"] == evaluate_calls
    assert (dict(PA.LAUNCHES), dict(PA.TIER_LAUNCHES), dict(PK.LAUNCHES)) == launches
    assert kernel_calls == plain
    s.close()


def test_same_bucket_for_a_new_fingerprint(svc, adder, maxc):
    a, m = svc.explore(adder), svc.explore(maxc)
    assert a.ok and m.ok and a.bucket == m.bucket
    evaluate_calls = svc.stats()["evaluate_calls"]
    r = svc.explore(gen_adder(5))  # new fingerprint, same bucket
    assert r.ok and not r.grid_cache_hit
    assert r.bucket == a.bucket
    assert svc.stats()["evaluate_calls"] == evaluate_calls + 1
    assert svc.stats()["distinct_buckets"] >= 1


# --------------------------- failure injection -----------------------------


def test_malformed_circuit(svc):
    r = svc.explore(ExploreRequest(circuit="not an aig"))
    assert not r.ok and r.error.code == "malformed-circuit"
    r2 = svc.explore(ExploreRequest(circuit=Aig(4, name="no-outputs")))
    assert not r2.ok and r2.error.code == "malformed-circuit"
    r3 = svc.explore(ExploreRequest(circuit=gen_adder(4), model_sweep="x"))
    assert not r3.ok and r3.error.code == "malformed-circuit"


def test_infeasible_memory_budget(svc, adder):
    r = svc.explore(adder, max_memory_kb=0.001)
    assert not r.ok and r.error.code == "infeasible-memory"
    assert "smallest candidate" in r.error.message
    with pytest.raises(ValueError):
        offline(adder, max_memory_kb=0.001)


def test_nan_sweep_structured_error(svc, adder):
    r = svc.explore(ExploreRequest(adder, model_sweep=nan_table()))
    assert not r.ok and r.error.code == "no-finite-energy"


def test_bad_batch_mates_do_not_sink_healthy(adder, maxc):
    s = _service(start=False, max_batch=8)
    futs = s.submit_batch([
        ExploreRequest(adder),
        ExploreRequest(circuit=12345),
        ExploreRequest(adder, max_memory_kb=0.001),
        ExploreRequest(maxc, model_sweep=nan_table()),
        ExploreRequest(maxc, max_latency_ns=1e6),
    ])
    assert s.pump() == 5
    rs = [f.result(timeout=0) for f in futs]
    assert rs[0].ok
    assert rs[1].error.code == "malformed-circuit"
    assert rs[2].error.code == "infeasible-memory"
    assert rs[3].error.code == "no-finite-energy"
    assert rs[4].ok
    assert_same_winner(rs[0].winner, offline(adder))
    assert_same_winner(rs[4].winner, offline(maxc, max_latency_ns=1e6))
    s.close()


def test_close_and_shutdown(adder):
    s = _service(start=False)
    fut = s.submit(ExploreRequest(adder))
    s.close()  # passive mode: the queued request resolves with shutdown
    r = fut.result(timeout=0)
    assert not r.ok and r.error.code == "shutdown"
    with pytest.raises(RuntimeError):
        s.submit(ExploreRequest(adder))
    s.close()  # idempotent


def test_threaded_submit_cancel(adder, maxc):
    """Submitter threads race the worker with mixed good/bad requests and
    eager cancellations: every future terminates, every response is
    structured, and the adder's winners equal the offline reference."""
    s = _service(start=True, max_batch=4)
    off_a = offline(adder)
    reqs = [
        ExploreRequest(adder),
        ExploreRequest(maxc),
        ExploreRequest(adder, max_latency_ns=1e6),
        ExploreRequest(adder, max_memory_kb=0.001),
        ExploreRequest(circuit=None),
    ]
    futures, lock = [], threading.Lock()

    def submitter(k: int):
        for i in range(4):
            f = s.submit(reqs[(k + i) % len(reqs)])
            if (k + i) % 5 == 4:
                f.cancel()  # may or may not win the race — both fine
            with lock:
                futures.append(f)

    threads = [threading.Thread(target=submitter, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(futures) == 12
    done = 0
    for f in futures:
        if f.cancelled():
            continue
        r = f.result(timeout=120)
        done += 1
        if r.ok:
            if r.request.circuit is adder and r.request.max_latency_ns is None:
                assert_same_winner(r.winner, off_a)
        else:
            assert r.error.code in {"malformed-circuit", "infeasible-memory", "shutdown"}
    assert done >= 1
    st = s.stats()
    assert st["submitted"] == 12
    assert st["served"] + st["errors"] + st["cancelled"] == 12
    s.close()
    with pytest.raises(RuntimeError):
        s.submit(ExploreRequest(adder))


# ----------------------------- service faults ------------------------------


def test_injected_crash_fails_batch_and_worker_survives(adder):
    with _service(start=True) as s:
        with faults.injected(faults.FaultRule("service.process", "raise")):
            resp = s.submit(ExploreRequest(adder)).result(timeout=300)
        assert not resp.ok and resp.error.code == "worker-crashed"
        resp2 = s.submit(ExploreRequest(adder)).result(timeout=300)
        assert resp2.ok
        st = s.stats()
        assert st["worker_crashes"] == 1
        assert "worker_restarts" not in st


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_dead_worker_thread_is_respawned_on_submit(adder):
    s = _service(start=True)
    try:
        orig = s._process

        def fatal(batch):
            raise SystemExit("simulated fatal worker error")

        s._process = fatal
        resp = s.submit(ExploreRequest(adder)).result(timeout=60)
        assert resp.error.code == "worker-crashed"
        s._thread.join(timeout=30)
        assert not s._thread.is_alive()
        s._process = orig
        resp2 = s.submit(ExploreRequest(adder)).result(timeout=300)
        assert resp2.ok
        assert s.stats()["worker_restarts"] == 1
    finally:
        s.close()


@pytest.mark.parametrize("where", ["request", "service-default"])
def test_deadline_expires_before_pipeline(adder, where):
    kw = {"default_deadline_s": 0.0} if where == "service-default" else {}
    with _service(start=False, **kw) as s:
        req = ExploreRequest(adder) if kw else ExploreRequest(adder, deadline_s=0.0)
        fut = s.submit(req)
        time.sleep(0.01)
        s.pump()
        resp = fut.result(timeout=5)
        assert not resp.ok and resp.error.code == "deadline-exceeded"
        assert resp.winner is None
        assert s.stats()["deadline_exceeded"] == 1
        # a generous per-request deadline answers normally
        assert s.explore(ExploreRequest(adder, deadline_s=600.0)).ok


def test_device_cha_failure_degrades_to_python_with_parity(adder):
    with _service(start=False) as clean:
        ref = clean.explore(ExploreRequest(adder))
    assert ref.ok and not ref.degraded
    with _service(start=False) as s:
        with faults.injected(faults.FaultRule("cha.backend", "raise", match="device")):
            resp = s.explore(ExploreRequest(adder))
        assert resp.ok and resp.degraded
        assert s.stats()["degraded"] == 1
        for k in ("recipe", "topology", "energy_nj", "latency_ns"):
            assert getattr(resp.winner, k) == getattr(ref.winner, k), k
        resp2 = s.explore(ExploreRequest(adder))
        assert resp2.ok and not resp2.degraded and resp2.cha_cache_hit


@pytest.fixture
def kernel_fault(monkeypatch):
    """K1's wrapper entry raising `KernelError`, as a failed launch does."""

    def broken(*a, **kw):
        raise KernelError("eval_mega: CUDA error 700 at launch")

    monkeypatch.setattr(PA, "eval_tts", broken)


def test_kernel_error_is_not_degraded_in_passive_mode(adder, kernel_fault):
    with _service(start=False) as s:
        with pytest.raises(KernelError):
            s.explore(ExploreRequest(adder))
        assert "degraded" not in s.stats()


def test_kernel_error_crashes_the_batch_under_the_worker(adder, kernel_fault):
    with _service(start=True) as s:
        resp = s.submit(ExploreRequest(adder)).result(timeout=300)
        assert not resp.ok and not resp.degraded
        assert resp.error.code == "worker-crashed"
        assert "KernelError" in resp.error.message
        st = s.stats()
        assert st["worker_crashes"] == 1 and "degraded" not in st


@pytest.fixture
def operand_fault(monkeypatch):
    """K1's packer handing the wrapper a chunk table it refuses: the real
    host check raises `OperandError` before any launch."""
    pack = PA._pack_mega

    def corrupt(*a, **kw):
        batch = pack(*a, **kw)
        meta = batch.meta.copy()
        meta[0, 0] = -1
        return dataclasses.replace(batch, meta=meta)

    monkeypatch.setattr(PA, "_pack_mega", corrupt)


def test_operand_refusal_is_not_degraded_in_passive_mode(adder, operand_fault):
    with _service(start=False) as s:
        with pytest.raises(OperandError, match="negative"):
            s.explore(ExploreRequest(adder))
        assert "degraded" not in s.stats()


def test_operand_refusal_crashes_the_batch_under_the_worker(adder, operand_fault):
    with _service(start=True) as s:
        resp = s.submit(ExploreRequest(adder)).result(timeout=300)
        assert not resp.ok and not resp.degraded
        assert resp.error.code == "worker-crashed"
        assert "OperandError" in resp.error.message
        st = s.stats()
        assert st["worker_crashes"] == 1 and "degraded" not in st


def test_service_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ExplorationService(sram_list=TOPOS, recipes=RECIPES, start=False)
    ExplorationService(sram_list=TOPOS, recipes=RECIPES, start=False, device=CPU).close()
