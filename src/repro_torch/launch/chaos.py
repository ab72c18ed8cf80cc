"""Chaos matrix of the port: the fault scenarios over every named injection
point, on ``--device`` (default ``cuda``).

Runs crash / hang / corrupt scenarios against each point in
`repro_torch.runtime.faults.POINTS` with fixed seeds, asserting the
survivability contract after every one:

  * **recovery** -- the layer under fault finishes (retry, rebuild,
    resume, degrade) instead of wedging or aborting the whole run;
  * **parity** -- the surviving result is bit-identical to a clean
    reference (or, for quarantine scenarios, bit-identical on the
    surviving subset with the failure reported in a structured way);
  * **disabled means invisible** -- with no plan armed, every injection
    point is a strict no-op and repeated runs are bit-identical.

The clean references characterize with ``backend="python"``; the service
and sweep scenarios run the port's defaults on ``--device``, so on the
card their front half is the device backend and K1 runs.  In-process
scenarios arm plans through `faults.injected`; scenarios that hard-exit
a process (``exit`` rules) arm through the ``REPRO_FAULTS`` environment
of a spawned pool worker or a subprocess sweep, with
``REPRO_FAULTS_ONCE_DIR`` bounding the global fire budget so a retried
task cannot re-fire forever.

    python -m repro_torch.launch.chaos                # full matrix, on the card
    python -m repro_torch.launch.chaos --device cpu   # on the host
    python -m repro_torch.launch.chaos --list         # scenario names
    python -m repro_torch.launch.chaos -k sweep       # substring filter

Each scenario prints ``ok``/``FAIL``, its seconds and, where it reached
the card, its K1 launches.  Exit status is the number of failed scenarios
(0 = all recovered); an uncovered point of the registry exits 1.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Sequence

import numpy as np

from ..ckpt.manager import CheckpointManager
from ..core.circuits import benchmark_suite, gen_adder
from ..core.sram import TOPOLOGY_LIBRARY
from ..core.sweep_runner import run_sweep
from ..core.transforms import CharacterizationCache, PoolPolicy, characterize_suite
from ..device import resolve_device
from ..kernels import aig_sim
from ..runtime import faults
from ..serve.explore_service import ExplorationService, ExploreRequest

CIRCUITS = ["adder", "bar", "max"]
RECIPES = [(), ("Rw",), ("Rf",), ("Ba", "Rw")]
TOPOS = list(TOPOLOGY_LIBRARY[:5])
SEED = 0
FAST = PoolPolicy(backoff_s=0.01, backoff_cap_s=0.1, seed=SEED)
#: the directory that holds the ``repro_torch`` package, for the
#: subprocess sweep's ``PYTHONPATH``
SRC = str(pathlib.Path(__file__).resolve().parents[2])

_SCENARIOS: list = []


def scenario(point: str, action: str):
    def wrap(fn):
        fn.point, fn.action = point, action
        _SCENARIOS.append(fn)
        return fn

    return wrap


class Ctx:
    """Shared clean references + scratch space for every scenario."""

    def __init__(self, work: str, device: str):
        self.work = work
        self.device = device
        self.circuits = benchmark_suite("tiny", only=CIRCUITS)
        self.cache = os.path.join(work, "cha")  # warm, for sweep scenarios
        self.cha_clean = characterize_suite(
            self.circuits, RECIPES, cache=self.cache, n_jobs=1,
            backend="python", device=device,
        )
        self.sweep_clean = run_sweep(
            self.circuits, journal_dir=None, shard_size=None,
            sram_list=TOPOS, recipes=RECIPES, cache=self.cache, n_jobs=1,
            device=device,
        )

    def tmp(self, name: str) -> str:
        path = os.path.join(self.work, name)
        os.makedirs(path, exist_ok=True)
        return path

    def sweep(self, **kw):
        """`run_sweep` over the scenario circuits on the port's defaults."""
        kw.setdefault("cache", self.cache)
        return run_sweep(
            self.circuits, sram_list=TOPOS, recipes=RECIPES, n_jobs=1,
            device=self.device, **kw,
        )

    def service(self, start: bool) -> ExplorationService:
        return ExplorationService(sram_list=TOPOS, recipes=RECIPES, start=start,
                                  device=self.device)


def assert_cha_parity(got, ref, circuits=None):
    names = circuits if circuits is not None else sorted(ref)
    assert sorted(got) == sorted(names), (sorted(got), sorted(names))
    for c in names:
        assert got[c] == ref[c], f"characterization mismatch on {c}"


def assert_sweep_parity(out, ref, circuits=None):
    sel, rsel = out.selection, ref.selection
    rows = (
        slice(None)
        if circuits is None
        else [ref.circuits.index(c) for c in circuits]
    )
    assert np.array_equal(sel.winner_idx, rsel.winner_idx[rows])
    assert np.array_equal(sel.nominal_latency_ns, rsel.nominal_latency_ns[rows])
    assert np.array_equal(sel.nominal_fits, rsel.nominal_fits[rows])
    for k, v in rsel.winner_metrics.items():
        assert np.array_equal(sel.winner_metrics[k], v[rows]), k


def _arm_env(once_dir: str, spec: str) -> dict:
    env = dict(os.environ)
    env["REPRO_FAULTS"] = spec
    env["REPRO_FAULTS_SEED"] = str(SEED)
    env["REPRO_FAULTS_ONCE_DIR"] = once_dir
    return env


class _env_armed:
    """Arm REPRO_FAULTS for spawned children; the parent stays disarmed
    (faults.disable pins the parent's env check)."""

    def __init__(self, once_dir: str, spec: str):
        self.spec, self.once = spec, once_dir

    def __enter__(self):
        os.environ["REPRO_FAULTS"] = self.spec
        os.environ["REPRO_FAULTS_SEED"] = str(SEED)
        os.environ["REPRO_FAULTS_ONCE_DIR"] = self.once
        faults.disable()

    def __exit__(self, *exc):
        for k in ("REPRO_FAULTS", "REPRO_FAULTS_SEED", "REPRO_FAULTS_ONCE_DIR"):
            os.environ.pop(k, None)
        faults.disable()


# -- characterization pool (pool.task) --------------------------------------


def _pool_run(ctx: Ctx, policy: PoolPolicy):
    return characterize_suite(ctx.circuits, RECIPES, n_jobs=2, backend="python",
                              policy=policy, device=ctx.device)


@scenario("pool.task", "raise")
def pool_task_raise(ctx: Ctx):
    with _env_armed(ctx.tmp("once_pr"), "pool.task:raise::0:2"):
        out = _pool_run(ctx, FAST)
    assert_cha_parity(out, ctx.cha_clean)


@scenario("pool.task", "exit")
def pool_task_exit(ctx: Ctx):
    # A worker hard-exits mid-task: BrokenProcessPool -> rebuild and
    # re-dispatch the in-flight work.
    with _env_armed(ctx.tmp("once_px"), "pool.task:exit::1:1"):
        out = _pool_run(ctx, FAST)
    assert_cha_parity(out, ctx.cha_clean)


@scenario("pool.task", "hang")
def pool_task_hang(ctx: Ctx):
    # A worker sleeps past the per-task deadline: the attempt is failed,
    # the pool rebuilt (the stuck worker killed), and the task retried.
    # The deadline clock starts at submit and therefore absorbs the
    # spawn of a worker, so it must sit well above that startup and well
    # below the hang.  The port's worker imports torch: on an H100 host
    # two spawns took about 6 s each (the reference's jax-free worker
    # spawns in under 1 s, hence its 5.0 s), so the deadline is 20 s.
    policy = PoolPolicy(task_deadline_s=20.0, backoff_s=0.01, backoff_cap_s=0.1, seed=SEED)
    with _env_armed(ctx.tmp("once_ph"), "pool.task:hang::0:1:60"):
        out = _pool_run(ctx, policy)
    assert_cha_parity(out, ctx.cha_clean)


# -- characterization front half (cha.backend) ------------------------------


@scenario("cha.backend", "raise")
def cha_backend_quarantine(ctx: Ctx):
    # A circuit whose characterization fails permanently is quarantined
    # with a structured failure; the rest of the sweep survives with
    # bit-identical rows.
    with faults.injected(
        faults.FaultRule("cha.backend", "raise", match=":bar", count=None), seed=SEED,
    ):
        out = ctx.sweep(journal_dir=None, shard_size=2, cache=ctx.tmp("quarantine_cache"))
    assert set(out.failures) == {"bar"}, out.failures
    assert out.circuits == tuple(c for c in CIRCUITS if c != "bar")
    assert_sweep_parity(out, ctx.sweep_clean, circuits=list(out.circuits))


@scenario("cha.backend", "raise")
def cha_backend_degrades_service(ctx: Ctx):
    # Device-backend failure inside the service descends the ladder to
    # the python parity path and flags the response degraded.  The
    # port's device backend always resolves, so this never skips.
    adder = gen_adder(6)
    with ctx.service(start=False) as clean:
        ref = clean.explore(ExploreRequest(adder))
    assert ref.ok and not ref.degraded
    with ctx.service(start=False) as svc:
        with faults.injected(faults.FaultRule("cha.backend", "raise", match="device"),
                             seed=SEED):
            resp = svc.explore(ExploreRequest(adder))
    assert resp.ok and resp.degraded
    assert resp.winner.recipe == ref.winner.recipe
    assert resp.winner.topology == ref.winner.topology
    assert resp.winner.energy_nj == ref.winner.energy_nj


# -- characterization cache (cache.store) -----------------------------------


@scenario("cache.store", "corrupt")
def cache_store_corrupt(ctx: Ctx):
    # Every cache write is truncated mid-flight; reads must treat the
    # damage as a miss (never crash), and recharacterization restores
    # parity on a clean pass.
    cdir = ctx.tmp("corrupt_cache")

    def characterize():
        return characterize_suite(ctx.circuits, RECIPES, cache=cdir, n_jobs=1,
                                  backend="python", device=ctx.device)

    with faults.injected(faults.FaultRule("cache.store", "corrupt", count=None), seed=SEED):
        assert_cha_parity(characterize(), ctx.cha_clean)  # in-memory result intact
    assert_cha_parity(characterize(), ctx.cha_clean)
    # The repaired cache round-trips warm.
    cache = CharacterizationCache(cdir)
    hits = sum(len(cache.load(aig.fingerprint())) for aig in ctx.circuits.values())
    assert hits > 0, "no cache entries survived the clean rewrite"


# -- sweep runner (sweep.shard) ---------------------------------------------


@scenario("sweep.shard", "raise")
def sweep_shard_crash_resume(ctx: Ctx):
    journal = ctx.tmp("j_crash")
    try:
        with faults.injected(faults.FaultRule("sweep.shard", "raise", after=1), seed=SEED):
            ctx.sweep(journal_dir=journal, shard_size=1)
        raise AssertionError("injected shard crash did not fire")
    except faults.FaultError:
        pass
    out = ctx.sweep(journal_dir=journal, shard_size=1)
    assert out.shards_resumed >= 1
    assert_sweep_parity(out, ctx.sweep_clean)


@scenario("sweep.shard", "exit")
def sweep_shard_kill_resume(ctx: Ctx):
    # The real thing: a subprocess sweep hard-exits mid-shard (the
    # kill -9 model; on the card, a process holding a CUDA context) and
    # a second invocation resumes from the journal.
    journal = ctx.tmp("j_kill")
    out_npz = os.path.join(ctx.work, "killed.npz")
    cmd = [
        sys.executable, "-m", "repro_torch.core.sweep_runner",
        "--journal", journal, "--out", out_npz, "--shard-size", "1",
        "--cache", ctx.cache, "--circuits", ",".join(CIRCUITS),
        "--scale", "tiny", "--recipes", ";Rw;Rf;Ba,Rw", "--topos", "5",
        "--device", str(ctx.device),
    ]
    env = _arm_env(ctx.tmp("once_sk"), "sweep.shard:exit::1:1")
    env["PYTHONPATH"] = os.pathsep.join([SRC, env.get("PYTHONPATH", "")])
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 42, (proc.returncode, proc.stderr[-2000:])
    assert not os.path.exists(out_npz), "crashed run must not publish out"
    env.pop("REPRO_FAULTS")
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = np.load(out_npz)
    assert int(got["shards_resumed"]) >= 1
    ref = ctx.sweep_clean.selection
    assert np.array_equal(got["winner_idx"], ref.winner_idx)
    assert np.array_equal(got["nominal_latency_ns"], ref.nominal_latency_ns)


# -- shard journal (journal.write) ------------------------------------------


@scenario("journal.write", "raise")
def journal_write_failure_rerun(ctx: Ctx):
    # A publish that fails outright (disk error model): the sweep still
    # completes; the resume path treats the missing entry as absent work.
    journal = ctx.tmp("j_wfail")
    # The rule matches this journal only: publishes an earlier scenario
    # left in flight on its own journal must not take the one fire.
    with faults.injected(faults.FaultRule("journal.write", "raise", match=journal),
                         seed=SEED):
        out = ctx.sweep(journal_dir=journal, shard_size=1)
        # Publishes are async: keep the rule armed until the writer has
        # taken every one; the failed publish surfaces at the drain.
        try:
            CheckpointManager(journal).wait()
            raise AssertionError("injected publish failure did not fire")
        except faults.FaultError:
            pass
        assert_sweep_parity(out, ctx.sweep_clean)
    out2 = ctx.sweep(journal_dir=journal, shard_size=1)
    assert out2.shards_run >= 1  # the unpublished shard was redone
    assert_sweep_parity(out2, ctx.sweep_clean)


@scenario("journal.write", "corrupt")
def journal_write_torn_frame(ctx: Ctx):
    # A torn append that survives the flush: the reader must skip the
    # damaged frame (crc + magic re-sync) and redo only that shard.
    journal = ctx.tmp("j_torn")
    with faults.injected(faults.FaultRule("journal.write", "corrupt", match=journal),
                         seed=SEED):
        ctx.sweep(journal_dir=journal, shard_size=1)
        CheckpointManager(journal).wait()  # the torn publish lands while armed
    out = ctx.sweep(journal_dir=journal, shard_size=1)
    assert 1 <= out.shards_run < len(CIRCUITS), out.shards_run
    assert_sweep_parity(out, ctx.sweep_clean)


# -- exploration service (service.process) ----------------------------------


@scenario("service.process", "raise")
def service_crash_survives(ctx: Ctx):
    adder = gen_adder(6)
    with ctx.service(start=True) as svc:
        with faults.injected(faults.FaultRule("service.process", "raise"), seed=SEED):
            resp = svc.submit(ExploreRequest(adder)).result(timeout=300)
        assert not resp.ok and resp.error.code == "worker-crashed"
        resp2 = svc.submit(ExploreRequest(adder)).result(timeout=300)
        assert resp2.ok, "worker did not survive the crashed batch"
        assert svc.stats()["worker_crashes"] == 1


@scenario("service.process", "hang")
def service_deadline_from_hang(ctx: Ctx):
    # A wedged pipeline burns a queued request's deadline; the service
    # resolves it with a structured deadline error instead of wedging,
    # then serves the next request normally.
    adder = gen_adder(6)
    with ctx.service(start=False) as svc:
        fut = svc.submit(ExploreRequest(adder, deadline_s=0.3))
        with faults.injected(faults.FaultRule("service.process", "hang", hang_s=0.5),
                             seed=SEED):
            time.sleep(0.4)  # the deadline expires while "wedged"
            svc.pump()
        resp = fut.result(timeout=5)
        assert not resp.ok and resp.error.code == "deadline-exceeded"
        resp2 = svc.explore(ExploreRequest(adder, deadline_s=600.0))
        assert resp2.ok


# -- disabled means invisible ------------------------------------------------


@scenario("(all)", "disabled")
def disabled_is_noop(ctx: Ctx):
    faults.disable()
    assert not faults.enabled()
    a = ctx.sweep(journal_dir=None, shard_size=2)
    b = ctx.sweep(journal_dir=None, shard_size=2)
    assert_sweep_parity(a, ctx.sweep_clean)
    assert_sweep_parity(b, ctx.sweep_clean)
    assert faults.corrupt("cache.store", b"payload") == b"payload"
    faults.inject("sweep.shard")  # must be a strict no-op


def main(argv: "Sequence[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-k", default="", help="substring filter on scenarios")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    chosen = [s for s in _SCENARIOS if args.k in s.__name__]
    if args.list:
        for s in chosen:
            print(f"{s.__name__}  [{s.point} x {s.action}]")
        return 0

    points = {s.point for s in chosen if s.point in faults.POINTS}
    if not args.k and points != set(faults.POINTS):
        print(f"matrix gap: uncovered points {set(faults.POINTS) - points}")
        return 1

    device = str(resolve_device(args.device))
    work = tempfile.mkdtemp(prefix="chaos_")
    failures = 0
    try:
        t0 = time.perf_counter()
        ctx = Ctx(work, device)
        print(f"references ready in {time.perf_counter() - t0:.3f}s "
              f"({len(chosen)} scenarios on {device})", flush=True)
        for s in chosen:
            faults.disable()
            launches = dict(aig_sim.LAUNCHES)
            t0 = time.perf_counter()
            try:
                note = s(ctx)
            except Exception:
                failures += 1
                print(f"FAIL {s.__name__} [{s.point} x {s.action}]")
                traceback.print_exc()
            else:
                dt = time.perf_counter() - t0
                k1 = {k: v - launches[k] for k, v in aig_sim.LAUNCHES.items()}
                tag = f" K1 launches {k1}" if any(k1.values()) else ""
                tag += f" ({note})" if note else ""
                print(f"ok   {s.__name__} [{s.point} x {s.action}] {dt:.3f}s{tag}",
                      flush=True)
            finally:
                faults.disable()
        print(f"chaos matrix: {len(chosen) - failures}/{len(chosen)} "
              f"scenarios recovered with parity")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return failures


if __name__ == "__main__":
    sys.exit(main())
