"""Exploration-as-a-service: a warm, persistent query engine over
Algorithm I, on the card.

The offline tool answers one-shot questions — "given this circuit,
memory budget, and latency bound, which rCiM implementation strategy is
cheapest?" — by characterizing the circuit (seconds to minutes cold)
and sweeping its recipe x topology grid.  `ExplorationService` turns
that into a long-lived query engine that answers the same question in
milliseconds once warm, by arranging the pipeline so every expensive
stage is shared and every request-specific stage is cheap:

    submit() ──> request queue ──> continuous batching (drain up to
    max_batch) ──> bucket: pad circuits onto canonical SuiteTable
    shapes (`batch.bucket_suite`: C -> pow2, L -> pow2 x LEVEL_PAD), the
    batch group and the response's ``bucket`` key ──> grid cache: one
    lazy device-resident (V, T, R) sweep per (circuit fingerprint,
    model spec) ──> per-request re-rank: budget + latency constraints
    applied as a masked argmin over the cached device tensors
    (`batch.select_best_batch_device`) — no back-half pass and no
    re-characterization when only the constraints change.

Two cache layers, keyed content-addressed:

  * the on-disk `transforms.CharacterizationCache` (shared across
    processes, service restarts and with the reference package) plus an
    in-memory memo — both keyed by AIG structural fingerprint, so a
    repeated or structurally-shared circuit skips the front half (and
    its K1 launches) entirely;
  * the grid cache: (fingerprint, model-table hash) -> lazy
    `ExplorationGrid`/`VariationGrid` whose metric tensors stay on the
    device; only per-winner scalars cross to the host at answer time
    (`GridCell` single-scalar gathers + the (V,) winner-index /
    winner-energy vectors for variation summaries).

Robustness is part of the contract: a malformed circuit, an infeasible
memory budget, or an all-non-finite (NaN-salted) model sweep yields a
*structured* `ServiceError` on that request's future while the rest of
the batch keeps being served; the worker thread never dies on request
data.  Three further layers harden the service against its own runtime:

  * **per-request deadlines** — ``ExploreRequest.deadline_s`` (or the
    service-wide ``default_deadline_s``) bounds submit-to-answer wall
    time; an expired request resolves to ``deadline-exceeded`` at batch
    pickup or before the answer is assembled;
  * **worker supervision** — an exception escaping the batch pipeline
    (a bug, an injected ``service.process`` fault, a `KernelError`)
    fails that batch's unresolved futures with ``worker-crashed`` and
    the loop keeps serving; if the thread dies anyway, the next
    `submit` respawns it (``worker_restarts`` stat);
  * **graceful degradation** — a characterization failure on the
    configured backend retries on the ``backend="python"`` parity path;
    the answer is bit-identical (both backends are exact) but arrives
    slower and carries ``ExploreResponse.degraded=True`` plus a
    ``degraded`` stat.  A `KernelError` is not a rung trigger: a kernel
    fault is never served as a degraded answer.  It raises out of
    `pump` in passive mode and resolves the batch ``worker-crashed``
    under the worker.

All device work runs on ``device`` (default ``cuda``, raising without a
card; ``"cpu"`` runs the plain torch versions).  In worker mode the
worker thread does all of it, with the service's device set on entry, so
K1 launches on that thread's current stream.

Parity: every answer is bit-identical (same winner cell, same tiering
and tie-breaking) to a one-shot `explorer.explore_request` call with the
same constraints on the same device.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Sequence

import numpy as np
import torch

from ..core.aig import Aig, AigStats
from ..core.batch import (
    ExplorationGrid,
    SuiteTable,
    TopologyTable,
    VariationGrid,
    bucket_suite,
    evaluate_select_suite,
    select_best_batch_device,
    winner_summary,
)
from ..core.explorer import ENERGY_QUANTILES
from ..core.mapping import BITS_PER_GATE
from ..core.sram import (
    TOPOLOGY_LIBRARY,
    EnergyModel,
    ModelTable,
    SramTopology,
    inductor_size_nh,
)
from ..core.transforms import (
    CharacterizationCache,
    characterize_suite,
    resolve_backend,
)
from ..device import resolve_device
from ..kernels.build import KernelError
from ..runtime import faults


# ---------------------------------------------------------------------------
# Request / response schema
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ExploreRequest:
    """One design query: which implementation of ``circuit`` is cheapest
    under the given memory budget / latency bound, optionally across a
    `ModelTable` variation sweep (process corners, Monte-Carlo, ...)?"""

    circuit: Aig
    max_memory_kb: float | None = None
    max_latency_ns: float | None = None
    model_sweep: ModelTable | None = None
    tag: str | None = None  # caller correlation id, echoed in the response
    #: submit-to-answer wall-clock budget in seconds (None = the
    #: service's ``default_deadline_s``); expiry resolves the future
    #: with a ``deadline-exceeded`` `ServiceError`.
    deadline_s: float | None = None


@dataclasses.dataclass(frozen=True)
class ServiceError:
    """Structured per-request failure — the request's future still
    resolves (to a response carrying this), the batch keeps serving.

    Codes: ``malformed-circuit`` (input is not a usable AIG),
    ``characterization-failed`` (the transform front half raised, on
    every backend tried), ``infeasible-memory`` (no candidate topology
    fits the budget), ``no-finite-energy`` (every admissible cell is
    NaN/inf — e.g. a pathological model sweep), ``deadline-exceeded``
    (the request's wall-clock budget expired before an answer),
    ``worker-crashed`` (an exception escaped the batch pipeline; the
    batch's unresolved futures all resolve with this and the worker
    keeps serving), ``shutdown`` (service stopped before the request
    was served), ``internal`` (unexpected bug, message carries the
    exception).
    """

    code: str
    message: str


@dataclasses.dataclass(frozen=True)
class Winner:
    """The chosen implementation, materialized from single-scalar device
    gathers (`GridCell`) — the full sweep tensors never leave the
    device for this."""

    recipe: tuple[str, ...]
    topology: SramTopology
    energy_nj: float
    latency_ns: float
    power_mw: float
    area_mm2: float
    fits: bool
    meets_latency: bool
    inductor_nh: float | None  # None for correlated sweeps (no scalar model)


@dataclasses.dataclass(frozen=True)
class VariationSummary:
    """Per-variant winners + yield figures for a ``model_sweep`` request
    (the service-side analogue of `explorer.VariationResult`, computed
    from the (V,)-sized selection payload without materializing the
    (V, T, R) tensors)."""

    n_variants: int
    winners: tuple[tuple[tuple[str, ...], SramTopology], ...]
    winner_share: dict[str, float]
    best_yield: float
    latency_yield: float
    winner_energy_nj: np.ndarray            # (V,)
    energy_quantiles: dict[float, float]

    def cvar(self, alpha: float = 0.9) -> float:
        """Expected shortfall of the per-variant winner energy (see
        `explorer.VariationResult.cvar`)."""
        if not 0.0 <= alpha < 1.0:
            raise ValueError(f"alpha must be in [0, 1), got {alpha}")
        e = np.sort(self.winner_energy_nj)
        k = max(1, int(np.ceil((1.0 - alpha) * e.size)))
        return float(e[-k:].mean())


@dataclasses.dataclass
class ExploreResponse:
    request: ExploreRequest
    winner: Winner | None = None
    variation: VariationSummary | None = None
    error: ServiceError | None = None
    fingerprint: str | None = None
    bucket: tuple | None = None       # (C, R, L_pad, T, V) batch bucket
    cha_cache_hit: bool = False       # front half skipped (memo/disk)
    grid_cache_hit: bool = False      # back half skipped (re-rank only)
    degraded: bool = False            # served via a fallback backend
    queued_ms: float = 0.0            # submit -> batch pickup
    service_ms: float = 0.0           # batch pickup -> answer

    @property
    def ok(self) -> bool:
        return self.error is None


# ---------------------------------------------------------------------------
# Internal records
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Pending:
    request: ExploreRequest
    future: Future
    t_submit: float
    fp: str | None = None
    model_key: str | None = None
    error: ServiceError | None = None
    cha_hit: bool = False
    grid_hit: bool = False
    degraded: bool = False


@dataclasses.dataclass
class _GridEntry:
    """One cached (fingerprint, model spec) sweep: the lazy grid row plus
    flat device views of the re-rank operands."""

    row: "ExplorationGrid | VariationGrid"
    energy: torch.Tensor  # (V, N) fp64 on the device, N = T*R topology-major
    latency: torch.Tensor  # (V, N) fp64 on the device
    fits: np.ndarray      # (1, N) bool
    min_gates: int        # capacity threshold (Alg. I line 9 input)
    nominal_model: EnergyModel | None
    is_sweep: bool
    bucket: tuple         # (C, R, L_pad, T, V) batch bucket


def _model_key(table: ModelTable | None) -> str:
    """Content hash of a model spec — the grid-cache / batch-group key.
    ``None`` (the service's nominal model) hashes to a fixed key."""
    if table is None:
        return "nominal"
    return table.content_key()


_SENTINEL = object()


# ---------------------------------------------------------------------------
# The service
# ---------------------------------------------------------------------------


class ExplorationService:
    """A persistent Algorithm-I query engine with continuous batching.

    Usage::

        svc = ExplorationService(cache="runs/cha_cache", max_batch=8)
        fut = svc.submit(ExploreRequest(circuit, max_memory_kb=96,
                                        max_latency_ns=400.0))
        resp = fut.result()          # ExploreResponse
        svc.close()

    ``start=True`` (default) runs a single worker thread that drains the
    queue in batches (all device work happens on that thread).
    ``start=False`` leaves the service passive — call `pump()` to
    process everything queued on the caller's thread, which is the
    deterministic mode the tests use.

    The topology library, recipe set, accounting mode, discipline and
    device are service-level configuration: every request shares them.
    Per-request degrees of freedom are the circuit, the constraints, and
    the model sweep.
    """

    def __init__(
        self,
        sram_list: Sequence[SramTopology] = TOPOLOGY_LIBRARY,
        recipes: Sequence[tuple[str, ...]] | None = None,
        model: EnergyModel | None = None,
        mode: str = "physical",
        discipline: str = "list",
        cache: "CharacterizationCache | str | os.PathLike | None" = None,
        n_jobs: int | None = 1,
        cha_backend: str = "auto",
        max_batch: int = 8,
        grid_cache_size: int = 128,
        default_deadline_s: float | None = None,
        start: bool = True,
        device: "str | torch.device | None" = None,
    ):
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if grid_cache_size < 1:
            raise ValueError("grid_cache_size must be >= 1")
        self._topos = TopologyTable.from_topologies(sram_list)
        self._total_kb = np.array(
            [t.total_kb for t in self._topos.topologies], dtype=np.float64
        )
        self._recipes = (
            None if recipes is None else [tuple(r) for r in recipes]
        )
        self._model = model if model is not None else EnergyModel()
        self._mode = mode
        self._discipline = discipline
        self._cache = cache
        self._n_jobs = n_jobs
        self._cha_backend = cha_backend
        self.max_batch = max_batch
        self._grid_cache_size = grid_cache_size
        self.default_deadline_s = default_deadline_s

        self._queue: "queue.Queue" = queue.Queue()
        # Worker-thread-only state (no locks needed beyond the queue):
        self._cha: "collections.OrderedDict[str, tuple[dict[tuple[str, ...], AigStats], int]]" = (
            collections.OrderedDict()
        )
        self._grids: "collections.OrderedDict[tuple, _GridEntry]" = (
            collections.OrderedDict()
        )
        self._tables: dict[str, ModelTable | None] = {}
        self._stats = collections.Counter()
        self._buckets: "collections.Counter[tuple]" = collections.Counter()
        self._stats_lock = threading.Lock()
        self._closed = False
        self._thread: threading.Thread | None = None
        if start:
            self._thread = threading.Thread(
                target=self._serve_loop, name="explore-service", daemon=True
            )
            self._thread.start()

    # -- client API ----------------------------------------------------------

    def submit(self, request: ExploreRequest) -> Future:
        """Enqueue a request; the returned future resolves to an
        `ExploreResponse` (errors are *in* the response — the future
        itself only raises on cancellation)."""
        if self._closed:
            raise RuntimeError("ExplorationService is closed")
        self._ensure_worker()
        p = _Pending(request, Future(), time.perf_counter())
        with self._stats_lock:
            self._stats["submitted"] += 1
        self._queue.put(p)
        return p.future

    def submit_batch(self, requests: Sequence[ExploreRequest]) -> list[Future]:
        return [self.submit(r) for r in requests]

    def explore(self, request: "ExploreRequest | Aig", **kw) -> ExploreResponse:
        """Blocking convenience: submit one request and wait.  An `Aig`
        plus keyword constraints builds the `ExploreRequest` inline.  In
        passive (``start=False``) mode the queue is pumped on this
        thread."""
        if isinstance(request, Aig):
            request = ExploreRequest(circuit=request, **kw)
        elif kw:
            raise TypeError("keyword constraints only apply to a bare Aig")
        fut = self.submit(request)
        if self._thread is None:
            self.pump()
        return fut.result()

    def pump(self) -> int:
        """Passive mode: drain and process everything currently queued on
        the *caller's* thread (one `_process` call per ``max_batch``
        slice — the same continuous-batching path the worker runs).
        Returns the number of requests processed.  A `KernelError`
        raises out of here."""
        if self._thread is not None:
            raise RuntimeError("pump() is for start=False services")
        done = 0
        with self._on_device():
            while True:
                batch = self._drain(block=False)
                if not batch:
                    return done
                self._process(batch)
                done += len(batch)

    def close(self, timeout: float | None = 30.0) -> None:
        """Stop accepting requests, serve everything already queued, then
        shut the worker down.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self._thread is not None:
            self._queue.put(_SENTINEL)
            self._thread.join(timeout=timeout)
            self._thread = None
        # Passive mode (or a worker that timed out): fail anything left.
        self._fail_queue()

    def __enter__(self) -> "ExplorationService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> dict:
        """Counter snapshot: submitted / served / errors / cancelled,
        front-half (``cha_hits``/``cha_misses``) and back-half
        (``grid_hits``/``grid_misses``) cache traffic, ``batches`` and
        ``evaluate_calls``, plus the per-bucket batch histogram."""
        with self._stats_lock:
            out = dict(self._stats)
        out["buckets"] = {str(k): v for k, v in self._buckets.items()}
        out["distinct_buckets"] = len(self._buckets)
        return out

    # -- worker --------------------------------------------------------------

    def _on_device(self):
        """Make the service's device current (CUDA only), so kernels and
        tensor ops launch on this thread's stream of that device."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _ensure_worker(self) -> None:
        """Crash detection at the submit edge: a worker thread that died
        anyway (an error the loop supervision re-raised, a library-level
        crash) is replaced before the new request enqueues, so futures
        are never parked behind a dead consumer."""
        t = self._thread
        if t is None or t.is_alive() or self._closed:
            return
        with self._stats_lock:
            self._stats["worker_restarts"] += 1
        self._thread = threading.Thread(
            target=self._serve_loop, name="explore-service", daemon=True
        )
        self._thread.start()

    def _serve_loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            batch = self._drain(block=True)
            if batch is None:  # sentinel: drain leftovers, then exit
                self._fail_queue()
                return
            if not batch:
                continue
            try:
                self._process(batch)
            except BaseException as e:  # noqa: BLE001 — supervised loop
                # Fail the batch's unresolved futures with a structured
                # error and keep serving; genuinely fatal signals still
                # propagate (the next submit() respawns the worker).
                self._crash_batch(batch, e)
                if isinstance(e, (KeyboardInterrupt, SystemExit)):
                    raise

    def _crash_batch(self, batch: list, exc: BaseException) -> None:
        err = ServiceError(
            "worker-crashed", f"{type(exc).__name__}: {exc}"
        )
        now = time.perf_counter()
        for p in batch:
            if not p.future.done():
                p.error = err
                self._resolve(p, now)
        with self._stats_lock:
            self._stats["worker_crashes"] += 1

    def _drain(self, block: bool) -> "list[_Pending] | None":
        """Continuous batching: take the next request (blocking only in
        worker mode), then greedily drain up to ``max_batch`` without
        waiting.  Returns None when the shutdown sentinel is seen."""
        batch: list[_Pending] = []
        try:
            first = (
                self._queue.get(timeout=0.1) if block
                else self._queue.get_nowait()
            )
        except queue.Empty:
            return batch
        if first is _SENTINEL:
            return None
        batch.append(first)
        while len(batch) < self.max_batch:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is _SENTINEL:
                # Keep the sentinel semantics: everything queued before
                # close() is served; the loop exits on the next drain.
                self._queue.put(_SENTINEL)
                break
            batch.append(item)
        return batch

    def _fail_queue(self) -> None:
        while True:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                return
            if p is _SENTINEL:
                continue
            if p.future.set_running_or_notify_cancel():
                p.error = ServiceError("shutdown", "service closed")
                self._resolve(p, time.perf_counter())

    # -- batch pipeline ------------------------------------------------------

    def _deadline_expired(self, p: _Pending) -> bool:
        """Mark ``p`` with a structured deadline error if its wall-clock
        budget (request-level, else service default) has run out."""
        if p.error is not None:
            return False
        d = p.request.deadline_s
        if d is None:
            d = self.default_deadline_s
        if d is None or time.perf_counter() - p.t_submit <= d:
            return False
        p.error = ServiceError(
            "deadline-exceeded",
            f"request exceeded its {d:g}s deadline before an answer",
        )
        with self._stats_lock:
            self._stats["deadline_exceeded"] += 1
        return True

    def _process(self, batch: list[_Pending]) -> None:
        t0 = time.perf_counter()
        faults.inject("service.process", detail=str(len(batch)))
        live: list[_Pending] = []
        for p in batch:
            if p.future.set_running_or_notify_cancel():
                live.append(p)
            else:
                with self._stats_lock:
                    self._stats["cancelled"] += 1
        if not live:
            return
        for p in live:
            self._admit(p)
            # Deadline check at pickup: an already-expired request must
            # not occupy the characterize/evaluate pipeline.
            self._deadline_expired(p)
        self._characterize([p for p in live if p.error is None])
        self._evaluate([p for p in live if p.error is None])
        for p in live:
            if p.error is None and not self._deadline_expired(p):
                try:
                    self._answer(p, t0)
                    continue
                except KernelError:
                    raise
                except Exception as e:  # noqa: BLE001 - worker must survive
                    p.error = ServiceError("internal", f"{type(e).__name__}: {e}")
            self._resolve(p, t0)

    def _admit(self, p: _Pending) -> None:
        """Validate + fingerprint; structured error on malformed input."""
        r = p.request
        if not isinstance(r.circuit, Aig):
            p.error = ServiceError(
                "malformed-circuit",
                f"circuit must be an Aig, got {type(r.circuit).__name__}",
            )
            return
        if r.circuit.n_pis < 1 or not r.circuit.pos:
            p.error = ServiceError(
                "malformed-circuit",
                "circuit has no primary inputs or no primary outputs",
            )
            return
        if r.model_sweep is not None and not isinstance(
            r.model_sweep, ModelTable
        ):
            p.error = ServiceError(
                "malformed-circuit",
                f"model_sweep must be a ModelTable, got "
                f"{type(r.model_sweep).__name__}",
            )
            return
        try:
            p.fp = r.circuit.fingerprint()
        except Exception as e:  # noqa: BLE001
            p.error = ServiceError(
                "malformed-circuit", f"fingerprint failed: {e}"
            )
            return
        try:
            p.model_key = _model_key(r.model_sweep)
        except Exception as e:  # noqa: BLE001
            p.error = ServiceError(
                "malformed-circuit", f"bad model_sweep: {e}"
            )
            return
        self._tables.setdefault(p.model_key, r.model_sweep)

    def _characterize(self, live: list[_Pending]) -> None:
        """Front half per unique fingerprint: in-memory memo -> on-disk
        `CharacterizationCache` -> transforms (K1 on the card).  Failures
        are isolated per circuit (one bad netlist cannot sink its
        batch-mates).

        Degradation ladder: when the configured backend (``"auto"``
        resolves to the device engine) fails, the same circuit retries
        on the ``"python"`` parity path — both backends are exact, so
        the answer is bit-identical, just slower; the requests served
        that way carry ``degraded=True``.  Only when every rung fails
        does the request get ``characterization-failed``.  A
        `KernelError` is not a rung trigger: it propagates."""
        todo: dict[str, Aig] = {}
        for p in live:
            if p.fp in self._cha:
                p.cha_hit = True
                self._cha.move_to_end(p.fp)
            elif p.fp not in todo:
                todo[p.fp] = p.request.circuit
        with self._stats_lock:
            self._stats["cha_hits"] += sum(1 for p in live if p.cha_hit)
            self._stats["cha_misses"] += len(todo)
        ladder = [self._cha_backend]
        if resolve_backend(self._cha_backend) != "python":
            ladder.append("python")
        for fp, rtl in todo.items():
            entry = None
            errors = []
            for rung, backend in enumerate(ladder):
                try:
                    cha = characterize_suite(
                        {rtl.name: rtl},
                        self._recipes,
                        cache=self._cache,
                        n_jobs=self._n_jobs,
                        backend=backend,
                        device=self.device,
                    )[rtl.name]
                    # Empty/degenerate characterizations must fail the
                    # request, not the worker thread.
                    min_gates = min(s.total_gates for s in cha.values())
                    entry = (cha, min_gates)
                    break
                except KernelError:
                    raise  # a kernel fault is never served degraded
                except Exception as e:  # noqa: BLE001 - isolate the request
                    errors.append(f"{backend}: {type(e).__name__}: {e}")
            if entry is None:
                err = ServiceError(
                    "characterization-failed", "; ".join(errors)
                )
                for p in live:
                    if p.fp == fp:
                        p.error = err
                continue
            if rung > 0:
                with self._stats_lock:
                    self._stats["degraded"] += 1
                for p in live:
                    if p.fp == fp:
                        p.degraded = True
            self._cha[fp] = entry
            while len(self._cha) > max(4 * self._grid_cache_size, 64):
                self._cha.popitem(last=False)

    def _evaluate(self, live: list[_Pending]) -> None:
        """Back half: one fused device pass per (model spec, bucket) for
        every (fingerprint, model spec) not already in the grid cache."""
        need: dict[str, list[str]] = {}
        for p in live:
            key = (p.fp, p.model_key)
            if key in self._grids:
                p.grid_hit = True
                self._grids.move_to_end(key)
            elif p.fp in self._cha:
                need.setdefault(p.model_key, [])
                if p.fp not in need[p.model_key]:
                    need[p.model_key].append(p.fp)
        with self._stats_lock:
            self._stats["grid_hits"] += sum(1 for p in live if p.grid_hit)
            self._stats["grid_misses"] += sum(len(v) for v in need.values())
        for model_key, fps in need.items():
            table = self._tables[model_key]
            try:
                self._evaluate_group(model_key, fps, table)
            except KernelError:
                raise
            except ValueError as e:
                # The fused pass's host-side guard: some (circuit,
                # variant) cell has no finite energy — a poisoned model
                # spec.  Every request sharing the spec gets the
                # structured error; other groups are untouched.
                err = ServiceError("no-finite-energy", str(e))
                for p in live:
                    if p.model_key == model_key and p.fp in fps:
                        p.error = err
            except Exception as e:  # noqa: BLE001 - worker must survive
                err = ServiceError("internal", f"{type(e).__name__}: {e}")
                for p in live:
                    if p.model_key == model_key and p.fp in fps:
                        p.error = err

    def _evaluate_group(
        self, model_key: str, fps: list[str], table: ModelTable | None
    ) -> None:
        suite = SuiteTable.from_cha(
            {fp: self._cha[fp][0] for fp in fps}
        )
        n_variants = 1 if table is None else len(table)
        padded, bucket = bucket_suite(suite, len(self._topos), n_variants)
        # The batched pass uses the budget-free capacity mask (exactly
        # what `explore_suite` computes); per-request budgets fold in at
        # re-rank time so one cached grid serves every constraint.
        feas = np.stack(
            [
                self._capacity_feasible(self._cha[fp][1])
                for fp in padded.circuits[: len(fps)]
            ]
            + [self._capacity_feasible(self._cha[fps[0]][1])]
            * (len(padded.circuits) - len(fps))
        )
        t0 = time.perf_counter()
        sg, _sel = evaluate_select_suite(
            padded,
            self._topos,
            table if table is not None else self._model,
            mode=self._mode,
            discipline=self._discipline,
            feasible=feas,
            max_latency_ns=None,
            lazy=True,
            device=self.device,
        )
        with self._stats_lock:
            self._stats["batches"] += 1
            self._stats["evaluate_calls"] += 1
            self._stats["evaluate_ms"] += int(
                (time.perf_counter() - t0) * 1e3
            )
        self._buckets[bucket] += 1
        is_sweep = table is not None
        n = len(self._topos) * len(padded.recipes)
        for fp in fps:
            row = sg.variation(fp) if is_sweep else sg.grid(fp)
            # the lazy grid's raw device tensors, flattened topology-major
            energy = row._raw("energy_nj").reshape(-1, n)[-n_variants:]
            latency = row._raw("latency_ns").reshape(-1, n)[-n_variants:]
            # model-free capacity mask: (1, N) bools, cached on the host
            fits = row._raw("fits").reshape(1, n).cpu().numpy()
            self._grids[(fp, model_key)] = _GridEntry(
                row=row,
                energy=energy,
                latency=latency,
                fits=fits,
                min_gates=self._cha[fp][1],
                nominal_model=(
                    self._model if table is None
                    else (table.model(0) if table.uniform_row(0) else None)
                ),
                is_sweep=is_sweep,
                bucket=bucket,
            )
            while len(self._grids) > self._grid_cache_size:
                self._grids.popitem(last=False)

    # -- per-request re-rank -------------------------------------------------

    def _capacity_feasible(
        self, min_gates: int, within: np.ndarray | None = None
    ) -> np.ndarray:
        """Alg. I line 9 over the (optionally budget-restricted) library:
        capacity-feasible topologies, falling back to the largest
        in-budget candidate when nothing fits — byte-for-byte the
        `explorer._opt_and_feasible` rule applied inside the budget."""
        total_bits = self._topos.total_bits
        feas = total_bits >= BITS_PER_GATE * min_gates
        if within is not None:
            feas = feas & within
            if not feas.any():
                feas = np.zeros(len(self._topos), dtype=bool)
                feas[int(np.argmax(np.where(within, total_bits, -1)))] = True
        elif not feas.any():
            feas = np.zeros(len(self._topos), dtype=bool)
            feas[int(np.argmax(total_bits))] = True
        return feas

    def _answer(self, p: _Pending, t0: float) -> None:
        entry = self._grids[(p.fp, p.model_key)]
        r = p.request
        n_r = len(entry.row.recipes)
        n = len(self._topos) * n_r

        within = None
        if r.max_memory_kb is not None:
            within = self._total_kb <= r.max_memory_kb
            if not within.any():
                p.error = ServiceError(
                    "infeasible-memory",
                    f"no candidate topology fits the {r.max_memory_kb} KB "
                    f"budget (smallest candidate is "
                    f"{self._total_kb.min():g} KB)",
                )
                self._resolve(p, t0)
                return
        feas = self._capacity_feasible(entry.min_gates, within)
        feas_flat = np.broadcast_to(
            feas[:, None], (len(self._topos), n_r)
        ).reshape(1, n)

        energy = entry.energy
        if within is not None and not within.all():
            # Budget exclusion must hold in EVERY tier (a restricted
            # library simply does not contain the big topologies), so
            # out-of-budget cells become +inf — inadmissible everywhere,
            # exactly like `explore_request`'s restricted list.  The
            # fp64 tensor stays on the device and stays fp64.
            mask = np.broadcast_to(
                within[:, None], (len(self._topos), n_r)
            ).reshape(1, n)
            energy = torch.where(
                torch.as_tensor(mask, device=energy.device), energy, torch.inf
            )
        try:
            # Always through the latency tier (an absent bound is +inf,
            # which admits every finite latency), as the reference does.
            idx = select_best_batch_device(
                energy,
                entry.fits,
                latency=entry.latency,
                max_latency=(
                    r.max_latency_ns
                    if r.max_latency_ns is not None
                    else np.inf
                ),
                feasible=feas_flat,
                device=self.device,
            )
        except ValueError as e:
            p.error = ServiceError("no-finite-energy", str(e))
            self._resolve(p, t0)
            return

        flat0 = int(idx[0])
        ti, ri = flat0 // n_r, flat0 % n_r
        cell = (
            entry.row.cell(0, ti, ri)
            if entry.is_sweep
            else entry.row.cell(ti, ri)
        )
        resp = self._response(p, t0)
        resp.winner = Winner(
            recipe=cell.recipe,
            topology=cell.topology,
            energy_nj=cell.energy_nj,
            latency_ns=cell.latency_ns,
            power_mw=cell.power_mw,
            area_mm2=cell.area_mm2,
            fits=cell.fits,
            meets_latency=(
                r.max_latency_ns is None
                or cell.latency_ns <= r.max_latency_ns
            ),
            inductor_nh=(
                None
                if entry.nominal_model is None
                else inductor_size_nh(cell.topology, entry.nominal_model)
            ),
        )
        if entry.is_sweep:
            resp.variation = self._variation_summary(entry, idx, r)
        p.future.set_result(resp)
        with self._stats_lock:
            self._stats["served"] += 1

    def _variation_summary(
        self, entry: _GridEntry, idx: np.ndarray, r: ExploreRequest
    ) -> VariationSummary:
        row: VariationGrid = entry.row
        pairs = [row.unravel(int(i)) for i in idx]
        winners = tuple(
            (row.recipes[ri], row.topologies[ti]) for ti, ri in pairs
        )
        share, best_yield = winner_summary(
            [
                f"{topo.name}/{','.join(recipe) or '-'}"
                for recipe, topo in winners
            ]
        )
        # Device gathers: (V,) vectors are the only transfers here.
        idx_t = torch.as_tensor(idx, dtype=torch.int64, device=entry.energy.device)
        winner_energy = (
            torch.gather(entry.energy, -1, idx_t[:, None])[:, 0]
            .cpu().numpy().astype(float)
        )
        nominal_fits = bool(entry.fits[0, int(idx[0])])
        ok = np.full(len(idx), nominal_fits)
        if r.max_latency_ns is not None:
            lat_nom = entry.latency[:, int(idx[0])].cpu().numpy()
            ok &= lat_nom <= r.max_latency_ns
        return VariationSummary(
            n_variants=len(idx),
            winners=winners,
            winner_share=share,
            best_yield=best_yield,
            latency_yield=float(np.mean(ok)),
            winner_energy_nj=winner_energy,
            energy_quantiles={
                q: float(np.quantile(winner_energy, q))
                for q in ENERGY_QUANTILES
            },
        )

    def _response(self, p: _Pending, t0: float) -> ExploreResponse:
        entry = self._grids.get((p.fp, p.model_key))
        return ExploreResponse(
            request=p.request,
            error=p.error,
            fingerprint=p.fp,
            bucket=getattr(entry, "bucket", None),
            cha_cache_hit=p.cha_hit,
            grid_cache_hit=p.grid_hit,
            degraded=p.degraded,
            queued_ms=(t0 - p.t_submit) * 1e3,
            service_ms=(time.perf_counter() - t0) * 1e3,
        )

    def _resolve(self, p: _Pending, t0: float) -> None:
        p.future.set_result(self._response(p, t0))
        with self._stats_lock:
            self._stats["errors"] += 1
