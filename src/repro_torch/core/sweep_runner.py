"""Journaled, resumable (circuit x variant) sweeps, on the card.

`evaluate_select_suite` answers a whole circuits x variants x topologies
x recipes sweep in one device call, but a week-long million-design run
is many such calls — and a `kill -9` (preemption, OOM, node loss)
anywhere in the sequence used to lose everything.  `SweepRunner`
partitions the circuit axis into fixed-size shards, evaluates each
through the fused device pipeline, and journals every completed shard's
`SelectionResult` rows through `ckpt.manager.CheckpointManager`
— so a killed sweep resumes from the journal, re-running only the shards
that never published, and the assembled result is **bit-identical** to
an uninterrupted run (pinned by tests/test_torch_sweep_runner.py).

Why sharding preserves bit-identity:

  * only the *circuit* axis is sharded.  Every `SelectionResult` row —
    winner index, winner metrics, and the ``nominal_*`` fields (defined
    at that circuit's variant-0 winner) — depends on its own circuit's
    rows alone, so a row computed inside a 4-circuit shard equals the
    same row inside the full suite.  The variant axis is never split:
    splitting it would detach ``nominal_latency_ns`` from the global
    variant-0 winner cell.
  * every shard is padded to one fixed bucket shape
    ``(shard_size, R, L_suite, T, V)`` via `batch.pad_suite` (pad rows
    duplicate the shard's first circuit, so they stay finite and never
    trip the fused all-non-finite guard), and level padding is masked
    out by the schedule code — `pad_suite`'s per-real-circuit
    bit-identity contract.

Journal format (one `CheckpointManager` step per shard: one crc-framed
append to ``journal.wal``; the same format as the reference package's
journal, so either package reads the other's):

  * the arrays — ``winner_idx`` (c, V) int32, ``nominal_latency_ns``
    (c, V) float64, ``nominal_fits`` (c,) bool, and one ``met_<key>``
    (c, V) float64 per `batch._METRIC_KEYS` entry, where ``c`` counts
    the shard's *real* circuits (padding is sliced off before
    journaling).
  * the step's ``meta`` — the sweep ``config`` fingerprint (`sweep_config_key`),
    the shard's ``circuits`` (row order), ``n_variants``, and the
    device-``sharded`` flag.

Resume is keyed **per circuit**, not per shard boundary: a journal entry
contributes every circuit row whose name is still wanted, so a resumed
run may re-chunk the remaining circuits differently (or a later caller
may change ``shard_size``) and still assemble the identical result.  A
journal entry that fails `CheckpointManager.load_arrays`'s manifest
check (torn write surviving the rename — simulated by the
``journal.write`` fault point) is evicted and its shard re-run; an entry
whose ``config`` fingerprint differs is ignored (a different sweep
sharing the directory — the reference package's journal included: the
port's fingerprint carries a ``torch`` tag, so neither package adopts
the other's shards).

The front half runs through `transforms.characterize_suite` on
``device`` (K1 on the card for a cold circuit), with per-circuit
quarantine of bad netlists; a `KernelError` is never quarantined and
raises out of `SweepRunner.run`.  Every entry point takes ``device=``
(default ``cuda``, raising without a card; ``"cpu"`` runs the plain
torch versions).

CLI (the kill-9 test harness)::

    python -m repro_torch.core.sweep_runner --journal /tmp/j --out /tmp/sel.npz \
        --circuits adder,bar,max --scale tiny --recipes ";Rw;Ba,Rw" \
        --shard-size 2 --topos 5 --device cpu

prints ``shard <n> done: <names>`` after each published shard, so a
supervisor can SIGKILL it mid-sweep and re-invoke to resume.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Sequence

import numpy as np
import torch

from ..ckpt.manager import CheckpointCorruptError, CheckpointManager
from ..device import resolve_device
from ..runtime import faults
from .aig import Aig
from .batch import (
    SelectionResult,
    SuiteTable,
    TopologyTable,
    _METRIC_KEYS,
    evaluate_select_suite,
    pad_suite,
)
from .explorer import _opt_and_feasible, _restrict_cha
from .sram import (
    TOPOLOGY_LIBRARY,
    EnergyModel,
    ModelTable,
    SramTopology,
)
from .transforms import (
    TRANSFORM_VERSION,
    CharacterizationError,
    PoolPolicy,
    characterize_suite,
)


def sweep_config_key(
    circuits: Mapping[str, Aig],
    recipes: "Sequence[tuple[str, ...]] | None",
    topos: Sequence[SramTopology],
    model: "EnergyModel | ModelTable | None",
    mode: str,
    discipline: str,
    max_latency_ns: "float | None",
) -> str:
    """Content fingerprint of everything that determines a sweep's
    numbers.  Journal entries carry it, and resume only consumes entries
    whose key matches — so a changed model table, recipe list, circuit
    definition, or transform implementation can never smuggle stale rows
    into a fresh sweep.  The ``torch`` tag keeps the key apart from the
    reference package's for the same inputs."""
    import hashlib

    h = hashlib.sha1()
    h.update(b"torch:")
    h.update(f"v{TRANSFORM_VERSION}:{mode}:{discipline}".encode())
    h.update(repr(max_latency_ns).encode())
    for name, rtl in circuits.items():
        h.update(f"{name}={rtl.fingerprint()};".encode())
    if recipes is None:
        h.update(b"recipes=all64")
    else:
        h.update(repr([tuple(r) for r in recipes]).encode())
    h.update(repr([(t.name, t.rows, t.cols, t.n_macros) for t in topos]).encode())
    if isinstance(model, ModelTable):
        h.update(model.content_key().encode())
    elif model is None:
        h.update(b"model=nominal")
    else:
        h.update(repr(dataclasses.astuple(model)).encode())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class SweepOutcome:
    """What a journaled sweep hands back.

    ``selection`` is assembled per circuit in input order and is
    bit-identical to an uninterrupted `evaluate_select_suite` over the
    same (surviving) circuits.  ``failures`` carries quarantined
    characterization errors (`CharacterizationError`) for circuits that
    never reached the sweep; their rows are simply absent."""

    selection: SelectionResult
    circuits: tuple[str, ...]
    shards_run: int
    shards_resumed: int
    failures: dict[str, CharacterizationError]
    journal_dir: "str | None"
    config_key: str


def _slice_suite(suite: SuiteTable, lo: int, hi: int) -> SuiteTable:
    """A contiguous circuit-axis slice sharing the suite's level axis."""
    op_totals = suite.op_totals[lo:hi]
    return SuiteTable(
        circuits=suite.circuits[lo:hi],
        recipes=suite.recipes,
        ops=suite.ops[lo:hi],
        n_levels=suite.n_levels[lo:hi],
        op_totals=op_totals,
        gates=suite.gates[lo:hi],
    )


class SweepRunner:
    """Shard, evaluate, journal, resume — see the module docstring.

    ``journal_dir=None`` runs without a journal (pure sharded
    evaluation, still bit-identical); ``shard_size=None`` evaluates the
    whole suite as one shard."""

    def __init__(
        self,
        journal_dir: "str | os.PathLike | None" = None,
        shard_size: "int | None" = 4,
        on_shard=None,
    ):
        if shard_size is not None and shard_size < 1:
            raise ValueError("shard_size must be >= 1")
        self.journal_dir = os.fspath(journal_dir) if journal_dir else None
        self.shard_size = shard_size
        #: called as ``on_shard(index, circuit_names)`` after each shard
        #: publishes — the kill-9 harness's pacing signal.
        self.on_shard = on_shard

    def run(
        self,
        circuits: Mapping[str, Aig],
        sram_list: Sequence[SramTopology] = TOPOLOGY_LIBRARY,
        recipes: "Sequence[tuple[str, ...]] | None" = None,
        model: "EnergyModel | ModelTable | None" = None,
        mode: str = "physical",
        discipline: str = "list",
        max_latency_ns: "float | None" = None,
        cache=None,
        n_jobs: "int | None" = None,
        cha_backend: str = "auto",
        policy: "PoolPolicy | None" = None,
        shard: "bool | None" = None,
        device: "str | torch.device | None" = None,
    ) -> SweepOutcome:
        dev = resolve_device(device)
        if not circuits:
            raise ValueError("empty sweep")
        sram_list = list(sram_list)
        config = sweep_config_key(
            circuits, recipes, sram_list, model, mode, discipline,
            max_latency_ns,
        )

        # Front half, with per-circuit quarantine: a poisoned netlist is
        # reported in the outcome instead of sinking the sweep (a
        # KernelError is never quarantined: it raises).
        failures: dict[str, CharacterizationError] = {}
        cha = characterize_suite(
            circuits, recipes, cache=cache, n_jobs=n_jobs,
            backend=cha_backend, policy=policy, failures=failures,
            device=dev,
        )
        cha = {n: _restrict_cha(cha[n], recipes) for n in cha}
        names = [n for n in circuits if n in cha]
        if not names:
            raise CharacterizationError(
                "<suite>", f"every circuit failed characterization: "
                f"{sorted(failures)}"
            )

        feas_mask = np.zeros((len(names), len(sram_list)), dtype=bool)
        for i, name in enumerate(names):
            _, _, feasible = _opt_and_feasible(cha[name], sram_list)
            feas_mask[i] = [t in feasible for t in sram_list]

        suite = SuiteTable.from_cha(cha)
        topo_table = TopologyTable.from_topologies(sram_list)

        # Each shard publishes as ONE crc-framed append to the
        # directory's journal.wal (wal=True) through the shared async
        # writer: per-step files pay a file-create + rename per shard,
        # the log pays one buffered write into an already-open fd.
        # Writers publish in call order;
        # `wait()` makes durability observable at the pacing callback
        # and on the crash path.  The success path does NOT drain: a
        # shard lost between return and its in-flight publish is simply
        # re-run on resume — and the resume scan below drains first, so
        # a same-process resume always sees every completed publish.
        manager = (
            CheckpointManager(self.journal_dir, keep_n=1 << 30,
                              async_save=True, wal=True,
                              defer_snapshot=True)
            if self.journal_dir is not None
            else None
        )

        # -- resume: adopt journaled rows (keyed per circuit) ---------------
        rows: dict[str, dict[str, np.ndarray]] = {}
        resumed_shards = 0
        dev_sharded: "bool | None" = None
        next_step = 0
        if manager is not None:
            try:
                manager.wait()  # adopt in-flight publishes of a prior run
            except Exception:
                pass  # a prior run's write failure: its shard is re-run
            for step in manager.steps():
                next_step = max(next_step, step + 1)
                try:
                    arrays, meta = manager.load_arrays(step)
                except CheckpointCorruptError:
                    manager.remove(step)  # torn entry: redo its shard
                    continue
                info = meta.get("meta", {})
                if info.get("config") != config:
                    continue  # some other sweep shares this journal dir
                entry_names = info.get("circuits", [])
                used = False
                for i, cname in enumerate(entry_names):
                    if cname not in cha or cname in rows:
                        continue
                    rows[cname] = {k: arrays[k][i] for k in arrays}
                    used = True
                if used:
                    resumed_shards += 1
                    dev_sharded = bool(info.get("sharded", False))

        # -- evaluate the missing circuits shard by shard -------------------
        todo = [n for n in names if n not in rows]
        size = self.shard_size or max(len(todo), 1)
        shards_run = 0
        try:
            for lo in range(0, len(todo), size):
                chunk = todo[lo : lo + size]
                faults.inject("sweep.shard", detail=",".join(chunk))
                idx = [names.index(n) for n in chunk]
                lo_i, hi_i = idx[0], idx[-1] + 1
                assert idx == list(range(lo_i, hi_i)), "todo is order-preserving"
                part = pad_suite(
                    _slice_suite(suite, lo_i, hi_i),
                    n_circuits=size,
                    pad_levels_to=suite.ops.shape[2],
                )
                feas = np.concatenate(
                    [
                        feas_mask[lo_i:hi_i],
                        np.broadcast_to(
                            feas_mask[lo_i],
                            (size - len(chunk), len(sram_list)),
                        ),
                    ]
                )
                _, sel = evaluate_select_suite(
                    part, topo_table, model, mode=mode, discipline=discipline,
                    feasible=feas, max_latency_ns=max_latency_ns, lazy=True,
                    shard=shard, device=dev,
                )
                dev_sharded = sel.sharded
                payload = {
                    "winner_idx": sel.winner_idx[: len(chunk)],
                    "nominal_latency_ns": sel.nominal_latency_ns[: len(chunk)],
                    "nominal_fits": sel.nominal_fits[: len(chunk)],
                }
                for k in _METRIC_KEYS:
                    payload[f"met_{k}"] = sel.winner_metrics[k][: len(chunk)]
                if manager is not None:
                    manager.save(
                        next_step,
                        payload,
                        meta=dict(
                            config=config,
                            circuits=list(chunk),
                            n_variants=int(sel.winner_idx.shape[-1]),
                            sharded=bool(sel.sharded),
                        ),
                    )
                    next_step += 1
                for i, cname in enumerate(chunk):
                    rows[cname] = {k: payload[k][i] for k in payload}
                shards_run += 1
                if self.on_shard is not None:
                    if manager is not None:
                        # The pacing signal doubles as the durability
                        # signal (the kill-9 harness kills right after
                        # it), so drain the writer chain first.
                        manager.wait()
                    self.on_shard(shards_run - 1, tuple(chunk))
        except BaseException:
            # Drain the writer on the crash path so the journal is
            # consistent (every queued entry fully published) the moment
            # run() raises; a writer failure must not mask the crash.
            if manager is not None:
                try:
                    manager.wait()
                except Exception:
                    pass
            raise

        return SweepOutcome(
            selection=_assemble(names, rows, bool(dev_sharded)),
            circuits=tuple(names),
            shards_run=shards_run,
            shards_resumed=resumed_shards,
            failures=failures,
            journal_dir=self.journal_dir,
            config_key=config,
        )


def _assemble(
    names: Sequence[str],
    rows: Mapping[str, Mapping[str, np.ndarray]],
    dev_sharded: bool,
) -> SelectionResult:
    """Stack per-circuit rows (input order) into one `SelectionResult`.

    ``payload_bytes`` is recomputed with `batch._fetch_selection`'s
    formula (winner indices + the implicit (C, V) has-finite flags +
    nominal fields + winner metrics), so the assembled result equals a
    direct uninterrupted run field for field."""
    winner_idx = np.stack([rows[n]["winner_idx"] for n in names])
    nominal_latency = np.stack([rows[n]["nominal_latency_ns"] for n in names])
    nominal_fits = np.stack([rows[n]["nominal_fits"] for n in names])
    mets = {
        k: np.stack([rows[n][f"met_{k}"] for n in names])
        for k in _METRIC_KEYS
    }
    payload = (
        winner_idx.nbytes
        + winner_idx.size * np.dtype(bool).itemsize  # has_finite (C, V)
        + nominal_latency.nbytes
        + nominal_fits.nbytes
        + sum(v.nbytes for v in mets.values())
    )
    return SelectionResult(
        winner_idx=winner_idx,
        winner_metrics=mets,
        nominal_latency_ns=nominal_latency,
        nominal_fits=nominal_fits,
        payload_bytes=payload,
        sharded=dev_sharded,
    )


def run_sweep(
    circuits: Mapping[str, Aig],
    journal_dir: "str | os.PathLike | None" = None,
    shard_size: "int | None" = 4,
    **kwargs,
) -> SweepOutcome:
    """Convenience wrapper: ``SweepRunner(journal_dir, shard_size).run(...)``."""
    return SweepRunner(journal_dir, shard_size).run(circuits, **kwargs)


def _parse_recipes(spec: "str | None") -> "list[tuple[str, ...]] | None":
    """``";Rw;Ba,Rw"`` -> ``[(), ("Rw",), ("Ba", "Rw")]`` (None = all 64)."""
    if spec is None:
        return None
    out = []
    for part in spec.split(";"):
        part = part.strip()
        out.append(tuple(t for t in part.split(",") if t))
    return out


def main(argv: "Sequence[str] | None" = None) -> int:
    import argparse

    from .circuits import benchmark_suite

    ap = argparse.ArgumentParser(
        description="journaled resumable sweep (kill -9 safe)"
    )
    ap.add_argument("--journal", required=True, help="journal directory")
    ap.add_argument("--out", required=True, help="output .npz path")
    ap.add_argument("--circuits", default="adder,bar,max,sqrt",
                    help="comma-separated generator names")
    ap.add_argument("--scale", default="tiny")
    ap.add_argument("--recipes", default=";Rw;Ba,Rw;Rf",
                    help="';'-separated recipes, ','-separated transforms")
    ap.add_argument("--shard-size", type=int, default=2)
    ap.add_argument("--topos", type=int, default=5,
                    help="use the first N library topologies")
    ap.add_argument("--mode", default="physical")
    ap.add_argument("--discipline", default="list")
    ap.add_argument("--max-latency-ns", type=float, default=None)
    ap.add_argument("--cache", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    circuits = benchmark_suite(args.scale, only=args.circuits.split(","))

    def on_shard(i, names):
        print(f"shard {i} done: {','.join(names)}", flush=True)

    runner = SweepRunner(args.journal, args.shard_size, on_shard=on_shard)
    outcome = runner.run(
        circuits,
        sram_list=TOPOLOGY_LIBRARY[: args.topos],
        recipes=_parse_recipes(args.recipes),
        mode=args.mode,
        discipline=args.discipline,
        max_latency_ns=args.max_latency_ns,
        cache=args.cache,
        n_jobs=1,
        device=args.device,
    )
    sel = outcome.selection
    np.savez(
        args.out,
        circuits=np.array(outcome.circuits),
        winner_idx=sel.winner_idx,
        nominal_latency_ns=sel.nominal_latency_ns,
        nominal_fits=sel.nominal_fits,
        payload_bytes=np.int64(sel.payload_bytes),
        shards_run=np.int64(outcome.shards_run),
        shards_resumed=np.int64(outcome.shards_resumed),
        **{f"met_{k}": v for k, v in sel.winner_metrics.items()},
    )
    print(
        f"sweep done: {len(outcome.circuits)} circuits, "
        f"{outcome.shards_run} shards run, "
        f"{outcome.shards_resumed} resumed, "
        f"{len(outcome.failures)} quarantined",
        flush=True,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
