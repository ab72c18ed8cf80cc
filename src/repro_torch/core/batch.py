"""Tensorized back half of Algorithm I — the rapid-assessment engine, in
torch (fp64 / int64 on an explicit device).

The scalar path (`mapping.schedule_stats` + `sram.evaluate` inside
`explorer.explore`) walks the (recipe x topology) grid one Python
dataclass at a time; this module batches it into a structure-of-arrays
program so the whole ChaAIG -> Evaluate -> FilterEnergy sweep is one pass
of torch tensor ops:

  * ``TopologyTable``  — the SRAM topology library stacked into arrays;
  * ``WorkloadTable`` / ``SuiteTable`` — the characterized recipes
    stacked into ``(R, L, 3)`` / ``(C, R, L, 3)`` op-count tensors;
  * ``evaluate_batch`` / ``evaluate_suite`` — `mapping.schedule_stats`
    (both disciplines) and `sram.evaluate` (both modes) over the grid,
    yielding an ``ExplorationGrid`` / ``SuiteGrid`` — or, given a
    `sram.ModelTable`, a ``VariationGrid`` / ``SuiteVariationGrid`` with
    a model-variant axis.  These are the host-selection (``fused=False``)
    parity path;
  * ``evaluate_select_batch`` / ``evaluate_select_suite`` — the fused
    pipeline: the same three-tier argmin runs as tensor ops on the
    device, only a ``SelectionResult`` (winner indices + per-winner
    metrics, a few KB) crosses to the host, and the returned grids are
    *lazy* (`_LazyArrays`) — their tensors stay on the device until first
    access;
  * ``select_best`` / ``select_best_batch`` / ``select_best_worst`` — the
    numpy admissibility filter + energy argmin shared with the explorer;
    ``select_best_batch_device`` runs it on the device for precomputed
    metric arrays;
  * ``pad_suite`` / ``bucket_suite`` — snap a suite onto a canonical
    ``(C, R, L_pad, T, V)`` bucket, the exploration service's batch
    group and the sweep runner's shard shape.

Where the reference vmapped over variants and circuits, the port writes
those axes out: every kernel works on ``(C, V, T, R)`` tensors (circuits,
variants, topologies, recipes — already the final, topology-major
layout), and the single-circuit entry points run the suite code with
C = 1.  All floats are ``torch.float64`` and all schedule integers
``torch.int64``, created explicitly.

Parity contract: every cycle/flag quantity is exact integer arithmetic,
and the energy expressions are the *same functions* the scalar path uses
(`sram.paper_power_mw` / `sram.physical_energy_nj`, plus the per-op sum
written in the scalar path's order), evaluated in float64, so
``backend="torch"`` matches ``backend="python"`` to float round-off.
Flattened grids are topology-major — the exact iteration order of the
scalar loops — so argmin tie-breaking (lowest flat index) also matches.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Mapping, NamedTuple, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .aig import AigStats
from .mapping import BITS_PER_GATE, macros_per_type
from .sram import (
    OP_TYPES,
    EnergyModel,
    ModelTable,
    SramTopology,
    area_mm2_arrays,
    paper_energy_nj,
    paper_power_mw,
    physical_energy_nj,
)

LEVEL_PAD = 64  # pad the level axis to multiples of this (shape bucketing)

F64 = torch.float64


class ModelParams(NamedTuple):
    """The `EnergyModel` constants the evaluate pass reads, as float64
    arrays with a leading variant axis.  A NamedTuple so the `sram` mode
    helpers' ``model.<field>`` attribute reads work unchanged on it (the
    device copy, `_model_tensors`, holds broadcast-ready tensors).

    Scalar fields are ``(V,)`` for uniform sweeps or ``(V, T)`` for
    correlated (topology-dependent) variation — per-op fields likewise
    ``(V, 3)`` or ``(V, T, 3)``; the grid arithmetic broadcasts either
    along the topology axis — the same float ops either way."""
    f_clk_hz: np.ndarray            # (V,) or (V, T)
    e_op_marginal_fj: np.ndarray    # (V, 3) or (V, T, 3)
    p_ctrl_mw: np.ndarray           # (V,) or (V, T)
    e_macro_cycle_fj: np.ndarray    # (V,) or (V, T)
    e_col_cycle_fj: np.ndarray      # (V,) or (V, T)
    alpha_mw_per_level: np.ndarray  # (V,) or (V, T)
    pipeline_utilization: np.ndarray  # (V,) or (V, T)


def _model_params(table: ModelTable) -> ModelParams:
    return ModelParams(
        **{
            f: np.asarray(getattr(table, f), dtype=np.float64)
            for f in ModelParams._fields
        }
    )


def _as_table(model: "EnergyModel | ModelTable | None") -> tuple[ModelTable, bool]:
    """Normalize a model argument to a `ModelTable`; the bool flags
    whether the caller asked for a variant sweep (vs a single model)."""
    if isinstance(model, ModelTable):
        return model, True
    if model is None:
        model = EnergyModel()
    return ModelTable.from_models([model]), False


def _check_topo_axis(table: ModelTable, topos: "TopologyTable") -> None:
    """A correlated table's per-topology axis must match the topology
    table it is swept against (a `(V, 1)` axis broadcasts uniformly) —
    by width, and by *identity* when the table records which topologies
    its columns were generated for: a same-length but different/reordered
    topology list would silently land each column's variation on the
    wrong macro geometry."""
    if len(table) == 0:
        raise ValueError("empty ModelTable")
    t = table.n_topologies
    if t is not None and t != len(topos):
        raise ValueError(
            f"ModelTable per-topology axis has width {t}, but the sweep "
            f"covers {len(topos)} topologies"
        )
    if table.topology_names is not None:
        actual = tuple(tp.name for tp in topos.topologies)
        if table.topology_names != actual:
            raise ValueError(
                "ModelTable's per-topology columns were generated for "
                f"topologies {table.topology_names}, but the sweep covers "
                f"{actual} — regenerate the table for this topology list"
            )


def _per_topo(arr: np.ndarray) -> np.ndarray:
    """A scalar `ModelTable` field as a (V, 1)-or-(V, T) column view, so
    it broadcasts against (T,) topology arrays either way."""
    return arr[:, None] if arr.ndim == 1 else arr


# ---------------------------------------------------------------------------
# Structure-of-arrays tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TopologyTable:
    """The SRAM topology library as stacked arrays (one row per topology).

    Units: ``total_bits`` in bits (capacity check is
    ``mapping.BITS_PER_GATE`` = 4 bits/gate), ``ops_per_cycle`` in
    gate-ops per macro per clock cycle (``cols/2`` sense-amp slots).
    """

    topologies: tuple[SramTopology, ...]
    rows: np.ndarray            # (T,) bitcell rows per macro
    cols: np.ndarray            # (T,) bitcell columns per macro
    n_macros: np.ndarray        # (T,)
    total_bits: np.ndarray      # (T,) capacity in bits, all macros
    ops_per_cycle: np.ndarray   # (T,) sense-amp slots per macro per cycle
    macros_per_type: np.ndarray  # (T, 3) dedicated macros per op type
    is_single: np.ndarray       # (T,) bool — time-multiplexed single macro

    @classmethod
    def from_topologies(cls, topos: Sequence[SramTopology]) -> "TopologyTable":
        """Stack topologies (library entries and/or `sram.topology_grid`
        design points) into one table; rejects unsupported macro counts."""
        topos = tuple(topos)
        if not topos:
            raise ValueError("empty topology list")
        return cls(
            topologies=topos,
            rows=np.array([t.rows for t in topos], dtype=np.int32),
            cols=np.array([t.cols for t in topos], dtype=np.int32),
            n_macros=np.array([t.n_macros for t in topos], dtype=np.int32),
            total_bits=np.array([t.total_bits for t in topos], dtype=np.int32),
            ops_per_cycle=np.array(
                [t.ops_per_cycle_per_macro for t in topos], dtype=np.int32
            ),
            macros_per_type=np.array(
                [macros_per_type(t.n_macros) for t in topos], dtype=np.int32
            ),
            is_single=np.array([t.n_macros == 1 for t in topos], dtype=bool),
        )

    def __len__(self) -> int:
        return len(self.topologies)

    def area_mm2(self, model: "EnergyModel | ModelTable") -> np.ndarray:
        """Vectorized `SramTopology.area_mm2` — the same
        `sram.area_mm2_arrays` expression over the stacked ``total_bits``:
        ``(T,)`` for one `EnergyModel`, ``(V, T)`` for a `ModelTable`
        (whose area fields may themselves be per-topology ``(V, T)``)."""
        if isinstance(model, ModelTable):
            _check_topo_axis(model, self)
            return area_mm2_arrays(
                self.total_bits[None, :],
                _per_topo(model.bitcell_um2),
                _per_topo(model.periphery_overhead),
            )
        return area_mm2_arrays(
            self.total_bits.astype(np.float64),
            model.bitcell_um2,
            model.periphery_overhead,
        )


@dataclasses.dataclass(frozen=True)
class WorkloadTable:
    """Characterized recipes as a stacked op-count tensor.

    ``ops[r, l, k]`` is the number of ops of type ``OP_TYPES[k]`` in gate-
    netlist level ``l`` of recipe ``r``; levels beyond ``n_levels[r]`` are
    zero padding (the schedule kernels mask them out).
    """

    recipes: tuple[tuple[str, ...], ...]
    ops: np.ndarray        # (R, L_pad, 3)
    n_levels: np.ndarray   # (R,)
    op_totals: np.ndarray  # (R, 3)
    gates: np.ndarray      # (R,)

    @classmethod
    def from_stats(
        cls,
        items: Mapping[tuple[str, ...], AigStats]
        | Sequence[tuple[tuple[str, ...], AigStats]],
        pad_levels_to: int = LEVEL_PAD,
    ) -> "WorkloadTable":
        if isinstance(items, Mapping):
            items = list(items.items())
        items = list(items)
        if not items:
            raise ValueError("empty workload list")
        recipes = tuple(tuple(r) for r, _ in items)
        n_levels = np.array([s.n_levels for _, s in items], dtype=np.int32)
        max_l = int(n_levels.max(initial=1))
        pad = max(pad_levels_to, 1)
        l_pad = ((max(max_l, 1) + pad - 1) // pad) * pad
        ops = np.zeros((len(items), l_pad, len(OP_TYPES)), dtype=np.int32)
        for i, (_, s) in enumerate(items):
            m = s.ops_matrix()
            ops[i, : m.shape[0]] = m
        op_totals = ops.sum(axis=1)
        return cls(
            recipes=recipes,
            ops=ops,
            n_levels=n_levels,
            op_totals=op_totals,
            gates=op_totals.sum(axis=1),
        )

    def __len__(self) -> int:
        return len(self.recipes)


@dataclasses.dataclass(frozen=True)
class SuiteTable:
    """A whole benchmark suite's `WorkloadTable`s stacked on a leading
    circuit axis — the input of the circuits x recipes x topologies sweep.

    All circuits share one recipe list (Algorithm I applies the same 64
    recipes to every RTL input) and one padded level axis (the max over
    the suite, rounded up to `LEVEL_PAD`); levels beyond ``n_levels[c, r]``
    are zero padding which the schedule kernels mask out, so padded
    results are bit-identical to each circuit's own `WorkloadTable` run.

    ``ops[c, r, l, k]``: ops of type ``OP_TYPES[k]`` in level ``l`` of
    recipe ``r`` of circuit ``c``.
    """

    circuits: tuple[str, ...]
    recipes: tuple[tuple[str, ...], ...]
    ops: np.ndarray        # (C, R, L_pad, 3)
    n_levels: np.ndarray   # (C, R)
    op_totals: np.ndarray  # (C, R, 3)
    gates: np.ndarray      # (C, R)

    @classmethod
    def from_cha(
        cls,
        cha: Mapping[str, Mapping[tuple[str, ...], AigStats]],
        pad_levels_to: int = LEVEL_PAD,
    ) -> "SuiteTable":
        """Stack per-circuit characterizations (as produced by
        `transforms.characterize_suite` / `explorer.characterize_recipes`).
        Every circuit must cover the same recipe set."""
        if not cha:
            raise ValueError("empty suite")
        names = tuple(cha)
        recipes = tuple(cha[names[0]])
        for name in names:
            if tuple(cha[name]) != recipes:
                raise ValueError(
                    f"circuit {name!r} covers a different recipe set"
                )
        max_l = max(
            (s.n_levels for m in cha.values() for s in m.values()), default=1
        )
        pad = max(pad_levels_to, 1)
        l_pad = ((max(max_l, 1) + pad - 1) // pad) * pad
        tables = [
            WorkloadTable.from_stats(cha[name], pad_levels_to=l_pad)
            for name in names
        ]
        return cls.from_workloads(dict(zip(names, tables)))

    @classmethod
    def from_workloads(
        cls, works: Mapping[str, WorkloadTable]
    ) -> "SuiteTable":
        """Stack prebuilt workload tables, re-padding to a common level
        axis when they disagree."""
        if not works:
            raise ValueError("empty suite")
        names = tuple(works)
        recipes = works[names[0]].recipes
        for name in names:
            if works[name].recipes != recipes:
                raise ValueError(
                    f"circuit {name!r} covers a different recipe set"
                )
        l_pad = max(w.ops.shape[1] for w in works.values())
        ops = np.zeros(
            (len(names), len(recipes), l_pad, len(OP_TYPES)), dtype=np.int32
        )
        for i, name in enumerate(names):
            w = works[name].ops
            ops[i, :, : w.shape[1]] = w
        op_totals = ops.sum(axis=2)
        return cls(
            circuits=names,
            recipes=recipes,
            ops=ops,
            n_levels=np.stack([works[n].n_levels for n in names]),
            op_totals=op_totals,
            gates=op_totals.sum(axis=2),
        )

    def bucket_shape(self, n_topologies: int, n_variants: int = 1) -> tuple:
        """The bucket this table falls in (see `bucket_suite`):
        ``(C, R, L_pad, T, V)``.  The exploration service groups batches
        and labels responses by it."""
        c, r, l, _ = self.ops.shape
        return (c, r, l, int(n_topologies), int(n_variants))

    def workload(self, circuit: str | int) -> WorkloadTable:
        """One circuit's rows as a standalone `WorkloadTable` view."""
        c = self.circuit_index(circuit)
        return WorkloadTable(
            recipes=self.recipes,
            ops=self.ops[c],
            n_levels=self.n_levels[c],
            op_totals=self.op_totals[c],
            gates=self.gates[c],
        )

    def circuit_index(self, circuit: str | int) -> int:
        if isinstance(circuit, int):
            return circuit
        return self.circuits.index(circuit)

    def __len__(self) -> int:
        return len(self.circuits)


# ---------------------------------------------------------------------------
# Bucket-shape helpers (continuous batching for the exploration service)
# ---------------------------------------------------------------------------
#
# Eager torch has no trace to reuse, so bucketing buys no compile here.
# What it buys is a small, stable set of batch shapes: the circuit axis
# pads up to a power of two and the (already LEVEL_PAD-quantized) level
# axis up to a power-of-two multiple of LEVEL_PAD.  The exploration
# service groups its batches by that shape and reports it in every
# response (``ExploreResponse.bucket``); the sweep runner pads every
# shard to one shape.  Padding rows duplicate a real circuit (all cells
# stay finite, so the fused on-device selection never trips on them) and
# are named so callers can recognize and drop them; each real circuit's
# result is bit-identical to its unpadded run.

#: Name prefix of padding rows introduced by `pad_suite`.
PAD_CIRCUIT_PREFIX = "__pad"


def ceil_pow2(n: int) -> int:
    """Smallest power of two >= ``n`` (and >= 1)."""
    n = int(n)
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def bucket_levels(n_levels: int, pad: int = LEVEL_PAD) -> int:
    """Canonical level-axis width for a suite whose deepest circuit has
    ``n_levels`` levels: the smallest power-of-two multiple of ``pad``
    that covers it (64, 128, 256, ... for the default `LEVEL_PAD`), so
    progressively deeper circuits step through O(log L) shapes instead
    of one shape per depth."""
    pad = max(int(pad), 1)
    return pad * ceil_pow2(-(-max(int(n_levels), 1) // pad))


def pad_suite(
    suite: SuiteTable,
    n_circuits: int | None = None,
    pad_levels_to: int | None = None,
) -> SuiteTable:
    """Pad a `SuiteTable` into a canonical bucket shape.

    The circuit axis grows to ``n_circuits`` by *duplicating the first
    circuit's rows* under `PAD_CIRCUIT_PREFIX` names — real (finite)
    workloads rather than zeros, so every padded cell evaluates to
    finite metrics and the fused selection's all-non-finite guard never
    fires on padding.  The level axis grows to ``pad_levels_to`` with
    zero rows, which the schedule kernels mask out (``n_levels`` is
    unchanged) — padded results are bit-identical per real circuit.

    Defaults: ``n_circuits`` -> `ceil_pow2` of the current count,
    ``pad_levels_to`` -> `bucket_levels` of the current level width.
    """
    c, r, l, k = suite.ops.shape
    n_c = ceil_pow2(c) if n_circuits is None else int(n_circuits)
    l_pad = bucket_levels(l) if pad_levels_to is None else int(pad_levels_to)
    if n_c < c:
        raise ValueError(f"cannot pad {c} circuits down to {n_c}")
    if l_pad < l:
        raise ValueError(f"cannot pad level axis {l} down to {l_pad}")
    if n_c == c and l_pad == l:
        return suite
    names = list(suite.circuits)
    for i in range(n_c - c):
        names.append(f"{PAD_CIRCUIT_PREFIX}{i}")
    ops = np.zeros((n_c, r, l_pad, k), dtype=suite.ops.dtype)
    ops[:c, :, :l] = suite.ops
    ops[c:, :, :l] = suite.ops[0]
    n_levels = np.concatenate(
        [suite.n_levels, np.broadcast_to(suite.n_levels[0], (n_c - c, r))]
    )
    op_totals = ops.sum(axis=2)
    return SuiteTable(
        circuits=tuple(names),
        recipes=suite.recipes,
        ops=ops,
        n_levels=n_levels,
        op_totals=op_totals,
        gates=op_totals.sum(axis=2),
    )


def bucket_suite(
    suite: SuiteTable, n_topologies: int, n_variants: int = 1
) -> "tuple[SuiteTable, tuple]":
    """Snap a suite onto its canonical bucket: `pad_suite` with the
    default (power-of-two) targets, returning the padded table and its
    `SuiteTable.bucket_shape` key ``(C, R, L_pad, T, V)``."""
    padded = pad_suite(suite)
    return padded, padded.bucket_shape(n_topologies, n_variants)



# ---------------------------------------------------------------------------
# Grid kernels (torch tensor code on the device)
# ---------------------------------------------------------------------------


def _ceil_div(a, b):
    # floor division on int64 tensors: -(-a // b) is ceil for b > 0
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class _Operands:
    """The integer grid operands on the device: workload ``(C, R, L, 3)``
    op counts and ``(C, R)`` levels, topology ``(T,)`` / ``(T, 3)``
    arrays, all int64 (``is_single`` bool)."""

    ops: torch.Tensor
    n_levels: torch.Tensor
    width: torch.Tensor
    mpt: torch.Tensor
    is_single: torch.Tensor
    total_bits: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor

    @classmethod
    def build(cls, ops, n_levels, topos: "TopologyTable", device) -> "_Operands":
        def i64(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

        return cls(
            ops=i64(ops),
            n_levels=i64(n_levels),
            width=i64(topos.ops_per_cycle),
            mpt=i64(topos.macros_per_type),
            is_single=torch.as_tensor(np.asarray(topos.is_single, dtype=bool), device=device),
            total_bits=i64(topos.total_bits),
            rows=i64(topos.rows),
            cols=i64(topos.cols),
        )


def _schedule_core(o: _Operands, discipline: str):
    """Shared schedule math; mirrors mapping.schedule_stats exactly.

    Returns (cycles, active_macro_cycles, fits), each ``(C, T, R)``
    (int64, int64, bool)."""
    wt = o.width[:, None] * o.mpt                          # (T, 3)
    tot = o.ops.sum(dim=2)                                 # (C, R, 3)
    gates = tot.sum(dim=-1)                                # (C, R)
    single = o.is_single[None, :, None]                    # (1, T, 1)
    nl = o.n_levels[:, None, :]                            # (C, 1, R)

    if discipline == "list":
        # ASAP width-bound schedule: cycles = max(depth, width bound) + drain.
        b = _ceil_div(tot[:, None, :, :], wt[None, :, None, :])   # (C, T, R, 3)
        sum_b = b.sum(dim=-1)
        max_b = b.amax(dim=-1)
        width_bound = torch.where(single, sum_b, max_b)
        active = torch.where(
            single, sum_b, (b * o.mpt[None, :, None, :]).sum(dim=-1)
        )
        cycles = torch.maximum(nl, width_bound) + 1
        # Steady-state working set: ~width_bound/depth concurrent batches,
        # each needing 2 operand rows + 1 result row.
        rows_needed = 3 * _ceil_div(
            width_bound.clamp_min(1), nl.clamp_min(1)
        ) + 2
    elif discipline == "levels":
        # Lock-step: every real level pays max(1, per-type batch bound);
        # the single-macro case serializes the three op types.
        b = _ceil_div(
            o.ops[:, None, :, :, :], wt[None, :, None, None, :]
        )                                                  # (C, T, R, L, 3)
        n_l = o.ops.shape[2]
        real = (
            torch.arange(n_l, device=o.ops.device)[None, None, :]
            < o.n_levels[:, :, None]
        )                                                  # (C, R, L)
        sum_b = b.sum(dim=-1)                              # (C, T, R, L)
        max_b = b.amax(dim=-1)
        per_level = torch.where(
            o.is_single[None, :, None, None],
            sum_b.clamp_min(1),
            max_b.clamp_min(1),
        )
        per_level = per_level * real[:, None, :, :]
        cycles = per_level.sum(dim=-1) + 1                 # + pipeline drain
        active = torch.where(
            single,
            b.sum(dim=(-1, -2)),
            (b * o.mpt[None, :, None, None, :]).sum(dim=(-1, -2)),
        )
        # The busiest level's batch schedule is the peak working set.
        rows_needed = 3 * per_level.amax(dim=-1) + 2       # (C, T, R)
    else:
        raise ValueError(f"unknown discipline {discipline!r}")

    # Feasibility = bit capacity (Alg. I line 9) AND row budget — the
    # same two-term check as mapping.schedule_stats / _schedule_list.
    fits = (BITS_PER_GATE * gates[:, None, :] <= o.total_bits[None, :, None]) & (
        rows_needed <= o.rows[None, :, None]
    )
    return cycles, active, fits


def _model_tensors(params: ModelParams, device) -> ModelParams:
    """`ModelParams` as fp64 tensors shaped to broadcast against
    ``(C, V, T, R)``: scalar fields ``(V,)`` -> ``(1, V, 1, 1)`` and
    ``(V, T)`` -> ``(1, V, T, 1)``; the per-op field keeps its ``(V, 3)``
    / ``(V, T, 3)`` shape (`_evaluate_core` splits it by op type)."""
    out = {}
    for f in ModelParams._fields:
        t = torch.as_tensor(np.asarray(getattr(params, f), dtype=np.float64), device=device)
        if f != "e_op_marginal_fj":
            v = t.shape[0]
            t = t.reshape(1, v, 1, 1) if t.ndim == 1 else t.reshape(1, v, t.shape[1], 1)
        out[f] = t
    return ModelParams(**out)


def _evaluate_core(o: _Operands, model: ModelParams, discipline: str, mode: str):
    """Schedule once, then evaluate every model variant over it.

    The schedule (exact integers, model-free) is ``(C, T, R)``; each
    metric is ``(C, V, T, R)`` — the variant axis only multiplies the
    cheap float arithmetic.  The expressions are the scalar path's, in
    its order (`sram.evaluate`)."""
    cycles, active, fits = _schedule_core(o, discipline)
    tot = o.ops.sum(dim=2)                                 # (C, R, 3)
    gates = tot.sum(dim=-1)[:, None, None, :]              # (C, 1, 1, R)
    cycles_f = cycles.to(F64)[:, None]                     # (C, 1, T, R)
    t_ns = cycles_f / model.f_clk_hz * 1e9

    # sum(n_ops[t] * e[t]) over the op types, in the scalar path's order.
    e_marg = model.e_op_marginal_fj
    e_ops_fj = None
    for k in range(len(OP_TYPES)):
        if e_marg.ndim == 3:  # (V, T, 3) correlated per-op energies
            e_k = e_marg[:, :, k].reshape(1, e_marg.shape[0], e_marg.shape[1], 1)
        else:
            e_k = e_marg[:, k].reshape(1, -1, 1, 1)
        term = tot[:, None, None, :, k] * e_k
        e_ops_fj = term if e_ops_fj is None else e_ops_fj + term

    if mode == "paper":
        n_lvl = o.n_levels.to(F64)[:, None, None, :]
        p_mw = paper_power_mw(n_lvl, model) * torch.ones_like(t_ns)
        e_nj = paper_energy_nj(p_mw, t_ns)
    elif mode == "physical":
        e_nj = physical_energy_nj(
            t_ns, active[:, None], e_ops_fj, o.cols[None, None, :, None], model
        )
        p_mw = torch.where(t_ns > 0, e_nj / t_ns * 1e3, 0.0)
    else:
        raise ValueError(f"unknown mode {mode!r}")

    thr_gops = torch.where(
        t_ns > 0,
        gates / (t_ns * 1e-9) / 1e9 * model.pipeline_utilization,
        0.0,
    )
    tops_w = torch.where(p_mw > 0, (thr_gops / 1e3) / (p_mw * 1e-3), 0.0)
    mets = dict(
        latency_ns=t_ns,
        energy_nj=e_nj,
        power_mw=p_mw,
        throughput_gops=thr_gops,
        tops_per_watt=tops_w,
    )
    sched = dict(cycles=cycles, active_macro_cycles=active, fits=fits)
    return sched, mets


def _masked_tier_argmin_t(energy: torch.Tensor, tiers) -> torch.Tensor:
    """`_masked_tier_argmin` on tensors: per-cell argmin over the first
    non-empty tier; ``torch.argmin`` returns the first minimal index, so
    ties break to the lowest flat index (pinned by the port's tests)."""
    pool = tiers[-1]
    for tier in tiers[-2::-1]:
        pool = torch.where(tier.any(dim=-1, keepdim=True), tier, pool)
    return torch.argmin(torch.where(pool, energy, float("inf")), dim=-1)


def _select_core(energy, fits, feasible, latency, max_latency, use_latency):
    """`select_best_batch`'s three-tier masking as tensor ops.

    ``energy``/``latency`` are ``(..., V, N)``; ``fits``/``feasible``
    are model-free ``(..., 1, N)`` masks broadcast across the variant
    axis.  Returns per-cell winner indices and a per-cell any-finite flag
    (the all-non-finite error is raised host-side)."""
    finite = torch.isfinite(energy)
    tier2 = fits & finite
    tier1 = tier2 & feasible
    if use_latency:
        tier1 = tier1 & (latency <= max_latency)
    idx = _masked_tier_argmin_t(energy, (tier1, tier2, finite))
    return idx, finite.any(dim=-1)


def _fused_tail(sched, mets, feasible, max_latency, use_latency):
    """Select + gather after the evaluate pass: ``mets`` are
    ``(C, V, T, R)``, ``sched`` ``(C, T, R)``, ``feasible`` a ``(C, T)``
    bool tensor.  Returns the small selection payload: winner indices,
    per-winner metrics, each variant's latency and the capacity flag at
    the *nominal* (variant-0) winner cell."""
    fits = sched["fits"]
    c, t, r = fits.shape
    n = t * r
    energy = mets["energy_nj"].reshape(c, -1, n)
    latency = mets["latency_ns"].reshape(c, -1, n)
    fits_f = fits.reshape(c, 1, n)
    feas_f = feasible[:, :, None].expand(c, t, r).reshape(c, 1, n)
    idx, has_finite = _select_core(
        energy, fits_f, feas_f, latency, max_latency, use_latency
    )                                                     # (C, V)
    winner_mets = {
        k: mets[k].reshape(c, -1, n).gather(-1, idx[..., None])[..., 0]
        for k in _METRIC_KEYS
    }
    idx0 = idx[:, :1]                                     # (C, 1)
    nominal_latency = latency.gather(
        -1, idx0[:, :, None].expand(idx.shape + (1,))
    )[..., 0]
    nominal_fits = fits.reshape(c, n).gather(-1, idx0)[:, 0]
    return dict(
        winner_idx=idx.to(torch.int32),
        has_finite=has_finite,
        winner_mets=winner_mets,
        nominal_latency=nominal_latency,
        nominal_fits=nominal_fits,
    )


def _shard_variants(shard: "bool | None") -> bool:
    """The port runs the variant axis on one device: ``shard`` (None,
    True or False) is accepted for signature compatibility with the
    reference and never shards.  Returns the ``sharded`` flag (False)."""
    if shard not in (None, True, False):
        raise ValueError(f"shard must be None, True or False, got {shard!r}")
    return False


def _materialize_dict(d: dict, lazy: bool) -> dict:
    if lazy:
        return d
    return {k: v.cpu().numpy() for k, v in d.items()}


def _run_suite(ops, n_levels, topos, table, discipline, mode, device):
    o = _Operands.build(ops, n_levels, topos, device)
    return o, _evaluate_core(o, _model_tensors(_model_params(table), device), discipline, mode)


# ---------------------------------------------------------------------------
# Public batched API
# ---------------------------------------------------------------------------


_SCHED_KEYS = ("cycles", "active_macro_cycles", "fits")
_METRIC_KEYS = (
    "latency_ns", "energy_nj", "power_mw", "throughput_gops", "tops_per_watt"
)
# Grid fields that may hold device-resident (torch) tensors in lazy mode.
_LAZY_FIELDS = frozenset(_SCHED_KEYS + _METRIC_KEYS)


class _LazyArrays:
    """Mixin for the grid dataclasses: metric/schedule fields may hold
    *device* tensors instead of numpy — the lazy mode of the fused
    pipeline.  A field is materialized to numpy (``.cpu().numpy()``) on
    first attribute access and cached in place (the dataclasses are
    frozen, so the swap goes through ``object.__setattr__``), which means
    a grid that is never inspected never pays the device->host transfer:
    the fused selection already moved the winners across, and the full
    (C, V, T, R) tensors stay where they were computed.

    View methods (``grid``/``variation``/``suite``) slice through
    ``_raw`` so child grids inherit the un-materialized device tensors —
    slicing a tensor is a view, not a transfer.
    """

    def __getattribute__(self, name):
        val = object.__getattribute__(self, name)
        if name in _LAZY_FIELDS and isinstance(val, torch.Tensor):
            val = val.cpu().numpy()
            object.__setattr__(self, name, val)
        return val

    def _raw(self, name: str):
        """The stored array without materializing it (device or numpy)."""
        return object.__getattribute__(self, name)

    def _cell_scalar(self, name: str, idx: tuple) -> float:
        """One element of a (possibly device-resident) field.

        Indexing the raw tensor first keeps the gather on the device and
        moves a single scalar across the boundary — the full tensor is
        NOT materialized (and stays lazy for later accesses).
        """
        return float(self._raw(name)[idx])

    def _raw_size(self, name: str) -> int:
        """Element count of a field without materializing it (a torch
        tensor's ``size`` is a method, numpy's an int)."""
        return int(np.prod(self._raw(name).shape))

@dataclasses.dataclass(frozen=True)
class GridCell:
    """One design point of a sweep grid — the lazy per-cell gather result.

    Produced by the grids' ``cell(...)`` methods for post-hoc inspection
    of a single (circuit, variant, topology, recipe) choice without
    materializing the full device tensor: each field is a one-element
    device gather.  ``circuit``/``variant`` are None on grids without
    that axis.
    """

    recipe: tuple[str, ...]
    topology: SramTopology
    circuit: str | None
    variant: int | None
    cycles: int
    active_macro_cycles: int
    fits: bool
    feasible: bool
    latency_ns: float
    energy_nj: float
    power_mw: float
    throughput_gops: float
    tops_per_watt: float
    area_mm2: float


@dataclasses.dataclass(frozen=True)
class ExplorationGrid(_LazyArrays):
    """The full recipe x topology sweep as ``(n_topologies, n_recipes)``
    arrays — the batched analogue of ``ExplorationResult.evaluations``.

    Flattened (``.ravel()``) order is topology-major, matching the scalar
    loops ``for topo: for recipe:`` so argmin indices and tie-breaking
    line up with the Python path.
    """

    recipes: tuple[tuple[str, ...], ...]
    topologies: tuple[SramTopology, ...]
    cycles: np.ndarray               # (T, R) int
    active_macro_cycles: np.ndarray  # (T, R) int
    fits: np.ndarray                 # (T, R) bool
    latency_ns: np.ndarray           # (T, R)
    energy_nj: np.ndarray            # (T, R)
    power_mw: np.ndarray             # (T, R)
    throughput_gops: np.ndarray      # (T, R)
    tops_per_watt: np.ndarray        # (T, R)
    area_mm2: np.ndarray             # (T,)
    feasible: np.ndarray             # (T,) capacity-feasible (Alg. I line 9)
    mode: str
    discipline: str
    # The scalar model the grid was evaluated with; None when the grid is
    # a correlated-variant slice whose constants differ per topology (no
    # single EnergyModel exists — see ModelTable.uniform_row).
    model: EnergyModel | None

    @property
    def size(self) -> int:
        # a shape query must not materialize a lazy device tensor
        return self._raw_size("energy_nj")

    def unravel(self, flat_index: int) -> tuple[int, int]:
        """Flat (topology-major) index -> (topology_idx, recipe_idx)."""
        n_r = len(self.recipes)
        return flat_index // n_r, flat_index % n_r

    def fit_energies(self) -> np.ndarray:
        return self.energy_nj[self.fits]

    def best_index(self, max_latency_ns: float | None = None) -> int:
        return select_best(
            self.energy_nj,
            self.fits,
            latency=self.latency_ns,
            max_latency=max_latency_ns,
            feasible=np.broadcast_to(self.feasible[:, None], self.fits.shape),
        )

    def best_worst_indices(self) -> tuple[int, int]:
        return select_best_worst(self.energy_nj, self.fits)

    def cell(self, t: int, r: int) -> GridCell:
        """One (topology, recipe) design point as a `GridCell` — lazy
        per-element gathers, never materializes the full grid."""
        g = self._cell_scalar
        return GridCell(
            recipe=self.recipes[r],
            topology=self.topologies[t],
            circuit=None,
            variant=None,
            cycles=int(g("cycles", (t, r))),
            active_macro_cycles=int(g("active_macro_cycles", (t, r))),
            fits=bool(g("fits", (t, r))),
            feasible=bool(np.asarray(self._raw("feasible")[t])),
            latency_ns=g("latency_ns", (t, r)),
            energy_nj=g("energy_nj", (t, r)),
            power_mw=g("power_mw", (t, r)),
            throughput_gops=g("throughput_gops", (t, r)),
            tops_per_watt=g("tops_per_watt", (t, r)),
            area_mm2=float(np.asarray(self._raw("area_mm2")[t])),
        )


@dataclasses.dataclass(frozen=True)
class VariationGrid(_LazyArrays):
    """One circuit's recipe x topology sweep across every `ModelTable`
    variant — the batched analogue of N `ExplorationGrid`s, computed in
    one device pass.

    Schedules (``cycles`` / ``active_macro_cycles`` / ``fits``) are
    model-free exact integers, stored once as ``(T, R)``; each metric
    carries a leading variant axis ``(V, T, R)``.  ``grid(v)`` slices
    variant ``v`` back out as a standard `ExplorationGrid` (numpy views).
    """

    recipes: tuple[tuple[str, ...], ...]
    topologies: tuple[SramTopology, ...]
    models: ModelTable
    cycles: np.ndarray               # (T, R) int
    active_macro_cycles: np.ndarray  # (T, R) int
    fits: np.ndarray                 # (T, R) bool
    latency_ns: np.ndarray           # (V, T, R)
    energy_nj: np.ndarray            # (V, T, R)
    power_mw: np.ndarray             # (V, T, R)
    throughput_gops: np.ndarray      # (V, T, R)
    tops_per_watt: np.ndarray        # (V, T, R)
    area_mm2: np.ndarray             # (V, T)
    feasible: np.ndarray             # (T,)
    mode: str
    discipline: str

    @property
    def n_variants(self) -> int:
        return len(self.models)

    def __len__(self) -> int:
        return len(self.models)

    def unravel(self, flat_index: int) -> tuple[int, int]:
        """Flat (topology-major) index -> (topology_idx, recipe_idx)."""
        n_r = len(self.recipes)
        return flat_index // n_r, flat_index % n_r

    def grid(self, v: int) -> ExplorationGrid:
        """Variant ``v``'s sweep as a standard `ExplorationGrid`.

        For a correlated table, a topology-dependent variant has no
        single scalar model: the slice still carries every per-variant
        metric (winners, energies, areas all work), but its ``model``
        field is None — materialize per-cell models via
        ``models.model(v, topology=...)`` instead."""
        return ExplorationGrid(
            recipes=self.recipes,
            topologies=self.topologies,
            cycles=self._raw("cycles"),
            active_macro_cycles=self._raw("active_macro_cycles"),
            fits=self._raw("fits"),
            latency_ns=self._raw("latency_ns")[v],
            energy_nj=self._raw("energy_nj")[v],
            power_mw=self._raw("power_mw")[v],
            throughput_gops=self._raw("throughput_gops")[v],
            tops_per_watt=self._raw("tops_per_watt")[v],
            area_mm2=self.area_mm2[v],
            feasible=self.feasible,
            mode=self.mode,
            discipline=self.discipline,
            model=(
                self.models.model(v) if self.models.uniform_row(v) else None
            ),
        )

    def best_indices(self, max_latency_ns: float | None = None) -> np.ndarray:
        """Per-variant `select_best` winners: ``(V,)`` flat
        (topology-major) indices, same tiering/tie-breaking as the
        static-model path on every variant — all variants in one
        `select_best_batch` array pass (the model-free fits/feasible
        masks broadcast across the variant axis)."""
        v = len(self.models)
        feas = np.broadcast_to(self.feasible[:, None], self.fits.shape)
        return select_best_batch(
            self.energy_nj.reshape(v, -1),
            self.fits.reshape(1, -1),
            latency=self.latency_ns.reshape(v, -1),
            max_latency=max_latency_ns,
            feasible=feas.reshape(1, -1),
        )

    def cell(self, v: int, t: int, r: int) -> GridCell:
        """One (variant, topology, recipe) design point as a `GridCell`
        — lazy per-element gathers, never materializes the full
        ``(V, T, R)`` tensors."""
        g = self._cell_scalar
        return GridCell(
            recipe=self.recipes[r],
            topology=self.topologies[t],
            circuit=None,
            variant=v,
            cycles=int(g("cycles", (t, r))),
            active_macro_cycles=int(g("active_macro_cycles", (t, r))),
            fits=bool(g("fits", (t, r))),
            feasible=bool(np.asarray(self._raw("feasible")[t])),
            latency_ns=g("latency_ns", (v, t, r)),
            energy_nj=g("energy_nj", (v, t, r)),
            power_mw=g("power_mw", (v, t, r)),
            throughput_gops=g("throughput_gops", (v, t, r)),
            tops_per_watt=g("tops_per_watt", (v, t, r)),
            area_mm2=float(np.asarray(self._raw("area_mm2")[v, t])),
        )



def _grid_feasible(topos, feasible) -> np.ndarray:
    if feasible is None:
        feasible = np.ones(len(topos), dtype=bool)
    return np.asarray(feasible, dtype=bool)



def _build_grid(
    work, topos, table, model, is_sweep, mode, discipline, feasible,
    sched, mets,
) -> "ExplorationGrid | VariationGrid":
    """Assemble the single-circuit grid result from (possibly
    device-resident) schedule/metric arrays."""
    if not is_sweep:
        return ExplorationGrid(
            recipes=work.recipes,
            topologies=topos.topologies,
            area_mm2=topos.area_mm2(table.model(0)),
            feasible=feasible,
            mode=mode,
            discipline=discipline,
            model=model if isinstance(model, EnergyModel) else table.model(0),
            **sched,
            **{k: v[0] for k, v in mets.items()},
        )
    return VariationGrid(
        recipes=work.recipes,
        topologies=topos.topologies,
        models=table,
        area_mm2=topos.area_mm2(table),
        feasible=feasible,
        mode=mode,
        discipline=discipline,
        **sched,
        **mets,
    )


def evaluate_batch(
    work: WorkloadTable,
    topos: TopologyTable,
    model: "EnergyModel | ModelTable | None" = None,
    mode: str = "physical",
    discipline: str = "list",
    feasible: np.ndarray | None = None,
    lazy: bool = False,
    device: "str | torch.device | None" = None,
) -> "ExplorationGrid | VariationGrid":
    """Schedule + evaluate the full recipe x topology grid in one fp64
    pass on ``device``; the batched ``sram.evaluate``.

    ``model`` may be a single `EnergyModel` (returns an
    `ExplorationGrid`) or a `sram.ModelTable` of variants (returns a
    `VariationGrid` with a leading variant axis).  ``lazy=True`` keeps
    the metric tensors on the device: the grid's array fields
    materialize to numpy on first access (see `_LazyArrays`).
    """
    dev = resolve_device(device)
    table, is_sweep = _as_table(model)
    _check_topo_axis(table, topos)
    feasible = _grid_feasible(topos, feasible)
    _, (sched, mets) = _run_suite(
        work.ops[None], work.n_levels[None], topos, table, discipline, mode, dev
    )
    sched = _materialize_dict({k: v[0] for k, v in sched.items()}, lazy)
    mets = _materialize_dict({k: v[0] for k, v in mets.items()}, lazy)
    return _build_grid(
        work, topos, table, model, is_sweep, mode, discipline, feasible,
        sched, mets,
    )


# ---------------------------------------------------------------------------
# Suite-level sweep: circuits x recipes x topologies in one pass
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SuiteGrid(_LazyArrays):
    """The whole-suite sweep as ``(n_circuits, n_topologies, n_recipes)``
    arrays — one `ExplorationGrid` per circuit, stacked.

    Produced by `evaluate_suite`; ``grid(circuit)`` slices one circuit
    back out as a standard `ExplorationGrid` (numpy views, no copies), so
    everything downstream of the per-circuit sweep (``best_index``,
    `select_best`, `explorer.best_worst`) works unchanged.
    """

    circuits: tuple[str, ...]
    recipes: tuple[tuple[str, ...], ...]
    topologies: tuple[SramTopology, ...]
    cycles: np.ndarray               # (C, T, R) int
    active_macro_cycles: np.ndarray  # (C, T, R) int
    fits: np.ndarray                 # (C, T, R) bool
    latency_ns: np.ndarray           # (C, T, R)
    energy_nj: np.ndarray            # (C, T, R)
    power_mw: np.ndarray             # (C, T, R)
    throughput_gops: np.ndarray      # (C, T, R)
    tops_per_watt: np.ndarray        # (C, T, R)
    area_mm2: np.ndarray             # (T,)
    feasible: np.ndarray             # (C, T) capacity-feasible per circuit
    mode: str
    discipline: str
    model: EnergyModel | None  # None for correlated-variant slices

    @property
    def size(self) -> int:
        """Total swept implementations (circuits x topologies x recipes)."""
        return self._raw_size("energy_nj")

    def circuit_index(self, circuit: str | int) -> int:
        if isinstance(circuit, int):
            return circuit
        return self.circuits.index(circuit)

    def grid(self, circuit: str | int) -> ExplorationGrid:
        """One circuit's ``(T, R)`` slice as an `ExplorationGrid`."""
        c = self.circuit_index(circuit)
        return ExplorationGrid(
            recipes=self.recipes,
            topologies=self.topologies,
            cycles=self._raw("cycles")[c],
            active_macro_cycles=self._raw("active_macro_cycles")[c],
            fits=self._raw("fits")[c],
            latency_ns=self._raw("latency_ns")[c],
            energy_nj=self._raw("energy_nj")[c],
            power_mw=self._raw("power_mw")[c],
            throughput_gops=self._raw("throughput_gops")[c],
            tops_per_watt=self._raw("tops_per_watt")[c],
            area_mm2=self.area_mm2,
            feasible=self.feasible[c],
            mode=self.mode,
            discipline=self.discipline,
            model=self.model,
        )

    def grids(self) -> dict[str, ExplorationGrid]:
        return {name: self.grid(name) for name in self.circuits}

    def cell(self, circuit: str | int, t: int, r: int) -> GridCell:
        """One (circuit, topology, recipe) design point as a `GridCell`
        — lazy per-element gathers, never materializes the full
        ``(C, T, R)`` tensors."""
        c = self.circuit_index(circuit)
        g = self._cell_scalar
        return GridCell(
            recipe=self.recipes[r],
            topology=self.topologies[t],
            circuit=self.circuits[c],
            variant=None,
            cycles=int(g("cycles", (c, t, r))),
            active_macro_cycles=int(g("active_macro_cycles", (c, t, r))),
            fits=bool(g("fits", (c, t, r))),
            feasible=bool(np.asarray(self._raw("feasible")[c, t])),
            latency_ns=g("latency_ns", (c, t, r)),
            energy_nj=g("energy_nj", (c, t, r)),
            power_mw=g("power_mw", (c, t, r)),
            throughput_gops=g("throughput_gops", (c, t, r)),
            tops_per_watt=g("tops_per_watt", (c, t, r)),
            area_mm2=float(np.asarray(self._raw("area_mm2")[t])),
        )


@dataclasses.dataclass(frozen=True)
class SuiteVariationGrid(_LazyArrays):
    """The whole suite swept across every model variant: circuits x
    model-variants x topologies x recipes from ONE device pass — the
    fourth (variant) axis of the rapid-assessment engine.

    Schedules are model-free ``(C, T, R)`` exact integers; metrics are
    ``(C, V, T, R)``.  ``variation(circuit)`` slices one circuit's
    `VariationGrid`; ``suite(v)`` slices one variant's `SuiteGrid`.
    """

    circuits: tuple[str, ...]
    recipes: tuple[tuple[str, ...], ...]
    topologies: tuple[SramTopology, ...]
    models: ModelTable
    cycles: np.ndarray               # (C, T, R) int
    active_macro_cycles: np.ndarray  # (C, T, R) int
    fits: np.ndarray                 # (C, T, R) bool
    latency_ns: np.ndarray           # (C, V, T, R)
    energy_nj: np.ndarray            # (C, V, T, R)
    power_mw: np.ndarray             # (C, V, T, R)
    throughput_gops: np.ndarray      # (C, V, T, R)
    tops_per_watt: np.ndarray        # (C, V, T, R)
    area_mm2: np.ndarray             # (V, T)
    feasible: np.ndarray             # (C, T)
    mode: str
    discipline: str

    @property
    def n_variants(self) -> int:
        return len(self.models)

    @property
    def size(self) -> int:
        """Total swept implementations (C x V x T x R)."""
        return self._raw_size("energy_nj")

    def circuit_index(self, circuit: str | int) -> int:
        if isinstance(circuit, int):
            return circuit
        return self.circuits.index(circuit)

    def variation(self, circuit: str | int) -> VariationGrid:
        """One circuit's ``(V, T, R)`` sweep as a `VariationGrid`."""
        c = self.circuit_index(circuit)
        return VariationGrid(
            recipes=self.recipes,
            topologies=self.topologies,
            models=self.models,
            cycles=self._raw("cycles")[c],
            active_macro_cycles=self._raw("active_macro_cycles")[c],
            fits=self._raw("fits")[c],
            latency_ns=self._raw("latency_ns")[c],
            energy_nj=self._raw("energy_nj")[c],
            power_mw=self._raw("power_mw")[c],
            throughput_gops=self._raw("throughput_gops")[c],
            tops_per_watt=self._raw("tops_per_watt")[c],
            area_mm2=self.area_mm2,
            feasible=self.feasible[c],
            mode=self.mode,
            discipline=self.discipline,
        )

    def suite(self, v: int) -> SuiteGrid:
        """One model variant's suite sweep as a standard `SuiteGrid`
        (``model`` is None for a topology-dependent correlated variant —
        see `VariationGrid.grid`)."""
        return SuiteGrid(
            circuits=self.circuits,
            recipes=self.recipes,
            topologies=self.topologies,
            cycles=self._raw("cycles"),
            active_macro_cycles=self._raw("active_macro_cycles"),
            fits=self._raw("fits"),
            latency_ns=self._raw("latency_ns")[:, v],
            energy_nj=self._raw("energy_nj")[:, v],
            power_mw=self._raw("power_mw")[:, v],
            throughput_gops=self._raw("throughput_gops")[:, v],
            tops_per_watt=self._raw("tops_per_watt")[:, v],
            area_mm2=self.area_mm2[v],
            feasible=self.feasible,
            mode=self.mode,
            discipline=self.discipline,
            model=(
                self.models.model(v) if self.models.uniform_row(v) else None
            ),
        )

    def best_indices(self, max_latency_ns: float | None = None) -> np.ndarray:
        """Winners for every (circuit, variant) cell — ``(C, V)`` flat
        (topology-major) indices from ONE `select_best_batch` pass over
        the whole hypercube, bit-identical to running the per-variant
        `select_best` loop on each circuit's `VariationGrid`."""
        c, v = len(self.circuits), len(self.models)
        feas = np.broadcast_to(
            self.feasible[:, :, None], self.fits.shape
        )  # (C, T, R)
        return select_best_batch(
            self.energy_nj.reshape(c, v, -1),
            self.fits.reshape(c, 1, -1),
            latency=self.latency_ns.reshape(c, v, -1),
            max_latency=max_latency_ns,
            feasible=feas.reshape(c, 1, -1),
        )

    def cell(self, circuit: str | int, v: int, t: int, r: int) -> GridCell:
        """One (circuit, variant, topology, recipe) point of the full
        hypercube as a `GridCell` — lazy per-element gathers, never
        materializes the ``(C, V, T, R)`` tensors."""
        c = self.circuit_index(circuit)
        g = self._cell_scalar
        return GridCell(
            recipe=self.recipes[r],
            topology=self.topologies[t],
            circuit=self.circuits[c],
            variant=v,
            cycles=int(g("cycles", (c, t, r))),
            active_macro_cycles=int(g("active_macro_cycles", (c, t, r))),
            fits=bool(g("fits", (c, t, r))),
            feasible=bool(np.asarray(self._raw("feasible")[c, t])),
            latency_ns=g("latency_ns", (c, v, t, r)),
            energy_nj=g("energy_nj", (c, v, t, r)),
            power_mw=g("power_mw", (c, v, t, r)),
            throughput_gops=g("throughput_gops", (c, v, t, r)),
            tops_per_watt=g("tops_per_watt", (c, v, t, r)),
            area_mm2=float(np.asarray(self._raw("area_mm2")[v, t])),
        )


def _suite_feasible(suite, topos, feasible) -> np.ndarray:
    if feasible is None:
        feasible = np.ones((len(suite), len(topos)), dtype=bool)
    feasible = np.asarray(feasible, dtype=bool)
    if feasible.shape != (len(suite), len(topos)):
        raise ValueError(
            f"feasible must be (n_circuits, n_topologies)="
            f"{(len(suite), len(topos))}, got {feasible.shape}"
        )
    return feasible


def _build_suite_grid(
    suite, topos, table, model, is_sweep, mode, discipline, feasible,
    sched, mets,
) -> "SuiteGrid | SuiteVariationGrid":
    """Assemble the suite grid result from (possibly device-resident)
    schedule/metric arrays."""
    if not is_sweep:
        return SuiteGrid(
            circuits=suite.circuits,
            recipes=suite.recipes,
            topologies=topos.topologies,
            area_mm2=topos.area_mm2(table.model(0)),
            feasible=feasible,
            mode=mode,
            discipline=discipline,
            model=model if isinstance(model, EnergyModel) else table.model(0),
            **sched,
            **{k: v[:, 0] for k, v in mets.items()},
        )
    return SuiteVariationGrid(
        circuits=suite.circuits,
        recipes=suite.recipes,
        topologies=topos.topologies,
        models=table,
        area_mm2=topos.area_mm2(table),
        feasible=feasible,
        mode=mode,
        discipline=discipline,
        **sched,
        **mets,
    )



def evaluate_suite(
    suite: SuiteTable,
    topos: TopologyTable,
    model: "EnergyModel | ModelTable | None" = None,
    mode: str = "physical",
    discipline: str = "list",
    feasible: np.ndarray | None = None,
    lazy: bool = False,
    device: "str | torch.device | None" = None,
) -> "SuiteGrid | SuiteVariationGrid":
    """Schedule + evaluate circuits x recipes x topologies in one fp64
    pass on ``device`` — the suite-level `evaluate_batch`, and the
    host-selection (``fused=False``) parity path of the explorer.

    ``model`` may be a single `EnergyModel` (returns a `SuiteGrid`) or a
    `sram.ModelTable` (returns a `SuiteVariationGrid` with a variant axis
    on every metric).  ``feasible``: optional ``(n_circuits,
    n_topologies)`` bool mask of capacity-feasible topologies per circuit
    (Alg. I line 9); defaults to all-feasible.
    """
    dev = resolve_device(device)
    table, is_sweep = _as_table(model)
    _check_topo_axis(table, topos)
    feasible = _suite_feasible(suite, topos, feasible)
    _, (sched, mets) = _run_suite(
        suite.ops, suite.n_levels, topos, table, discipline, mode, dev
    )
    return _build_suite_grid(
        suite, topos, table, model, is_sweep, mode, discipline, feasible,
        _materialize_dict(sched, lazy), _materialize_dict(mets, lazy),
    )


# ---------------------------------------------------------------------------
# Device-resident pipeline: fused evaluate + select
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SelectionResult:
    """What the fused pipeline brings back across the host boundary: the
    winners of every (circuit, variant) cell plus their metrics — a few
    KB where the host-side filter transferred the full float64
    (C, V, T, R) tensors.  ``sharded`` is always False in the port (one
    device; see `_shard_variants`).

    ``winner_idx`` holds flat topology-major indices (``grid.unravel``
    decodes them), shaped ``(V,)`` for a single-circuit sweep and
    ``(C, V)`` for a suite (V=1 when a single `EnergyModel` was
    evaluated).  ``nominal_latency_ns`` / ``nominal_fits`` are each
    variant's latency / the capacity flag at the *nominal* (variant-0)
    winner cell — the inputs of the latency-yield figure.
    ``payload_bytes`` is the actual number of bytes materialized to
    host for this result.
    """

    winner_idx: np.ndarray            # (V,) or (C, V) int32
    winner_metrics: dict[str, np.ndarray]  # each (V,) or (C, V) float64
    nominal_latency_ns: np.ndarray    # (V,) or (C, V)
    nominal_fits: np.ndarray          # () or (C,) bool
    payload_bytes: int
    sharded: bool

    @property
    def winner_energy_nj(self) -> np.ndarray:
        return self.winner_metrics["energy_nj"]


def _fused(ops, n_levels, topos, table, feasible, max_latency_ns, mode,
           discipline, shard, device):
    """Evaluate + select on the device; returns the device-resident
    schedule/metric dicts and the fetched `SelectionResult`."""
    sharded = _shard_variants(shard)
    _, (sched, mets) = _run_suite(
        ops, n_levels, topos, table, discipline, mode, device
    )
    use_latency = max_latency_ns is not None
    res = _fused_tail(
        sched, mets,
        torch.as_tensor(np.asarray(feasible, dtype=bool), device=device),
        float(max_latency_ns) if use_latency else 0.0,
        use_latency,
    )
    return sched, mets, _fetch_selection(res, sharded)


def evaluate_select_batch(
    work: WorkloadTable,
    topos: TopologyTable,
    model: "EnergyModel | ModelTable | None" = None,
    mode: str = "physical",
    discipline: str = "list",
    feasible: np.ndarray | None = None,
    max_latency_ns: float | None = None,
    lazy: bool = True,
    shard: "bool | None" = None,
    device: "str | torch.device | None" = None,
) -> "tuple[ExplorationGrid | VariationGrid, SelectionResult]":
    """`evaluate_batch` with the FilterEnergy stage fused into the same
    device pass: schedule, evaluate, and the three-tier masked argmin run
    on ``device``, and only the (V,) winner indices + per-winner metrics
    are transferred.  The grid is returned lazy by default.  ``shard`` is
    accepted for compatibility and never shards (`_shard_variants`).
    """
    dev = resolve_device(device)
    table, is_sweep = _as_table(model)
    _check_topo_axis(table, topos)
    feasible = _grid_feasible(topos, feasible)
    sched, mets, sel = _fused(
        work.ops[None], work.n_levels[None], topos, table, feasible[None],
        max_latency_ns, mode, discipline, shard, dev,
    )
    sel = SelectionResult(
        winner_idx=sel.winner_idx[0],
        winner_metrics={k: v[0] for k, v in sel.winner_metrics.items()},
        nominal_latency_ns=sel.nominal_latency_ns[0],
        nominal_fits=sel.nominal_fits[0],
        payload_bytes=sel.payload_bytes,
        sharded=sel.sharded,
    )
    grid = _build_grid(
        work, topos, table, model, is_sweep, mode, discipline, feasible,
        _materialize_dict({k: v[0] for k, v in sched.items()}, lazy),
        _materialize_dict({k: v[0] for k, v in mets.items()}, lazy),
    )
    return grid, sel


def evaluate_select_suite(
    suite: SuiteTable,
    topos: TopologyTable,
    model: "EnergyModel | ModelTable | None" = None,
    mode: str = "physical",
    discipline: str = "list",
    feasible: np.ndarray | None = None,
    max_latency_ns: float | None = None,
    lazy: bool = True,
    shard: "bool | None" = None,
    device: "str | torch.device | None" = None,
) -> "tuple[SuiteGrid | SuiteVariationGrid, SelectionResult]":
    """The suite-level fused pipeline: circuits x variants x topologies x
    recipes evaluated AND filtered in one device pass.  Only the
    ``(C, V)`` winner indices + per-winner metrics cross the host
    boundary; the full metric tensors back the returned lazy grid.

    Winner parity with the host path (`evaluate_suite` +
    `SuiteVariationGrid.best_indices`) is exact — same tiering, same
    lowest-flat-index tie-breaking, same all-non-finite error.
    """
    dev = resolve_device(device)
    table, is_sweep = _as_table(model)
    _check_topo_axis(table, topos)
    feasible = _suite_feasible(suite, topos, feasible)
    sched, mets, sel = _fused(
        suite.ops, suite.n_levels, topos, table, feasible, max_latency_ns,
        mode, discipline, shard, dev,
    )
    grid = _build_suite_grid(
        suite, topos, table, model, is_sweep, mode, discipline, feasible,
        _materialize_dict(sched, lazy), _materialize_dict(mets, lazy),
    )
    return grid, sel


def _fetch_selection(res, sharded: bool) -> SelectionResult:
    """Materialize the small selection payload (the only device->host
    transfer of the fused path) and apply the host-side all-non-finite
    check that `select_best_batch` raises eagerly."""
    has_finite = res["has_finite"].cpu().numpy()
    if not has_finite.all():
        raise ValueError(
            "fused selection: a batch cell has no finite energies"
        )
    winner_idx = res["winner_idx"].cpu().numpy()
    winner_mets = {k: v.cpu().numpy() for k, v in res["winner_mets"].items()}
    nominal_latency = res["nominal_latency"].cpu().numpy()
    nominal_fits = res["nominal_fits"].cpu().numpy()
    payload = (
        winner_idx.nbytes
        + has_finite.nbytes
        + nominal_latency.nbytes
        + nominal_fits.nbytes
        + sum(v.nbytes for v in winner_mets.values())
    )
    return SelectionResult(
        winner_idx=winner_idx,
        winner_metrics=winner_mets,
        nominal_latency_ns=nominal_latency,
        nominal_fits=nominal_fits,
        payload_bytes=payload,
        sharded=sharded,
    )


def select_best_batch_device(
    energy,
    fits,
    latency=None,
    max_latency: float | None = None,
    feasible=None,
    device: "str | torch.device | None" = None,
) -> np.ndarray:
    """`select_best_batch` with the three-tier argmin run on ``device`` —
    the standalone filter for callers whose metrics are already arrays.

    Same semantics as the host version: tiering, lowest-flat-index
    tie-breaking, non-finite energies inadmissible everywhere, ValueError
    on an empty grid or an all-non-finite batch cell.  Tensors already on
    the device are used as they are (no host round trip).
    """
    dev = resolve_device(device)

    def on_dev(x, dtype):
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=dtype)
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    energy = on_dev(energy, F64)
    if energy.numel() == 0 or energy.shape[-1] == 0:
        raise ValueError("select_best_batch on an empty grid")
    fits = on_dev(fits, torch.bool)
    use_latency = max_latency is not None and latency is not None
    idx, has_finite = _select_core(
        energy,
        fits,
        on_dev(feasible, torch.bool) if feasible is not None else fits,
        on_dev(latency, F64) if use_latency else None,
        float(max_latency) if use_latency else 0.0,
        use_latency,
    )
    # winner payload only — (…, V) indices + flags, never the grid
    if not bool(has_finite.all()):
        raise ValueError(
            "select_best_batch: a batch cell has no finite energies"
        )
    return idx.cpu().numpy().astype(np.int64)


# ---------------------------------------------------------------------------
# Shared admissibility filter + argmin (FilterEnergy)
# ---------------------------------------------------------------------------


def _masked_tier_argmin(energy, tiers, xp=np):
    """Per-batch-cell argmin over the first non-empty tier.

    ``energy``: (..., N); ``tiers``: bool arrays of the same shape, most
    restrictive first.  Each batch cell uses its own first tier with any
    admissible entry; ties break to the lowest index along the last axis
    (``argmin`` returns the first occurrence).  Pure array ops on the
    ``xp`` namespace (numpy by default); the device twin is
    `_masked_tier_argmin_t`.
    """
    pool = tiers[-1]
    for tier in tiers[-2::-1]:
        pool = xp.where(tier.any(axis=-1, keepdims=True), tier, pool)
    return xp.argmin(xp.where(pool, energy, xp.inf), axis=-1)


def select_best_batch(
    energy,
    fits,
    latency=None,
    max_latency: float | None = None,
    feasible=None,
) -> np.ndarray:
    """Batched `select_best`: winners for every batch cell in one masked
    three-tier argmin pass — no per-variant python loop.

    ``energy`` is ``(..., N)`` with the candidate implementations along
    the LAST axis (flat C-order, e.g. a raveled topology-major (T, R)
    grid) and arbitrary batch axes in front — ``(V, T*R)`` for one
    circuit's variant sweep, ``(C, V, T*R)`` for a whole suite.
    ``fits`` / ``latency`` / ``feasible`` broadcast against ``energy``,
    so model-free masks are passed once (e.g. ``(C, 1, T*R)``) and serve
    every variant row.

    Tiering, tie-breaking (lowest flat index), and NaN handling are
    exactly `select_best`'s, applied independently per batch cell;
    raises if any batch cell has no finite energy at all.

    Returns int64 winner indices of shape ``energy.shape[:-1]``.
    """
    energy = np.asarray(energy, dtype=float)
    if energy.size == 0 or energy.shape[-1] == 0:
        raise ValueError("select_best_batch on an empty grid")
    finite = np.isfinite(energy)
    if not finite.any(axis=-1).all():
        raise ValueError(
            "select_best_batch: a batch cell has no finite energies"
        )
    tier2 = np.broadcast_to(np.asarray(fits, dtype=bool), energy.shape) & finite
    tier1 = tier2
    if feasible is not None:
        tier1 = tier1 & np.broadcast_to(
            np.asarray(feasible, dtype=bool), energy.shape
        )
    if max_latency is not None and latency is not None:
        tier1 = tier1 & (
            np.broadcast_to(np.asarray(latency, dtype=float), energy.shape)
            <= max_latency
        )
    return _masked_tier_argmin(energy, (tier1, tier2, finite))


def select_best(
    energy,
    fits,
    latency=None,
    max_latency: float | None = None,
    feasible=None,
) -> int:
    """Alg. I line 14 — lowest-energy admissible implementation.

    Args:
        energy: energies, any shape (nJ for the SRAM explorer, J for the
            mesh explorer — only the ordering matters).
        fits: bool mask, same shape — capacity check (4 bits/gate).
        latency: optional latencies (same unit as ``max_latency``; ns for
            the SRAM explorer, s for the mesh explorer).
        max_latency: optional admissibility bound on ``latency``.
        feasible: optional bool mask — Alg. I line 9 topology feasibility.

    Admissibility tiers, in order (first non-empty pool wins, matching
    both `explorer.explore` and `mesh_explorer.explore_mesh`):

      1. fits capacity AND (feasible if given) AND (latency constraint
         if given),
      2. fits capacity,
      3. everything with a finite energy.

    Non-finite energies (NaN / ±inf — e.g. a pathological Monte-Carlo
    variant) are inadmissible in every tier; if *all* energies are
    non-finite there is no winner and a ValueError is raised.

    Returns the flat C-order index of the winner; ties break to the
    lowest flat index, like ``min`` over the scalar evaluation list.

    The single-cell view of `select_best_batch` — one implementation of
    the filter serves the scalar explorers, the variation sweeps, and
    the mesh explorer alike.
    """
    energy = np.asarray(energy, dtype=float).ravel()
    if energy.size == 0:
        raise ValueError("select_best on an empty grid")
    return int(
        select_best_batch(
            energy[None, :],
            np.asarray(fits, dtype=bool).ravel()[None, :],
            latency=None
            if latency is None
            else np.asarray(latency, dtype=float).ravel()[None, :],
            max_latency=max_latency,
            feasible=None
            if feasible is None
            else np.asarray(feasible, dtype=bool).ravel()[None, :],
        )[0]
    )


def winner_summary(winner_keys: Sequence[str]) -> tuple[dict[str, float], float]:
    """Yield arithmetic shared by the SRAM and mesh variation summaries:
    the share of variants each winning implementation takes, and the
    fraction of variants agreeing with the nominal (first) winner."""
    if not winner_keys:
        raise ValueError("winner_summary on an empty sweep")
    counts = collections.Counter(winner_keys)
    n = len(winner_keys)
    share = {k: c / n for k, c in counts.items()}
    return share, counts[winner_keys[0]] / n


def select_best_worst(energy, fits) -> tuple[int, int]:
    """Table I companion: (argmin, argmax) energy over the fitting pool
    (or over everything when nothing fits).  Non-finite energies are
    inadmissible at both ends; all-non-finite raises."""
    energy = np.asarray(energy, dtype=float).ravel()
    if energy.size == 0:
        raise ValueError("select_best_worst on an empty grid")
    finite = np.isfinite(energy)
    if not finite.any():
        raise ValueError("select_best_worst: all energies are non-finite")
    pool = np.asarray(fits, dtype=bool).ravel() & finite
    if not pool.any():
        pool = finite
    best = int(np.argmin(np.where(pool, energy, np.inf)))
    worst = int(np.argmax(np.where(pool, energy, -np.inf)))
    return best, worst

