"""Mapping a NAND2/NOR2/NOT netlist onto rCiM SRAM topologies (§III-D).

The paper maps AIG levels onto SRAM rows: level i's operands occupy rows,
outputs are written to subsequent rows, and execution proceeds one level
per computational cycle — subject to two architectural limits:

  * width: one macro executes ``cols/2`` ops of ONE type per cycle
    (one sense-amp per column pair);
  * concurrency: a single-macro topology runs one op TYPE per cycle
    (NAND2 *or* NOR2 *or* NOT — the pulse generator is programmed per
    cycle), a three-macro topology runs the three types concurrently
    (one type per macro), a six-macro topology gives each type two macros.

This module turns a characterized netlist (ops per level per type) into a
cycle-accurate schedule plus capacity checks (Alg. I line 9: bits >= 4x
gates — 2 operand bits + 2 output bits per gate, "accounting for cases
where complementary outputs are required").
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from .aig import AigStats
from .sram import OP_TYPES, SramTopology

# Alg. I line 9 capacity rule: 2 operand bits + 2 output bits per gate
# ("accounting for cases where complementary outputs are required").
BITS_PER_GATE = 4

# Sense-amp groups per op type by macro count (§III-D): a single macro
# time-multiplexes the three types, three macros dedicate one macro per
# type, six macros dedicate two.  Shared with the batched engine
# (core/batch.py), which stacks these rows into a per-topology array.
MACROS_PER_TYPE: dict[int, tuple[int, int, int]] = {
    1: (1, 1, 1),
    3: (1, 1, 1),
    6: (2, 2, 2),
}


def macros_per_type(n_macros: int) -> tuple[int, int, int]:
    """Dedicated macros per op type (nand, nor, inv) for a macro count.

    Generalizes the paper's three points (1: time-multiplexed single
    macro, 3: one macro per type, 6: two per type) to any multiple of
    three — the rule `topology_grid` design points follow.  Counts that
    are neither 1 nor a multiple of 3 have no mapping under §III-D's
    type-per-macro-group discipline and are rejected.
    """
    got = MACROS_PER_TYPE.get(n_macros)
    if got is not None:
        return got
    if n_macros > 0 and n_macros % 3 == 0:
        k = n_macros // 3
        return (k, k, k)
    raise ValueError(
        f"unsupported macro count {n_macros}: must be 1 or a multiple of 3"
    )


@dataclasses.dataclass
class MappingResult:
    topo: SramTopology
    n_levels: int
    total_cycles: int
    active_macro_cycles: int  # sum over cycles of #macros doing useful work
    op_counts: dict[str, int]
    rows_used: int
    fits: bool
    per_level_cycles: list[int]

    @property
    def utilization(self) -> float:
        cap = self.total_cycles * self.topo.n_macros * self.topo.ops_per_cycle_per_macro
        return sum(self.op_counts.values()) / cap if cap else 0.0


def _macros_per_type(topo: SramTopology) -> dict[str, int]:
    return dict(zip(OP_TYPES, macros_per_type(topo.n_macros)))


def schedule_stats(
    stats: AigStats,
    topo: SramTopology,
    writeback_pipelined: bool = True,
    discipline: str = "list",
) -> MappingResult:
    """Cycle schedule for a characterized AIG on a topology.

    ``discipline``:
      * "levels" — lock-step, one AIG level at a time (the paper's Fig 7
        mapping narrative).  Conservative: every level pays at least one
        cycle per op type present.
      * "list" (default) — ASAP list scheduling enabled by the paper's
        flexible operand placement (§III-D: dual row decoders, operands
        "placed flexibly within the two columns, not strictly confined to
        a single row or column").  Ops issue as soon as their operands are
        written and a sense-amp slot of the right type is free, giving the
        Brent bound  cycles = max(depth, width_bound) + drain.  This is the
        regime in which the paper's §IV-B scaling claims (47% energy drop
        on macro doubling, 38%/47% latency drops for 3-/6-macro) hold.
    """
    if discipline == "list":
        return _schedule_list(stats, topo)
    assert discipline == "levels"
    w = topo.ops_per_cycle_per_macro
    mpt = _macros_per_type(topo)
    per_level_cycles: list[int] = []
    active_macro_cycles = 0
    op_counts = {t: 0 for t in OP_TYPES}

    for level in stats.ops_per_level:
        for t in OP_TYPES:
            op_counts[t] += level.get(t, 0)
        if topo.n_macros == 1:
            # Types serialize on the single macro.
            c = 0
            for t in OP_TYPES:
                n = level.get(t, 0)
                batches = math.ceil(n / w) if n else 0
                c += batches
                active_macro_cycles += batches
            c = max(c, 1)
        else:
            # Types run concurrently, each on its dedicated macro group.
            c = 1
            for t in OP_TYPES:
                n = level.get(t, 0)
                width_t = w * mpt[t]
                batches = math.ceil(n / width_t) if n else 0
                c = max(c, batches)
                # each busy macro of the group is active for `batches` cycles
                active_macro_cycles += batches * mpt[t]
        per_level_cycles.append(c)

    total = sum(per_level_cycles)
    if not writeback_pipelined:
        total += len(per_level_cycles)  # +1 writeback cycle per level
    else:
        total += 1  # pipeline drain for the final writeback

    # Capacity check (Alg. I line 9): 4 bits per gate.
    gates = sum(op_counts.values())
    # Row schedule: each level batch needs 2 operand rows + 1 result row;
    # rows are recycled every other level (outputs become next operands).
    # The working set of the busiest level must actually fit in the row
    # budget — bit capacity alone is not feasibility (a wide, shallow
    # netlist can satisfy the 4-bits/gate rule while its peak level
    # needs more rows than the macro has).
    max_batches = max(per_level_cycles) if per_level_cycles else 0
    rows_needed = 3 * max_batches + 2
    fits = BITS_PER_GATE * gates <= topo.total_bits and rows_needed <= topo.rows
    rows_used = min(topo.rows, rows_needed)

    return MappingResult(
        topo=topo,
        n_levels=stats.n_levels,
        total_cycles=total,
        active_macro_cycles=active_macro_cycles,
        op_counts=op_counts,
        rows_used=rows_used,
        fits=fits,
        per_level_cycles=per_level_cycles,
    )


def _schedule_list(stats: AigStats, topo: SramTopology) -> MappingResult:
    """ASAP width-bound schedule: cycles = max(depth, width bound) + drain."""
    w = topo.ops_per_cycle_per_macro
    mpt = _macros_per_type(topo)
    op_counts = {t: 0 for t in OP_TYPES}
    for level in stats.ops_per_level:
        for t in OP_TYPES:
            op_counts[t] += level.get(t, 0)

    depth_bound = stats.n_levels
    active_macro_cycles = 0
    if topo.n_macros == 1:
        # one op type per cycle on the single macro: issue-slot bound is the
        # sum over types.
        width_bound = sum(math.ceil(op_counts[t] / w) for t in OP_TYPES if op_counts[t])
        active_macro_cycles = width_bound
    else:
        per_type = [
            math.ceil(op_counts[t] / (w * mpt[t])) for t in OP_TYPES if op_counts[t]
        ]
        width_bound = max(per_type) if per_type else 0
        active_macro_cycles = sum(
            math.ceil(op_counts[t] / (w * mpt[t])) * mpt[t]
            for t in OP_TYPES
            if op_counts[t]
        )

    total = max(depth_bound, width_bound) + 1  # +1 writeback drain

    gates = sum(op_counts.values())
    # Feasibility = bit capacity (Alg. I line 9) AND row budget: the
    # steady-state working set holds ~width_bound/depth_bound concurrent
    # batches, each needing 2 operand rows + 1 result row.
    rows_needed = 3 * math.ceil(max(1, width_bound) / max(1, depth_bound)) + 2
    fits = BITS_PER_GATE * gates <= topo.total_bits and rows_needed <= topo.rows
    rows_used = min(topo.rows, rows_needed)

    return MappingResult(
        topo=topo,
        n_levels=stats.n_levels,
        total_cycles=total,
        active_macro_cycles=active_macro_cycles,
        op_counts=op_counts,
        rows_used=rows_used,
        fits=fits,
        per_level_cycles=[],
    )
