"""Public ops for the CiM logic engine.

``compile_netlist`` lowers a GateNetlist to the kernel's instruction
stream, performing the paper's operand-placement step (§III-D): signals
are assigned SRAM rows, and rows are recycled once their last consumer has
executed (linear-scan liveness) — the software analogue of "operands can
be placed flexibly ... optimizing the use of available SRAM resources".

``cim_program`` schedules that stream for the CUDA kernel: its gates in
levels over a renamed register file (`cim_logic.CimProgram`), built on
the host once per compiled netlist.

``cim_evaluate`` is the user-facing entry point; it packs test vectors,
pads shapes (8-row sublanes x ``block_words`` lanes), runs K2
(`cim_logic.cim_call`) on ``device``, and unpacks outputs.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from ..core.aig import GateNetlist
from ..device import resolve_device
from . import build, ref
from .cim_logic import (
    BATCH, CHUNK_SLOTS, LANE, SUBLANE, CimProgram, _round_up, check_rows, cim_call,
)


@dataclasses.dataclass
class CompiledCim:
    """Instruction stream + row map for one netlist."""

    instrs: np.ndarray  # (n_gates + n_pos, 4) int32; last n_pos are PO gathers
    n_rows: int  # register-file height (before sublane padding)
    n_gates: int
    n_pos: int
    pi_rows: np.ndarray  # (n_pis,) row of each primary input
    po_rows: np.ndarray  # (n_pos,) row holding each primary output
    n_signals: int  # before row reuse (for reporting)

    @property
    def n_rows_padded(self) -> int:
        return _round_up(max(self.n_rows, SUBLANE), SUBLANE)

    @property
    def reuse_factor(self) -> float:
        return self.n_signals / max(1, self.n_rows)


def compile_netlist(net: GateNetlist, reuse_rows: bool = True) -> CompiledCim:
    """Lower a NAND/NOR/NOT netlist to kernel instructions.

    With ``reuse_rows`` the register file height is the maximum number of
    simultaneously-live signals instead of the total signal count — this is
    what lets multi-thousand-gate circuits keep the register file in a
    block's shared memory.
    """
    kind_code = {"nand": 0, "nor": 1, "inv": 2}

    # Liveness: last use position of each signal (gate index, or +inf for POs).
    last_use = np.full(net.n_signals, -1, dtype=np.int64)
    for gi, g in enumerate(net.gates):
        last_use[g.a] = gi
        last_use[g.b] = gi
    for s in net.po_signals:
        last_use[s] = len(net.gates) + 1  # keep alive to the end
    for s in net.pi_signals:
        last_use[s] = max(last_use[s], 0)

    row_of: dict[int, int] = {}
    free_rows: list[int] = []
    next_row = 0

    def alloc(sig: int) -> int:
        nonlocal next_row
        if sig in row_of:
            return row_of[sig]
        if reuse_rows and free_rows:
            r = free_rows.pop()
        else:
            r = next_row
            next_row += 1
        row_of[sig] = r
        return r

    # PIs first so they occupy the leading rows contiguously — the kernel
    # copies the planes straight into the register file.
    pi_rows = np.array([alloc(s) for s in net.pi_signals], dtype=np.int32)
    # constants: const0 row / const1 row (signals 0, 1 per GateNetlist)
    alloc(0)
    alloc(1)

    instrs = np.zeros((len(net.gates) + len(net.po_signals), 4), dtype=np.int32)
    for gi, g in enumerate(net.gates):
        ra = row_of[g.a]
        rb = row_of[g.b]
        # Operand rows are read before the store, so an in-place write
        # would be safe; still, free only rows dead strictly before.
        ro = alloc(g.out)
        instrs[gi] = (kind_code[g.kind], ra, rb, ro)
        for s in (g.a, g.b):
            if last_use[s] == gi and s in row_of:
                free_rows.append(row_of.pop(s))

    po_rows = np.array([row_of[s] for s in net.po_signals], dtype=np.int32)
    for j, s in enumerate(net.po_signals):
        instrs[len(net.gates) + j] = (3, 0, 0, row_of[s])

    return CompiledCim(
        instrs=instrs,
        n_rows=next_row,
        n_gates=len(net.gates),
        n_pos=len(net.po_signals),
        pi_rows=pi_rows,
        po_rows=po_rows,
        n_signals=net.n_signals,
    )


def cim_program(cc: CompiledCim) -> CimProgram:
    """K2's program for ``cc``'s instruction stream, built once per
    `CompiledCim` (kept on it) on the host, with ``code`` on the CPU.

    Each reference row read before any gate writes it (PIs, the constant
    rows, any row left at its planes value) is an input, loaded into a
    renamed row.  Each gate goes one level past the latest of its two
    operands (inputs are level 0; gates no PO depends on stay) and writes
    a fresh renamed row; a row returns to the free list after the last
    level that reads it, so only a later level's gate reuses it.  Within
    a level no gate reads another's output, and all outputs differ.  The
    POs are the renamed rows holding ``po_rows`` at the end of the
    stream.  The program keeps a copy of the stream: `cim_call` refuses
    it for another stream (``cc.instrs`` changed in place included)."""
    prog = vars(cc).get("_cim_program")
    if prog is None:
        prog = _schedule(cc.instrs, cc.n_gates, cc.n_pos, cc.n_rows_padded)
        vars(cc)["_cim_program"] = prog
    return prog


def _schedule(instrs: np.ndarray, n_gates: int, n_pos: int, n_rows_p: int) -> CimProgram:
    # Nodes: gate i is node i; the planes row r read as an input is node
    # n_gates + r.  `cur` maps each reference row to the node it holds.
    cur: dict[int, int] = {}
    srcs = np.empty((n_gates, 2), dtype=np.int64)
    level = np.zeros(n_gates + n_rows_p, dtype=np.int64)
    for i, (_, a, b, o) in enumerate(instrs[:n_gates].tolist()):
        na, nb = cur.get(a, n_gates + a), cur.get(b, n_gates + b)
        srcs[i] = na, nb
        level[i] = 1 + max(level[na], level[nb])
        cur[o] = i
    po_nodes = [cur.get(r, n_gates + r) for r in instrs[n_gates : n_gates + n_pos, 3].tolist()]

    # The last level that reads each node (POs: past the end; a gate
    # nothing reads: its own level).  Inputs nothing reads are not loaded.
    end = int(level[:n_gates].max(initial=0)) + 1
    last_read = np.full(n_gates + n_rows_p, -1, dtype=np.int64)
    last_read[:n_gates] = level[:n_gates]
    np.maximum.at(last_read, srcs.ravel(), np.repeat(level[:n_gates], 2))
    last_read[po_nodes] = end
    inputs = np.flatnonzero(last_read[n_gates:] >= 0) + n_gates
    n_levels = end - 1
    by_level: list[list[int]] = [[] for _ in range(end)]
    for i, lv in enumerate(level[:n_gates].tolist()):
        by_level[lv].append(i)
    frees_after: list[list[int]] = [[] for _ in range(end + 1)]
    for node in [*range(n_gates), *inputs.tolist()]:
        frees_after[last_read[node]].append(node)

    # Renamed rows: inputs first, then each level's outputs from the rows
    # freed by the levels before it.
    row = {int(node): r for r, node in enumerate(inputs)}
    free: list[int] = []
    n_rows = len(inputs)
    slot_rows, levels = [], [0]
    for lv in range(1, n_levels + 1):
        for node in frees_after[lv - 1]:
            heapq.heappush(free, row[node])
        gates = by_level[lv]
        for i in gates:
            if free:
                row[i] = heapq.heappop(free)
            else:
                row[i], n_rows = n_rows, n_rows + 1
        rows = [(-int(instrs[i, 0] == 1), row[srcs[i, 0]], row[srcs[i, 1]], row[i])
                for i in gates]
        rows += [None] * (-len(rows) % BATCH)
        slot_rows += rows
        levels.append(len(slot_rows))
    pad = n_rows  # the pad row, written and read only by padding slots
    slots = np.array([(0, pad, pad, pad) if r is None else r for r in slot_rows],
                     dtype=np.int32).reshape(-1, 4)

    # Steps (a level, or a CHUNK_SLOTS piece of a wider one) and chunks
    # (runs of steps within CHUNK_SLOTS).
    steps = [0]
    for lo, hi in zip(levels[:-1], levels[1:]):
        steps += list(range(lo + CHUNK_SLOTS, hi, CHUNK_SLOTS)) + [hi]
    chunks, size = [0], 0
    for s, (lo, hi) in enumerate(zip(steps[:-1], steps[1:])):
        if size + hi - lo > CHUNK_SLOTS:
            chunks.append(s)
            size = 0
        size += hi - lo
    if len(steps) > 1:
        chunks.append(len(steps) - 1)
    code = np.concatenate([
        slots.ravel(), steps, chunks, inputs - n_gates, [row[n] for n in po_nodes],
    ]).astype(np.int32)
    return CimProgram(
        code=torch.from_numpy(code), n_slots=len(slots), n_steps=len(steps) - 1,
        n_chunks=len(chunks) - 1, n_in=len(inputs), n_pos=n_pos, n_rows=n_rows + 1,
        ref_rows=n_rows_p, n_gates=n_gates,
        widest=max((len(g) for g in by_level), default=0),
        levels=tuple(levels), stream=_frozen(instrs),
    )


def _frozen(a: np.ndarray) -> np.ndarray:
    a = a.copy()
    a.flags.writeable = False
    return a


def place_pi_planes(cc: CompiledCim, pi_words: np.ndarray, n_words: int) -> np.ndarray:
    """Scatter packed PI planes (n_pis, n_words) into the padded row layout,
    including the constant rows."""
    planes = np.zeros((cc.n_rows_padded, n_words), dtype=np.int32)
    planes[cc.pi_rows] = pi_words
    # const1 signal is id 1; find its row from the instruction stream usage:
    # GateNetlist guarantees signal 1 == const1; compile allocated it.
    return planes


def cim_planes(
    cc: CompiledCim, pi_words: np.ndarray, block_words: int = 512
) -> tuple[np.ndarray, int]:
    """The K2 operand for packed PI words: lanes padded to a multiple of
    the block width, PIs placed, const1 row all ones.  Returns (planes,
    block width)."""
    n_words = pi_words.shape[1]
    bw = min(block_words, _round_up(n_words, LANE))
    n_words_p = _round_up(n_words, bw)
    if n_words_p != n_words:
        pi_words = np.pad(pi_words, ((0, 0), (0, n_words_p - n_words)))
    planes = place_pi_planes(cc, pi_words, n_words_p)
    const1_row = _const1_row(cc)
    if const1_row is not None:
        planes[const1_row] = -1  # all ones
    return planes, bw


def cim_evaluate(
    net_or_cc: GateNetlist | CompiledCim,
    vectors: np.ndarray,  # (n_pis, n_vectors) bits  OR packed int32 words
    packed: bool = False,
    block_words: int = 512,
    device: "str | torch.device | None" = None,
) -> np.ndarray:
    """Evaluate a netlist on test vectors through K2 on ``device``
    (default ``cuda``; raises without a card).

    Returns (n_pos, n_vectors) bits (or packed words if ``packed``).
    """
    dev = resolve_device(device)
    cc = net_or_cc if isinstance(net_or_cc, CompiledCim) else compile_netlist(net_or_cc)
    if packed:
        pi_words = np.asarray(vectors, dtype=np.int32)
        n_vec = pi_words.shape[1] * 32
    else:
        n_vec = vectors.shape[1]
        pi_words = ref.pack_vectors(vectors)

    n_words = pi_words.shape[1]
    planes, bw = cim_planes(cc, pi_words, block_words)
    check_rows(cc.instrs, planes.shape[0])
    with build.device_faults("cim", dev):
        out = cim_call(
            torch.from_numpy(cc.instrs),  # the host stream: checked, not read, on CUDA
            torch.from_numpy(planes).to(dev),
            n_rows=cc.n_rows,
            n_gates=cc.n_gates,
            n_pos=cc.n_pos,
            block_words=bw,
            program=cim_program(cc).to(dev),
        ).cpu().numpy()[: cc.n_pos, :n_words]
    if packed:
        return out
    return ref.unpack_vectors(out, n_vec)


def _const1_row(cc: CompiledCim) -> int | None:
    # const1 is signal id 1; its row was allocated right after the PIs.
    # pi rows occupy [0, n_pis); const0 and const1 take the next two rows.
    return len(cc.pi_rows) + 1 if cc.n_rows > len(cc.pi_rows) + 1 else None


def cim_reference_evaluate(
    net: GateNetlist,
    vectors: np.ndarray,
    block_words: int = 512,
    device: "str | torch.device | None" = None,
) -> np.ndarray:
    """ref.py-backed oracle with the same packing path (for kernel tests)."""
    dev = resolve_device(device)
    cc = compile_netlist(net, reuse_rows=False)
    pi_words = ref.pack_vectors(vectors)
    planes = place_pi_planes(cc, pi_words, pi_words.shape[1])
    const1_row = _const1_row(cc)
    if const1_row is not None:
        planes[const1_row] = -1
    out = ref.cim_reference(
        torch.from_numpy(cc.instrs[: cc.n_gates]).to(dev),
        torch.from_numpy(planes).to(dev),
        torch.from_numpy(cc.po_rows).to(dev),
        n_rows=cc.n_rows_padded,
    )
    return ref.unpack_vectors(out.cpu().numpy(), vectors.shape[1])
