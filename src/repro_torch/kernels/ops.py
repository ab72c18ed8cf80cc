"""Public ops for the CiM logic engine.

``compile_netlist`` lowers a GateNetlist to the kernel's instruction
stream, performing the paper's operand-placement step (§III-D): signals
are assigned SRAM rows, and rows are recycled once their last consumer has
executed (linear-scan liveness) — the software analogue of "operands can
be placed flexibly ... optimizing the use of available SRAM resources".

``cim_evaluate`` is the user-facing entry point; it packs test vectors,
pads shapes (8-row sublanes x ``block_words`` lanes), runs K2
(`cim_logic.cim_call`) on ``device``, and unpacks outputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.aig import GateNetlist
from ..device import resolve_device
from . import build, ref
from .cim_logic import LANE, SUBLANE, _round_up, check_rows, cim_call


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
            torch.from_numpy(cc.instrs).to(dev),
            torch.from_numpy(planes).to(dev),
            n_rows=cc.n_rows,
            n_gates=cc.n_gates,
            n_pos=cc.n_pos,
            block_words=bw,
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
