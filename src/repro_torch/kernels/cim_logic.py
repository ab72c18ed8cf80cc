"""K2: the CiM bit-plane boolean logic engine.

The paper's in-SRAM computing (§III-B): the entire combinational
evaluation happens inside the "SRAM array" (here a register file of
bit-plane rows) with no trips to device memory between logic levels.
One instruction = one macro op: two row reads (the dual read ports), a
NAND2/NOR2/NOT on packed test vectors, one row writeback.  Row indices
come from ops.compile_netlist, which performs the paper's operand
placement (with linear-scan row reuse).

`cim_call` has the contract of the reference's ``cim_pallas_call``:

  * instrs (n_gates + n_pos, 4) int32 — [kind, a_row, b_row, out_row],
    the last n_pos slots are kind-3 PO gathers (row in column 3)
  * planes (n_rows_p, n_words) int32  — PI planes pre-placed in rows,
    n_rows_p a multiple of `SUBLANE`, n_words a multiple of block_words
  * returns (n_pos_p, n_words) int32  — gathered PO planes

On a CPU tensor it runs the plain torch version over that stream
(`cim_plain`, i.e. `ref.cim_reference`).  On a CUDA tensor it launches
the hand-written kernel (``csrc/cim_logic.cu``), which does not read the
stream: it runs a `CimProgram` built from it on the host
(`ops.cim_program`), the same gates as a level schedule over renamed
rows, passed as ``program=`` and required there; `check_program` holds
it to the stream.  `program_plain` is the plain torch executor of a
program, for the tests.  ``LAUNCHES`` counts kernel launches: a view of
the registry's one counter (`analysis.registry.LAUNCH_COUNTS`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..analysis import registry as _registry
from . import build
from .ref import cim_reference

# repro: kernel-module — host syncs in device-adjacent code are annotated
#: Kernel launches (plain-version calls do not count).
LAUNCHES = _registry.CounterView(("cim",))
_registry.register_counter("cim", __name__)

LANE = 128
SUBLANE = 8
#: Shared memory one block may use on the H100 (227 KB).
MAX_SHARED_BYTES = 232_448
#: Gates the kernel issues together (loads, then logic, then stores): a
#: program pads each level to a multiple of it.
BATCH = 8
#: Program slots (16 bytes each) in one staged chunk; the kernel keeps
#: two chunks in shared memory, the next one loading while it runs one.
CHUNK_SLOTS = 512


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=None)
def _k2():
    lib = build.load("cim_logic")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.k2_cim.argtypes = [vp, ci, ci, ci, ci, ci, ci, vp, ci, vp, ci, vp, ci, vp]
    lib.k2_cim.restype = ci
    lib.k2_shared_bytes.argtypes = [ci, ci]
    lib.k2_shared_bytes.restype = ctypes.c_long
    return lib


def cim_plain(instrs, planes, n_gates: int, n_pos: int) -> torch.Tensor:
    """Plain torch version of `cim_call` (same operands and output)."""
    n_rows_p, n_words = planes.shape
    out = torch.zeros(
        (_round_up(n_pos, SUBLANE), n_words), dtype=torch.int32, device=planes.device
    )
    out[:n_pos] = cim_reference(
        instrs[:n_gates], planes, instrs[n_gates : n_gates + n_pos, 3], n_rows_p
    )
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class CimProgram:
    """K2's kernel-private program for one instruction stream (built by
    `ops.cim_program`): the stream's gates in levels (each gate one level
    past its latest operand), each gate's output in a fresh row of
    a renamed register file, a row reused only from the level after its
    last read.

    ``code`` is the kernel's operand, one int32 vector of five sections:

      * slots (n_slots, 4) [op, a, b, out] over renamed rows (op -1 for
        NOR2, 0 for NAND2 and NOT, whose b is a), level by level, each
        level padded to a multiple of `BATCH` with no-op slots on the pad
        row (the last row, never read by a real gate);
      * step offsets (n_steps + 1), in slots: a step is one level, or a
        `CHUNK_SLOTS` piece of a wider one, and holds independent gates;
      * chunk offsets (n_chunks + 1), in steps: a chunk's slots fit
        `CHUNK_SLOTS`, the unit the kernel stages in shared memory;
      * in_rows (n_in): the planes row loaded into renamed row i;
      * po_rows (n_pos): the renamed row holding each PO at the end.

    The rest is host metadata: ``levels`` are the levels' slot offsets,
    ``ref_rows`` the planes height the in_rows index, ``stream`` a
    read-only copy of the instruction stream it was built from."""

    code: torch.Tensor
    n_slots: int
    n_steps: int
    n_chunks: int
    n_in: int
    n_pos: int
    n_rows: int
    ref_rows: int
    n_gates: int
    widest: int
    levels: tuple
    stream: np.ndarray

    @property
    def n_levels(self) -> int:
        return len(self.levels) - 1

    @property
    def pad_row(self) -> int:
        return self.n_rows - 1

    def section(self, name: str) -> torch.Tensor:
        """One section of ``code`` (a view): ``slots`` as (n_slots, 4),
        else ``steps``, ``chunks``, ``in_rows`` or ``po_rows``."""
        sizes = dict(slots=4 * self.n_slots, steps=self.n_steps + 1,
                     chunks=self.n_chunks + 1, in_rows=self.n_in, po_rows=self.n_pos)
        start = 0
        for key, size in sizes.items():
            if key == name:
                view = self.code[start : start + size]
                return view.view(-1, 4) if name == "slots" else view
            start += size
        raise KeyError(name)

    def to(self, device) -> "CimProgram":
        """The same program with ``code`` on ``device``."""
        return dataclasses.replace(self, code=self.code.to(device))


def program_plain(program: CimProgram, planes: torch.Tensor) -> torch.Tensor:
    """Plain torch executor of a `CimProgram` over ``planes`` (the
    operand `cim_call` takes): each level one gather, logic op and
    scatter over its slots and all words.  Returns `cim_call`'s output."""
    n_words = planes.shape[1]
    dev = planes.device
    code = program.code.to(dev)
    prog = dataclasses.replace(program, code=code)
    regs = torch.zeros((program.n_rows, n_words), dtype=torch.int32, device=dev)
    regs[: program.n_in] = planes[prog.section("in_rows").long()]
    slots = prog.section("slots").long()
    for lo, hi in zip(program.levels[:-1], program.levels[1:]):
        op, a, b, o = slots[lo:hi].unbind(1)
        x, y = regs[a], regs[b]
        regs[o] = torch.where((op != 0)[:, None], ~(x | y), ~(x & y))
    out = torch.zeros((_round_up(program.n_pos, SUBLANE), n_words), dtype=torch.int32, device=dev)
    out[: program.n_pos] = regs[prog.section("po_rows").long()]
    return out


def _validate(instrs, planes, n_rows, n_gates, n_pos, block_words) -> None:
    for name, t in (("instrs", instrs), ("planes", planes)):
        if t.dtype != torch.int32:
            raise build.OperandError(f"{name} must be int32, got {t.dtype}")
        if t.ndim != 2 or not t.is_contiguous():
            raise build.OperandError(f"{name} must be a contiguous 2-D tensor")
    if instrs.device not in (planes.device, torch.device("cpu")):
        raise build.OperandError("instrs must be on the planes' device or on the host")
    if tuple(instrs.shape) != (n_gates + n_pos, 4):
        raise build.OperandError(
            f"instrs must be ({n_gates + n_pos}, 4), got {tuple(instrs.shape)}"
        )
    n_rows_p, n_words = planes.shape
    if n_rows_p != _round_up(n_rows, SUBLANE):
        raise build.OperandError(f"planes rows {n_rows_p} != round_up({n_rows}, {SUBLANE})")
    if n_words % block_words:
        raise build.OperandError(f"n_words {n_words} is not a multiple of {block_words}")


def check_rows(instrs: np.ndarray, n_rows_p: int) -> None:
    """Row indices of the (n, 4) instruction array must lie in
    [0, n_rows_p).  Checked on the host array before upload: on a CUDA
    tensor the check would cost a device sync on every launch."""
    rows = instrs[:, 1:]
    if rows.size and (int(rows.min()) < 0 or int(rows.max()) >= n_rows_p):
        raise build.OperandError(f"instrs hold a row index outside [0, {n_rows_p})")


def check_program(program: CimProgram, instrs: torch.Tensor, n_rows_p: int, n_gates: int,
                  n_pos: int) -> None:
    """``program`` must be the one `ops.cim_program` builds from this
    stream: for planes of this height, this many gates and POs, and, when
    ``instrs`` is on the host, from these very instructions.  A stream on
    the card is held by its shape only: reading it would sync."""
    if (program.ref_rows, program.n_gates, program.n_pos) != (n_rows_p, n_gates, n_pos):
        raise build.OperandError(
            f"program built for {program.ref_rows} rows, {program.n_gates} gates and "
            f"{program.n_pos} POs, given {n_rows_p}, {n_gates} and {n_pos}"
        )
    on_host = instrs.device.type == "cpu"
    # repro: host-boundary — the host stream, never the card's
    if on_host and not np.array_equal(instrs.numpy(), program.stream):
        raise build.OperandError(
            "program was built from another instruction stream: pass ops.cim_program(cc) of "
            "this stream"
        )


def _validate_program(program, dev) -> None:
    """The CUDA path's program: present, its code on the planes' device."""
    if program is None:
        raise build.OperandError(
            "cim_call on CUDA runs a program: pass program=ops.cim_program(cc).to(device)"
        )
    code = program.code
    if code.dtype != torch.int32 or code.ndim != 1 or not code.is_contiguous():
        raise build.OperandError("program.code must be a contiguous 1-D int32 tensor")
    if code.device != dev:
        raise build.OperandError(f"program.code is on {code.device}, the planes on {dev}")
    if code.data_ptr() % 16:
        raise build.OperandError("program.code must be 16-byte aligned (int4 slots)")


def cim_call(
    instrs: torch.Tensor,
    pi_planes: torch.Tensor,
    n_rows: int,
    n_gates: int,
    n_pos: int,
    block_words: int = 512,
    *,
    program: "CimProgram | None" = None,
) -> torch.Tensor:
    """Run the instruction stream over every word column (see module doc).

    On CUDA planes the kernel runs ``program`` (`ops.cim_program` of the
    stream, with its ``code`` on the planes' device) and refuses to run
    without it; it does not read ``instrs``, which may stay on the host
    there (as `ops.cim_evaluate` passes it: no upload, and the program is
    checked against it) or lie on the card (shape only).  The
    CPU path runs the stream itself, and checks a program given to it.
    The launch path holds no device sync: on CUDA tensors the row
    indices are the caller's to check (`check_rows` on the host array,
    as `ops.cim_evaluate` does); on CPU tensors the wrapper checks them
    itself."""
    _validate(instrs, pi_planes, n_rows, n_gates, n_pos, block_words)
    dev = pi_planes.device
    n_rows_p, n_words = pi_planes.shape
    if dev.type == "cpu":
        check_rows(instrs.numpy(), n_rows_p)  # repro: host-boundary — CPU operands
        if program is not None:
            check_program(program, instrs, n_rows_p, n_gates, n_pos)
        return cim_plain(instrs, pi_planes, n_gates, n_pos)
    if dev.type != "cuda":
        raise ValueError(f"cim_call: unsupported device {dev}")
    _validate_program(program, dev)
    check_program(program, instrs, n_rows_p, n_gates, n_pos)
    lib = _k2()
    n_pos_p = _round_up(n_pos, SUBLANE)
    out = torch.empty((n_pos_p, n_words), dtype=torch.int32, device=dev)
    scratch = None
    if lib.k2_shared_bytes(program.n_rows, CHUNK_SLOTS) > MAX_SHARED_BYTES:
        # Renamed register file too tall for shared memory: global (L2)
        # scratch, laid out [row][word] over whole warps of words.
        scratch = torch.empty((program.n_rows, _round_up(n_words, 32)), dtype=torch.int32,
                              device=dev)
    rc = lib.k2_cim(
        ctypes.c_void_p(program.code.data_ptr()), program.n_slots, program.n_steps,
        program.n_chunks, program.n_in, n_pos, program.n_rows,
        ctypes.c_void_p(pi_planes.data_ptr()), n_words,
        ctypes.c_void_p(out.data_ptr()), n_pos_p,
        ctypes.c_void_p(None if scratch is None else scratch.data_ptr()),
        CHUNK_SLOTS,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
    )
    build.check(rc, "k2_cim")
    LAUNCHES["cim"] += 1
    return out


# ---------------------------------------------------------------------------
# Kernel registration (static analyzer)
# ---------------------------------------------------------------------------


def _ex_cim(device):
    """A 4-bit ripple adder's netlist over 128 words of test vectors:
    `cim_call`'s operands as `ops.cim_evaluate` builds them, with the
    stream on ``device`` too (the graph layer holds the outputs to the
    first operand's device; a stream on the card is not read)."""
    from ..core.circuits import gen_adder
    from .ops import cim_planes, cim_program, compile_netlist

    cc = compile_netlist(gen_adder(4).to_gate_netlist())
    rng = np.random.default_rng(0)
    pi_words = rng.integers(-(2**31), 2**31, size=(len(cc.pi_rows), 128)).astype(np.int32)
    planes, bw = cim_planes(cc, pi_words, block_words=128)
    return _registry.KernelExample(
        fn=cim_call,
        args=(torch.from_numpy(cc.instrs).to(device), torch.from_numpy(planes).to(device)),
        kwargs=dict(n_rows=cc.n_rows, n_gates=cc.n_gates, n_pos=cc.n_pos, block_words=bw,
                    program=cim_program(cc).to(device)),
    )


# The reference registers K2's counter only; the port also registers a
# builder under the counter's name, so the graph layer launches K2.
_registry.register_kernel("cim", __name__, _ex_cim, x64=False, launches=("cim",))
