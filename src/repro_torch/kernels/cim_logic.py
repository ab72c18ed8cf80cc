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

On a CUDA tensor it launches the hand-written kernel
(``csrc/cim_logic.cu``); on a CPU tensor it runs the plain torch version
(`ref.cim_reference`).  ``LAUNCHES`` counts kernel launches: a view of
the registry's one counter (`analysis.registry.LAUNCH_COUNTS`).
"""

from __future__ import annotations

import ctypes
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


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=None)
def _k2():
    lib = build.load("cim_logic")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.k2_cim.argtypes = [vp, ci, ci, vp, ci, ci, vp, ci, vp, vp]
    lib.k2_cim.restype = ci
    lib.k2_shared_bytes.argtypes = [ci]
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


def _validate(instrs, planes, n_rows, n_gates, n_pos, block_words) -> None:
    for name, t in (("instrs", instrs), ("planes", planes)):
        if t.dtype != torch.int32:
            raise build.OperandError(f"{name} must be int32, got {t.dtype}")
        if t.ndim != 2 or not t.is_contiguous():
            raise build.OperandError(f"{name} must be a contiguous 2-D tensor")
    if planes.device != instrs.device:
        raise build.OperandError("instrs and planes must be on one device")
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


def cim_call(
    instrs: torch.Tensor,
    pi_planes: torch.Tensor,
    n_rows: int,
    n_gates: int,
    n_pos: int,
    block_words: int = 512,
) -> torch.Tensor:
    """Run the instruction stream over every word column (see module doc).

    The launch path holds no device sync: on CUDA tensors the row indices
    are the caller's to check (`check_rows` on the host array before
    upload, as `ops.cim_evaluate` does); on CPU tensors the wrapper checks
    them itself."""
    _validate(instrs, pi_planes, n_rows, n_gates, n_pos, block_words)
    dev = pi_planes.device
    if dev.type == "cpu":
        check_rows(instrs.numpy(), pi_planes.shape[0])  # repro: host-boundary — CPU operands
        return cim_plain(instrs, pi_planes, n_gates, n_pos)
    if dev.type != "cuda":
        raise ValueError(f"cim_call: unsupported device {dev}")
    lib = _k2()
    n_rows_p, n_words = pi_planes.shape
    n_pos_p = _round_up(n_pos, SUBLANE)
    out = torch.empty((n_pos_p, n_words), dtype=torch.int32, device=dev)
    scratch = None
    if lib.k2_shared_bytes(n_rows_p) > MAX_SHARED_BYTES:
        # Register file too tall for shared memory: global (L2) scratch.
        scratch = torch.empty((n_rows_p, n_words), dtype=torch.int32, device=dev)
    rc = lib.k2_cim(
        ctypes.c_void_p(instrs.data_ptr()), n_gates, n_pos,
        ctypes.c_void_p(pi_planes.data_ptr()), n_rows_p, n_words,
        ctypes.c_void_p(out.data_ptr()), n_pos_p,
        ctypes.c_void_p(None if scratch is None else scratch.data_ptr()),
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
    `cim_call`'s operands as `ops.cim_evaluate` builds them."""
    from ..core.circuits import gen_adder
    from .ops import cim_planes, compile_netlist

    cc = compile_netlist(gen_adder(4).to_gate_netlist())
    rng = np.random.default_rng(0)
    pi_words = rng.integers(-(2**31), 2**31, size=(len(cc.pi_rows), 128)).astype(np.int32)
    planes, bw = cim_planes(cc, pi_words, block_words=128)
    return _registry.KernelExample(
        fn=cim_call,
        args=(torch.from_numpy(cc.instrs).to(device), torch.from_numpy(planes).to(device)),
        kwargs=dict(n_rows=cc.n_rows, n_gates=cc.n_gates, n_pos=cc.n_pos, block_words=bw),
    )


# The reference registers K2's counter only; the port also registers a
# builder under the counter's name, so the graph layer launches K2.
_registry.register_kernel("cim", __name__, _ex_cim, x64=False, launches=("cim",))
