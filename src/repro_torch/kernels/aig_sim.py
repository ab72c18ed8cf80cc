"""Bit-packed AIG cone simulation — the front half's engine, in torch.

The transforms (core/transforms.py) spend their time simulating small
cones: exact truth tables over a cut's leaves (rewrite / refactor /
resub verification) and whole-graph random signatures (resub).  This
module evaluates them as *batched bit-packed simulation*:

  * `compile_aig` lowers the (already topologically ordered) AIG once
    into a ``[kind, a_row, b_row, out_row]`` int32 instruction stream
    where ``kind`` packs the two fanin complement bits
    (``out = (a ^ pa) & (b ^ pb)``) and rows are node indices — plus a
    *wave-packed* variant (independent same-level nodes grouped so one
    step evaluates a whole wave) and the per-node AIG levels.
  * `eval_tts` evaluates a *batch* of (roots, support) queries.  Each
    word tier's queries are packed into one batch of **mega-program**
    chunks (`_pack_mega`): every query's cone is laid out in its chunk's
    flat row space (row 0 = const0, then per query its support rows —
    pinned to elementary truth tables, exactly `Aig.truth_table`'s
    semantics — followed by its cone rows), and each chunk's
    instructions are wave-packed by AIG level.  Device work is therefore
    proportional to the *useful* cone work, not batch x whole-graph.
  * `node_signatures` runs the whole-graph wave stream over random
    uint64 pattern words (viewed as uint32 lanes) — bit-identical to
    ``transforms._node_signatures``.

Both evaluations go through `eval_mega` / `sig_eval`, one call per word
tier (one per graph for signatures), with one upload of the packed
operands and one read-back.  On a CUDA tensor they launch the
hand-written kernel K1 (``csrc/aig_sim.cu``: one block per chunk and
word-column slice, rows in shared memory), on a CPU tensor they run the
plain torch version beside it (`eval_mega_plain` / `sig_eval_plain`: a
loop over chunks and waves, vectorized within each wave).  Planes travel
as int32 in torch (torch's CPU build lacks ``~``/``>>`` for uint32);
uint32 lanes are reinterpreted with numpy ``.view`` at the host
boundary.  ``LAUNCHES`` counts kernel launches per entry point and
``TIER_LAUNCHES`` the ``eval_mega`` launches per word tier.

Shape discipline: queries bucket into word tiers (k <= 5 / 10 / 14
support vars -> 1 / 32 / 512 uint32 words); chunks are bounded by a
per-tier row budget sized for shared memory.  On CUDA every query of up
to `MAX_VARS` support vars goes through K1, as the reference's Pallas
engine does; on the CPU queries wider than ``DEVICE_MAX_VARS["cpu"]``
take the host bigint path, as the reference's jnp engine does.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
from typing import Sequence

import numpy as np
import torch

from ..core.aig import Aig, _elementary_int
from ..device import resolve_device
from . import build

#: Kernel launches per K1 entry point (plain-version calls do not count).
LAUNCHES = {"eval_mega": 0, "sig_eval": 0}
#: ``eval_mega`` launches per word tier (words per truth table).
TIER_LAUNCHES = {1: 0, 32: 0, 512: 0}

# (max vars, uint32 words) shape tiers for truth-table queries.  A query
# with k support vars lands in the smallest tier with 32 * words >= 2**k;
# its table occupies the low 2**k bits and the host masks the rest off.
_TIERS: tuple[tuple[int, int], ...] = ((5, 1), (10, 32), (14, 512))

#: Mega-program shape knobs per word tier: the widest wave (the packer
#: picks each batch's wave width up to it), the word columns one block
#: owns (``cw``), and the per-chunk row budget.  A block holds its
#: chunk's rows x cw words plus a double buffer of two waves in shared
#: memory: W=1 8 K rows x 1 word + 32 KB, W=32 8 K x 4 + 8 KB, W=512
#: 2 K x 8 + 4 KB, all well inside 227 KB; chunks cut to spread a launch
#: (`_TARGET_BLOCKS`) need a third of that or less, so two or three
#: blocks share an SM.  Wave width x cw is at most 1024 (slot, column)
#: pairs, one pass of a block's threads.
_MEGA_WAVE = {1: 1024, 32: 256, 512: 128}
_MEGA_SLICE = {1: 1, 32: 4, 512: 8}
_MEGA_BUDGET = {1: 8192, 32: 8192, 512: 2048}
#: Blocks one launch aims for (one per SM of the H100), and the smallest
#: row budget the packer cuts a chunk to on the way.
_TARGET_BLOCKS = 132
_MIN_BUDGET = 512
#: Widest word-column slice of `sig_eval`; halved until the graph's rows
#: fit shared memory.
_SIG_SLICE = 2
#: Shared memory one block may use on the H100 (227 KB).  A launch whose
#: blocks need more runs K1's global-memory row space.
MAX_SHARED_BYTES = 232_448
#: Widest support `eval_tts` sends to the device engine, per device type.
#: On CUDA that is every tier (as the reference's Pallas engine does);
#: the plain torch version on the CPU stops at 10, as the reference's jnp
#: engine does.  Wider queries take the host bigint path.
DEVICE_MAX_VARS = {"cpu": 10, "cuda": 14}

MAX_VARS = _TIERS[-1][0]

#: Instructions per wave of the level-packed stream (see `compile_aig`).
WAVE_WIDTH = 128


@dataclasses.dataclass(frozen=True)
class AigProgram:
    """One AIG lowered to the shared instruction stream.

    ``instrs[i] = [kind, a_row, b_row, out_row]`` evaluates node
    ``n_pis + 1 + i``; rows are node indices (node 0 = const0, nodes
    1..n_pis = PIs).  ``kind`` = pa | (pb << 1) — the fanin complement
    bits.  Rows/instructions are padded to ``n_pad`` (power of two);
    padding instructions write the scratch row ``n_pad - 1``.

    ``waves`` is the same stream *level-packed*: nodes grouped by AIG
    level (same-level nodes never depend on each other), each level
    split into `WAVE_WIDTH`-wide waves, so one step evaluates up to 128
    independent nodes and the step count is ~depth, not ~n_nodes.  Wave
    count pads to a power of two.
    """

    instrs: np.ndarray  # (n_pad, 4) int32 — flat stream
    waves: np.ndarray  # (n_waves_pad, wave_w, 4) int32 — signature engine
    lv: np.ndarray  # (n_nodes,) int64 — AIG levels (mega wave packing)
    n_nodes: int
    n_pis: int
    n_pad: int


def _next_pow2(x: int, floor: int = 3) -> int:
    return 1 << max(floor, (x - 1).bit_length())


def compile_aig(aig: Aig) -> AigProgram:
    """Lower an AIG to the level-ordered instruction stream (host, once)."""
    n_nodes = aig.n_nodes
    n_pad = _next_pow2(n_nodes + 1)
    f0 = np.asarray(aig._f0, dtype=np.int64)
    f1 = np.asarray(aig._f1, dtype=np.int64)
    instrs = np.zeros((n_pad, 4), dtype=np.int32)
    # No-op padding: AND of const0 with itself, parked in the scratch row.
    instrs[:, 3] = n_pad - 1
    lo = aig.n_pis + 1
    n_ands = n_nodes - lo
    if n_ands > 0:
        a, b = f0[lo:], f1[lo:]
        instrs[:n_ands, 0] = (a & 1) | ((b & 1) << 1)
        instrs[:n_ands, 1] = a >> 1
        instrs[:n_ands, 2] = b >> 1
        instrs[:n_ands, 3] = np.arange(lo, n_nodes)

    # Pack into waves by capacity-constrained ASAP list scheduling: a node
    # goes into the first non-full wave after both fanins' waves.  The wave
    # width adapts to the graph's average level width (deep carry-chain
    # circuits get narrow waves), so the stream stays *dense* — total slots
    # ~ n_ands, steps ~ depth — and memory traffic is bounded by useful
    # work, not padding.  Padding slots replay the no-op (scratch-row
    # write of const0 — duplicates within a wave all store the same value).
    lv = np.asarray(aig.levels(), dtype=np.int64)
    if n_ands > 0:
        depth = max(1, int(lv.max()))
        wave_w = _next_pow2(min(WAVE_WIDTH, max(8, -(-n_ands // depth))))
        wave_of = np.full(n_nodes, -1, dtype=np.int64)
        fill: list[int] = []
        wave_id = np.zeros(n_ands, dtype=np.int64)
        col = np.zeros(n_ands, dtype=np.int64)
        for i in range(n_ands):
            node = lo + i
            w = max(wave_of[f0[node] >> 1], wave_of[f1[node] >> 1]) + 1
            while w < len(fill) and fill[w] >= wave_w:
                w += 1
            while w >= len(fill):
                fill.append(0)
            wave_of[node] = w
            wave_id[i] = w
            col[i] = fill[w]
            fill[w] += 1
        n_waves = len(fill)
    else:
        wave_w = 8
        n_waves = 0
    n_waves_pad = _next_pow2(n_waves + 1, floor=1)
    waves = np.zeros((n_waves_pad, wave_w, 4), dtype=np.int32)
    waves[:, :, 3] = n_pad - 1
    if n_ands > 0:
        waves[wave_id, col] = instrs[:n_ands]
    return AigProgram(
        instrs=instrs,
        waves=waves,
        lv=lv,
        n_nodes=n_nodes,
        n_pis=aig.n_pis,
        n_pad=n_pad,
    )


@functools.lru_cache(maxsize=None)
def _elem_words(k_max: int) -> np.ndarray:
    """Elementary truth tables of ``k_max`` vars as (k_max, words) uint32,
    LSB-first pattern order — `Aig._elementary_int` bit-packed."""
    n_pat = 1 << k_max
    words = max(1, n_pat // 32)
    out = np.zeros((k_max, words), dtype=np.uint32)
    for i in range(k_max):
        v = _elementary_int(i, k_max)
        out[i] = np.frombuffer(v.to_bytes(words * 4, "little"), dtype="<u4")
    return out


@functools.lru_cache(maxsize=None)
def _dev_elem(k_max: int, device: torch.device) -> torch.Tensor:
    """`_elem_words(k_max)` as int32, already resident on ``device``."""
    return torch.from_numpy(_elem_words(k_max).view(np.int32)).to(device)


def _tier_for(k: int) -> tuple[int, int]:
    for k_max, w in _TIERS:
        if k <= k_max:
            return k_max, w
    raise ValueError(f"eval_tts limited to {MAX_VARS} support vars, got {k}")


# ---------------------------------------------------------------------------
# K1 and its plain torch version
# ---------------------------------------------------------------------------
#
# Batched contract, shared by both entry points: ``waves`` (L, M, 4)
# holds every chunk's waves back to back, the row operand (``pin_rows``
# (N,) or ``vals0`` (N, W)) every chunk's rows back to back, and ``meta``
# (C, 6) for ``eval_mega`` / (C, 4) for ``sig_eval`` says what chunk c
# owns: ``[wave_off, wave_cnt, row_base, row_cnt, root_off, root_cnt]``.
# Row indices inside the waves and ``rootp`` are local to the chunk; a
# chunk's padding slots write its last row.  A one-chunk batch
# ``meta = [[0, L, 0, N, 0, Q]]`` is the reference jnp engine's contract.


def _wave_step(vals: torch.Tensor, ins: torch.Tensor) -> None:
    """One wave of independent int32 instructions, in place (plain
    version).  Complement masks are ``-(bit)`` in int32, so the XOR stays
    in the planes' dtype."""
    kind = ins[:, 0]
    a, b, o = ins[:, 1].long(), ins[:, 2].long(), ins[:, 3].long()
    va = vals[a] ^ (-(kind & 1))[:, None]
    vb = vals[b] ^ (-((kind >> 1) & 1))[:, None]
    # Padding slots all write const0 to the scratch row: the duplicate
    # indices store the same value.
    vals[o] = va & vb


def eval_mega_plain(waves, pin_rows, elem, rootp, meta) -> torch.Tensor:
    """Plain torch version of K1's ``eval_mega`` contract.

    Per chunk: support rows (``pin_rows`` var index >= 0) hold elementary
    tables from ``elem`` (K, W), every other row 0; the chunk's waves run
    in order; ``rootp`` packs each root query as ``row << 1 | phase``.
    Returns (Q, W) i32.  Support rows are never written (cone membership
    excludes pinned nodes), so each step is gather-AND-scatter.
    """
    k, w = elem.shape
    out = torch.zeros((rootp.shape[0], w), dtype=torch.int32, device=elem.device)
    zero = torch.zeros((), dtype=torch.int32, device=elem.device)
    for wave_off, wave_cnt, row_base, row_cnt, root_off, root_cnt in meta.tolist():
        pin = pin_rows[row_base : row_base + row_cnt]
        vals = torch.where((pin >= 0)[:, None], elem[pin.clamp(0, k - 1).long()], zero)
        for ins in waves[wave_off : wave_off + wave_cnt]:
            _wave_step(vals, ins)
        rp = rootp[root_off : root_off + root_cnt]
        out[root_off : root_off + root_cnt] = vals[(rp >> 1).long()] ^ (-(rp & 1))[:, None]
    return out


def sig_eval_plain(waves, vals0, meta) -> torch.Tensor:
    """Plain torch version of K1's ``sig_eval`` contract: each chunk's
    rows of ``vals0`` (N, W) i32, PI rows pre-placed, run through its
    waves -> (N, W) i32."""
    vals = vals0.clone()
    for wave_off, wave_cnt, row_base, row_cnt in meta.tolist():
        rows = vals[row_base : row_base + row_cnt]  # a view: updated in place
        for ins in waves[wave_off : wave_off + wave_cnt]:
            _wave_step(rows, ins)
    return vals


def _check(t: torch.Tensor, name: str, ndim: int, device: torch.device) -> None:
    if t.device != device:
        raise build.OperandError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise build.OperandError(f"{name} must be int32, got {t.dtype}")
    if t.ndim != ndim:
        raise build.OperandError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise build.OperandError(f"{name} must be contiguous")


def _check_rows(a: np.ndarray, n_rows: int, name: str) -> None:
    """Row indices the kernel dereferences must lie in [0, n_rows)."""
    if a.size and (int(a.min()) < 0 or int(a.max()) >= n_rows):
        raise build.OperandError(f"{name} holds a row index outside [0, {n_rows})")


def _check_chunks(
    waves: np.ndarray,
    meta: np.ndarray,
    n_rows: int,
    max_rows: int,
    rootp: np.ndarray | None = None,
) -> None:
    """Every range of ``meta`` must lie inside its operand, every chunk
    fit ``max_rows``, and every row index a chunk's waves or roots
    dereference lie inside that chunk's rows.

    Checked on the host arrays before they are uploaded: on CUDA tensors
    the check would cost a device sync per operand on every launch."""
    ncol = 6 if rootp is not None else 4
    if meta.ndim != 2 or meta.shape[1] != ncol:
        raise build.OperandError(f"meta must be (C, {ncol}), got {meta.shape}")
    if waves.ndim != 3 or waves.shape[2] != 4:
        raise build.OperandError(f"waves must be (L, M, 4), got {waves.shape}")
    m = meta.astype(np.int64)
    if m.size and int(m.min()) < 0:
        raise build.OperandError("meta holds a negative offset or count")
    spans = [(0, len(waves), "waves"), (2, n_rows, "rows")]
    if rootp is not None:
        spans.append((4, len(rootp), "roots"))
    for col, limit, what in spans:
        if m.size and int((m[:, col] + m[:, col + 1]).max()) > limit:
            raise build.OperandError(f"meta: a chunk's {what} run past {limit}")
    if m.size and (int(m[:, 3].min()) < 1 or int(m[:, 3].max()) > max_rows):
        raise build.OperandError(f"meta: a chunk's rows outside [1, max_rows={max_rows}]")
    for row in m:
        cnt = int(row[3])
        _check_rows(waves[row[0] : row[0] + row[1], :, 1:], cnt, "waves")
        if rootp is not None:
            _check_rows(rootp[row[4] : row[4] + row[5]] >> 1, cnt, "rootp")


def _p(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


@functools.lru_cache(maxsize=None)
def _k1():
    lib = build.load("aig_sim")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.k1_shared_bytes.argtypes = [ci, ci, ci]
    lib.k1_shared_bytes.restype = ctypes.c_long
    lib.k1_eval_mega.argtypes = [vp, ci, vp, ci, ci, ci, ci, vp, vp, ci, vp, ci, vp, vp, vp]
    lib.k1_eval_mega.restype = ci
    lib.k1_sig_eval.argtypes = [vp, ci, vp, ci, ci, ci, ci, vp, ci, ci, vp, vp]
    lib.k1_sig_eval.restype = ci
    return lib


def _shift(cw: int) -> int:
    if cw < 1 or cw & (cw - 1):
        raise build.OperandError(f"column slice {cw} is not a power of two")
    return cw.bit_length() - 1


def _fits_shared(wave_m: int, max_rows: int, cw: int) -> bool:
    """Whether one block's rows x cw words and instruction double buffer
    fit `MAX_SHARED_BYTES` (decides K1's row-space variant)."""
    return _k1().k1_shared_bytes(wave_m, max_rows, _shift(cw)) <= MAX_SHARED_BYTES


def _check_launch(waves: torch.Tensor, tensors: dict, dev: torch.device) -> None:
    _check(waves, "waves", 3, dev)
    if waves.shape[2] != 4:
        raise build.OperandError(f"waves must be (L, M, 4), got {tuple(waves.shape)}")
    if waves.data_ptr() % 16:
        raise build.OperandError("waves must be 16-byte aligned (read as int4)")
    for name, (t, ndim) in tensors.items():
        _check(t, name, ndim, dev)


def eval_mega(waves, pin_rows, elem, rootp, meta, cw: int, max_rows: int) -> torch.Tensor:
    """K1 ``eval_mega`` over a batch of chunks: launches the CUDA kernel
    for CUDA tensors (one block per chunk and ``cw``-word column slice),
    runs `eval_mega_plain` for CPU tensors (same contract).

    ``max_rows`` bounds every chunk's ``row_cnt`` and sizes the blocks'
    shared memory; a batch whose blocks do not fit `MAX_SHARED_BYTES`
    runs on a global-memory row space instead.  The launch path holds no
    device sync: on CUDA tensors ``meta`` and the row indices are the
    caller's to check (`_check_chunks` on the host arrays before upload,
    as `_eval_mega_tier` does); on CPU tensors the wrapper checks them."""
    dev = waves.device
    if dev.type == "cpu":
        _check_chunks(waves.numpy(), meta.numpy(), pin_rows.shape[0], max_rows, rootp.numpy())
        return eval_mega_plain(waves, pin_rows, elem, rootp, meta)
    if dev.type != "cuda":
        raise ValueError(f"eval_mega: unsupported device {dev}")
    _check_launch(
        waves,
        {"pin_rows": (pin_rows, 1), "elem": (elem, 2), "rootp": (rootp, 1), "meta": (meta, 2)},
        dev,
    )
    k, w = elem.shape
    shift = _shift(cw)
    wave_m = waves.shape[1]
    out = torch.empty((rootp.shape[0], w), dtype=torch.int32, device=dev)
    grows = None
    if not _fits_shared(wave_m, max_rows, cw):
        grows = torch.empty((pin_rows.shape[0], w), dtype=torch.int32, device=dev)
    rc = _k1().k1_eval_mega(
        _p(waves), wave_m, _p(meta), meta.shape[0], -(-w // cw), shift, w,
        _p(pin_rows), _p(elem), k, _p(rootp), max_rows, _p(grows), _p(out), _stream(),
    )
    build.check(rc, "k1_eval_mega")
    LAUNCHES["eval_mega"] += 1
    TIER_LAUNCHES[w] = TIER_LAUNCHES.get(w, 0) + 1
    return out


def _sig_cw(wave_m: int, max_rows: int) -> tuple[int, bool]:
    """`sig_eval`'s column slice and whether its rows sit in shared
    memory: the widest slice up to `_SIG_SLICE` that fits, else
    `_SIG_SLICE` on the global-memory row space."""
    cw = _SIG_SLICE
    while cw >= 1:
        if _fits_shared(wave_m, max_rows, cw):
            return cw, True
        cw //= 2
    return _SIG_SLICE, False


def sig_eval(waves, vals0, meta, max_rows: int) -> torch.Tensor:
    """K1 ``sig_eval`` over a batch of chunks: launches the CUDA kernel
    for CUDA tensors, runs `sig_eval_plain` for CPU tensors (same
    contract).  The wrapper picks the column slice and row-space variant
    by size (`_sig_cw`); ``meta`` and row indices are checked as in
    `eval_mega`: by the caller on CUDA, here on the CPU."""
    dev = waves.device
    if dev.type == "cpu":
        _check_chunks(waves.numpy(), meta.numpy(), vals0.shape[0], max_rows)
        return sig_eval_plain(waves, vals0, meta)
    if dev.type != "cuda":
        raise ValueError(f"sig_eval: unsupported device {dev}")
    _check_launch(waves, {"vals0": (vals0, 2), "meta": (meta, 2)}, dev)
    n_rows, w = vals0.shape
    wave_m = waves.shape[1]
    cw, shared = _sig_cw(wave_m, max_rows)
    out = torch.empty((n_rows, w), dtype=torch.int32, device=dev)
    rc = _k1().k1_sig_eval(
        _p(waves), wave_m, _p(meta), meta.shape[0], -(-w // cw), _shift(cw), w,
        _p(vals0), max_rows, int(not shared), _p(out), _stream(),
    )
    build.check(rc, "k1_sig_eval")
    LAUNCHES["sig_eval"] += 1
    return out


def upload(device: torch.device, *arrays: np.ndarray) -> list[torch.Tensor]:
    """Copy int32 host arrays to ``device`` as one buffer, in one copy,
    and return a view of it per array, in that array's shape.  The first
    array starts the buffer, so it keeps the allocation's alignment (K1
    reads ``waves`` as 16-byte int4)."""
    flat = np.concatenate([np.ascontiguousarray(a).reshape(-1).view(np.int32) for a in arrays])
    buf = torch.from_numpy(flat).to(device)
    views, o = [], 0
    for a in arrays:
        views.append(buf[o : o + a.size].view(a.shape))
        o += a.size
    return views


# ---------------------------------------------------------------------------
# Host API
# ---------------------------------------------------------------------------


def _cone_members(
    aig: Aig,
    items: Sequence[tuple[Sequence[int], Sequence[int]]],
    idxs: Sequence[int],
) -> np.ndarray:
    """(len(idxs), n_nodes) bool: AND nodes in each query's pinned cone(s).

    Descending-index scan (fanins always have smaller indices): a node
    active in a query (visited, not a leaf) marks both fanin nodes.
    Multi-root queries seed every root's node, so one row covers the
    union cone (resub's (n, m) pairs).
    """
    n = aig.n_nodes
    n_pis = aig.n_pis
    f0 = np.asarray(aig._f0, dtype=np.int64)
    f1 = np.asarray(aig._f1, dtype=np.int64)
    # (n_nodes, batch) layout: the scan touches whole node rows, which
    # are contiguous this way round (the (B, n) layout strides by n per
    # element and is several times slower).
    vis = np.zeros((n, len(idxs)), dtype=bool)
    leaf = np.zeros((n, len(idxs)), dtype=bool)
    hi = n_pis
    for row, i in enumerate(idxs):
        roots, support = items[i]
        leaf[list(support), row] = True
        for rl in roots:
            r = rl >> 1
            vis[r, row] = True
            if r > hi:
                hi = r
    for node in range(hi, n_pis, -1):
        act = vis[node] & ~leaf[node]
        if not act.any():
            continue
        vis[f0[node] >> 1][act] = True
        vis[f1[node] >> 1][act] = True
    members = vis & ~leaf
    members[: n_pis + 1] = False
    return np.ascontiguousarray(members.T)


@dataclasses.dataclass(frozen=True)
class MegaBatch:
    """One word tier's queries packed as the operands of one `eval_mega`
    launch (numpy, host), plus what the host needs to unpack them."""

    waves: np.ndarray  # (L, M, 4) int32, every chunk's waves back to back
    pin_rows: np.ndarray  # (N,) int32, every chunk's pin map back to back
    rootp: np.ndarray  # (Q,) int32
    meta: np.ndarray  # (C, 6) int32, see the batched contract above
    cw: int  # word columns per block
    qoff: np.ndarray  # (n_queries + 1,) output row of each query's first root

    @property
    def max_rows(self) -> int:
        return int(self.meta[:, 3].max())

    def operands(self, device: torch.device, elem: torch.Tensor) -> tuple:
        """`eval_mega`'s positional operands on ``device`` (one upload)."""
        waves, pin_rows, rootp, meta = upload(
            device, self.waves, self.pin_rows, self.rootp, self.meta
        )
        return waves, pin_rows, elem, rootp, meta, self.cw, self.max_rows


def _chunk_bounds(sizes: np.ndarray, budget: int) -> np.ndarray:
    """Greedy chunking: a chunk takes queries in order while their rows
    fit ``budget``, and always at least one.  Returns the chunk
    boundaries as query positions (first 0, last ``len(sizes)``)."""
    cum = np.cumsum(sizes)
    bounds = [0]
    while bounds[-1] < len(sizes):
        i = bounds[-1]
        base = int(cum[i - 1]) if i else 0
        j = int(np.searchsorted(cum, base + budget, side="right"))
        bounds.append(max(j, i + 1))
    return np.asarray(bounds, dtype=np.int64)


def _pack_mega(
    aig: Aig,
    prog: AigProgram,
    items: Sequence[tuple[Sequence[int], Sequence[int]]],
    idxs: list[int],
    w: int,
    mem: np.ndarray,
) -> MegaBatch:
    """Pack one word tier's queries into one batch of mega-program chunks.

    Queries fill chunks in order up to a row budget: the tier's
    `_MEGA_BUDGET`, cut so the launch spreads over `_TARGET_BLOCKS`
    blocks where the queries allow.  Each chunk's row space is row 0 =
    const0, then per query its k support rows (pinned to elementary
    tables) followed by its cone rows in topo order, then the scratch row
    that padding slots write.  A query's node -> row lookup is sparse:
    sorted keys ``query * n_nodes + node``, fanins and roots found by
    ``searchsorted``; nodes outside a query's support and cone read row 0
    (const0) — the python path would raise on such a read, and no caller
    produces one (cones are closed over their supports).  Each chunk's
    instructions are wave-packed by AIG level (fanins always have
    strictly smaller levels, and cross-query instructions are
    independent); the wave width is the mean (chunk, level) population
    rounded up to a power of two, capped by `_MEGA_WAVE`.
    """
    n = aig.n_nodes
    f0 = np.asarray(aig._f0, dtype=np.int64)
    f1 = np.asarray(aig._f1, dtype=np.int64)
    nq = len(idxs)
    it = [items[i] for i in idxs]
    k_b = np.fromiter((len(s) for _, s in it), dtype=np.int64, count=nq)
    r_b = np.fromiter((len(r) for r, _ in it), dtype=np.int64, count=nq)
    # Cone members in (query, node) order.  The flat scan of the dense
    # (queries x nodes) matrix is several times faster than 2-D nonzero.
    cone_keys = np.flatnonzero(mem)
    b_idx, node_idx = np.divmod(cone_keys, n)
    counts = np.bincount(b_idx, minlength=nq)
    sizes = k_b + counts

    # Spread the tier over about one block per SM where the queries allow:
    # cut the row budget down (not below _MIN_BUDGET) so the chunks times
    # the column slices reach _TARGET_BLOCKS.
    want_chunks = -(-_TARGET_BLOCKS // -(-w // _MEGA_SLICE[w]))
    budget = min(_MEGA_BUDGET[w], max(_MIN_BUDGET, -(-int(sizes.sum()) // want_chunks)))
    bounds = _chunk_bounds(sizes, budget)
    n_chunks = len(bounds) - 1
    chunk_of = np.repeat(np.arange(n_chunks), np.diff(bounds))
    before = np.cumsum(sizes) - sizes  # tier rows before each query
    first = before[bounds[:-1]]  # ... before each chunk's first query
    row_base = 1 + before - first[chunk_of]  # chunk-local first row per query
    row_cnt = 2 + np.add.reduceat(sizes, bounds[:-1])  # + const0, scratch
    chunk_row = np.concatenate(([0], np.cumsum(row_cnt)[:-1]))

    # Support rows: pinned to elementary tables via the pin map.
    tot_k = int(k_b.sum())
    sup_nodes = np.fromiter(
        itertools.chain.from_iterable(s for _, s in it), dtype=np.int64, count=tot_k
    )
    q_of_sup = np.repeat(np.arange(nq), k_b)
    koff = np.concatenate(([0], np.cumsum(k_b)[:-1]))
    var_idx = np.arange(tot_k) - np.repeat(koff, k_b)
    sup_rows = row_base[q_of_sup] + var_idx
    pin_rows = np.full(int(row_cnt.sum()), -1, dtype=np.int32)
    pin_rows[chunk_row[chunk_of[q_of_sup]] + sup_rows] = var_idx

    # Cone rows, and the sparse (query, node) -> row lookup: the flat scan
    # gave the cone keys ``query * n_nodes + node`` already sorted, and the
    # support keys (a handful per query) are sorted once.
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    cone_rows = row_base[b_idx] + k_b[b_idx] + np.arange(len(b_idx)) - np.repeat(starts, counts)
    sup_keys = q_of_sup * n + sup_nodes
    sup_order = np.argsort(sup_keys, kind="stable")
    tables = ((cone_keys, cone_rows), (sup_keys[sup_order], sup_rows[sup_order]))

    def row_of(q: np.ndarray, node: np.ndarray) -> np.ndarray:
        key = q * n + node
        rows = np.zeros(len(key), dtype=np.int64)
        for keys, vals in tables:  # a query's supports and cone are disjoint
            if len(keys):
                # The last of equal keys, as a dense map's last write would be.
                i = np.maximum(np.searchsorted(keys, key, side="right") - 1, 0)
                hit = keys[i] == key
                rows[hit] = vals[i[hit]]
        return rows

    wave_m = 1
    wave_chunk = np.zeros(0, dtype=np.int64)
    if len(b_idx):
        f0n, f1n = f0[node_idx], f1[node_idx]
        instr = np.empty((len(b_idx), 4), dtype=np.int32)
        instr[:, 0] = (f0n & 1) | ((f1n & 1) << 1)
        instr[:, 1] = row_of(b_idx, f0n >> 1)
        instr[:, 2] = row_of(b_idx, f1n >> 1)
        instr[:, 3] = cone_rows
        # Wave-pack by (chunk, level), chopping each group into
        # wave_m-wide waves (same-level instructions never depend).
        group = chunk_of[b_idx] * (int(prog.lv.max()) + 1) + prog.lv[node_idx]
        order = np.argsort(group, kind="stable")
        sg = group[order]
        new_group = np.concatenate(([True], sg[1:] != sg[:-1]))
        gstart = np.flatnonzero(new_group)
        pos = np.arange(len(order)) - np.repeat(gstart, np.diff(np.append(gstart, len(order))))
        wave_m = min(_MEGA_WAVE[w], _next_pow2(-(-len(order) // len(gstart)), floor=0))
        slot = pos % wave_m
        # A wave starts at each group's start and every wave_m slots after.
        step = new_group | (slot == 0)
        wid = np.cumsum(step) - 1
        wave_chunk = chunk_of[b_idx[order[step]]]
    wave_cnt = np.bincount(wave_chunk, minlength=n_chunks)
    waves = np.zeros((len(wave_chunk), wave_m, 4), dtype=np.int32)
    waves[:, :, 3] = (row_cnt[wave_chunk] - 1)[:, None]  # no-op padding: scratch <- 0
    if len(b_idx):
        waves[wid, slot] = instr[order]

    # Root queries: one output row per root literal.
    q_root = np.repeat(np.arange(nq), r_b)
    root_lits = np.fromiter(
        itertools.chain.from_iterable(r for r, _ in it), dtype=np.int64, count=int(r_b.sum())
    )
    rootp = ((row_of(q_root, root_lits >> 1) << 1) | (root_lits & 1)).astype(np.int32)
    qoff = np.concatenate(([0], np.cumsum(r_b)))
    meta = np.stack(
        [
            np.concatenate(([0], np.cumsum(wave_cnt)[:-1])),
            wave_cnt,
            chunk_row,
            row_cnt,
            qoff[bounds[:-1]],
            np.diff(qoff[bounds]),
        ],
        axis=1,
    ).astype(np.int32)
    return MegaBatch(
        waves=waves, pin_rows=pin_rows, rootp=rootp, meta=meta, cw=_MEGA_SLICE[w], qoff=qoff
    )


def _eval_mega_tier(
    aig: Aig,
    prog: AigProgram,
    items: Sequence[tuple[Sequence[int], Sequence[int]]],
    idxs: list[int],
    w: int,
    mem: np.ndarray,
    results: list,
    device: torch.device,
) -> None:
    """Run one word tier's queries as one `eval_mega` call on ``device``
    (one upload, one launch, one read-back) and unpack each query's
    truth tables into ``results``."""
    k_max = next(km for km, tw in _TIERS if tw == w)
    batch = _pack_mega(aig, prog, items, idxs, w, mem)
    _check_chunks(batch.waves, batch.meta, len(batch.pin_rows), batch.max_rows, batch.rootp)
    with build.device_faults("eval_mega", device):
        ops = batch.operands(device, _dev_elem(k_max, device))
        out = eval_mega(*ops).cpu().numpy().view(np.uint32)
    qoff = batch.qoff.tolist()
    if w == 1:
        flat = out[:, 0].tolist()
        for pos, idx in enumerate(idxs):
            roots, support = items[idx]
            mask = (1 << (1 << len(support))) - 1
            base = qoff[pos]
            results[idx] = tuple(flat[base + ri] & mask for ri in range(len(roots)))
    else:
        buf = out.tobytes()
        nb = w * 4
        for pos, idx in enumerate(idxs):
            roots, support = items[idx]
            n_pat = 1 << len(support)
            need = (n_pat + 7) // 8  # bytes holding the low 2**k bits
            mask = (1 << n_pat) - 1
            base = qoff[pos]
            results[idx] = tuple(
                int.from_bytes(buf[(base + ri) * nb : (base + ri) * nb + need], "little")
                & mask
                for ri in range(len(roots))
            )


def _check_engine(engine: str) -> None:
    # ``engine`` is kept for signature compatibility with the reference;
    # the engine is picked by the device (K1 on CUDA, plain on CPU).
    if engine != "auto":
        raise ValueError(f"unknown aig_sim engine {engine!r} (only 'auto')")


def eval_tts(
    aig: Aig,
    items: Sequence[tuple[Sequence[int], Sequence[int]]],
    engine: str = "auto",
    program: AigProgram | None = None,
    members: np.ndarray | None = None,
    device: "str | torch.device | None" = None,
) -> list[tuple[int, ...]]:
    """Batched exact truth tables: ``items[i] = (root_lits, support)``.

    Returns, per item, one python-int truth table per root literal —
    bit-identical to ``aig.truth_table(root_lit, support)`` (same
    LSB-first pattern order, same pinned-support semantics).

    Queries with up to ``DEVICE_MAX_VARS[device.type]`` support vars are
    bucketed by word tier and evaluated, one `eval_mega` call per tier,
    as batches of mega-program chunks (see `_pack_mega`) on ``device``
    (default ``cuda``; raises without a card).  On CUDA that is every
    query of up to `MAX_VARS`; wider queries (on the CPU, those above 10)
    take the host bigint path.
    ``members`` may supply precomputed cone membership rows aligned with
    ``items`` (callers that already ran an MFFC sweep have them);
    otherwise membership is derived here with the same descending scan.
    """
    _check_engine(engine)
    dev = resolve_device(device)
    if not items:
        return []
    prog = program if program is not None else compile_aig(aig)
    max_vars = DEVICE_MAX_VARS[dev.type]
    results: list[tuple[int, ...] | None] = [None] * len(items)
    tiers: dict[int, list[int]] = {}
    for idx, (roots, support) in enumerate(items):
        k = len(support)
        if k > max_vars:
            sup = list(support)
            results[idx] = tuple(aig.truth_table(rl, sup) for rl in roots)
        else:
            _, w = _tier_for(k)
            tiers.setdefault(w, []).append(idx)
    for w, idxs in tiers.items():
        if members is not None:
            mem = members[np.asarray(idxs, dtype=np.int64)]
        else:
            mem = _cone_members(aig, items, idxs)
        _eval_mega_tier(aig, prog, items, idxs, w, mem, results, dev)
    return results  # type: ignore[return-value]


def eval_tt(
    aig: Aig,
    root_lit: int,
    support: Sequence[int],
    engine: str = "auto",
    program: AigProgram | None = None,
    device: "str | torch.device | None" = None,
) -> int:
    """Single-query convenience wrapper around `eval_tts`."""
    return eval_tts(
        aig, [((root_lit,), list(support))], engine, program, device=device
    )[0][0]


def node_signatures(
    aig: Aig,
    patterns: np.ndarray,
    engine: str = "auto",
    program: AigProgram | None = None,
    device: "str | torch.device | None" = None,
) -> np.ndarray:
    """Per-node random-simulation signatures through `sig_eval`.

    ``patterns``: (n_pis, n_words) uint64.  Returns (n_nodes, n_words)
    uint64, bit-identical to ``transforms._node_signatures`` (the uint64
    words are simulated as pairs of uint32 lanes).  The whole graph is
    one chunk; K1 splits it over word-column slices.
    """
    _check_engine(engine)
    dev = resolve_device(device)
    prog = program if program is not None else compile_aig(aig)
    patterns = np.asarray(patterns, dtype=np.uint64)
    n_words = patterns.shape[1]
    vals0 = np.zeros((prog.n_pad, 2 * n_words), dtype=np.uint32)
    vals0[1 : 1 + prog.n_pis] = patterns.view("<u4")
    meta = np.array([[0, len(prog.waves), 0, prog.n_pad]], dtype=np.int32)
    _check_chunks(prog.waves, meta, prog.n_pad, prog.n_pad)
    with build.device_faults("sig_eval", dev):
        waves, v0, meta_t = upload(dev, prog.waves, vals0.view(np.int32), meta)
        out = sig_eval(waves, v0, meta_t, prog.n_pad).cpu().numpy()
    return np.ascontiguousarray(out[: prog.n_nodes]).view("<u8")
