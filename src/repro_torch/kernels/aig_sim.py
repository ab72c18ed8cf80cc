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
    word-tier's queries are assembled into chunked **mega-programs**:
    every query's cone is laid out in a shared flat row space (row 0 =
    const0, then per query its support rows — pinned to elementary truth
    tables, exactly `Aig.truth_table`'s semantics — followed by its cone
    rows), and the concatenated instructions are wave-packed by global
    AIG level.  Device work is therefore proportional to the *useful*
    cone work, not batch x whole-graph.
  * `node_signatures` runs the whole-graph wave stream over random
    uint64 pattern words (viewed as uint32 lanes) — bit-identical to
    ``transforms._node_signatures``.

Both evaluations go through `eval_mega` / `sig_eval`: on a CUDA tensor
they launch the hand-written kernel K1 (``csrc/aig_sim.cu``), on a CPU
tensor they run the plain torch version beside it (`eval_mega_plain` /
`sig_eval_plain`: a loop over waves, vectorized within each wave).
Planes travel as int32 in torch (torch's CPU build lacks ``~``/``>>``
for uint32); uint32 lanes are reinterpreted with numpy ``.view`` at the
host boundary.  ``LAUNCHES`` counts kernel launches per entry point.

Shape discipline: queries bucket into word tiers (k <= 5 / 10 / 14
support vars -> 1 / 32 / 512 uint32 words); mega-program chunks are
bounded by a per-tier instruction budget.  Queries wider than
`DEVICE_MAX_VARS` take the host bigint path — at 512 words per table
CPython's limb loops already run at memory speed.  The W=512 tier stays
in the kernel's contract (``_MEGA_WAVE`` / ``_MEGA_BUDGET`` carry it)
for callers that pack such chunks directly.
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

# (max vars, uint32 words) shape tiers for truth-table queries.  A query
# with k support vars lands in the smallest tier with 32 * words >= 2**k;
# its table occupies the low 2**k bits and the host masks the rest off.
_TIERS: tuple[tuple[int, int], ...] = ((5, 1), (10, 32), (14, 512))

#: Mega-program shape knobs per word tier: instructions per wave and the
#: per-chunk instruction budget.  Wider waves amortize the per-wave
#: barrier; the budget bounds the row-space scratch.  ``eval_tts`` never
#: packs the 512-word tier (see `DEVICE_MAX_VARS`); its entry serves
#: direct callers of `_eval_mega_tier` that check the kernel at W=512.
_MEGA_WAVE = {1: 1024, 32: 256, 512: 16}
_MEGA_BUDGET = {1: 1 << 17, 32: 1 << 14, 512: 1 << 10}
#: Queries with more support vars than this take the host bigint path:
#: at 512 words per table, CPython's big-int AND/XOR (a C loop over
#: limbs) is already at memory speed and the device round trip cannot win.
DEVICE_MAX_VARS = 10

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


def eval_mega_plain(waves, pin_rows, elem, rootp) -> torch.Tensor:
    """Plain torch version of K1's ``eval_mega`` contract.

    waves (L,M,4) i32 over a flat row space; pin_rows (N,) i32
    var-index-or--1; elem (K,W) i32; rootp (Q,) i32 packs each root
    query as ``row << 1 | phase``.  Returns (Q,W) i32.  Support rows
    hold elementary tables and are never written (cone membership
    excludes pinned nodes), so each step is gather-AND-scatter.
    """
    k = elem.shape[0]
    vals = torch.where(
        (pin_rows >= 0)[:, None],
        elem[pin_rows.clamp(0, k - 1).long()],
        torch.zeros((), dtype=torch.int32, device=elem.device),
    )
    for ins in waves:
        _wave_step(vals, ins)
    phase = -(rootp & 1)
    return vals[(rootp >> 1).long()] ^ phase[:, None]


def sig_eval_plain(waves, vals0) -> torch.Tensor:
    """Plain torch version of K1's ``sig_eval`` contract: waves (L,M,4)
    i32; vals0 (N,W) i32 with PI rows pre-placed -> (N,W) i32."""
    vals = vals0.clone()
    for ins in waves:
        _wave_step(vals, ins)
    return vals


def _check(t: torch.Tensor, name: str, ndim: int, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_rows(a: np.ndarray, n_rows: int, name: str) -> None:
    """Row indices the kernel dereferences must lie in [0, n_rows).

    Checked on the host arrays before they are uploaded: on CUDA tensors
    the check would cost a device sync per operand on every launch."""
    if a.size and (int(a.min()) < 0 or int(a.max()) >= n_rows):
        raise ValueError(f"{name} holds a row index outside [0, {n_rows})")


def _check_mega_rows(waves: np.ndarray, n_rows: int, rootp: np.ndarray) -> None:
    _check_rows(waves[..., 1:], n_rows, "waves")
    _check_rows(rootp >> 1, n_rows, "rootp")


def _p(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


@functools.lru_cache(maxsize=None)
def _k1():
    lib = build.load("aig_sim")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.k1_eval_mega.argtypes = [vp, ci, ci, vp, ci, vp, ci, ci, vp, ci, vp, vp, vp]
    lib.k1_eval_mega.restype = ci
    lib.k1_sig_eval.argtypes = [vp, ci, ci, vp, ci, ci, vp, vp]
    lib.k1_sig_eval.restype = ci
    return lib


def eval_mega(waves, pin_rows, elem, rootp) -> torch.Tensor:
    """K1 ``eval_mega``: launches the CUDA kernel for CUDA tensors, runs
    `eval_mega_plain` for CPU tensors (same contract).

    The launch path holds no device sync: on CUDA tensors the row indices
    are the caller's to check (`_check_mega_rows` on the host arrays
    before upload, as `_eval_mega_tier` does); on CPU tensors the wrapper
    checks them itself."""
    dev = waves.device
    if dev.type == "cpu":
        _check_mega_rows(waves.numpy(), pin_rows.shape[0], rootp.numpy())
        return eval_mega_plain(waves, pin_rows, elem, rootp)
    if dev.type != "cuda":
        raise ValueError(f"eval_mega: unsupported device {dev}")
    _check(waves, "waves", 3, dev)
    _check(pin_rows, "pin_rows", 1, dev)
    _check(elem, "elem", 2, dev)
    _check(rootp, "rootp", 1, dev)
    if waves.shape[2] != 4:
        raise ValueError(f"waves must be (L, M, 4), got {tuple(waves.shape)}")
    n_waves, wave_m = waves.shape[0], waves.shape[1]
    k, w = elem.shape
    n_rows, n_q = pin_rows.shape[0], rootp.shape[0]
    scratch = torch.empty((n_rows, w), dtype=torch.int32, device=dev)
    out = torch.empty((n_q, w), dtype=torch.int32, device=dev)
    rc = _k1().k1_eval_mega(
        _p(waves), n_waves, wave_m, _p(pin_rows), n_rows, _p(elem), k, w,
        _p(rootp), n_q, _p(scratch), _p(out), _stream(),
    )
    build.check(rc, "k1_eval_mega")
    LAUNCHES["eval_mega"] += 1
    return out


def sig_eval(waves, vals0) -> torch.Tensor:
    """K1 ``sig_eval``: launches the CUDA kernel for CUDA tensors, runs
    `sig_eval_plain` for CPU tensors (same contract).  Row indices are
    checked as in `eval_mega`: by the caller on CUDA, here on the CPU."""
    dev = waves.device
    if dev.type == "cpu":
        _check_rows(waves.numpy()[..., 1:], vals0.shape[0], "waves")
        return sig_eval_plain(waves, vals0)
    if dev.type != "cuda":
        raise ValueError(f"sig_eval: unsupported device {dev}")
    _check(waves, "waves", 3, dev)
    _check(vals0, "vals0", 2, dev)
    if waves.shape[2] != 4:
        raise ValueError(f"waves must be (L, M, 4), got {tuple(waves.shape)}")
    n_rows, w = vals0.shape
    out = torch.empty((n_rows, w), dtype=torch.int32, device=dev)
    rc = _k1().k1_sig_eval(
        _p(waves), waves.shape[0], waves.shape[1], _p(vals0), n_rows, w,
        _p(out), _stream(),
    )
    build.check(rc, "k1_sig_eval")
    LAUNCHES["sig_eval"] += 1
    return out


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
class MegaChunk:
    """One packed mega-program: the operands of `eval_mega` (numpy, host)
    plus what the host needs to unpack its rows."""

    waves: np.ndarray  # (L, M, 4) int32
    pin_rows: np.ndarray  # (N,) int32
    rootp: np.ndarray  # (Q_pad,) int32
    positions: list[int]  # chunk entries: positions into the tier's idxs
    qoff: np.ndarray  # (n_items + 1,) root-row offset of each item


def _pack_mega_chunks(
    aig: Aig,
    prog: AigProgram,
    items: Sequence[tuple[Sequence[int], Sequence[int]]],
    idxs: list[int],
    w: int,
    mem: np.ndarray,
) -> list[MegaChunk]:
    """Pack one word tier's queries into budget-bounded mega-programs.

    Each chunk concatenates the per-query cone programs into one flat
    row space (row 0 = const0, then per query: k support rows pinned to
    elementary tables followed by its cone rows in topo order).
    Instructions are wave-packed by global AIG level (fanins always have
    strictly smaller levels, and cross-query instructions are
    independent), which keeps waves dense.
    """
    f0 = np.asarray(aig._f0, dtype=np.int64)
    f1 = np.asarray(aig._f1, dtype=np.int64)
    sizes = mem.sum(axis=1).astype(np.int64)
    budget = _MEGA_BUDGET[w]
    wave_m = _MEGA_WAVE[w]

    chunks: list[list[int]] = []
    cur: list[int] = []
    acc = 0
    for pos in range(len(idxs)):
        s = int(sizes[pos])
        if cur and acc + s > budget:
            chunks.append(cur)
            cur, acc = [], 0
        cur.append(pos)
        acc += s
    if cur:
        chunks.append(cur)

    packed: list[MegaChunk] = []
    for chunk in chunks:
        if len(chunk) == len(idxs):
            cm, counts = mem, sizes
        else:
            sel = np.asarray(chunk, dtype=np.int64)
            cm, counts = mem[sel], sizes[sel]
        it = [items[idxs[p]] for p in chunk]
        k_b = np.array([len(s) for _, s in it], dtype=np.int64)
        r_b = np.array([len(r) for r, _ in it], dtype=np.int64)
        row_base = 1 + np.concatenate(([0], np.cumsum(k_b + counts)[:-1]))
        n_rows = int(1 + (k_b + counts).sum())
        n_rows_pad = _next_pow2(n_rows + 1, floor=10)
        # Support rows: pinned to elementary tables via the pin map.
        tot_k = int(k_b.sum())
        sup_nodes = np.fromiter(
            itertools.chain.from_iterable(s for _, s in it),
            dtype=np.int64,
            count=tot_k,
        )
        item_of_sup = np.repeat(np.arange(len(it)), k_b)
        koff = np.concatenate(([0], np.cumsum(k_b)[:-1]))
        var_idx = np.arange(tot_k) - np.repeat(koff, k_b)
        sup_rows = row_base[item_of_sup] + var_idx
        pin_rows = np.full(n_rows_pad, -1, dtype=np.int32)
        pin_rows[sup_rows] = var_idx
        # node -> row per query; unmapped nodes fall through to row 0
        # (const0) — the python path would raise on such a read, and no
        # caller produces one (cones are closed over their supports).
        rowmap = np.zeros((len(it), aig.n_nodes), dtype=np.int32)
        rowmap[item_of_sup, sup_nodes] = sup_rows
        b_idx, node_idx = np.nonzero(cm)
        n_waves = 0
        if len(b_idx):
            starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
            local = np.arange(len(b_idx)) - np.repeat(starts, counts)
            cone_rows = row_base[b_idx] + k_b[b_idx] + local
            rowmap[b_idx, node_idx] = cone_rows
            f0n = f0[node_idx]
            f1n = f1[node_idx]
            kind = (f0n & 1) | ((f1n & 1) << 1)
            a_row = rowmap[b_idx, f0n >> 1]
            b_row = rowmap[b_idx, f1n >> 1]
            instr = np.stack([kind, a_row, b_row, cone_rows], axis=1).astype(
                np.int32
            )
            # Wave-pack by global level, chopping each level into
            # wave_m-wide groups (same-level instrs never depend).
            lvn = prog.lv[node_idx]
            order = np.argsort(lvn, kind="stable")
            slv = lvn[order]
            lstarts = np.searchsorted(slv, slv, side="left")
            pos_in_lv = np.arange(len(order)) - lstarts
            # (level, sub-group) keys are non-decreasing in `order`, so
            # consecutive-difference cumsum numbers the waves directly.
            key = slv * (len(order) + 1) + pos_in_lv // wave_m
            wid = np.concatenate(([0], np.cumsum(np.diff(key) > 0)))
            n_waves = int(wid[-1]) + 1
        n_waves_pad = _next_pow2(n_waves + 1, floor=2)
        waves = np.zeros((n_waves_pad, wave_m, 4), dtype=np.int32)
        waves[:, :, 3] = n_rows_pad - 1  # no-op padding: scratch row <- 0
        if len(b_idx):
            waves[wid, pos_in_lv % wave_m] = instr[order]
        # Root queries: one output row per root literal.
        q_item = np.repeat(np.arange(len(it)), r_b)
        root_lits = np.fromiter(
            itertools.chain.from_iterable(r for r, _ in it),
            dtype=np.int64,
            count=int(r_b.sum()),
        )
        root_rows = rowmap[q_item, root_lits >> 1]
        n_q = len(root_lits)
        n_q_pad = _next_pow2(n_q, floor=6)
        rootp = np.zeros(n_q_pad, dtype=np.int32)
        rootp[:n_q] = (root_rows.astype(np.int64) << 1) | (root_lits & 1)
        packed.append(
            MegaChunk(
                waves=waves,
                pin_rows=pin_rows,
                rootp=rootp,
                positions=chunk,
                qoff=np.concatenate(([0], np.cumsum(r_b))),
            )
        )
    return packed


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
    """Run one word tier's queries as mega-programs through `eval_mega`
    on ``device`` and unpack each query's truth tables into ``results``."""
    k_max = next(km for km, tw in _TIERS if tw == w)
    for ch in _pack_mega_chunks(aig, prog, items, idxs, w, mem):
        _check_mega_rows(ch.waves, len(ch.pin_rows), ch.rootp)
        with build.device_faults("eval_mega", device):
            out = eval_mega(
                torch.from_numpy(ch.waves).to(device),
                torch.from_numpy(ch.pin_rows).to(device),
                _dev_elem(k_max, device),
                torch.from_numpy(ch.rootp).to(device),
            ).cpu().numpy().view(np.uint32)
        n_q = int(ch.qoff[-1])
        if w == 1:
            flat = out[:n_q, 0].tolist()
            for bi, p in enumerate(ch.positions):
                idx = idxs[p]
                roots, support = items[idx]
                mask = (1 << (1 << len(support))) - 1
                base = int(ch.qoff[bi])
                results[idx] = tuple(
                    flat[base + ri] & mask for ri in range(len(roots))
                )
        else:
            buf = np.ascontiguousarray(out[:n_q]).tobytes()
            nb = w * 4
            for bi, p in enumerate(ch.positions):
                idx = idxs[p]
                roots, support = items[idx]
                mask = (1 << (1 << len(support))) - 1
                base = int(ch.qoff[bi])
                results[idx] = tuple(
                    int.from_bytes(
                        buf[(base + ri) * nb : (base + ri + 1) * nb], "little"
                    )
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

    Queries with <= `DEVICE_MAX_VARS` support vars are bucketed by word
    tier and evaluated as chunked *mega-programs* (see
    `_pack_mega_chunks`) on ``device`` (default ``cuda``; raises without
    a card); wider queries take the host bigint path.  ``members`` may
    supply precomputed cone membership rows aligned with ``items``
    (callers that already ran an MFFC sweep have them); otherwise
    membership is derived here with the same descending scan.
    """
    _check_engine(engine)
    dev = resolve_device(device)
    if not items:
        return []
    prog = program if program is not None else compile_aig(aig)
    results: list[tuple[int, ...] | None] = [None] * len(items)
    tiers: dict[int, list[int]] = {}
    for idx, (roots, support) in enumerate(items):
        k = len(support)
        if k > DEVICE_MAX_VARS:
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
    words are simulated as pairs of uint32 lanes).
    """
    _check_engine(engine)
    dev = resolve_device(device)
    prog = program if program is not None else compile_aig(aig)
    patterns = np.asarray(patterns, dtype=np.uint64)
    n_words = patterns.shape[1]
    vals0 = np.zeros((prog.n_pad, 2 * n_words), dtype=np.uint32)
    vals0[1 : 1 + prog.n_pis] = patterns.view("<u4")
    _check_rows(prog.waves[..., 1:], prog.n_pad, "waves")
    with build.device_faults("sig_eval", dev):
        out = sig_eval(
            torch.from_numpy(prog.waves).to(dev),
            torch.from_numpy(vals0.view(np.int32)).to(dev),
        ).cpu().numpy()
    return np.ascontiguousarray(out[: prog.n_nodes]).view("<u8")
