#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Usage (from the repository root, on a machine with one CUDA card and
``nvcc``)::

    python3 chip_smoke.py

It builds both hand-written kernels from ``src/repro_torch/kernels/csrc``
and then runs these phases, failing (non-zero exit) on any error:

1. K1 (``aig_sim.eval_mega`` / ``aig_sim.sig_eval``) against its plain
   torch version on the card, on the default-scale ``square`` circuit:
   rewrite- and refactor-shaped queries (the W=1 and W=32 tiers), a
   k = 11..14 set (the W=512 tier) and whole-graph signatures, each
   packed as ``eval_tts`` packs it (one launch per word tier).  Both row
   spaces, shared memory (as the main path runs it) and global memory,
   must be bit-equal to the plain version; a sample must match
   python-int ``Aig.truth_table``.  Times per launch, per query and the
   blocks per launch are printed.
2. The main path, with every kernel launch count set to 0 first:
   ``characterize_suite`` over the default 9-circuit suite (front half,
   through K1, every tier on the card: no host ``Aig.truth_table`` call
   and at least one W=512 launch), the fused torch back half
   (``explore_suite``) and the end check -- each winner lowered to a gate
   netlist and run through K2 (``ops.cim_evaluate``) at 2**16 test
   vectors, the adder's sums and carries checked against integer
   arithmetic.  Winners must equal the scalar ``backend="python"`` back
   half on the same characterization; the device-backend ``AigStats`` of
   ``adder`` and ``log2`` must equal the python backend's.
3. A 1024-variant Monte-Carlo sweep of the back half; its winners must
   equal the ``fused=False`` host-selection path.
4. K2 against its plain torch version on the card, per winner netlist,
   with its register file in shared memory (as the main path runs it)
   and forced into global memory.

Kernel times are device times of back-to-back launches; ``bound_ms``
counts each byte a call must move once, over the card's HBM rate.

It prints the card (``nvidia-smi --query-gpu=name,power.limit``), the
build seconds, per-phase times, a ``{"kernels": [...]}`` JSON line and,
last, ``{"ok": true, "device": {...}}``.  It exits non-zero without a
CUDA device and when ``src/repro_torch`` is not beside it.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
#: Peak HBM bandwidth of one H100 SXM (NVIDIA data sheet), bytes/s.
HBM_BYTES_PER_S = 3.35e12
N_VECTORS = 1 << 16
MC_VARIANTS = 1024
K1_SAMPLE = 300  # queries per tier checked against Aig.truth_table
W512_QUERIES = 256


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


_SPIN_CYCLES_PER_MS: list[float] = []


def spin_cycles_per_ms() -> float:
    """Clock cycles per millisecond of ``torch.cuda._sleep``, measured once."""
    import torch

    if not _SPIN_CYCLES_PER_MS:
        n = 10_000_000
        torch.cuda._sleep(n)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(n)
        end.record()
        end.synchronize()
        _SPIN_CYCLES_PER_MS.append(n / start.elapsed_time(end))
    return _SPIN_CYCLES_PER_MS[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` back-to-back calls
    (CUDA events, one warm-up).  A spin kernel holds the stream while the
    host enqueues every call, so the events time the launches on the card
    and not the host's rate of enqueueing them."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(spin_cycles_per_ms() * (2 * host_ms * reps + 5)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def mega_bytes(batch, k_max: int, w: int) -> int:
    """Bytes one ``eval_mega`` launch must move, each once: its real
    instructions (padding slots left out), the chunk table, the pin map
    over the rows in use (each chunk's const0 row, its pinned support
    rows and its cone rows), the elementary tables, the root queries and
    their (n_q, W) output."""
    import numpy as np

    meta = batch.meta
    scratch = np.repeat(meta[:, 3] - 1, meta[:, 1])  # each wave's padding row
    n_instr = int((batch.waves[..., 3] != scratch[:, None]).sum())
    n_rows = len(meta) + n_instr + int((batch.pin_rows >= 0).sum())
    n_q = len(batch.rootp)
    return 4 * (4 * n_instr + 6 * len(meta) + n_rows + k_max * w + n_q + n_q * w)


#: Largest |kernel - plain| seen per kernel over every comparison made.
MAX_ERR = {"eval_mega": 0, "sig_eval": 0, "cim": 0}


def same(key: str, got, want, msg: str) -> None:
    """Hold a kernel's int32 output against its plain version: record the
    largest absolute difference and require bit equality."""
    check(got.shape == want.shape, f"{msg}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    MAX_ERR[key] = max(MAX_ERR[key], err)
    check(err == 0, f"{msg}: max |kernel - plain| = {err}")


@contextlib.contextmanager
def spans(device_fns, host_fns):
    """Time the main path's layers without changing what it runs: CUDA
    events around each kernel wrapper in ``device_fns`` and host clocks
    around each entry point in ``host_fns`` (``(module, name)`` pairs).
    Yields ``{name: [(start, end) events] or [seconds]}``."""
    import torch

    got: dict[str, list] = {}
    saved = []

    def on_device(name, fn):
        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            got.setdefault(name, []).append((start, end))
            return out

        return timed

    def on_host(name, fn):
        def timed(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                got.setdefault(name, []).append(time.perf_counter() - t)

        return timed

    for fns, wrap in ((device_fns, on_device), (host_fns, on_host)):
        for mod, name in fns:
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, wrap(name, getattr(mod, name)))
    try:
        yield got
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def device_s(events) -> float:
    """Summed seconds of (start, end) CUDA event pairs."""
    import torch

    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / 1e3


# ---------------------------------------------------------------------------
# Phase 1: K1 against its plain version
# ---------------------------------------------------------------------------


def k1_query_sets(aig):
    """Query sets shaped as the device transforms build them: rewrite
    (k <= 4 cuts, `_rewrite_device`), refactor (reconvergence cuts of up
    to 10 leaves, `_refactor_device`) and a wide k = 11..14 set."""
    from repro_torch.core import transforms as T
    from repro_torch.core.aig import lit

    reach = T._reachable(aig)
    cuts = T._enumerate_cuts(aig, k=4, max_cuts=8)
    ands = [n for n in range(aig.n_pis + 1, aig.n_nodes) if reach[n]]
    rewrite = [
        ((lit(n),), sorted(cut))
        for n in ands
        for cut in cuts[n]
        if len(cut) >= 2 and n not in cut
    ]
    fanout, lv = aig.fanout_counts(), aig.levels()
    refactor = []
    for n in ands:
        if fanout[n] < 2 and lv[n] % 3 != 0:
            continue
        leaves = T._reconv_cut(aig, n, 10)
        if 3 <= len(leaves) <= 12 and n not in leaves:
            refactor.append(((lit(n),), list(leaves)))
    wide = []
    for n in reversed(ands):
        leaves = T._reconv_cut(aig, n, 14)
        if 11 <= len(leaves) <= 14 and n not in leaves:
            wide.append(((lit(n), lit(n, 1)), list(leaves)))
            if len(wide) == W512_QUERIES:
                break
    return {"rewrite": rewrite, "refactor": refactor, "wide": wide}


def k1_batches(aig, prog, items):
    """``{w: (idxs, MegaBatch)}`` for ``items``, grouped by word tier and
    packed exactly as `aig_sim.eval_tts` packs them on the card (one
    launch per tier)."""
    from repro_torch.kernels import aig_sim as A

    tiers: dict[int, list[int]] = {}
    for i, (_, sup) in enumerate(items):
        tiers.setdefault(A._tier_for(len(sup))[1], []).append(i)
    out = {}
    for w, idxs in sorted(tiers.items()):
        mem = A._cone_members(aig, items, idxs)
        out[w] = (idxs, A._pack_mega(aig, prog, items, idxs, w, mem))
    return out


@contextlib.contextmanager
def global_memory(mod):
    """Make a kernel wrapper of ``mod`` (`aig_sim` or `cim_logic`) take
    its global-memory variant: no launch fits ``MAX_SHARED_BYTES = 0``."""
    saved, mod.MAX_SHARED_BYTES = mod.MAX_SHARED_BYTES, 0
    try:
        yield
    finally:
        mod.MAX_SHARED_BYTES = saved


def phase_k1(dev, rng):
    import numpy as np
    from repro_torch.core import circuits as C
    from repro_torch.core import transforms as T
    from repro_torch.kernels import aig_sim as A

    aig = C.benchmark_suite("default", only=["square"])["square"]
    prog = A.compile_aig(aig)
    sets = k1_query_sets(aig)
    print(
        f"K1 circuit square: {aig.n_ands} ANDs; queries "
        + ", ".join(f"{k}={len(v)}" for k, v in sets.items())
    )
    launches = []
    for name, items in sets.items():
        for w, (idxs, batch) in k1_batches(aig, prog, items).items():
            k_max = next(km for km, tw in A._TIERS if tw == w)
            A._check_chunks(
                batch.waves, batch.meta, len(batch.pin_rows), batch.max_rows, batch.rootp
            )
            ops = batch.operands(dev, A._dev_elem(k_max, dev))
            got = A.eval_mega(*ops)
            want = A.eval_mega_plain(*ops[:5])
            same("eval_mega", got, want, f"K1 eval_mega ({name}, W={w})")
            with global_memory(A):
                same("eval_mega", A.eval_mega(*ops), want,
                     f"K1 eval_mega, global row space ({name}, W={w})")
            # sample against the python-int reference
            out = got.cpu().numpy().view(np.uint32)
            checked = min(K1_SAMPLE, len(idxs))
            for pos in range(checked):
                roots, sup = items[idxs[pos]]
                mask = (1 << (1 << len(sup))) - 1
                for ri, rl in enumerate(roots):
                    row = out[int(batch.qoff[pos]) + ri]
                    tt = int.from_bytes(row.tobytes(), "little") & mask
                    check(
                        tt == aig.truth_table(rl, sup),
                        f"K1 truth table mismatch ({name}, W={w})",
                    )
            blocks = len(batch.meta) * -(-w // batch.cw)
            launches.append(
                dict(name=name, w=w, queries=len(idxs), blocks=blocks, ops=ops,
                     bytes=mega_bytes(batch, k_max, w))
            )
            print(
                f"  {name} W={w}: {len(idxs)} queries, {len(batch.meta)} chunks x "
                f"{-(-w // batch.cw)} column slices = {blocks} blocks (wave width "
                f"{batch.waves.shape[1]}, at most {int(batch.meta[:, 1].max())} waves "
                f"and {batch.max_rows} rows a chunk); shared and global row space "
                f"bit-equal to plain, {checked} checked against truth_table"
            )

    # Signatures: the whole-graph wave stream, as `_resub_device` runs it.
    patterns = rng.integers(0, 1 << 63, size=(aig.n_pis, 32), dtype=np.int64).astype(
        np.uint64
    )
    sig = A.node_signatures(aig, patterns, device=dev)
    check(
        np.array_equal(sig, T._node_signatures(aig, patterns)),
        "K1 node_signatures != transforms._node_signatures",
    )
    vals0 = np.zeros((prog.n_pad, 64), dtype=np.uint32)
    vals0[1 : 1 + prog.n_pis] = patterns.view("<u4")
    meta = np.array([[0, len(prog.waves), 0, prog.n_pad]], dtype=np.int32)
    sig_ops = (*A.upload(dev, prog.waves, vals0.view(np.int32), meta), prog.n_pad)
    sig_want = A.sig_eval_plain(*sig_ops[:3])
    same("sig_eval", A.sig_eval(*sig_ops), sig_want, "K1 sig_eval")
    with global_memory(A):
        same("sig_eval", A.sig_eval(*sig_ops), sig_want, "K1 sig_eval, global row space")
    sig_cw, _ = A._sig_cw(prog.waves.shape[1], prog.n_pad)
    sig_blocks = -(-64 // sig_cw)
    print(
        f"  signatures: {sig_blocks} blocks ({sig_cw}-word column slices); shared and "
        "global row space bit-equal to plain and to transforms._node_signatures"
    )

    # Times: device ms per launch (CUDA events), per query and per block.
    for ln in launches:
        ops = ln["ops"]
        ln["ms"] = cuda_ms(lambda: A.eval_mega(*ops), 20)
        with global_memory(A):
            ln["global_ms"] = cuda_ms(lambda: A.eval_mega(*ops), 20)
        ln["plain_ms"] = cuda_ms(lambda: A.eval_mega_plain(*ops[:5]), 1)
        print(
            f"  eval_mega {ln['name']} W={ln['w']}: {ln['ms']:.4f} ms/launch "
            f"({1e3 * ln['ms'] / ln['queries']:.4f} us/query, {ln['blocks']} blocks); "
            f"global row space {ln['global_ms']:.4f} ms; plain {ln['plain_ms']:.3f} ms; "
            f"bound {ln['bytes'] / HBM_BYTES_PER_S * 1e3:.6f} ms"
        )
    n = len(launches)
    mega = {k: sum(ln[k] for ln in launches) / n for k in ("ms", "plain_ms", "bytes")}
    sig_ms = cuda_ms(lambda: A.sig_eval(*sig_ops), 20)
    with global_memory(A):
        sig_global = cuda_ms(lambda: A.sig_eval(*sig_ops), 20)
    sig_plain = cuda_ms(lambda: A.sig_eval_plain(*sig_ops[:3]), 3)
    # the AND instructions (padding slots left out), vals0 in, vals out
    sig_bytes = 16 * aig.n_ands + 2 * nbytes(sig_ops[1])
    print(
        f"  eval_mega: {n} main-path-shaped launches, mean {mega['ms']:.4f} ms/launch "
        f"(plain {mega['plain_ms']:.3f} ms); sig_eval {sig_ms:.4f} ms on "
        f"{sig_blocks} blocks (global row space {sig_global:.4f} ms; plain "
        f"{sig_plain:.3f} ms)"
    )
    return {
        "eval_mega": mega,
        "sig_eval": dict(ms=sig_ms, plain_ms=sig_plain, bytes=sig_bytes),
    }


# ---------------------------------------------------------------------------
# Phase 2: the main path
# ---------------------------------------------------------------------------


def adder_bits(rng, width: int):
    """(2*width, N_VECTORS) operand bits and the expected (width+1, N)
    sum + carry bits, by ripple-carry over numpy bit columns."""
    import numpy as np

    a = rng.integers(0, 2, size=(width, N_VECTORS), dtype=np.uint8)
    b = rng.integers(0, 2, size=(width, N_VECTORS), dtype=np.uint8)
    out = np.zeros((width + 1, N_VECTORS), dtype=np.uint8)
    c = np.zeros(N_VECTORS, dtype=np.uint8)
    for i in range(width):
        out[i] = a[i] ^ b[i] ^ c
        c = (a[i] & b[i]) | (c & (a[i] ^ b[i]))
    out[width] = c
    return np.concatenate([a, b]), out


@contextlib.contextmanager
def wide_queries(A, suite):
    """Count the W=512-tier (k = 11..14) queries `aig_sim.eval_tts` is
    given, per circuit of ``suite``.  Yields ``{circuit: count}``."""
    names = {rtl.name: key for key, rtl in suite.items()}
    counts = {key: 0 for key in suite}
    real = A.eval_tts

    def counting(aig, items, *args, **kw):
        n = sum(1 for _, sup in items if A._TIERS[1][0] < len(sup) <= A.MAX_VARS)
        key = names.get(aig.name, aig.name)
        counts[key] = counts.get(key, 0) + n
        return real(aig, items, *args, **kw)

    A.eval_tts = counting
    try:
        yield counts
    finally:
        A.eval_tts = real


def phase_main(dev, rng):
    import numpy as np
    import torch
    from repro_torch.core import circuits as C
    from repro_torch.core.aig import Aig
    from repro_torch.core.explorer import explore_suite
    from repro_torch.core.transforms import RecipeRunner, characterize_suite
    from repro_torch.kernels import aig_sim as A
    from repro_torch.kernels import cim_logic as K
    from repro_torch.kernels import ops

    suite = C.benchmark_suite("default")
    for d in (A.LAUNCHES, A.TIER_LAUNCHES, K.LAUNCHES):
        for k in d:
            d[k] = 0
    t0 = time.time()
    # Aig.truth_table runs in the front half only as eval_tts's host path
    # for supports wider than the device takes: none on the card.
    host_fns = [(A, "eval_tts"), (A, "node_signatures"), (A, "_cone_members"),
                (A, "_pack_mega"), (Aig, "truth_table")]
    with wide_queries(A, suite) as wide, spans(
        [(A, "eval_mega"), (A, "sig_eval")], host_fns
    ) as front:
        cha = characterize_suite(suite, backend="device", device=dev)
    t1 = time.time()
    res = explore_suite(suite, cha=cha, device=dev)
    torch.cuda.synchronize()
    t2 = time.time()
    netlists, vectors, k2_s = {}, {}, 0.0
    for name, r in res.items():
        best_aig = RecipeRunner(suite[name], backend="device", device=dev).run(
            r.best.recipe
        )
        net = best_aig.to_gate_netlist()
        if name == "adder":
            bits, want = adder_bits(rng, best_aig.n_pis // 2)
        else:
            bits = rng.integers(0, 2, size=(best_aig.n_pis, N_VECTORS), dtype=np.uint8)
            want = None
        with spans([(ops, "cim_call")], []) as end_check:
            out = ops.cim_evaluate(net, bits, device=dev)
        k2_s += device_s(end_check["cim_call"])
        check(out.shape == (len(best_aig.pos), N_VECTORS), f"K2 output shape for {name}")
        if want is not None:
            check(np.array_equal(out, want), "adder winner: wrong sums/carries on K2")
        netlists[name], vectors[name] = net, bits
    torch.cuda.synchronize()
    t3 = time.time()
    launches = {**A.LAUNCHES, **K.LAUNCHES}
    print(
        f"main path: front half {t1 - t0:.3f} s, back half {t2 - t1:.3f} s, "
        f"end check {t3 - t2:.3f} s; launches {launches}; eval_mega launches per "
        f"word tier {A.TIER_LAUNCHES}"
    )
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched on the main path")
    print("wide-tier (k = 11..14) queries per circuit on the main path: " + json.dumps(wide))
    check(A.TIER_LAUNCHES[512] > 0, "no W=512 eval_mega launch on the main path")
    n_tt = len(front.get("truth_table", []))
    check(n_tt == 0, f"{n_tt} host Aig.truth_table calls on the card's main path")
    k1 = {k: device_s(front.get(k, [])) for k in ("eval_mega", "sig_eval")}
    k1_s = sum(k1.values())
    host = {name: sum(front.get(name, [])) for _, name in host_fns}
    sim_s = host["eval_tts"] + host["node_signatures"]
    rest_s = sim_s - k1_s - host["_cone_members"] - host["_pack_mega"]
    rest_s -= host["truth_table"]
    front_s = t1 - t0
    print(
        f"front half layers: K1 {k1_s:.4f} s on the card (events around each "
        f"wrapper call: kernel plus its enqueue; eval_mega "
        f"{k1['eval_mega']:.4f} s, sig_eval {k1['sig_eval']:.4f} s); inside the "
        f"aig_sim entry points ({sim_s:.3f} s): cone membership "
        f"{host['_cone_members']:.3f} s, chunk packing "
        f"{host['_pack_mega']:.3f} s, host truth tables {host['truth_table']:.3f} s "
        f"({n_tt} calls), copies/syncs/unpacking {rest_s:.3f} s; transforms host "
        f"code {front_s - sim_s:.3f} s; K1 busy share {k1_s / front_s:.6f}"
    )
    print(f"end check: K2 {k2_s:.4f} s on the card of {t3 - t2:.3f} s")
    print(f"adder winner on K2: sums and carries correct for {N_VECTORS} random operands")
    for name, r in res.items():
        print("  table-I", json.dumps(r.table_row()))

    # Winners against the scalar python back half on the same cha.
    ref = explore_suite(suite, cha=cha, backend="python", device=dev)
    for name in suite:
        a, b = res[name].best, ref[name].best
        check(
            (a.recipe, a.topo) == (b.recipe, b.topo),
            f"{name}: torch winner {a.recipe}/{a.topo.name} != python "
            f"{b.recipe}/{b.topo.name}",
        )
    print("winners equal the scalar python back half for all 9 circuits")

    # Front-half parity on the smallest default circuit, and on log2,
    # whose resub sends wide (k = 11..14) queries through K1.
    for name in ("adder", "log2"):
        t = time.time()
        py = characterize_suite({name: suite[name]}, backend="python", n_jobs=1, device=dev)
        check(py[name] == cha[name], f"{name} AigStats: device != python backend")
        print(
            f"{name} AigStats: device backend == python backend ({len(py[name])} "
            f"recipes; python backend {time.time() - t:.3f} s)"
        )
    return suite, cha, netlists, vectors, launches, t1 - t0, t2 - t1


# ---------------------------------------------------------------------------
# Phase 3: Monte-Carlo variation sweep
# ---------------------------------------------------------------------------


def phase_sweep(dev, suite, cha):
    import torch
    from repro_torch.core.explorer import explore_suite
    from repro_torch.core.sram import ModelTable

    mc = ModelTable.monte_carlo(n=MC_VARIANTS, sigma=0.1, seed=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    fused = explore_suite(suite, cha=cha, model_sweep=mc, device=dev)
    torch.cuda.synchronize()
    t1 = time.time()
    peak = torch.cuda.max_memory_allocated()
    host = explore_suite(suite, cha=cha, model_sweep=mc, fused=False, device=dev)
    t2 = time.time()
    for name in suite:
        check(
            fused[name].variation.winners == host[name].variation.winners,
            f"{name}: fused MC winners != host-selection winners",
        )
    cells = len(suite) * MC_VARIANTS * 12 * len(cha["adder"])
    print(
        f"MC sweep: {cells} fp64 cells, fused {t1 - t0:.3f} s, host-selection "
        f"{t2 - t1:.3f} s, peak device memory {peak} bytes; winners equal"
    )
    for name in suite:
        v = fused[name].variation
        print(f"  {name}: best_yield {v.best_yield} cvar90 {v.cvar(0.9)}")


# ---------------------------------------------------------------------------
# Phase 4: K2 against its plain version
# ---------------------------------------------------------------------------


def phase_k2(dev, netlists, vectors):
    import torch
    from repro_torch.kernels import cim_logic as K
    from repro_torch.kernels import ops, ref

    calls = []
    for name, net in netlists.items():
        cc = ops.compile_netlist(net)
        planes, bw = ops.cim_planes(cc, ref.pack_vectors(vectors[name]))
        args = (
            torch.from_numpy(cc.instrs).to(dev),
            torch.from_numpy(planes).to(dev),
        )
        kw = dict(n_rows=cc.n_rows, n_gates=cc.n_gates, n_pos=cc.n_pos, block_words=bw)
        got = K.cim_call(*args, **kw)
        want = K.cim_plain(*args, n_gates=cc.n_gates, n_pos=cc.n_pos)
        same("cim", got, want, f"K2 on {name}'s winner")
        # The global-memory register file, which netlists too tall for
        # shared memory take, held against the plain version as well.
        with global_memory(K):
            glob = K.cim_call(*args, **kw)
        same("cim", glob, want, f"K2 (global register file) on {name}'s winner")
        # instructions in; PI, const0 and const1 rows in; PO rows out
        n_words = planes.shape[1]
        moved = nbytes(args[0]) + (len(cc.pi_rows) + 2 + cc.n_pos) * n_words * 4
        calls.append((args, kw, moved))
    n = len(calls)
    ms = cuda_ms(lambda: [K.cim_call(*a, **kw) for a, kw, _ in calls], 10) / n
    with global_memory(K):
        glob_ms = cuda_ms(lambda: [K.cim_call(*a, **kw) for a, kw, _ in calls], 10) / n
    plain = cuda_ms(
        lambda: [
            K.cim_plain(*a, n_gates=kw["n_gates"], n_pos=kw["n_pos"]) for a, kw, _ in calls
        ],
        1,
    ) / n
    print(
        f"K2: {n} winner netlists at {N_VECTORS} vectors bit-equal to plain "
        "(shared and global register file); "
        f"{ms:.4f} ms/launch (global register file {glob_ms:.4f} ms; "
        f"plain {plain:.3f} ms)"
    )
    return {"cim": dict(ms=ms, plain_ms=plain, bytes=sum(b for *_, b in calls) / n)}


KERNELS = {
    "eval_mega": (
        "aig_sim.eval_mega",
        "src/repro_torch/kernels/csrc/aig_sim.cu",
        "src/repro/kernels/aig_sim.py:362",
    ),
    "sig_eval": (
        "aig_sim.sig_eval",
        "src/repro_torch/kernels/csrc/aig_sim.cu",
        "src/repro/kernels/aig_sim.py:331",
    ),
    "cim": (
        "cim_logic.cim_call",
        "src/repro_torch/kernels/csrc/cim_logic.cu",
        "src/repro/kernels/cim_logic.py:96",
    ),
}


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"src/repro_torch not found beside {Path(__file__).name}")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")
    t0 = time.time()
    logs = build.build_all()
    print(f"build s {time.time() - t0:.3f}")
    for src, log in logs.items():
        print(f"== nvcc {src}.cu\n{log}", file=sys.stderr)

    rng = np.random.default_rng(0)
    times = phase_k1(dev, rng)
    suite, cha, netlists, vectors, launches, front_s, back_s = phase_main(dev, rng)
    phase_sweep(dev, suite, cha)
    times.update(phase_k2(dev, netlists, vectors))

    rows = []
    for key, (kname, source, replaces) in KERNELS.items():
        t = times[key]
        rows.append(
            dict(
                name=kname,
                route="cuda",
                source=source,
                replaces=replaces,
                launches=launches[key],
                max_abs_err=MAX_ERR[key],
                ms=t["ms"],
                plain_ms=t["plain_ms"],
                bound_ms=t["bytes"] / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes",
                library_ms=None,
            )
        )
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": name,
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
