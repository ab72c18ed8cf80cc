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
   k = 11..14 set for the W=512 tier, and whole-graph signatures.  The
   kernel must be bit-equal to the plain version; a sample must match
   python-int ``Aig.truth_table``.
2. The main path, with every kernel launch count set to 0 first:
   ``characterize_suite`` over the default 9-circuit suite (front half,
   through K1), the fused torch back half (``explore_suite``) and the
   end check -- each winner lowered to a gate netlist and run through K2
   (``ops.cim_evaluate``) at 2**16 test vectors, the adder's sums and
   carries checked against integer arithmetic.  Winners must equal the
   scalar ``backend="python"`` back half on the same characterization;
   the adder's device-backend ``AigStats`` must equal the python
   backend's.
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


def mega_bytes(ch, k_max: int, w: int) -> int:
    """Bytes one ``eval_mega`` chunk must move, each once: its real
    instructions (padding slots left out), the pin map over the rows in
    use, the elementary tables, the real root queries and their (n_q, W)
    output."""
    pad_row = len(ch.pin_rows) - 1  # every padding slot writes this row
    n_instr = int((ch.waves[..., 3] != pad_row).sum())
    n_rows = 1 + n_instr + int((ch.pin_rows >= 0).sum())
    n_q = int(ch.qoff[-1])
    return 4 * (4 * n_instr + n_rows + k_max * w + n_q + n_q * w)


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


def k1_chunks(aig, prog, items):
    """``{w: [MegaChunk]}`` for ``items``, grouped by word tier exactly as
    `aig_sim.eval_tts` groups them (plus the W=512 tier it leaves to the
    host)."""
    from repro_torch.kernels import aig_sim as A

    tiers: dict[int, list[int]] = {}
    for i, (_, sup) in enumerate(items):
        tiers.setdefault(A._tier_for(len(sup))[1], []).append(i)
    out = {}
    for w, idxs in sorted(tiers.items()):
        mem = A._cone_members(aig, items, idxs)
        out[w] = (idxs, A._pack_mega_chunks(aig, prog, items, idxs, w, mem))
    return out


def phase_k1(dev, rng):
    import numpy as np
    import torch
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
    main_ops, main_bytes = [], 0
    for name, items in sets.items():
        for w, (idxs, chunks) in k1_chunks(aig, prog, items).items():
            k_max = next(km for km, tw in A._TIERS if tw == w)
            elem = A._dev_elem(k_max, dev)
            checked = 0
            for ch in chunks:
                ops = tuple(
                    torch.from_numpy(a).to(dev)
                    for a in (ch.waves, ch.pin_rows)
                ) + (elem, torch.from_numpy(ch.rootp).to(dev))
                got = A.eval_mega(*ops)
                want = A.eval_mega_plain(*ops)
                same("eval_mega", got, want, f"K1 eval_mega ({name}, W={w})")
                # sample against the python-int reference
                out = got.cpu().numpy().view(np.uint32)
                for bi, p in enumerate(ch.positions):
                    if checked >= K1_SAMPLE:
                        break
                    roots, sup = items[idxs[p]]
                    mask = (1 << (1 << len(sup))) - 1
                    for ri, rl in enumerate(roots):
                        row = out[int(ch.qoff[bi]) + ri]
                        tt = int.from_bytes(row.tobytes(), "little") & mask
                        check(
                            tt == aig.truth_table(rl, sup),
                            f"K1 truth table mismatch ({name}, W={w})",
                        )
                    checked += 1
                if name != "wide":
                    main_ops.append(ops)
                    main_bytes += mega_bytes(ch, k_max, w)
            print(
                f"  {name} W={w}: {len(idxs)} queries, {len(chunks)} chunks, "
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
    sig_ops = (
        torch.from_numpy(prog.waves).to(dev),
        torch.from_numpy(vals0.view(np.int32)).to(dev),
    )
    same("sig_eval", A.sig_eval(*sig_ops), A.sig_eval_plain(*sig_ops), "K1 sig_eval")
    print("  signatures: bit-equal to plain and to transforms._node_signatures")

    n = len(main_ops)
    mega_ms = cuda_ms(lambda: [A.eval_mega(*o) for o in main_ops], 5) / n
    mega_plain = cuda_ms(lambda: [A.eval_mega_plain(*o) for o in main_ops], 1) / n
    sig_ms = cuda_ms(lambda: A.sig_eval(*sig_ops), 20)
    sig_plain = cuda_ms(lambda: A.sig_eval_plain(*sig_ops), 3)
    # the AND instructions (padding slots left out), vals0 in, vals out
    sig_bytes = 16 * aig.n_ands + 2 * nbytes(sig_ops[1])
    print(
        f"  eval_mega: {n} main-path chunks, {mega_ms:.4f} ms/launch "
        f"(plain {mega_plain:.3f} ms); sig_eval {sig_ms:.4f} ms "
        f"(plain {sig_plain:.3f} ms)"
    )
    return {
        "eval_mega": dict(ms=mega_ms, plain_ms=mega_plain, bytes=main_bytes / n),
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
    for d in (A.LAUNCHES, K.LAUNCHES):
        for k in d:
            d[k] = 0
    t0 = time.time()
    # Aig.truth_table runs in the front half only as eval_tts's host path
    # for supports wider than DEVICE_MAX_VARS.
    host_fns = [(A, "eval_tts"), (A, "node_signatures"), (A, "_cone_members"),
                (A, "_pack_mega_chunks"), (Aig, "truth_table")]
    with spans([(A, "eval_mega"), (A, "sig_eval")], host_fns) as front:
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
        f"end check {t3 - t2:.3f} s; launches {launches}"
    )
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched on the main path")
    k1 = {k: device_s(front.get(k, [])) for k in ("eval_mega", "sig_eval")}
    k1_s = sum(k1.values())
    host = {name: sum(front.get(name, [])) for _, name in host_fns}
    sim_s = host["eval_tts"] + host["node_signatures"]
    rest_s = sim_s - k1_s - host["_cone_members"] - host["_pack_mega_chunks"]
    rest_s -= host["truth_table"]
    front_s = t1 - t0
    print(
        f"front half layers: K1 {k1_s:.4f} s on the card (events around each "
        f"wrapper call: kernel plus its enqueue; eval_mega "
        f"{k1['eval_mega']:.4f} s, sig_eval {k1['sig_eval']:.4f} s); inside the "
        f"aig_sim entry points ({sim_s:.3f} s): cone membership "
        f"{host['_cone_members']:.3f} s, chunk packing "
        f"{host['_pack_mega_chunks']:.3f} s, host truth tables for k > "
        f"{A.DEVICE_MAX_VARS} {host['truth_table']:.3f} s, copies/syncs/"
        f"unpacking {rest_s:.3f} s; transforms host code {front_s - sim_s:.3f} s; "
        f"K1 busy share {k1_s / front_s:.6f}"
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

    # Front-half parity on the smallest default circuit.
    adder = {"adder": suite["adder"]}
    py = characterize_suite(adder, backend="python", n_jobs=1, device=dev)
    check(py["adder"] == cha["adder"], "adder AigStats: device != python backend")
    print(f"adder AigStats: device backend == python backend ({len(py['adder'])} recipes)")
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


@contextlib.contextmanager
def global_register_file(K):
    """Make `cim_logic.cim_call` take its global-memory register file."""
    saved, K.MAX_SHARED_BYTES = K.MAX_SHARED_BYTES, 0
    try:
        yield
    finally:
        K.MAX_SHARED_BYTES = saved


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
        with global_register_file(K):
            glob = K.cim_call(*args, **kw)
        same("cim", glob, want, f"K2 (global register file) on {name}'s winner")
        # instructions in; PI, const0 and const1 rows in; PO rows out
        n_words = planes.shape[1]
        moved = nbytes(args[0]) + (len(cc.pi_rows) + 2 + cc.n_pos) * n_words * 4
        calls.append((args, kw, moved))
    n = len(calls)
    ms = cuda_ms(lambda: [K.cim_call(*a, **kw) for a, kw, _ in calls], 10) / n
    with global_register_file(K):
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
