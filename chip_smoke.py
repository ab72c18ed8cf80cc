#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Usage (from the repository root, on a machine with one CUDA card and
``nvcc``)::

    python3 chip_smoke.py

It builds the hand-written kernels from ``src/repro_torch/kernels/csrc``
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
   every circuit must equal the python backend's (``adder`` and ``log2``
   serially, the other seven on the spawn pool, sine first).
3. A 1024-variant Monte-Carlo sweep of the back half; its winners must
   equal the ``fused=False`` host-selection path.
4. K2 against its plain torch version on the card, per winner netlist,
   with its register file in shared memory (as the main path runs it)
   and forced into global memory; per netlist its program
   (``ops.cim_program``: levels, widest level, renamed rows, shared
   bytes), ms per launch, the plain version's ms and the bound.
5. The exploration service (``ExplorationService(device="cuda")``) over
   ``adder``, ``max`` and ``log2`` at the default scale, all 65 recipes
   and the 12 topologies, on a fresh on-disk cache: 3 cold requests in
   one batch (their front half must launch ``eval_mega``, W=512 included,
   and ``sig_eval``, with no host ``Aig.truth_table`` call), 20 rounds
   of 24 warm re-ranks (no K1 launch, no back-half pass), a 1024-variant sweep
   request on ``log2``, two structured errors, a 64-request burst from 4
   threads and a second service answering from the disk cache with no K1
   launch.  Every winner must equal ``explore_request`` on the card (the
   float bits of energy and latency included), the sweep's summary
   ``explore_request(model_sweep=...)``; no request may be degraded and
   the worker may neither crash nor restart.
6. The journaled sweep runner (``run_sweep``, one circuit per shard,
   the 1024-variant table, the same cache): an uninterrupted run, a run
   crashed by the ``sweep.shard`` fault after its first shard, and its
   resume, which must equal the uninterrupted rows bit for bit; each
   circuit's per-variant winners and winner energies must equal phase
   3's.
7. The paper's CLI (``repro_torch.launch.cim_explore``, in process, on
   the card): ``--all`` from a cache seeded with phase 2's
   characterization (its nine Table-I rows must equal phase 2's, with no
   K1 launch), ``log2`` from a cold cache (K1 launches in all three word
   tiers, the same row) and ``log2`` under the 1024-variant Monte-Carlo
   table (the yield summary of phase 3's sweep).
8. The chaos matrix (``repro_torch.launch.chaos --device cuda``, in
   process): all 13 scenarios must recover with parity, none skipped;
   then the journal's ``machinery_overhead_pct`` as the reference's
   fault bench defines it, printed beside its 2% gate (a reading, not a
   check).
9. Workload pricing and the rCiM-vs-roofline comparison
   (``repro_torch.launch.system``): ``compare_system`` on the card for
   each of the 33 runnable zoo cells at published size, each record equal
   to the same call on the CPU and its rCiM side to the scalar back half
   (``mapping.schedule_stats`` + ``sram.evaluate`` + numpy
   ``select_best_batch``) over the 12 topologies -- winners and
   bottlenecks identical, fp64 within ``rtol=1e-12`` -- conserved, and
   its bandwidth sweep's memory time strictly falling; ``evaluate_lowered``
   in both modes and both disciplines held the same way; the three
   primitive tiles (mac8, add16, max8) through K2 at 2**16 random
   operands, equal to their integer arithmetic, and K2 bit-equal to its
   plain version with either register file, printed as in phase 4; one
   cell's CLI run (``system.main``), its record equal to the phase's.
10. The LM serving path of the dense family (``repro_torch.models``,
   ``serve.engine``, ``launch.serve llm``), random weights from seed 0,
   TF32 off: (a) minicpm-2b at published size in bf16 served as
   ``launch.serve llm`` serves it (two waves of 4 requests, prompts of
   32-128 tokens left-padded to 128, 32 new tokens), twice: every token
   in the vocab, finite logits, the same tokens both times; prefill ms
   per wave, decode ms per step and tokens/s beside the decode step's
   bytes bound; (b) its fp32 decode (batch 2, prompt 128, 32 steps)
   against the teacher-forced forward on the card; (c) depth 2 at full
   width, fp32, the card against the CPU from one CPU init (prefill
   logits, aligned caches, 16 teacher-forced decode steps); (d)
   gemma3-27b at published width and one pattern period of depth (five
   ``local`` layers, one ``attn``), fp32, prompt 1,088 > window 1,024
   (ring rotated by 64), 64 decode steps against the forward; (e)
   ``python -m repro_torch.launch.serve llm --preset 100m`` in process;
   (f) the decode attention kernel (``decode_attn.decode_attention``)
   against its plain version on the same bf16 card tensors at both
   serving cells' layer shapes and two small batches it splits: caches
   bit-equal, outputs within ``decode_attn.tolerance``, a launch that
   skips the oldest valid slot outside it; ms per launch beside the
   plain version, ``scaled_dot_product_attention`` (a yardstick the port
   never calls), the bound, and for the split shapes the kernel without
   its occupancy split.  Tolerances of (b)-(d): the reference's 2e-3
   (prefill) and 5e-3 (decode) on the logits, 1e-3 of their scale on
   the caches.  The path launches neither K1 nor K2; its decode
   attention launches in (a)-(e) are the kernel row's ``launches``.
11. The LM serving path of the MoE and recurrent families, random
   weights from seed 0, TF32 off: (a) deepseek-moe-16b,
   recurrentgemma-9b and mamba2-780m at published size in bf16 (every
   param bf16 but ``models.model.FP32_PARAMS``, which are fp32), each
   served as in phase 10 (a), twice, with the same checks and numbers,
   the MoE's active-param bytes and the share of its first wave's
   routed assignments dropped at capacity; (b) fp32 decode against the
   teacher-forced forward: mamba2-780m at published size (batch 2,
   prompt 128, 64 steps), recurrentgemma-9b at published width over one
   pattern period (prompt 2,112 > window 2,048, ring rotated by 64, 32
   steps), deepseek-moe-16b at depth 3 with a dropless capacity factor
   (64 / 6; no assignment may drop); (c) the card against the CPU at
   full width (deepseek depth 2 at its published capacity factor 1.25,
   batch 4 x prompt 64 with drops, its expert ids and keep masks equal
   first; mamba2 depth 2; recurrentgemma depth 3); (d) ``launch.serve
   llm --preset 100m`` for the four new archs (moonshot-v1-16b-a3b runs
   on the card at this preset only).  Phase 10's tolerances; neither K1
   nor K2 is launched.
12. whisper-tiny's encoder-decoder and internvl2-2b's patch prefix, and
   the training path, random weights from seed 0, TF32 off: (a) both at
   published size in bf16, served as in phase 10 (a) but wave by wave
   through ``ServeEngine.generate(..., extra_batch=)`` (``serve`` refuses
   them, as the reference's fails on them), encoder frames (4, 1500, 384)
   or image patches (4, 256, 2048) drawn from seed 0, with the decode
   step's bytes bound counting the whole cross KV; (b) fp32 decode
   against the teacher-forced forward at published size (batch 2,
   prompt 128, 32 steps); (c) the card against the CPU at full width
   (whisper-tiny at published size, internvl2-2b at depth 2), the
   cross keys and values ``xk``/``xv`` among the aligned caches; (d)
   training through ``repro_torch.launch.train.main`` in process:
   minicpm-2b at ``--preset full`` (batch 4 x 128, wsd, 6 steps: step
   ms, tokens/s, loss and grad norm per step, peak memory, one step's
   kernels under the profiler), ``--preset 100m`` 8 steps straight
   against 4 steps with a checkpoint every 2 and ``--resume`` to 8
   (params, moments and step bit-equal, the loss falling),
   whisper-tiny and internvl2-2b at ``--preset 100m`` (finite losses),
   and one ``make_train_step`` of minicpm-2b at full width, depth 2,
   fp32, the card against the CPU (the loss; every grad leaf within the
   CPU grads' own sensitivity to a one-ulp move of the params, which the
   random weights make large, and never tighter than 1e-3 of its scale;
   the updated params where both grads agree in sign).  Phase 10's
   tolerances; neither K1 nor K2 is launched.
13. The mesh explorer and its dry-run layer (``core.mesh_explorer``,
   ``launch.dryrun``): every cell is the step traced on meta DTensors over
   a fake 512-rank process group (the reference's 512 placeholder host
   devices), its per-device costs read off the trace: (a)
   ``explore_mesh`` of minicpm-2b x train_4k at published size over the
   four default topologies (16x16, 32x8, 64x4 and 2x16x16 on the 512
   ranks) and the six default recipes, the 24 cells traced by 8 worker
   processes, with the energy constants' corners and the selection on the
   card: every variant's winner and the pick must equal the same call
   selecting on the CPU; each cell's trace time, per-device costs and
   HBM are printed; (b) ``explore_mesh_suite`` over whisper-tiny x
   decode_32k and deepseek-moe-16b x decode_32k (the base recipe, the
   four topologies), its global pick, card against CPU; (c) the dry-run's
   memory estimate against the card: ``run_cell`` of whisper-tiny x
   decode_32k on a (1, 1) mesh (bf16 params, 27 GB of caches at batch
   128 x 32,768 positions), then the same ``decode_step`` for real on the
   card: the estimate's argument bytes must equal the real arguments'
   bytes, and the card's allocation for them within the caching
   allocator's rounding per tensor; its HBM must not be below them; the
   ratio of the estimate to ``max_memory_allocated`` is printed; (d)
   ``run_cell`` of mamba2-780m x train_4k on one 16x16 mesh, the base
   recipe, at published width and 24 of its 48 layers: the recurrent
   blocks' backward through the port's ``softplus_backward`` and
   ``constant_pad_nd`` sharding rules, a record with work, collectives
   and memory, its trace time and per-device costs printed.  Neither K1
   nor K2 is launched.
14. The device-discipline lint (``repro_torch.analysis``) on the card:
   (a) the AST layer over ``src/repro_torch``, no new finding against the
   checked-in baseline; (b) the graph layer with ``device="cuda"`` over
   every registered kernel, no new finding, the K1 and K2 builders
   launching ``eval_mega``, ``sig_eval`` and ``cim`` once each (the hand
   kernels ran, not their plain versions), every output equal to the same
   builder's on the CPU (bits, fp64 to 1e-12); per kernel the aten op
   count, the syncs and the launches are printed; (c)
   ``select_best_batch_device`` on (4, 96) CUDA operands: no
   ``_local_scalar_dense``, and the only copy to the host is the (4,)
   winner payload (the operands never cross), its winners equal to the
   host filter's.

15. The tables and training on a host mesh: (a) ``batch.schedule_suite``
   and ``schedule_batch`` on the card, both disciplines, over phase 2's
   characterization (9 circuits x 65 recipes x 12 topologies): equal to
   the CPU's, to ``mapping.schedule_stats`` in every cell and (list) to
   phase 2's fused back half; ``table2_batch`` within ``rtol=1e-12`` of
   ``sram.table2_metrics`` for the nominal model and phase 3's 1024
   variants; ms a call; (b) ``python -m torch.distributed.run --standalone
   --nproc-per-node 1 -m repro_torch.launch.train`` with phase 12 (d)'s
   argv for 3 steps: minicpm-2b at published size with DTensor params on a
   (1, 1) NCCL mesh, its losses and grad norms held to (d)'s first three
   (phase 12's tolerances; bit-equality reported), ms a step and peak
   memory (``--metrics-out``) and one step's kernels (profiled in this
   process on a one-rank NCCL group) beside (d)'s; ``--model-parallel 2``
   on the one card must exit non-zero with the launcher's `ValueError`.
   Neither K1 nor K2 is launched.

Kernel times are device times of back-to-back launches; ``bound_ms``
counts each byte a call must move once, over the card's HBM rate, and
for K2 is the larger of that and its int32 logic ops (one a gate and
word) over the card's integer rate (132 SMs x 64 int32 lanes x the SM
clock ``nvidia-smi`` reports as ``clocks.max.sm``).

It prints the card (``nvidia-smi --query-gpu=name,power.limit``), the
build seconds, per-phase times (the launches of phases 5-15 on lines of
their own), the script's wall time, a ``{"kernels": [...]}`` JSON line
(launch counts of phase 2; the decode attention kernel's of phase 10,
its times the mean over the two serving cells' shapes) and, last,
``{"ok": true, "device": {...}}``.
It exits non-zero without a CUDA device and when ``src/repro_torch`` is
not beside it.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
#: Peak HBM bandwidth of one H100 SXM (NVIDIA data sheet), bytes/s.
HBM_BYTES_PER_S = 3.35e12
N_VECTORS = 1 << 16
#: circuits whose device-backend AigStats phase 2 also holds against the
#: python backend on a spawn pool (adder and log2 are checked serially)
PYTHON_CHECKED = ("sine", "sqrt", "mult", "bar", "max", "div", "square")
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
MAX_ERR = {"eval_mega": 0, "sig_eval": 0, "cim": 0, "decode_attn": 0}


_SM_CLOCK_HZ: list[float] = []


def int32_ops_per_s() -> float:
    """The card's int32 rate: 132 SMs x 64 int32 lanes x the SM clock
    (``nvidia-smi``'s ``clocks.max.sm``), read once."""
    if not _SM_CLOCK_HZ:
        mhz = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.split()[0]
        _SM_CLOCK_HZ.append(float(mhz) * 1e6)
    return 132 * 64 * _SM_CLOCK_HZ[0]


def k2_operands(dev, net, bits):
    """(cc, program, positional operands, keywords) of one `cim_call`, as
    ``ops.cim_evaluate`` builds them (the stream stays on the host)."""
    import torch
    from repro_torch.kernels import ops, ref

    cc = ops.compile_netlist(net)
    program = ops.cim_program(cc)
    planes, bw = ops.cim_planes(cc, ref.pack_vectors(bits))
    args = (torch.from_numpy(cc.instrs), torch.from_numpy(planes).to(dev))
    kw = dict(n_rows=cc.n_rows, n_gates=cc.n_gates, n_pos=cc.n_pos, block_words=bw,
              program=program.to(dev))
    return cc, program, args, kw


def k2_bound(program, kw, planes) -> dict:
    """K2's least time for one call: the program in, its input rows in and
    the PO rows out over the HBM rate, against one int32 logic op per gate
    and word over the integer rate; the larger bounds it."""
    n_words = planes.shape[1]
    moved = nbytes(kw["program"].code) + (program.n_in + program.n_pos) * n_words * 4
    ops_ = program.n_gates * n_words
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_ / int32_ops_per_s() * 1e3
    return dict(bytes=moved, ops=ops_, bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def k2_check(name: str, cc, args, kw):
    """K2 against `cim_plain` with both register files, and the program's
    plain executor against it."""
    import torch
    from repro_torch.kernels import cim_logic as K

    want = K.cim_plain(*args, n_gates=cc.n_gates, n_pos=cc.n_pos)
    same("cim", K.cim_call(*args, **kw), want, f"K2 on {name}")
    with global_memory(K):
        same("cim", K.cim_call(*args, **kw), want, f"K2 (global register file) on {name}")
    check(torch.equal(K.program_plain(kw["program"], args[1]), want),
          f"{name}: program_plain != cim_plain")


def k2_line(name: str, cc, program, bound: dict, ms: float, glob_ms: float,
            plain_ms: float) -> str:
    from repro_torch.kernels import cim_logic as K

    shared = K._k2().k2_shared_bytes(program.n_rows, K.CHUNK_SLOTS)
    return (f"  {name}: n_gates {cc.n_gates}, levels (depth) {program.n_levels}, widest "
            f"{program.widest}, renamed rows {program.n_rows} (stream {cc.n_rows_padded}), "
            f"shared {shared} B; K2 {ms:.4f} ms/launch (global register "
            f"file {glob_ms:.4f} ms; plain {plain_ms:.3f} ms); bound {bound['bound_ms']:.6f} ms "
            f"by {bound['bound_by']} (bytes {bound['bytes_ms']:.6f} ms for {bound['bytes']} B, "
            f"int32 ops {bound['ops_ms']:.6f} ms for {bound['ops']}); "
            f"{ms / bound['bound_ms']:.0f}x the bound, "
            f"{ms * 1e3 / max(program.n_levels, 1):.3f} us a level")


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
    zero_launches()
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
    print(f"end check: K2 {k2_s:.4f} s between events around each wrapper call (the "
          f"wrapper's host work and the first call's library and module load included; "
          f"phase 4 gives the launches' device time) of {t3 - t2:.3f} s")
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
    # The rest of the suite on the python backend's spawn pool, sine (the
    # main path's largest source of W=512 queries) first.
    jobs = min(8, os.cpu_count() or 1)
    t = time.time()
    py = characterize_suite({n: suite[n] for n in PYTHON_CHECKED}, backend="python",
                            n_jobs=jobs, device=dev)
    for name in PYTHON_CHECKED:
        bad = [r for r in cha[name] if py[name][r] != cha[name][r]]
        check(not bad, f"{name} AigStats: device != python backend for {len(bad)} "
                       f"recipes, first {bad[:1]}")
    print(
        f"AigStats device backend == python backend for {', '.join(PYTHON_CHECKED)} "
        f"({len(cha['sine'])} recipes each; python backend on {jobs} spawn workers "
        f"{time.time() - t:.3f} s)"
    )
    return suite, cha, res, netlists, vectors, launches, t1 - t0, t2 - t1


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
    return mc, fused


# ---------------------------------------------------------------------------
# Phase 4: K2 against its plain version
# ---------------------------------------------------------------------------


def phase_k2(dev, netlists, vectors):
    from repro_torch.kernels import cim_logic as K

    calls, bounds, print_lines = [], [], []
    plain = 0.0
    for name, net in netlists.items():
        cc, program, args, kw = k2_operands(dev, net, vectors[name])
        k2_check(f"{name}'s winner", cc, args, kw)
        bound = k2_bound(program, kw, args[1])
        ms = cuda_ms(lambda: K.cim_call(*args, **kw), 10)
        with global_memory(K):
            glob_ms = cuda_ms(lambda: K.cim_call(*args, **kw), 10)
        plain_ms = cuda_ms(lambda: K.cim_plain(*args, n_gates=cc.n_gates, n_pos=cc.n_pos), 1)
        plain += plain_ms
        print_lines.append(k2_line(name, cc, program, bound, ms, glob_ms, plain_ms))
        calls.append((args, kw))
        bounds.append(bound)
    n = len(calls)
    ms = cuda_ms(lambda: [K.cim_call(*a, **kw) for a, kw in calls], 10) / n
    with global_memory(K):
        glob_ms = cuda_ms(lambda: [K.cim_call(*a, **kw) for a, kw in calls], 10) / n
    bound_ms = sum(b["bound_ms"] for b in bounds) / n
    print(
        f"K2: {n} winner netlists at {N_VECTORS} vectors bit-equal to plain "
        "(shared and global register file; program_plain too); "
        f"{ms:.4f} ms/launch (global register file {glob_ms:.4f} ms; "
        f"plain {plain / n:.3f} ms; bound {bound_ms:.6f} ms); the end check's K2 on the "
        f"card: {n} launches x {ms:.4f} ms = {n * ms:.4f} ms"
    )
    for line in print_lines:
        print(line)
    by = "operations" if sum(b["ops_ms"] for b in bounds) > sum(b["bytes_ms"] for b in bounds) \
        else "bytes"
    return {"cim": dict(ms=ms, plain_ms=plain / n, bound_ms=bound_ms, bound_by=by)}


# ---------------------------------------------------------------------------
# Phase 5: the exploration service on the card
# ---------------------------------------------------------------------------

SERVICE_CIRCUITS = ("adder", "max", "log2")
#: max_memory_kb x max_latency_ns of the warm re-rank traffic
WARM_CONSTRAINTS = [
    dict(max_memory_kb=kb, max_latency_ns=lat)
    for kb in (None, 12, 48, 192)
    for lat in (None, 100.0)
]
#: rounds of the warm traffic (every circuit x constraint set per round),
#: so that its p99 is read from 480 requests and not from 24
WARM_ROUNDS = 20
BURST_REQUESTS, BURST_THREADS = 64, 4


def zero_launches():
    from repro_torch.kernels import aig_sim as A
    from repro_torch.kernels import cim_logic as K
    from repro_torch.kernels import decode_attn as DA

    for d in (A.LAUNCHES, A.TIER_LAUNCHES, K.LAUNCHES, DA.LAUNCHES):
        for k in d:
            d[k] = 0


def k1_launches() -> dict:
    from repro_torch.kernels import aig_sim as A

    return {**A.LAUNCHES, "eval_mega_by_tier": dict(A.TIER_LAUNCHES)}


def same_winner(w, off, msg: str) -> None:
    """A service `Winner` against the offline `explore_request` result:
    recipe, topology and the float bits of energy and latency (the
    offline grid cell comes from the same fused pass)."""
    g = off.grid
    cell = g.cell(g.topologies.index(off.best.topo), g.recipes.index(tuple(off.best.recipe)))
    check(
        (w.recipe, w.topology) == (tuple(off.best.recipe), off.best.topo),
        f"{msg}: service winner {w.recipe}/{w.topology.name} != explore_request "
        f"{off.best.recipe}/{off.best.topo.name}",
    )
    check(
        (w.energy_nj.hex(), w.latency_ns.hex()) == (cell.energy_nj.hex(), cell.latency_ns.hex()),
        f"{msg}: winner energy/latency bits differ from explore_request",
    )


def phase_service(dev, suite, cha, mc, cache_dir):
    """`ExplorationService` on ``dev`` over ``suite``: cold, warm
    re-rank, a Monte-Carlo sweep request, errors, a threaded burst and a
    second service answering from the on-disk cache."""
    import threading

    import numpy as np
    import torch
    from repro_torch.core.aig import Aig
    from repro_torch.core.explorer import explore_request
    from repro_torch.core.transforms import CharacterizationCache
    from repro_torch.kernels import aig_sim as A
    from repro_torch.serve.explore_service import ExplorationService, ExploreRequest

    t_phase = time.time()
    zero_launches()
    svc = ExplorationService(device=dev, start=True, cache=cache_dir)
    offline = {}

    def expect(name, kw):
        key = (name, tuple(sorted(kw.items())))
        if key not in offline:
            offline[key] = explore_request(suite[name], cha=cha[name], device=dev, **kw)
        return offline[key]

    try:
        # cold: one submit_batch of every circuit; the front half runs K1
        with spans([(A, "eval_mega"), (A, "sig_eval")], [(Aig, "truth_table")]) as k1:
            t = time.time()
            cold = [f.result() for f in svc.submit_batch(
                [ExploreRequest(suite[n], tag=n) for n in suite]
            )]
            cold_s = time.time() - t
        cold_launches = k1_launches()
        k1_cold_s = sum(device_s(k1.get(k, [])) for k in ("eval_mega", "sig_eval"))
        for r in cold:
            check(r.ok, f"service cold {r.request.tag}: {r.error}")
            same_winner(r.winner, expect(r.request.tag, {}), f"service cold {r.request.tag}")
        check(A.LAUNCHES["eval_mega"] > 0 and A.LAUNCHES["sig_eval"] > 0,
              f"cold service requests launched no K1: {cold_launches}")
        check(A.TIER_LAUNCHES[512] > 0, "cold service requests made no W=512 eval_mega launch")
        n_tt = len(k1.get("truth_table", []))
        check(n_tt == 0, f"{n_tt} host Aig.truth_table calls in the service's front half")
        st = svc.stats()
        print(
            f"service cold: {len(cold)} requests in {cold_s:.3f} s; service_ms "
            + json.dumps({r.request.tag: r.service_ms for r in cold})
            + f"; buckets {st['buckets']}; K1 {k1_cold_s:.4f} s on the card"
        )
        print("service cold K1 launches: " + json.dumps(cold_launches))
        # the service's characterization (cached on disk) equals phase 2's
        disk = CharacterizationCache(cache_dir)
        for name in ("adder", "log2"):
            got = disk.load(suite[name].fingerprint())
            check({r: got[r] for r in cha[name]} == cha[name],
                  f"{name}: service AigStats != phase 2's")

        # warm re-rank: constraints only; no K1 launch, no back-half pass
        launches = k1_launches()
        evaluate_calls = svc.stats()["evaluate_calls"]
        warm_ms = []
        for _ in range(WARM_ROUNDS):
            for name in suite:
                for kw in WARM_CONSTRAINTS:
                    r = svc.submit(ExploreRequest(suite[name], **kw)).result()
                    check(r.ok, f"warm {name} {kw}: {r.error}")
                    check(r.grid_cache_hit and r.cha_cache_hit,
                          f"warm {name} {kw}: not a cache hit")
                    same_winner(r.winner, expect(name, kw), f"warm {name} {kw}")
                    warm_ms.append(r.service_ms)
        check(k1_launches() == launches, "warm re-ranks launched K1")
        check(svc.stats()["evaluate_calls"] == evaluate_calls, "warm re-ranks ran the back half")
        print(
            f"service warm re-rank: {len(warm_ms)} requests, service_ms p50 "
            f"{np.percentile(warm_ms, 50):.4f} p99 {np.percentile(warm_ms, 99):.4f} "
            f"max {max(warm_ms):.4f}"
        )

        # a Monte-Carlo sweep request on log2
        r = svc.submit(ExploreRequest(suite["log2"], model_sweep=mc)).result()
        check(r.ok, f"service MC sweep: {r.error}")
        off = explore_request(suite["log2"], cha=cha["log2"], model_sweep=mc, device=dev)
        v, vo = r.variation, off.variation
        check(list(v.winners) == [(tuple(a), b) for a, b in vo.winners],
              "service MC sweep: winners != explore_request(model_sweep=...)")
        check(np.array_equal(v.winner_energy_nj, vo.winner_energy_nj),
              "service MC sweep: winner_energy_nj != explore_request")
        check(v.energy_quantiles == vo.energy_quantiles
              and v.best_yield == vo.best_yield and v.latency_yield == vo.latency_yield,
              "service MC sweep: quantiles or yields != explore_request")
        print(
            f"service MC sweep: log2 x {v.n_variants} variants, service_ms {r.service_ms:.3f}, "
            f"best_yield {v.best_yield}; equal to explore_request(model_sweep=...)"
        )

        # structured errors
        bad = svc.submit(ExploreRequest(Aig(4, name="no-outputs"))).result()
        check(not bad.ok and bad.error.code == "malformed-circuit",
              f"no-output circuit answered {bad.error}")
        tiny = svc.submit(ExploreRequest(suite["adder"], max_memory_kb=1)).result()
        check(not tiny.ok and tiny.error.code == "infeasible-memory",
              f"max_memory_kb=1 answered {tiny.error}")

        # burst: warm requests from several threads
        launches = k1_launches()
        plan = [
            (name, WARM_CONSTRAINTS[i % len(WARM_CONSTRAINTS)])
            for i, name in enumerate(list(suite) * (BURST_REQUESTS // len(suite) + 1))
        ][:BURST_REQUESTS]
        got = [None] * len(plan)

        def submitter(k):
            for i in range(k, len(plan), BURST_THREADS):
                name, kw = plan[i]
                got[i] = svc.submit(ExploreRequest(suite[name], **kw)).result()

        threads = [threading.Thread(target=submitter, args=(k,)) for k in range(BURST_THREADS)]
        t = time.time()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        burst_s = time.time() - t
        for (name, kw), r in zip(plan, got):
            check(r is not None and r.ok, f"burst {name} {kw}: {r and r.error}")
            same_winner(r.winner, expect(name, kw), f"burst {name} {kw}")
        check(k1_launches() == launches, "burst requests launched K1")
        print(
            f"service burst: {len(plan)} warm requests from {BURST_THREADS} threads in "
            f"{burst_s:.4f} s = {len(plan) / burst_s:.2f} requests/s"
        )
        st = svc.stats()
    finally:
        svc.close()
    for k in ("degraded", "worker_crashes", "worker_restarts"):
        check(st.get(k, 0) == 0, f"service stats: {k} = {st.get(k)}")

    # a second service over the same cache directory answers from disk
    launches = k1_launches()
    with ExplorationService(device=dev, start=True, cache=cache_dir) as svc2:
        r = svc2.submit(ExploreRequest(suite["adder"])).result()
    check(r.ok, f"disk-hit service: {r.error}")
    same_winner(r.winner, expect("adder", {}), "disk-hit service")
    check(k1_launches() == launches, "the disk-hit service launched K1")
    print(f"service disk hit: adder answered in {r.service_ms:.3f} ms with 0 K1 launches")
    torch.cuda.synchronize()
    wall = time.time() - t_phase
    print(f"service phase: wall {wall:.3f} s; stats " + json.dumps(
        {k: v for k, v in st.items() if k != "buckets"}))
    return wall


# ---------------------------------------------------------------------------
# Phase 6: the journaled sweep runner on the card
# ---------------------------------------------------------------------------


def phase_runner(dev, suite, mc, fused, cache_dir, journal_root):
    """`run_sweep` over ``suite`` under the Monte-Carlo table ``mc``: an
    uninterrupted run, a run crashed after its first shard, and its
    resume; rows against phase 3's fused ``explore_suite`` results."""
    import numpy as np
    from repro_torch.ckpt import manager as M
    from repro_torch.core.sram import TOPOLOGY_LIBRARY
    from repro_torch.core.sweep_runner import SweepRunner, run_sweep
    from repro_torch.core.transforms import enumerate_recipes
    from repro_torch.runtime import faults

    t_phase = time.time()
    zero_launches()
    kw = dict(model=mc, cache=cache_dir, device=dev)
    marks = []
    # the writer thread's publish time, every publish of the three runs
    with spans([], [(M.CheckpointManager, "_write")]) as publish:
        runner = SweepRunner(f"{journal_root}/whole", 1,
                             on_shard=lambda i, names: marks.append(time.perf_counter()))
        t0 = time.perf_counter()
        whole = runner.run(suite, **kw)
        whole_s = time.perf_counter() - t0
        with faults.injected(faults.FaultRule("sweep.shard", "raise", after=1)):
            try:
                run_sweep(suite, journal_dir=f"{journal_root}/crashed", shard_size=1, **kw)
            except faults.FaultError:
                pass
            else:
                fail("the sweep.shard fault did not stop the crashed run")
        t = time.perf_counter()
        resumed = run_sweep(suite, journal_dir=f"{journal_root}/crashed", shard_size=1, **kw)
        resume_s = time.perf_counter() - t
        M.CheckpointManager(f"{journal_root}/crashed").wait()
    publish_s = publish["_write"]
    check(resumed.shards_resumed == 1 and resumed.shards_run == len(suite) - 1,
          f"resume: {resumed.shards_resumed} resumed, {resumed.shards_run} run")
    a, b = resumed.selection, whole.selection
    check(np.array_equal(a.winner_idx, b.winner_idx)
          and np.array_equal(a.nominal_latency_ns, b.nominal_latency_ns)
          and np.array_equal(a.nominal_fits, b.nominal_fits)
          and all(np.array_equal(a.winner_metrics[k], v) for k, v in b.winner_metrics.items()),
          "resumed sweep rows != uninterrupted sweep rows")
    # the runner's per-circuit rows against phase 3's fused explore_suite
    recipes = list(dict.fromkeys([()] + enumerate_recipes()))
    for c, name in enumerate(whole.circuits):
        var = fused[name].variation
        rows = [divmod(int(i), len(recipes)) for i in b.winner_idx[c]]
        check([(recipes[ri], TOPOLOGY_LIBRARY[ti]) for ti, ri in rows]
              == [(tuple(r), t) for r, t in var.winners],
              f"{name}: sweep runner winners != phase 3's")
        check(np.array_equal(b.winner_metrics["energy_nj"][c], var.winner_energy_nj),
              f"{name}: sweep runner winner energies != phase 3's")
    check(k1_launches()["eval_mega"] == 0, "the sweep runner's front half launched K1")
    # time between shard publishes (the first also holds the front half,
    # here disk hits); each on_shard waits for its publish to land
    shard_ms = [1e3 * (m1 - m0) for m0, m1 in zip([t0] + marks, marks)]
    print(
        f"sweep runner: {len(suite)} circuits x {len(mc)} variants, shard_size 1: "
        f"uninterrupted {1e3 * whole_s:.3f} ms (per shard "
        + ", ".join(f"{x:.3f}" for x in shard_ms)
        + " ms); journal publish ms (writer thread, every publish of the three runs) "
        + ", ".join(f"{1e3 * x:.3f}" for x in publish_s)
        + f"; resume {1e3 * resume_s:.3f} ms; rows bit-equal after resume and equal to "
        "phase 3's winners and energies"
    )
    print("sweep runner K1 launches: " + json.dumps(k1_launches()))
    wall = time.time() - t_phase
    print(f"sweep runner phase: wall {wall:.3f} s")
    return wall


# ---------------------------------------------------------------------------
# Phase 7: the paper's CLI at full width
# ---------------------------------------------------------------------------


def run_cli(argv):
    """``cim_explore.main(argv)`` on the card; its printed report is kept,
    and only each circuit's header and saving line are shown.  Returns
    (results, stdout, wall s)."""
    from repro_torch.launch import cim_explore

    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = cim_explore.main(argv)
    wall = time.perf_counter() - t
    for line in buf.getvalue().splitlines():
        if line.startswith(("===", "  best-vs-worst")):
            print("  " + line.strip())
    return res, buf.getvalue(), wall


def phase_cli(suite, cha, res, fused, warm_dir, cold_dir):
    """`python -m repro_torch.launch.cim_explore` in process on the card:
    every circuit from a warm cache seeded with phase 2's
    characterization (no K1 launch), log2 cold (K1 in every word tier),
    and log2 under the 1024-variant Monte-Carlo table."""
    from repro_torch.core.transforms import CharacterizationCache
    from repro_torch.kernels import aig_sim as A
    from repro_torch.launch.cim_explore import yield_summary

    t_phase = time.time()
    cache = CharacterizationCache(warm_dir)
    for name, aig in suite.items():
        cache.store(aig.fingerprint(), cha[name])

    zero_launches()
    got, _, wall = run_cli(["--all", "--scale", "default", "--cache", warm_dir])
    check(list(got) == list(suite), f"CLI --all answered {list(got)}")
    for name in suite:
        check(got[name].table_row() == res[name].table_row(),
              f"CLI {name} row {got[name].table_row()} != phase 2's {res[name].table_row()}")
    check(k1_launches()["eval_mega"] == 0 and k1_launches()["sig_eval"] == 0,
          f"the warm CLI run launched K1: {k1_launches()}")
    print(f"CLI warm --all: {len(got)} Table-I rows equal phase 2's in {wall:.3f} s; "
          f"K1 launches {json.dumps(k1_launches())}")

    zero_launches()
    got, _, wall = run_cli(["--circuit", "log2", "--scale", "default", "--cache", cold_dir])
    check(got["log2"].table_row() == res["log2"].table_row(),
          f"CLI cold log2 row {got['log2'].table_row()} != phase 2's")
    check(all(A.TIER_LAUNCHES[w] > 0 for w in (1, 32, 512)),
          f"the cold CLI run missed a word tier: {dict(A.TIER_LAUNCHES)}")
    print(f"CLI cold log2: row equals phase 2's in {wall:.3f} s; K1 launches "
          f"{json.dumps(k1_launches())}")

    zero_launches()
    got, out, wall = run_cli(["--circuit", "log2", "--scale", "default", "--cache", warm_dir,
                              "--model-sweep", "mc", "--model-variants", str(MC_VARIANTS),
                              "--model-sigma", "0.1"])
    var, want = got["log2"].variation, fused["log2"].variation
    check(var.winners == want.winners, "CLI MC sweep: log2 winners != phase 3's")
    lines = out.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("  model sweep"))
    check(lines[start:] == yield_summary(want),
          "CLI MC sweep: log2 yield summary != phase 3's")
    check(k1_launches()["eval_mega"] == 0, "the warm CLI MC sweep launched K1")
    print("\n".join(lines[start:start + 2]))
    print(f"CLI MC sweep: log2 x {var.n_variants} variants, yield summary equals phase "
          f"3's, in {wall:.3f} s; K1 launches {json.dumps(k1_launches())}")
    wall = time.time() - t_phase
    print(f"CLI phase: wall {wall:.3f} s")
    return wall


# ---------------------------------------------------------------------------
# Phase 8: the chaos matrix on the card, and the journal's overhead
# ---------------------------------------------------------------------------


def phase_chaos():
    """`python -m repro_torch.launch.chaos --device cuda` in process: all
    13 scenarios must recover with parity, none skipped."""
    from repro_torch.launch import chaos

    t = time.time()
    zero_launches()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            failures = chaos.main(["--device", "cuda"])
    finally:
        print(buf.getvalue(), end="")
    text = buf.getvalue()
    n = len(chaos._SCENARIOS)
    check(failures == 0, f"chaos matrix: {failures} scenarios failed on the card")
    check(f"chaos matrix: {n}/{n} scenarios recovered with parity" in text,
          "chaos matrix: not every scenario was reported recovered")
    check(text.count("\nok   ") == n and "skipped" not in text,
          "chaos matrix: a scenario was skipped or not reported")
    wall = time.time() - t
    print(f"chaos phase: {n}/{n} scenarios recovered with parity on the card in "
          f"{wall:.3f} s; K1 launches {json.dumps(k1_launches())}")
    return wall


JOURNAL_SHARD_SIZE = 2
#: the reference's gate on the journal's machinery overhead, percent of
#: the warm full-suite sweep (benchmarks/bench_faults.py)
JOURNAL_GATE_PCT = 2.0


def journal_overhead(dev, suite, cache_dir, work):
    """The journal's machinery overhead as the reference's fault bench
    defines it: N ``save()`` + durable-publish cycles of a real shard
    payload through `CheckpointManager` (WAL layout, deferred snapshot,
    the closing drain charged to the loop), divided by N, times the
    shard count, over the median plain warm full-suite sweep (every
    recipe, the 12 topologies, shards of two circuits)."""
    import statistics

    import torch
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.core.sram import TOPOLOGY_LIBRARY
    from repro_torch.core.sweep_runner import SweepRunner
    from repro_torch.core.transforms import enumerate_recipes
    from repro_torch.runtime import faults

    recipes = enumerate_recipes()

    def sweep(journal_dir):
        t = time.perf_counter()
        SweepRunner(journal_dir, JOURNAL_SHARD_SIZE).run(
            suite, sram_list=TOPOLOGY_LIBRARY, recipes=recipes, cache=cache_dir,
            n_jobs=1, device=dev,
        )
        torch.cuda.synchronize()
        return time.perf_counter() - t

    sweep(None)  # warm-up
    plain = [sweep(None) for _ in range(9)]
    plain_s = statistics.median(plain)
    # a real shard payload: crash a journaled sweep after two shards
    n_shards = -(-len(suite) // JOURNAL_SHARD_SIZE)
    journal = f"{work}/crashed"
    with faults.injected(faults.FaultRule("sweep.shard", "raise", after=n_shards // 2)):
        try:
            sweep(journal)
        except faults.FaultError:
            pass
        else:
            fail("the sweep.shard fault did not stop the journaled sweep")
    arrays, meta0 = CheckpointManager(journal).load_arrays(0)
    payload = {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}
    mdir = f"{work}/machinery"
    os.makedirs(mdir)
    open(os.path.join(mdir, "journal.wal"), "ab").close()
    mgr = CheckpointManager(mdir, keep_n=1 << 30, async_save=True, wal=True,
                            defer_snapshot=True)
    torch.cuda.synchronize()
    n_pub, best, step = 12, float("inf"), 0
    for _ in range(10):  # short trials, best wins (as the reference bench)
        t = time.perf_counter()
        for _ in range(n_pub):
            mgr.save(step, payload, meta=meta0.get("meta", {}))
            step += 1
        mgr.wait()
        best = min(best, (time.perf_counter() - t) / n_pub)
    pct = 100.0 * best * n_shards / plain_s
    print(
        f"journal machinery_overhead_pct {pct:.4f} (reference gate < {JOURNAL_GATE_PCT}%): "
        f"publish {1e3 * best:.4f} ms x {n_shards} shards over the median plain warm "
        f"full-suite sweep {plain_s:.4f} s (sweeps "
        + ", ".join(f"{x:.4f}" for x in plain) + " s)"
    )


# ---------------------------------------------------------------------------
# Phase 9: workload pricing and the rCiM-vs-roofline comparison
# ---------------------------------------------------------------------------

SYSTEM_HBM_SWEEP = (4e11, 8e11, 1.6e12)
#: operand widths of each primitive tile, in PI order
TILE_WIDTHS = {"mac8": (8, 8, 16), "add16": (16, 16), "max8": (8, 8)}
SYSTEM_RTOL = 1e-12
SYSTEM_REPS = 50


def same_record(got, want, msg: str, path: str = "") -> None:
    """Same structure and value types; floats within ``SYSTEM_RTOL``,
    everything else (winners, bottlenecks, counts, flags) identical."""
    check(type(got) is type(want), f"{msg}: {path} is {type(got).__name__}, "
                                   f"want {type(want).__name__}")
    if isinstance(want, dict):
        check(list(got) == list(want), f"{msg}: {path} keys {list(got)} != {list(want)}")
        for k in want:
            same_record(got[k], want[k], msg, f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        check(len(got) == len(want), f"{msg}: {path} has {len(got)} entries, want {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            same_record(g, w, msg, f"{path}[{i}]")
    elif isinstance(want, float):
        check(abs(got - want) <= SYSTEM_RTOL * abs(want),
              f"{msg}: {path} = {got!r}, want {want!r} (rtol {SYSTEM_RTOL})")
    else:
        check(got == want, f"{msg}: {path} = {got!r}, want {want!r}")


def scalar_tiles(model, mode: str, discipline: str) -> dict:
    """Per primitive tile, the port's scalar back half over the 12
    topologies (`mapping.schedule_stats` + `sram.evaluate`, winner by
    the numpy `batch.select_best_batch`): ``{tile: (topology name,
    energy nJ, latency ns)}``."""
    import numpy as np
    from repro_torch.core import workloads as W
    from repro_torch.core.batch import select_best_batch
    from repro_torch.core.mapping import schedule_stats
    from repro_torch.core.sram import TOPOLOGY_LIBRARY, evaluate

    out = {}
    for name, stats in W.primitive_stats().items():
        mets, fits = [], []
        for topo in TOPOLOGY_LIBRARY:
            sched = schedule_stats(stats, topo, discipline=discipline)
            mets.append(evaluate(sched, topo, model, mode))
            fits.append(sched.fits)
        i = int(select_best_batch(np.array([[m.energy_nj for m in mets]]), np.array([fits]))[0])
        out[name] = (TOPOLOGY_LIBRARY[i].name, float(mets[i].energy_nj),
                     float(mets[i].latency_ns))
    return out


def scalar_priced(lowered, tiles, n_units: int) -> dict:
    """What `evaluate_lowered(...).as_dict()` must give, from the scalar
    path's tile metrics, summed per layer in `evaluate_lowered`'s order."""
    e_nj = {p: e for p, (_, e, _) in tiles.items()}
    t_ns = {p: t for p, (_, _, t) in tiles.items()}
    per_layer, total_e, total_t = [], 0.0, 0.0
    for layer in lowered.layers:
        le = sum(n * e_nj[p] for p, n in layer.tiles.items()) * 1e-9
        lt = sum(n * t_ns[p] for p, n in layer.tiles.items()) * 1e-9 / n_units
        per_layer.append(dict(kind=layer.kind, count=layer.count,
                              tiles={k: int(v) for k, v in layer.tiles.items()},
                              energy_per_token_j=le * layer.count,
                              latency_per_token_s=lt * layer.count))
        total_e += le * layer.count
        total_t += lt * layer.count
    return dict(
        arch=lowered.arch, shape=lowered.shape, n_units=n_units,
        winners={p: w for p, (w, _, _) in tiles.items()}, tile_energy_nj=e_nj,
        tile_latency_ns=t_ns,
        tiles_per_token={k: int(v) for k, v in lowered.tiles_per_token().items()},
        per_layer=per_layer, energy_per_token_j=total_e, latency_per_token_s=total_t,
    )


def tile_operands(name: str, rng):
    """(PI bits (n_pis, N_VECTORS), expected output integers) for random
    operands of the primitive tile ``name``."""
    import numpy as np

    widths = TILE_WIDTHS[name]
    vals = [rng.integers(0, 1 << w, N_VECTORS, dtype=np.int64) for w in widths]
    bits = np.concatenate([(v[None, :] >> np.arange(w)[:, None]) & 1
                           for v, w in zip(vals, widths)]).astype(np.uint8)
    if name == "mac8":
        want = (vals[0] * vals[1] + vals[2]) % 65536
    elif name == "add16":
        want = (vals[0] + vals[1]) % 65536
    else:
        want = np.maximum(vals[0], vals[1])
    return bits, want


def profiled_device_ms(fn) -> "tuple[int, float] | None":
    """(CUDA kernels, summed device ms) of one ``fn()`` under
    `torch.profiler`; None where the profiler shows no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernel_us = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
    return (len(kernel_us), sum(kernel_us) / 1e3) if kernel_us else None


def phase_system(dev, rng):
    """`launch.system.compare_system` on the card for every runnable zoo
    cell at published size, `evaluate_lowered` in both modes and both
    disciplines, the three tiles through K2, and one cell's CLI run."""
    import statistics

    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core import workloads as W
    from repro_torch.kernels import cim_logic as K
    from repro_torch.kernels import ops
    from repro_torch.launch import system as S
    from repro_torch.models.config import SHAPES

    t_phase = time.time()
    zero_launches()
    cells = configs.runnable_cells()
    check(len(cells) == 33, f"{len(cells)} runnable zoo cells, want 33")
    tiles = scalar_tiles(None, "physical", "list")
    recs, card_ms = {}, []
    for arch, shape in cells:
        t = time.perf_counter()
        rec = S.compare_system(arch, shape, device="cuda", hbm_bw_sweep=SYSTEM_HBM_SWEEP)
        torch.cuda.synchronize()
        card_ms.append(1e3 * (time.perf_counter() - t))
        msg = f"system {arch}/{shape}"
        same_record(rec, S.compare_system(arch, shape, device="cpu",
                                          hbm_bw_sweep=SYSTEM_HBM_SWEEP), f"{msg}: cuda != cpu")
        lowered = W.lower_config(configs.get_config(arch), SHAPES[shape])
        same_record(rec["rcim"], scalar_priced(lowered, tiles, 8192),
                    f"{msg}: rcim != the scalar path")
        check(rec["conserved"], f"{msg}: the lowering does not conserve its ops")
        mem = rec["bw_sweep"]["memory_s"]
        check(all(a > b for a, b in zip(mem, mem[1:])),
              f"{msg}: bw_sweep.memory_s {mem} is not strictly decreasing")
        json.dumps(rec)
        recs[(arch, shape)] = rec
    print(f"system: {len(cells)} runnable zoo cells at published size, records on the card "
          f"equal the CPU's and the scalar path's; compare_system on the card "
          f"{card_ms[0]:.3f} ms for the first cell, median {statistics.median(card_ms[1:]):.3f} "
          f"ms (min {min(card_ms[1:]):.3f}, max {max(card_ms[1:]):.3f}) over the other "
          f"{len(cells) - 1}; tile winners "
          f"{json.dumps({p: w for p, (w, _, _) in tiles.items()})} in every cell")
    for (arch, shape), rec in recs.items():
        r, b = rec["rcim"], rec["baseline"]
        print(f"  {arch} {shape}: rcim {r['energy_per_token_j']!r} J "
              f"{r['latency_per_token_s']!r} s/token; baseline {b['energy_per_token_j']!r} J "
              f"{b['latency_per_token_s']!r} s/token ({b['bottleneck']})")

    # Both modes and both disciplines on one cell.
    lowered = W.lower_config(configs.get_config("mamba2-780m"), SHAPES["decode_32k"])
    for mode in ("physical", "paper"):
        for discipline in ("list", "levels"):
            msg = f"evaluate_lowered mamba2-780m/decode_32k {mode}/{discipline}"
            got = W.evaluate_lowered(lowered, mode=mode, discipline=discipline,
                                     device="cuda").as_dict()
            same_record(got, W.evaluate_lowered(lowered, mode=mode, discipline=discipline,
                                                device="cpu").as_dict(), f"{msg}: cuda != cpu")
            same_record(got, scalar_priced(lowered, scalar_tiles(None, mode, discipline), 8192),
                        f"{msg}: != the scalar path")
            print(f"  {mode}/{discipline}: winners {json.dumps(got['winners'])}, "
                  f"{got['energy_per_token_j']!r} J/token")
    print("evaluate_lowered: both modes x both disciplines equal the CPU and the scalar path")

    # Times of the two entry points on the card (each call ends in a
    # device-to-host copy of its result; synchronized besides).
    cost = S.token_cost(configs.get_config("mamba2-780m"), SHAPES["decode_32k"])

    def mean_ms(fn):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(SYSTEM_REPS):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / SYSTEM_REPS

    def lowered_call():
        return W.evaluate_lowered(lowered, device="cuda")

    def sweep_call():
        return S.sweep_roofline(cost, hbm_bw=SYSTEM_HBM_SWEEP, device="cuda")

    el_ms, sw_ms = mean_ms(lowered_call), mean_ms(sweep_call)
    el_cpu_ms = mean_ms(lambda: W.evaluate_lowered(lowered, device="cpu"))
    prof = profiled_device_ms(lowered_call)
    busy = ("not measured (the profiler showed no device time)" if prof is None else
            f"{prof[0]} CUDA kernels, {prof[1]:.4f} ms on the card "
            f"(busy share {prof[1] / el_ms:.4f})")
    print(f"evaluate_lowered {el_ms:.3f} ms per call on the card ({SYSTEM_REPS} calls, "
          f"synchronized; the same call on the host CPU {el_cpu_ms:.3f} ms): {busy}; "
          f"sweep_roofline {sw_ms:.3f} ms per call on the card")

    # The slice's end check: each tile's netlist through K2 at 2**16
    # operands, against integer arithmetic.
    k2 = {}
    for name in TILE_WIDTHS:
        net = W.primitive_aigs()[name].to_gate_netlist()
        bits, want = tile_operands(name, rng)
        out = ops.cim_evaluate(net, bits, device=dev)
        got = (out.astype(np.int64) << np.arange(out.shape[0])[:, None]).sum(axis=0)
        check(np.array_equal(got, want), f"{name} tile on K2: wrong outputs")
        k2[name] = (net, bits)
    launches = dict(K.LAUNCHES)
    check(launches["cim"] == len(TILE_WIDTHS), f"K2 launches in phase 9: {launches}")
    print(f"tiles on K2: mac8 (a*b + acc) mod 2^16, add16 (a + b) mod 2^16, max8 max(a, b) "
          f"exact at {N_VECTORS} random operands each; K2 launches {json.dumps(launches)}")
    print(f"K2 on the tiles (int32 rate {int32_ops_per_s():.4e} ops/s):")
    for name, (net, bits) in k2.items():
        cc, program, args, kw = k2_operands(dev, net, bits)
        k2_check(f"the {name} tile", cc, args, kw)
        bound = k2_bound(program, kw, args[1])
        ms = cuda_ms(lambda: K.cim_call(*args, **kw), 20)
        with global_memory(K):
            glob_ms = cuda_ms(lambda: K.cim_call(*args, **kw), 20)
        plain_ms = cuda_ms(lambda: K.cim_plain(*args, n_gates=cc.n_gates, n_pos=cc.n_pos), 1)
        print(k2_line(name, cc, program, bound, ms, glob_ms, plain_ms) + "; bit-equal to plain")

    # One cell's CLI run in process, on the card.
    arch, shape = "gemma3-27b", "decode_32k"
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rec = S.main(["--arch", arch, "--shape", shape, "--device", "cuda", "--hbm-sweep",
                      *map(str, SYSTEM_HBM_SWEEP)])
    cli_s = time.perf_counter() - t
    check(rec == recs[(arch, shape)], f"CLI {arch}/{shape}: record != phase 9's")
    check(json.loads(buf.getvalue()) == rec, f"CLI {arch}/{shape}: printed != returned")
    wall = time.time() - t_phase
    print(f"system CLI: {arch} {shape} record equals phase 9's in {cli_s:.3f} s")
    print(f"system phase: wall {wall:.3f} s")
    return wall


# ---------------------------------------------------------------------------
# Phase 10: the LM serving path (dense family) on the card
# ---------------------------------------------------------------------------

#: (a): minicpm-2b at published size, bf16, served as `launch.serve llm`
#: serves (q_chunk = kv_chunk = 64, greedy): two waves of 4 requests,
#: prompts of 32-128 tokens left-padded to 128, 32 new tokens each
LLM_ARCH = "minicpm-2b"
LLM_BATCH, LLM_REQUESTS, LLM_PROMPT_PAD, LLM_MAX_NEW = 4, 8, 128, 32
LLM_CHUNK = 64
#: the reference's own tolerances of decode against forward (fp32,
#: ``tests/test_models.py:53``): prefill logits, then each decode step
LLM_PREFILL_ATOL, LLM_DECODE_ATOL = 2e-3, 5e-3
#: (c): card against CPU, caches within this share of their own scale
LLM_CACHE_RTOL = 1e-3


def free() -> None:
    """Give a freed model's device memory back before the next is built."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def llm_model(cfg, dev, dtype, generator=None):
    """`Model` as `launch.serve llm` builds it, random-initialized from
    ``generator`` (seed 0 on ``dev`` by default).  In bf16 each leaf is
    drawn in fp32 and cast on its way in (`FP32_PARAMS` stay fp32), so the
    whole model is never held in fp32."""
    import torch
    from repro_torch.models.config import ParallelConfig
    from repro_torch.models.model import Model

    m = Model(cfg, ParallelConfig(), compute_dtype=dtype, q_chunk=LLM_CHUNK,
              kv_chunk=LLM_CHUNK, device=dev, param_dtype=dtype)
    return m.init(generator or torch.Generator(device=dev).manual_seed(0))


def timed_steps(model, dev):
    """Wrap the model's ``prefill`` and ``decode_step`` (instance
    attributes, so `ServeEngine` calls them) to record each call's
    milliseconds, synchronized on both sides, and count non-finite
    logits on the device after the clock stops."""
    import torch

    rec = dict(prefill=[], decode=[], bad=torch.zeros((), dtype=torch.int64, device=dev))

    def wrap(fn, key):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, caches = fn(*args)
            torch.cuda.synchronize()
            rec[key].append(1e3 * (time.perf_counter() - t))
            rec["bad"] += (~torch.isfinite(logits)).sum()
            return logits, caches
        return run

    model.prefill = wrap(model.prefill, "prefill")
    model.decode_step = wrap(model.decode_step, "decode")
    return rec


@contextlib.contextmanager
def routing_log():
    """Record every `layers.moe_route` result (one per MoE layer call) made
    inside the block."""
    from repro_torch.models import layers as L

    seen, route = [], L.moe_route

    def recording(*args):
        seen.append(route(*args))
        return seen[-1]

    L.moe_route = recording
    try:
        yield seen
    finally:
        L.moe_route = route


def dropped(routes) -> "tuple[int, int]":
    """(assignments dropped at capacity, routed assignments) of ``routes``."""
    return (sum(int((~r.keep).sum()) for r in routes), sum(r.keep.numel() for r in routes))


def step_state_bytes(cfg, kinds, pos: int) -> "tuple[int, int]":
    """(KV bytes read, recurrent bytes read and written) of one decode step
    at ``pos`` over the batch: an attention layer reads its valid bf16
    entries (positions 0..pos, at most ``window`` in a local one), a
    cross-attention layer besides them all ``enc_seq`` cross keys and
    values; a recurrent layer reads and writes its bf16 conv inputs and
    fp32 state."""
    kv = rec = 0
    for kind in kinds:
        if kind in ("attn", "local", "xattn"):
            n = min(pos + 1, cfg.window) if kind == "local" and cfg.window else pos + 1
            n += cfg.enc_seq if kind == "xattn" else 0
            kv += 2 * LLM_BATCH * n * cfg.n_kv_heads * cfg.resolved_head_dim * 2
        elif kind == "ssm":
            di = cfg.d_inner or 2 * cfg.d_model
            conv = (cfg.conv_width - 1) * (di + 2 * cfg.ssm_state) * 2
            rec += 2 * LLM_BATCH * (conv + di * cfg.ssm_state * 4)
        else:  # rglru
            w = cfg.lru_width or cfg.d_model
            rec += 2 * LLM_BATCH * ((cfg.conv_width - 1) * w * 2 + w * 4)
    return kv, rec


def lm_extras(cfg, b: int, rng) -> dict:
    """The inputs a config reads besides the tokens, drawn from ``rng``:
    encoder frames (B, enc_seq, d_model) or image patches (B, n_patches,
    d_model), fp32 numpy ({} for a decoder-only config)."""
    import numpy as np

    out = {}
    if cfg.is_encoder_decoder:
        out["frames"] = rng.standard_normal((b, cfg.enc_seq, cfg.d_model), dtype=np.float32)
    if cfg.n_patches:
        out["patches"] = rng.standard_normal((b, cfg.n_patches, cfg.d_model), dtype=np.float32)
    return out


def on(dev, extra: dict) -> dict:
    import torch

    return {k: torch.as_tensor(v, device=dev) for k, v in extra.items()}


def llm_serve(dev, cfg):
    """(a): two serves of the same 8 requests at published size in bf16,
    as `launch.serve llm` serves them; a config that reads frames or
    patches is served wave by wave through ``ServeEngine.generate(...,
    extra_batch=)`` (the reference's entry for it; ``serve`` refuses it),
    each wave's inputs drawn from seed 0."""
    import statistics

    import numpy as np
    import torch
    from repro_torch.models.model import keeps_fp32
    from repro_torch.serve.engine import Request, ServeEngine

    t = time.perf_counter()
    model = llm_model(cfg, dev, torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    param_bytes = sum(p.numel() * p.element_size() for p in params.values())
    wrong = [n for n, p in params.items()
             if p.dtype != (torch.float32 if keeps_fp32(n) else torch.bfloat16)]
    check(not wrong, f"{cfg.name}: params neither bf16 nor (FP32_PARAMS) fp32: {wrong[:4]}")
    n_fp32 = sum(p.dtype == torch.float32 for p in params.values())
    max_seq = LLM_PROMPT_PAD + LLM_MAX_NEW
    engine = ServeEngine(model, batch=LLM_BATCH, max_seq=max_seq, temperature=0.0, device=dev)
    rng = np.random.default_rng(0)
    lens = rng.integers(32, LLM_PROMPT_PAD + 1, size=LLM_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    rng_x = np.random.default_rng(0)
    waves = [prompts[w:w + LLM_BATCH] for w in range(0, LLM_REQUESTS, LLM_BATCH)]
    extras = [lm_extras(cfg, LLM_BATCH, rng_x) for _ in waves]
    npch = cfg.n_patches

    def padded(wave):
        out = np.zeros((LLM_BATCH, LLM_PROMPT_PAD), np.int32)
        for i, p in enumerate(wave):
            out[i, LLM_PROMPT_PAD - len(p):] = p  # left-pad, as serve() does
        return out

    runs = []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats()
        rec = timed_steps(model, dev)
        t = time.perf_counter()
        if extras[0]:
            toks = np.concatenate([engine.generate(padded(w), LLM_MAX_NEW, extra_batch=x)
                                   for w, x in zip(waves, extras)])
        else:
            reqs = [Request(uid=i, prompt=p, max_new=LLM_MAX_NEW) for i, p in enumerate(prompts)]
            toks = np.array([r.out_tokens for r in engine.serve(reqs, prompt_pad=LLM_PROMPT_PAD)])
        rec["wall_s"] = time.perf_counter() - t
        rec["tokens"] = toks
        del model.prefill, model.decode_step  # back to the class's methods
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        runs.append(rec)
    for i, rec in enumerate(runs):
        toks = rec["tokens"]
        check(toks.shape == (LLM_REQUESTS, LLM_MAX_NEW), f"serve {i}: tokens {toks.shape}")
        check(((toks >= 0) & (toks < cfg.vocab_size)).all(),
              f"{cfg.name} serve {i}: a token outside [0, {cfg.vocab_size})")
        check(int(rec["bad"]) == 0, f"{cfg.name} serve {i}: {int(rec['bad'])} non-finite logits")
    check(np.array_equal(runs[0]["tokens"], runs[1]["tokens"]),
          f"{cfg.name}: a second serve of the same requests returned other tokens")

    # decode bytes bound: every param once (an MoE layer runs all its
    # experts over their capacity slots), the valid KV entries (mean over
    # the steps) and the recurrent states, the logits written
    states = [step_state_bytes(cfg, model.kinds, pos)
              for pos in range(npch + LLM_PROMPT_PAD, npch + max_seq - 1)]
    kv_bytes = statistics.mean(kv for kv, _ in states)
    rec_bytes = states[0][1]
    logit_bytes = LLM_BATCH * cfg.padded_vocab * 2
    step_bytes = param_bytes + kv_bytes + rec_bytes + logit_bytes
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    n_tok = int(runs[1]["tokens"].size)
    kinds = ",".join(dict.fromkeys(model.kinds))
    inputs = "".join(f"; {k} {tuple(x.shape)} per wave (seed 0)" for k, x in extras[0].items())
    if cfg.is_encoder_decoder:
        inputs += f", {cfg.n_enc_layers} encoder layers"
    print(f"llm (a) {cfg.name} at published size: {cfg.n_layers} layers ({kinds}), d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} padded "
          f"to {cfg.padded_vocab}{inputs}; {n_params} params ({param_bytes} B; bf16 but for "
          f"{n_fp32} FP32_PARAMS leaves), init + cast {init_s:.3f} s; {LLM_REQUESTS} requests "
          f"in {len(runs[1]['prefill'])} waves of {LLM_BATCH}, prompts {sorted(lens.tolist())} "
          f"left-padded to {LLM_PROMPT_PAD}, {LLM_MAX_NEW} new tokens each"
          f"{' (generate with extra_batch)' if extras[0] else ''}; every token in "
          f"[0, {cfg.vocab_size}), logits finite, the second serve's tokens equal the first's")
    for i, rec in enumerate(runs):
        dec = rec["decode"]
        print(f"  serve {i + 1}: prefill ms per wave "
              f"{', '.join(f'{x:.3f}' for x in rec['prefill'])}; decode ms per step p50 "
              f"{statistics.median(dec):.3f} max {max(dec):.3f} min {min(dec):.3f} over "
              f"{len(dec)} steps; {n_tok} tokens in {rec['wall_s']:.3f} s = "
              f"{n_tok / rec['wall_s']:.1f} tokens/s")
    p50 = statistics.median(runs[1]["decode"])
    print(f"  decode bytes bound {bound_ms:.4f} ms ({step_bytes:.0f} B a step: params "
          f"{param_bytes}, KV read {kv_bytes:.0f} mean"
          f"{' (self KV valid, cross KV whole)' if cfg.is_encoder_decoder else ''}, "
          f"recurrent states read + written "
          f"{rec_bytes}, logits {logit_bytes}); steady p50 is {p50 / bound_ms:.2f}x the "
          f"bound; peak device memory {runs[1]['peak_bytes']} B")
    if cfg.is_moe:
        idle = sum(p.numel() * p.element_size() for n, p in params.items()
                   if ".moe.we_" in n) * (cfg.n_experts - cfg.top_k) // cfg.n_experts
        print(f"  active-param bytes (not the bound: top-{cfg.top_k} of {cfg.n_experts} routed "
              f"experts per token, shared experts, attention, embeddings) "
              f"{param_bytes - idle}, {(param_bytes - idle) / HBM_BYTES_PER_S * 1e3:.4f} ms")

    # Device time of one wave's prefill and of its first decode step under
    # the profiler, against the host-clock times above; the first wave's
    # MoE routing.
    from repro_torch.serve.engine import align_prefill_caches

    tt = torch.as_tensor(padded(waves[0]), dtype=torch.int64, device=dev)
    batch = dict(tokens=tt, **on(dev, extras[0]))
    with torch.inference_mode():
        with routing_log() as routes:
            logits, caches = model.prefill(batch)
        caches = align_prefill_caches(model, caches, npch + LLM_PROMPT_PAD, npch + max_seq,
                                      LLM_BATCH)
        tok = logits.argmax(-1)
        pre = profiled_device_ms(lambda: model.prefill(batch))
        step = profiled_device_ms(lambda: model.decode_step(caches, tok, npch + LLM_PROMPT_PAD))
    if cfg.is_moe:
        n_drop, n_routed = dropped(routes)
        print(f"  MoE routing of the first wave's prefill: {len(routes)} MoE layers x "
              f"{LLM_BATCH * LLM_PROMPT_PAD} tokens x top-{cfg.top_k} = {n_routed} routed "
              f"assignments, capacity {routes[0].cap} per expert (factor "
              f"{cfg.capacity_factor}), {n_drop} dropped ({n_drop / n_routed:.4%})")
    p50_pre = statistics.median(runs[1]["prefill"])
    for what, prof, host_ms in (("prefill of one wave", pre, p50_pre), ("decode step", step, p50)):
        if prof is None:
            print(f"  profiler: no device events for the {what}: not measured")
            continue
        n, dev_ms = prof
        print(f"  profiler, {what}: {n} CUDA kernels, {dev_ms:.3f} ms on the card against "
              f"{host_ms:.3f} ms on the host clock (busy share {dev_ms / host_ms:.4f})")
    del engine, model
    free()


def decode_vs_forward(model, toks, plen, dev, extra=None):
    """Prefill ``toks[:, :plen]`` (with ``extra``'s frames or patches),
    align, decode the rest teacher-forced; the worst |decode - forward| of
    the prefill logits and of the steps, and the forward logits' largest
    magnitude."""
    import torch
    from repro_torch.serve.engine import align_prefill_caches

    b, s = toks.shape
    npch = model.cfg.n_patches
    tt = torch.as_tensor(toks, dtype=torch.int64, device=dev)
    ex = on(dev, extra or {})
    with torch.inference_mode():
        full, _ = model.forward(dict(tokens=tt, **ex))
        last, caches = model.prefill(dict(tokens=tt[:, :plen], **ex))
        caches = align_prefill_caches(model, caches, npch + plen, npch + s, batch=b)
        pre = float((last - full[:, plen - 1]).abs().max())
        worst = torch.zeros((), device=dev)
        for t in range(plen, s):
            logits, caches = model.decode_step(caches, tt[:, t], npch + t)
            worst = torch.maximum(worst, (logits - full[:, t]).abs().max())
        v = model.cfg.vocab_size
        return pre, float(worst), float(full[..., :v].abs().max())


def decode_checks(dev, cases, rng):
    """fp32 decode against the teacher-forced forward on the card, one
    ``(tag, config, batch, prompt, steps)`` case at a time.  An MoE case
    must drop nothing: decode equals the forward only without drops."""
    import torch

    for tag, c, b, plen, steps in cases:
        t = time.perf_counter()
        model = llm_model(c, dev, torch.float32)
        toks = rng.integers(0, c.vocab_size, (b, plen + steps))
        with routing_log() as routes:
            pre, worst, scale = decode_vs_forward(model, toks, plen, dev, lm_extras(c, b, rng))
        n_params = sum(p.numel() for p in model.parameters())
        kinds = "".join(k[0] for k in model.kinds)
        del model
        free()
        n_drop, n_routed = dropped(routes)
        moe = (f"; MoE capacity factor {c.capacity_factor:.4f}, {n_drop} of {n_routed} routed "
               f"assignments dropped" if c.is_moe else "")
        print(f"llm {tag} {c.name} fp32, {c.n_layers} layers ({kinds}), d_model {c.d_model}, "
              f"{n_params} params, window {c.window}: batch {b}, prompt {plen}, {steps} "
              f"decode steps against the teacher-forced forward over {plen + steps} tokens: "
              f"worst |diff| prefill {pre:.3e} (tol {LLM_PREFILL_ATOL}), decode {worst:.3e} "
              f"(tol {LLM_DECODE_ATOL}); max |logit| {scale:.4f}{moe}; "
              f"{time.perf_counter() - t:.3f} s")
        check(n_drop == 0, f"llm {tag} {c.name}: {n_drop} MoE assignments dropped")
        check(pre <= LLM_PREFILL_ATOL,
              f"llm {tag} {c.name}: prefill logits {pre} off the forward's")
        check(worst <= LLM_DECODE_ATOL,
              f"llm {tag} {c.name}: decode logits {worst} off the forward's")


def card_vs_cpu(dev, c, rng, tag, b, plen, steps):
    """Full width, fp32, one CPU init copied to the card: prefill logits,
    aligned caches (KV, conv inputs, recurrent states) and teacher-forced
    decode steps.  An MoE config's routing (expert ids and keep mask of
    every MoE layer call) must be equal first; the smallest top-k margin
    on the CPU tells a near-tie flip from a fault."""
    import torch
    from repro_torch.serve.engine import align_prefill_caches

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    host = llm_model(c, cpu, torch.float32, torch.Generator().manual_seed(0))
    card = llm_model(c, dev, torch.float32)
    card.load_state_dict(host.state_dict())
    toks = rng.integers(0, c.vocab_size, (b, plen + steps))
    extra, npch = lm_extras(c, b, rng), c.n_patches
    out = {}
    for name, m in (("cpu", host), ("card", card)):
        tt = torch.as_tensor(toks, dtype=torch.int64, device=m.device)
        with torch.inference_mode(), routing_log() as routes:
            last, caches = m.prefill(dict(tokens=tt[:, :plen], **on(m.device, extra)))
            caches = align_prefill_caches(m, caches, npch + plen, npch + plen + steps, batch=b)
            aligned = [{k: x.to("cpu", copy=True) for k, x in layer.items()}
                       for layer in caches]  # decode_step writes in place
            logits = [last.cpu()]
            for t in range(plen, plen + steps):
                lg, caches = m.decode_step(caches, tt[:, t], npch + t)
                logits.append(lg.cpu())
        out[name] = (torch.stack(logits), aligned, routes)
    (lg_cpu, c_cpu, r_cpu), (lg_card, c_card, r_card) = out["cpu"], out["card"]
    moe = ""
    if c.is_moe:
        check(len(r_cpu) == len(r_card),
              f"llm {tag} {c.name}: MoE calls {len(r_cpu)} != {len(r_card)}")
        margin = min(float((p[..., c.top_k - 1] - p[..., c.top_k]).min())
                     for p in (torch.sort(r.probs, dim=-1, descending=True).values for r in r_cpu))
        n_moe = sum("moe" in layer for layer in host.layers)
        n_drop, n_routed = dropped(r_cpu[:n_moe])
        moe = (f"; routing equal in all {len(r_cpu)} MoE layer calls, smallest top-{c.top_k} "
               f"margin on the CPU {margin:.3e}; prefill capacity {r_cpu[0].cap} (factor "
               f"{c.capacity_factor}), {n_drop} of {n_routed} assignments dropped")
        for i, (x, y) in enumerate(zip(r_card, r_cpu)):
            check(torch.equal(x.expert_idx.cpu(), y.expert_idx)
                  and torch.equal(x.keep.cpu(), y.keep),
                  f"llm {tag} {c.name}: MoE call {i} routes differently on the card (smallest "
                  f"top-k margin on the CPU {margin:.3e})")
    pre = float((lg_card[0] - lg_cpu[0]).abs().max())
    worst = float((lg_card[1:] - lg_cpu[1:]).abs().max())
    cache_rel = max(float((x[k] - y[k]).abs().max() / y[k].abs().max())
                    for x, y in zip(c_card, c_cpu) for k in y)
    scale = float(lg_cpu[..., :c.vocab_size].abs().max())
    kinds = "".join(k[0] for k in host.kinds)
    names = sorted({k for layer in c_cpu for k in layer})
    print(f"llm {tag} {c.name} fp32 at depth {c.n_layers} ({kinds}), full width, card against "
          f"CPU (one CPU init): batch {b}, prompt {plen}"
          f"{''.join(f', {k} {tuple(x.shape)}' for k, x in extra.items())}, {steps} "
          f"teacher-forced decode steps, caches {'/'.join(names)}: "
          f"worst |card - cpu| prefill {pre:.3e} (tol {LLM_PREFILL_ATOL}), decode {worst:.3e} "
          f"(tol {LLM_DECODE_ATOL}), aligned caches {cache_rel:.3e} of their scale (tol "
          f"{LLM_CACHE_RTOL}); max |logit| {scale:.4f}{moe}; {time.perf_counter() - t0:.3f} s")
    check(pre <= LLM_PREFILL_ATOL, f"llm {tag} {c.name}: prefill logits card vs cpu {pre}")
    check(worst <= LLM_DECODE_ATOL, f"llm {tag} {c.name}: decode logits card vs cpu {worst}")
    check(cache_rel <= LLM_CACHE_RTOL,
          f"llm {tag} {c.name}: aligned caches card vs cpu {cache_rel}")
    del host, card
    free()


def check_tf32_off():
    import torch

    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 matmuls are on: the fp32 checks would not be fp32")


def serve_cli_100m(dev, arch: str) -> str:
    """`launch.serve llm --preset 100m` in process; its first line."""
    from repro_torch.launch import serve as serve_cli

    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        serve_cli.main(["llm", "--arch", arch, "--preset", "100m", "--device", dev.type])
    lines = buf.getvalue().splitlines()
    check(lines and lines[0].startswith("served 8 requests, 128 tokens in "),
          f"llm {arch} --preset 100m: the CLI printed {lines[:1]}")
    free()
    return (f"`python -m repro_torch.launch.serve llm --arch {arch} --preset 100m --device "
            f"{dev.type}` in process, {time.perf_counter() - t:.3f} s: {lines[0]}")


#: (f)'s decode attention shapes: (name, batch, slots, KV heads, n_rep,
#: head_dim, pos).  The serving cells' layers at their last prompt
#: position, then two batches too small to fill the card, which the launch
#: plan splits into chunks (the second also by its scores' shared memory).
DECODE_ATTN_SHAPES = (
    ("minicpm-2b.serve", 32, 2176, 36, 1, 64, 2111),
    ("deepseek-moe-16b.serve", 256, 384, 16, 1, 128, 319),
    ("minicpm-2b at batch 2", 2, 2176, 36, 1, 64, 2111),
    ("deepseek-coder-33b at batch 1", 1, 8192, 8, 7, 128, 7999),
)
#: the shapes whose times make the kernel's row of the ``kernels`` line
DECODE_ATTN_CELLS = 2


def decode_attn_checks(dev) -> dict:
    """(f) The decode attention kernel (`layers.decode_attend_kernel`)
    against its plain version (`layers.decode_attend`) on the same bf16
    card tensors at `DECODE_ATTN_SHAPES`: caches bit-equal after the
    append, the output within `decode_attn.tolerance` of the plain one,
    and a launch that skips the oldest valid slot outside it.  Times per
    launch (CUDA events): the kernel, the plain version, PyTorch's
    ``scaled_dot_product_attention`` over the same valid slots as a
    yardstick only (no RoPE, no append; the port never calls it), and
    for the split shapes the kernel with the occupancy split off
    (``WAVES = 0``).  The bound reads the attended K and V once.  Returns
    the kernel row's times: the mean over the serving cells' shapes."""
    import math
    import types

    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attn as DA
    from repro_torch.models import layers as L

    rows = []
    for name, b, s, kv, n_rep, hd, pos in DECODE_ATTN_SHAPES:
        cfg = types.SimpleNamespace(n_heads=kv * n_rep, n_kv_heads=kv, window=0)
        g = torch.Generator(device=dev).manual_seed(pos)
        mk = lambda *shape: torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        q, kn, vn = mk(b, 1, kv * n_rep, hd), mk(b, 1, kv, hd), mk(b, 1, kv, hd)
        kern = dict(k=mk(b, s, kv, hd), v=mk(b, s, kv, hd))
        plain = {k: t.clone() for k, t in kern.items()}
        skip = {k: t.clone() for k, t in kern.items()}
        with torch.inference_mode():
            want = L.decode_attend(q, kn, vn, plain, cfg, "attn", 1e4, pos)
            got = L.decode_attend_kernel(q, kn, vn, kern, cfg, "attn", 1e4, pos)
            first, n = L.decode_window("attn", cfg, s, pos)
            off = DA.decode_attention(q, kn, vn, skip["k"], skip["v"],
                                      L.rope_inv_freq(hd, 1e4, dev), pos, first + 1, n - 1,
                                      1.0 / math.sqrt(hd))
        for c in ("k", "v"):
            check(torch.equal(kern[c].view(torch.int16), plain[c].view(torch.int16)),
                  f"llm (f) {name}: the kernel's {c} cache differs from the plain version's")
        tol = DA.tolerance(want, plain["v"])
        gap = (got.float() - want.float()).abs()
        share = float((gap / tol).max())
        planted = float(((off.float() - want.float()).abs() / tol).max())
        check(share <= 1.0, f"llm (f) {name}: the output is {share:.3f}x its tolerance off")
        check(planted > 1.0, f"llm (f) {name}: skipping the oldest slot stays within the "
                             f"tolerance ({planted:.3f}x)")
        MAX_ERR["decode_attn"] = max(MAX_ERR["decode_attn"], float(gap.max()))
        del plain, skip, want, off
        free()
        with torch.inference_mode():
            ms = cuda_ms(lambda: L.decode_attend_kernel(q, kn, vn, kern, cfg, "attn", 1e4, pos),
                         50)
            plain_ms = cuda_ms(lambda: L.decode_attend(q, kn, vn, kern, cfg, "attn", 1e4, pos),
                               5)
            qs = q.transpose(1, 2)  # (B, H, 1, D)
            ks, vs = kern["k"][:, :n].transpose(1, 2), kern["v"][:, :n].transpose(1, 2)
            library_ms = cuda_ms(
                lambda: F.scaled_dot_product_attention(qs, ks, vs, enable_gqa=n_rep > 1), 50)
            threads, n_split, _ = DA.plan(b, kv, n_rep, hd, 2, n, DA._sm_count(dev.index))
            unsplit = ""
            if n_split > 1:
                waves, DA.WAVES = DA.WAVES, 0
                try:
                    _, n_unsplit, _ = DA.plan(b, kv, n_rep, hd, 2, n, DA._sm_count(dev.index))
                    unsplit_ms = cuda_ms(
                        lambda: L.decode_attend_kernel(q, kn, vn, kern, cfg, "attn", 1e4, pos),
                        50)
                finally:
                    DA.WAVES = waves
                unsplit = (f"; without the occupancy split ({n_unsplit} chunk(s)) "
                           f"{unsplit_ms:.4f} ms")
        bound_ms = 2 * b * n * kv * hd * 2 / HBM_BYTES_PER_S * 1e3
        print(f"llm (f) decode attention, {name} (B {b}, {n} of {s} slots, {kv} KV heads x "
              f"{n_rep}, head_dim {hd}, bf16): caches bit-equal, output at most {share:.4f} "
              f"of its tolerance off (max |kernel - plain| {float(gap.max()):.3e}), the "
              f"oldest slot skipped {planted:.2f}x; {b * kv * n_split} blocks x {threads} "
              f"threads ({n_split} chunk(s)); {ms:.4f} ms a layer, bound {bound_ms:.4f} ms "
              f"({100 * bound_ms / ms:.1f}%), plain {plain_ms:.3f} ms, "
              f"scaled_dot_product_attention (yardstick) {library_ms:.4f} ms{unsplit}")
        rows.append(dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, library_ms=library_ms))
        del q, kn, vn, kern, got, gap, tol
        free()
    cells = rows[:DECODE_ATTN_CELLS]
    return {k: sum(r[k] for r in cells) / len(cells) for k in cells[0]}


def k1_k2_idle(phase: str) -> dict:
    from repro_torch.kernels import aig_sim as A
    from repro_torch.kernels import cim_logic as K

    launched = {**A.LAUNCHES, **K.LAUNCHES}
    check(not any(launched.values()), f"the {phase} launched a K1/K2 kernel: {launched}")
    return launched


def phase_llm(dev, rng):
    """The LM serving path of the dense family on the card: (a) minicpm-2b
    served at published size in bf16, (b) its decode against the forward
    in fp32, (c) card against CPU at depth 2, (d) gemma3-27b's ring cache
    at published width, (e) `launch.serve llm --preset 100m` in process.
    The path launches neither K1 nor K2 (their counts stay 0), and its
    decode attention is the hand kernel (`kernels.decode_attn`), whose
    launches (a)-(e) count; then (f), that kernel against its plain
    version (`decode_attn_checks`).  Returns the wall seconds and the
    kernel's times, with those launches."""
    import dataclasses

    from repro_torch.launch.train import build_model_config

    check_tf32_off()
    t_phase = time.time()
    zero_launches()
    cfg = build_model_config(LLM_ARCH, "full")
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab_size, cfg.padded_vocab)
          == (40, 2304, 36, 5760, 122_753, 122_880), f"{LLM_ARCH}: not the published size")
    llm_serve(dev, cfg)
    gemma = dataclasses.replace(build_model_config("gemma3-27b", "full"), n_layers=6)
    decode_checks(dev, [("(b)", cfg, 2, 128, 32), ("(d)", gemma, 1, 1088, 64)], rng)
    card_vs_cpu(dev, dataclasses.replace(cfg, n_layers=2), rng, "(c)", 2, 64, 16)
    print(f"llm (e) {serve_cli_100m(dev, LLM_ARCH)}")
    launched = k1_k2_idle("LM path")
    from repro_torch.kernels import decode_attn as DA

    served = DA.LAUNCHES["decode_attn"]
    check(served > 0, "the LM path launched no decode attention kernel")
    times = dict(decode_attn_checks(dev), launches=served)
    wall = time.time() - t_phase
    print(f"llm phase: wall {wall:.3f} s; K1/K2 launches {json.dumps(launched)}; decode "
          f"attention launches {served} in (a)-(e)")
    return wall, times


# ---------------------------------------------------------------------------
# Phase 11: LM serving for the MoE and recurrent families on the card
# ---------------------------------------------------------------------------

#: (a)'s archs, served at published size with phase 10's mix, and the
#: (n_layers, d_model, vocab_size) each config must have
LLM11_ARCHS = {
    "deepseek-moe-16b": (28, 2048, 102_400),
    "recurrentgemma-9b": (38, 4096, 256_000),
    "mamba2-780m": (48, 1536, 50_280),
}
#: (d): every new arch through the CLI; moonshot-v1-16b-a3b (57 GB in bf16)
#: is served on the card at this preset only
LLM11_CLI_ARCHS = (*LLM11_ARCHS, "moonshot-v1-16b-a3b")


def phase_llm11(dev, rng):
    """The MoE and recurrent families on the card: (a) deepseek-moe-16b,
    recurrentgemma-9b and mamba2-780m served at published size in bf16;
    (b) fp32 decode against the forward (mamba2 at published size,
    recurrentgemma at published width over one pattern period with its
    ring rotated, deepseek at depth 3 with a dropless capacity factor);
    (c) card against CPU at full width and depth 2-3, the MoE at its
    published capacity factor with drops; (d) `launch.serve llm --preset
    100m` for the four new archs.  Neither K1 nor K2 is launched."""
    import dataclasses

    from repro_torch.launch.train import build_model_config

    check_tf32_off()
    t_phase = time.time()
    zero_launches()
    cfgs = {}
    for arch, size in LLM11_ARCHS.items():
        cfgs[arch] = cfg = build_model_config(arch, "full")
        check((cfg.n_layers, cfg.d_model, cfg.vocab_size) == size,
              f"{arch}: not the published size")
        llm_serve(dev, cfg)
    ds, rg, mb = (cfgs[a] for a in LLM11_ARCHS)
    decode_checks(dev, [
        ("(b)", mb, 2, 128, 64),
        # prompt 2,112 > window 2,048: the ring is rotated by 64
        ("(b)", dataclasses.replace(rg, n_layers=3), 1, 2112, 32),
        # dense layer 0 and two scanned MoE layers; capacity n_experts / top_k drops nothing
        ("(b)", dataclasses.replace(ds, n_layers=3, capacity_factor=ds.n_experts / ds.top_k),
         2, 128, 32),
    ], rng)
    # 4 x 64 tokens at capacity factor 1.25: capacity 30 against a mean load of 24
    card_vs_cpu(dev, dataclasses.replace(ds, n_layers=2), rng, "(c)", 4, 64, 16)
    card_vs_cpu(dev, dataclasses.replace(mb, n_layers=2), rng, "(c)", 2, 64, 16)
    card_vs_cpu(dev, dataclasses.replace(rg, n_layers=3), rng, "(c)", 2, 64, 16)
    for arch in LLM11_CLI_ARCHS:
        note = (" (held on the CPU at smoke size and on the card at this preset only: 57 GB "
                "in bf16 at published size)" if arch not in LLM11_ARCHS else "")
        print(f"llm (d) {serve_cli_100m(dev, arch)}{note}")
    launched = k1_k2_idle("MoE/recurrent LM path")
    wall = time.time() - t_phase
    print(f"llm11 phase: wall {wall:.3f} s; K1/K2 launches {json.dumps(launched)}")
    return wall


# ---------------------------------------------------------------------------
# Phase 12: whisper-tiny and internvl2-2b served, and the training path
# ---------------------------------------------------------------------------

#: (a)'s archs at published size: (n_layers, d_model, vocab_size, params)
LLM12_ARCHS = {
    "whisper-tiny": (4, 384, 51_865, 42_265_344),
    "internvl2-2b": (24, 2048, 92_553, 1_707_182_080),
}
#: (d): the launcher's default arch at published size, and its run
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "minicpm-2b", 4, 128, 6
#: (d): card against CPU, one train step: each grad leaf within this share
#: of its own scale (the CPU tests' tolerance against the reference) or
#: within ULP_FACTOR times the CPU grads' largest change under ULP_BUMPS
#: one-ulp moves of every param, whichever is larger (`train_card_vs_cpu`)
TRAIN_GRAD_RTOL, ULP_FACTOR, ULP_BUMPS = 1e-3, 8.0, 3
#: H100 SXM dense bf16 peak (NVIDIA data sheet), FLOP/s
BF16_FLOPS = 989e12
#: (d)'s run of `train_full`: per-step losses, grad norms, lrs and ms, the
#: peak device bytes and one step's CUDA kernels (phase 15 (b) compares)
TRAIN_FULL: dict = {}


def spec_params(cfg) -> int:
    """Parameters of ``cfg``'s spec tree (computed from shapes, nothing
    allocated)."""
    import math

    from repro_torch.models import layers as L
    from repro_torch.models.model import build_segments, model_specs

    return sum(math.prod(s.shape) for _, s in L.tree_leaves(model_specs(cfg, build_segments(cfg))))


def run_train(argv) -> "tuple[dict, list[str]]":
    """`python -m repro_torch.launch.train ... --device cuda` in process;
    its result and printed lines."""
    from repro_torch.launch import train as train_cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = train_cli.main([*argv, "--device", "cuda"])
    return out, buf.getvalue().splitlines()


def finite_run(out, what: str) -> None:
    import math

    vals = out["losses"] + out["grad_norms"]
    check(vals and all(math.isfinite(v) for v in vals), f"{what}: a non-finite loss or grad norm")


def train_full(dev):
    """(d) minicpm-2b at published size through the launcher (fp32
    masters, bf16 compute, remat "block", AdamW, wsd): step times, loss
    and grad norm per step, peak memory; then one more step under the
    profiler (kernels and device ms against the host's step time)."""
    import statistics

    import torch
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.optim.adamw import AdamWConfig, constant_schedule
    from repro_torch.train.steps import make_train_step

    free()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out, lines = run_train(["--arch", TRAIN_ARCH, "--preset", "full", "--batch", str(TRAIN_BATCH),
                            "--seq", str(TRAIN_SEQ), "--schedule", "wsd",
                            "--steps", str(TRAIN_STEPS)])
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    finite_run(out, f"train {TRAIN_ARCH} full")
    model, params, state = out["model"], out["params"], out["opt_state"]
    cfg = model.cfg
    n_params = sum(p.numel() for p in params.values())
    check(n_params == 2_725_173_504, f"train {TRAIN_ARCH}: {n_params} params, not the published")
    state_bytes = sum(x.numel() * x.element_size() for x in params.values()) + sum(
        x.numel() * x.element_size() for k in ("m", "v") for x in state[k].values())
    ms = [1e3 * x for x in out["step_s"]]
    p50 = statistics.median(ms[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = 6 * n_params * tokens
    print(f"train (d) {TRAIN_ARCH} --preset full through `launch.train.main` on the card: "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab_size} padded to "
          f"{cfg.padded_vocab}; {n_params} params, fp32 masters + m + v {state_bytes} B, remat "
          f"{model.pc.remat}; batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, wsd, {TRAIN_STEPS} steps in "
          f"{wall:.3f} s (model init included)")
    for i, (l, g, lr, x) in enumerate(zip(out["losses"], out["grad_norms"], out["lrs"], ms)):
        print(f"  step {i}: loss {l:.6f} grad norm {g:.6f} lr {lr:.3e} {x:.3f} ms")
    print(f"  step ms p50 {p50:.3f} (steps 1-{TRAIN_STEPS - 1}; first {ms[0]:.3f}), "
          f"{tokens / p50 * 1e3:.1f} tokens/s; peak device memory {peak} B; 6 x params x "
          f"tokens = {flops:.4e} FLOP, {flops / BF16_FLOPS * 1e3:.4f} ms at the bf16 peak "
          f"({p50 / (flops / BF16_FLOPS * 1e3):.2f}x)")
    data = Pipeline(DataConfig(batch_per_host=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                               vocab_size=cfg.vocab_size))
    batch = on(dev, data.get_batch(TRAIN_STEPS))
    step = make_train_step(model, constant_schedule(out["lrs"][-1]), AdamWConfig())
    prof = profiled_device_ms(lambda: step(params, state, batch))
    if prof is None:
        print("  profiler: no device events for the train step: not measured")
    else:
        n, dev_ms = prof
        print(f"  profiler, one train step: {n} CUDA kernels, {dev_ms:.3f} ms on the card against "
              f"{p50:.3f} ms on the host clock (busy share {dev_ms / p50:.4f})")
    TRAIN_FULL.update(losses=out["losses"], grad_norms=out["grad_norms"], lrs=out["lrs"],
                      ms=ms, peak=peak, kernels=prof[0] if prof else None)
    del out, model, params, state, step
    free()


def train_resume(dev):
    """(d) `--preset 100m`: 8 steps straight against 4 steps with a
    checkpoint every 2 (device snapshots through ``defer_snapshot``) and
    a ``--resume`` to 8: params, m, v and step bit-equal on this card, the
    resumed losses the straight run's, the loss falling."""
    import torch

    t = time.perf_counter()
    # the writer thread may pre-create its next spool file after wait()
    # returns (`ckpt.manager._DirWriter._loop`): a late file, not an error
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_", ignore_cleanup_errors=True) as ck:
        straight, _ = run_train(["--preset", "100m", "--steps", "8"])
        first, _ = run_train(["--preset", "100m", "--steps", "4", "--ckpt-dir", ck,
                              "--ckpt-every", "2"])
        resumed, lines = run_train(["--preset", "100m", "--steps", "8", "--ckpt-dir", ck,
                                    "--ckpt-every", "2", "--resume"])
    for out, what in ((straight, "straight"), (first, "first 4"), (resumed, "resumed")):
        finite_run(out, f"train 100m {what}")
    check("resumed from step 4" in lines, f"train 100m resume: printed {lines[:3]}")
    check(resumed["losses"] == straight["losses"][4:],
          f"train 100m: resumed losses {resumed['losses']} != {straight['losses'][4:]}")
    diff = [n for n, p in straight["params"].items() if not torch.equal(resumed["params"][n], p)]
    diff += [f"{k}.{n}" for k in ("m", "v") for n, x in straight["opt_state"][k].items()
             if not torch.equal(resumed["opt_state"][k][n], x)]
    check(not diff, f"train 100m: resumed state != the uninterrupted run's: {diff[:4]}")
    check(int(resumed["opt_state"]["step"]) == int(straight["opt_state"]["step"]) == 8,
          "train 100m: the optimizer step is not 8")
    ls = straight["losses"]
    check(ls[-1] < ls[0], f"train 100m: the loss did not fall: {ls}")
    n_params = sum(p.numel() for p in straight["params"].values())
    print(f"train (d) {TRAIN_ARCH} --preset 100m ({n_params} params): 8 steps straight and 4 + "
          f"--resume to 8 with a checkpoint every 2 (defer_snapshot of device copies): params, "
          f"m, v and step bit-equal, losses equal ({', '.join(f'{x:.6f}' for x in ls)}); "
          f"{time.perf_counter() - t:.3f} s")
    del straight, first, resumed
    free()


def train_card_vs_cpu(dev, rng):
    """(d) One `make_train_step` of minicpm-2b at full width, depth 2,
    fp32, from one CPU init on the card and on the CPU, ``b1=0`` and no
    clipping (the first moment is then the grad).

    Random weights with the reference's fan-in quirk (std 1/sqrt(2) at
    depth 2, `ROADMAP.md` §3) make these grads ill-conditioned in fp32:
    the residual stream grows to about 1e4 over the embeddings' 0.1, and
    the norms' backward cancels.  So the grads are held against the CPU
    within the CPU's own sensitivity to rounding, measured in the same
    run: the worst leaf's change (share of its scale) when every param
    moves by one ulp (a random direction each, seeded; the largest of
    `ULP_BUMPS` such moves, since one move's reading varies about 3x),
    times `ULP_FACTOR`, and never tighter than `TRAIN_GRAD_RTOL`.  The loss
    within 1e-4; the updated params within 1e-6 wherever both grads have
    one sign and both |g| > 1e-4 (there AdamW's first step, ``lr * (g /
    (|g| + eps) + wd * p)``, differs by at most ``lr * eps / |g|`` = 3e-8
    between them); the sign flips are counted."""
    import dataclasses

    import torch
    from repro_torch.launch.train import build_model_config
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, constant_schedule
    from repro_torch.train.steps import make_train_step

    t0 = time.perf_counter()
    c = dataclasses.replace(build_model_config(TRAIN_ARCH, "full"), n_layers=2)
    cpu = torch.device("cpu")
    host = llm_model(c, cpu, torch.float32, torch.Generator().manual_seed(0))
    card = llm_model(c, dev, torch.float32)
    card.load_state_dict(host.state_dict())
    toks = rng.integers(0, c.vocab_size, (2, 65))
    batch = dict(tokens=toks[:, :-1], labels=toks[:, 1:])

    # the CPU grads' sensitivity to one ulp of every param
    g = torch.Generator().manual_seed(1)
    g_bumped = []
    for _ in range(ULP_BUMPS):
        bumped = {}
        for n, p in host.named_parameters():
            up = torch.rand(p.shape, generator=g) < 0.5
            bumped[n] = torch.nextafter(p.detach(), torch.where(up, torch.inf, -torch.inf)
                                        ).requires_grad_(True)
        loss_b, _ = host.loss_fn(on(cpu, batch), params=bumped)
        g_bumped.append(dict(zip(bumped, torch.autograd.grad(loss_b, list(bumped.values())))))
        del bumped, loss_b

    opt = AdamWConfig(b1=0.0, clip_norm=0.0)
    out = {}
    for name, m in (("cpu", host), ("card", card)):
        P = m.train_params()
        step = make_train_step(m, constant_schedule(3e-4), opt)
        P, state, metrics = step(P, adamw_init(P, opt), on(m.device, batch))
        out[name] = (float(metrics["loss"]), {n: x.cpu() for n, x in state["m"].items()},
                     {n: p.detach().cpu() for n, p in P.items()})
    (l_cpu, g_cpu, p_cpu), (l_card, g_card, p_card) = out["cpu"], out["card"]
    rel = lambda a, b: max(float((a[n] - x).abs().max()) / max(float(x.abs().max()), 1e-30)
                           for n, x in b.items())
    grad_rel = rel(g_card, g_cpu)
    ulp_rels = [rel(gb, g_cpu) for gb in g_bumped]
    ulp_rel = max(ulp_rels)
    tol = max(TRAIN_GRAD_RTOL, ULP_FACTOR * ulp_rel)
    param_err, flips, n_same = 0.0, 0, 0
    for n, x in g_cpu.items():
        same = (torch.sign(x) == torch.sign(g_card[n])) & (torch.minimum(
            x.abs(), g_card[n].abs()) > 1e-4)
        flips += int((torch.sign(x) != torch.sign(g_card[n])).sum())
        n_same += int(same.sum())
        if same.any():
            param_err = max(param_err, float((p_card[n] - p_cpu[n])[same].abs().max()))
    n_params = sum(x.numel() for x in p_cpu.values())
    print(f"train (d) {TRAIN_ARCH} fp32 at depth 2, full width ({n_params} params), one train "
          f"step, card against CPU (one CPU init, remat {host.pc.remat}): loss {l_card:.6f} vs "
          f"{l_cpu:.6f} (|diff| {abs(l_card - l_cpu):.3e}, tol 1e-4); worst grad leaf "
          f"{grad_rel:.3e} of its scale over {len(g_cpu)} leaves, against the CPU's one-ulp "
          f"sensitivity {', '.join(f'{x:.3e}' for x in ulp_rels)} (tol max({TRAIN_GRAD_RTOL}, "
          f"{ULP_FACTOR} x the largest) = "
          f"{tol:.3e}); updated params {param_err:.3e} (tol 1e-6) over the {n_same} entries "
          f"with one grad sign and both |g| > 1e-4, {flips} grad signs differ; "
          f"{time.perf_counter() - t0:.3f} s")
    check(abs(l_card - l_cpu) <= 1e-4, f"train card vs cpu: loss {l_card} vs {l_cpu}")
    check(grad_rel <= tol, f"train card vs cpu: grads {grad_rel} of scale (tol {tol})")
    check(param_err <= 1e-6, f"train card vs cpu: updated params {param_err}")
    del host, card, out, g_bumped
    free()


def phase_llm12(dev, rng):
    """whisper-tiny's encoder-decoder and internvl2-2b's patch prefix served
    on the card, and the training path: (a) both at published size in
    bf16 through ``generate(..., extra_batch=)``; (b) fp32 decode against
    the forward at published size; (c) the card against the CPU (whisper
    at published size, internvl2 at depth 2); (d) training through
    `launch.train.main`: minicpm-2b at published size, the 100m resume,
    whisper-tiny and internvl2-2b at 100m, one train step card against
    CPU.  Neither K1 nor K2 is launched."""
    import dataclasses

    from repro_torch.launch.train import build_model_config

    check_tf32_off()
    t_phase = time.time()
    zero_launches()
    cfgs = {}
    for arch, size in LLM12_ARCHS.items():
        cfgs[arch] = cfg = build_model_config(arch, "full")
        n = spec_params(cfg)
        check((cfg.n_layers, cfg.d_model, cfg.vocab_size, n) == size,
              f"{arch}: not the published size ({n} params)")
        llm_serve(dev, cfg)
    wh, vl = (cfgs[a] for a in LLM12_ARCHS)
    decode_checks(dev, [("(b)", wh, 2, 128, 32), ("(b)", vl, 2, 128, 32)], rng)
    card_vs_cpu(dev, wh, rng, "(c)", 2, 64, 16)
    card_vs_cpu(dev, dataclasses.replace(vl, n_layers=2), rng, "(c)", 2, 64, 16)
    train_full(dev)
    train_resume(dev)
    for arch in LLM12_ARCHS:
        t = time.perf_counter()
        out, _ = run_train(["--arch", arch, "--preset", "100m", "--steps", "3"])
        finite_run(out, f"train {arch} 100m")
        print(f"train (d) {arch} --preset 100m, zero {'frames' if out['model'].cfg.enc_seq else 'patches'}: "
              f"losses {', '.join(f'{x:.6f}' for x in out['losses'])}, grad norms "
              f"{', '.join(f'{x:.4f}' for x in out['grad_norms'])}; "
              f"{time.perf_counter() - t:.3f} s")
        del out
        free()
    train_card_vs_cpu(dev, rng)
    launched = k1_k2_idle("enc-dec/VLM serving and training path")
    wall = time.time() - t_phase
    print(f"llm12 phase: wall {wall:.3f} s; K1/K2 launches {json.dumps(launched)}")
    return wall


# ---------------------------------------------------------------------------
# Phase 13: the mesh explorer and its dry-run layer
# ---------------------------------------------------------------------------

#: (a) the CLI's default shape over the default grid, at published size
MESH_ARCH, MESH_SHAPE = "minicpm-2b", "train_4k"
#: (b) the reference's own dry-run test cell and an MoE arch, decode
MESH_SUITE = (("whisper-tiny", "decode_32k"), ("deepseek-moe-16b", "decode_32k"))
#: (d) a recurrent family's train cell at published width, depth cut by
#: half: the whole 48 layers traced in 154.7 s on the card's host, past
#: the phase's share of the script's time, 24 in 79.6 s (the cost is per
#: layer)
MESH_RECURRENT, MESH_RECURRENT_LAYERS = "mamba2-780m", 24
#: processes tracing the cells (the trace is single-threaded host work)
MESH_WORKERS = 8
#: PyTorch's CUDA caching allocator: the largest small-pool request and
#: the rounding of a large request's segment
ALLOC_SMALL, ALLOC_ROUND_LARGE = 1 << 20, 2 << 20


def mesh_records(out_dir: str, arch: str, shape: str) -> list[dict]:
    return [json.loads(f.read_text())
            for f in sorted(Path(out_dir).glob(f"{arch}__{shape}__*.json"))]


def print_cells(recs: list[dict]) -> None:
    for r in recs:
        rl = r["roofline"]
        print(f"  {r['tag']:32s} trace {r['lower_s']:6.1f} s  flops/dev {rl['flops']:.4e}  "
              f"hbm B/dev {rl['hbm_bytes']:.4e}  link B/dev {rl['link_bytes']:.4e} "
              f"{json.dumps(rl['coll_breakdown'])}  HBM {r['hbm_per_device_gb']:.3f} GB  "
              f"-> {rl['bottleneck']}")


def mesh_memory(dev) -> None:
    """(c): the dry-run's memory record of one decode step on a (1, 1)
    mesh against the same step on the card."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models.config import SHAPES
    from repro_torch.models.model import Model

    arch, shape = MESH_SUITE[0]
    s = SHAPES[shape]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mem_") as tmp:
        rec = run_cell(arch, shape, False, tmp, mesh_shape=(1, 1))
    mem = rec["memory"]
    free()
    base = torch.cuda.memory_allocated()
    model = Model(get_config(arch), device=dev, param_dtype=torch.bfloat16)
    model.init(torch.Generator(device=dev).manual_seed(0))
    caches = model.init_cache(s.global_batch, s.seq_len)
    token = torch.randint(0, model.cfg.vocab_size, (s.global_batch,), dtype=torch.int32,
                          device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    real_args = torch.cuda.memory_allocated() - base
    sizes = [t.nbytes for t in (*model.parameters(), *(t for c in caches for t in c.values()),
                                token)]
    est_args = mem["argument_size_in_bytes"]
    check(sum(sizes) == est_args,
          f"mesh (c): argument bytes {est_args} estimated, {sum(sizes)} on the card")
    # the caching allocator's rounding: 512 B blocks, and a large tensor's
    # block may keep the rest (under 1 MiB) of its 2 MiB-rounded segment
    slack = sum(512 if n <= ALLOC_SMALL else ALLOC_ROUND_LARGE for n in sizes)
    check(abs(real_args - est_args) <= slack,
          f"mesh (c): {real_args} B allocated for {est_args} B of arguments "
          f"({len(sizes)} tensors, rounding slack {slack} B)")
    n_args = len(sizes)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with torch.no_grad():
        logits, _ = model.decode_step(caches, token, s.seq_len - 1)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t
    check(bool(torch.isfinite(logits.float()).all()), "mesh (c): non-finite decode logits")
    peak = torch.cuda.max_memory_allocated()
    est = rec["hbm_per_device_gb"] * 2**30
    check(est >= est_args, f"mesh (c): estimate {est} below the arguments {est_args}")
    print(f"mesh (c) {arch} x {shape} on a (1, 1) mesh: trace {rec['lower_s']} s; estimate "
          f"arguments {est_args} B (the card's tensors {sum(sizes)} B, allocated "
          f"{real_args} B over {n_args} tensors), temp "
          f"{mem['temp_size_in_bytes']} B, donated {mem['alias_size_in_bytes']} B, HBM "
          f"{rec['hbm_per_device_gb']} GB; the real decode step: {step_s:.3f} s, "
          f"max_memory_allocated {peak} B ({peak / 2**30:.3f} GiB); estimate / card "
          f"{est / peak:.4f}")
    del model, caches, token, logits
    free()


def mesh_recurrent() -> None:
    """(d): the recurrent blocks' train step on a 16x16 mesh (it runs
    through `aten.softplus_backward`, which takes the port's sharding
    rule): a record with work, memory and the reference's keys."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.mesh_explorer import StepRecipe
    from repro_torch.launch.dryrun import run_cell

    cfg = get_config(MESH_RECURRENT)
    cut = dataclasses.replace(cfg, n_layers=MESH_RECURRENT_LAYERS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rec_") as tmp:
        t = time.time()
        rec = run_cell(MESH_RECURRENT, "train_4k", False, tmp, tag="base", mesh_shape=(16, 16),
                       overrides=dict(cfg=cut, **StepRecipe("base").overrides()))
        wall = time.time() - t
    rl, mem = rec["roofline"], rec["memory"]
    check(rec["n_chips"] == 256 and rl["flops"] > 0 and rl["hbm_bytes"] > 0
          and rec["n_collectives"] > 0,
          f"mesh (d): {MESH_RECURRENT} x train_4k traced no work or no collective")
    check(mem["temp_size_in_bytes"] > 0 and mem["argument_size_in_bytes"] > 0
          and mem["alias_size_in_bytes"] > 0 and rec["trip_counts"] == {"seg0": cut.n_layers},
          f"mesh (d): {MESH_RECURRENT} x train_4k has no memory record: {json.dumps(mem)}")
    print(f"mesh (d) {MESH_RECURRENT} x train_4k, base recipe, one 16x16 mesh, at published "
          f"width and depth {cut.n_layers} of {cfg.n_layers} (cut): trace {rec['lower_s']} s "
          f"(run_cell wall {wall:.3f} s); argument {mem['argument_size_in_bytes']} B, temp "
          f"{mem['temp_size_in_bytes']} B, donated {mem['alias_size_in_bytes']} B")
    print_cells([rec])


def phase_mesh(dev):
    """The mesh explorer and its dry-run layer: (a) `explore_mesh` at
    published size over the default grid, selection on the card against
    the CPU; (b) `explore_mesh_suite` over two decode workloads; (c) the
    dry-run's memory record against a real decode step; (d) a recurrent
    train cell.  Neither K1 nor K2 is launched."""
    import logging

    from repro_torch.core import mesh_explorer as MX
    from repro_torch.launch.roofline import model_flops
    from repro_torch.configs import get_config
    from repro_torch.models.config import SHAPES

    # DTensor warns at every multi-step redistribute; the costs hold them
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    t_phase = time.time()
    zero_launches()
    corners = MX.constant_corners()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        t = time.time()
        res = MX.explore_mesh(MESH_ARCH, MESH_SHAPE, out_dir=f"{tmp}/a", constant_sweep=corners,
                              device=dev, workers=MESH_WORKERS)
        sweep_s = time.time() - t
        recs = mesh_records(f"{tmp}/a", MESH_ARCH, MESH_SHAPE)
        grid = len(MX.DEFAULT_TOPOLOGIES) * len(MX.DEFAULT_RECIPES)
        check(len(res["sweep"]) == len(recs) == grid,
              f"mesh (a): {len(res['sweep'])} cells swept, {len(recs)} records, not {grid}")
        mf = model_flops(get_config(MESH_ARCH), SHAPES[MESH_SHAPE])
        for r in recs:
            check(r["roofline"]["model_flops_total"] == mf and r["n_chips"] in (256, 512),
                  f"mesh (a): {r['tag']} is not {MESH_ARCH} at published size")
            check(r["roofline"]["flops"] > 0 and r["n_collectives"] > 0,
                  f"mesh (a): {r['tag']} traced no work or no collective")
        print(f"mesh (a) explore_mesh {MESH_ARCH} x {MESH_SHAPE}: {grid} cells in "
              f"{sweep_s:.3f} s on {MESH_WORKERS} workers (trace s summed "
              f"{sum(r['lower_s'] for r in recs):.1f})")
        print_cells(recs)
        cpu = MX.explore_mesh(MESH_ARCH, MESH_SHAPE, out_dir=f"{tmp}/a", constant_sweep=corners,
                              device="cpu")
        check(res == cpu, "mesh (a): the card's selection differs from the CPU's")
        print(f"mesh (a) pick {json.dumps(res['best'])}; variant winners "
              f"{json.dumps(res['variation']['winners'])}, best_yield "
              f"{res['variation']['best_yield']} (card == CPU)")

        t = time.time()
        kw = dict(recipes=(MX.StepRecipe("base"),), out_dir=f"{tmp}/b", constant_sweep=corners)
        suite = MX.explore_mesh_suite(list(MESH_SUITE), device=dev, workers=MESH_WORKERS, **kw)
        suite_s = time.time() - t
        for arch, shape in MESH_SUITE:
            recs = mesh_records(f"{tmp}/b", arch, shape)
            check(len(recs) == len(MX.DEFAULT_TOPOLOGIES), f"mesh (b): {arch} has {len(recs)} cells")
            print(f"mesh (b) {arch} x {shape}: pick "
                  f"{json.dumps(suite['workloads'][f'{arch}/{shape}']['best'])}")
            print_cells(recs)
        check(suite == MX.explore_mesh_suite(list(MESH_SUITE), device="cpu", **kw),
              "mesh (b): the card's suite selection differs from the CPU's")
        print(f"mesh (b) explore_mesh_suite in {suite_s:.3f} s: global pick "
              f"{json.dumps(suite['best'])} (card == CPU)")
    mesh_memory(dev)
    mesh_recurrent()
    launched = k1_k2_idle("mesh explorer")
    wall = time.time() - t_phase
    print(f"mesh phase: wall {wall:.3f} s; K1/K2 launches {json.dumps(launched)}")
    return wall


# ---------------------------------------------------------------------------
# Phase 14: the device-discipline lint on the card
# ---------------------------------------------------------------------------


def phase_lint(dev):
    """(a) the AST layer over ``src/repro_torch``; (b) the graph layer on
    the card over every registered kernel: no new finding, the hand
    kernels' builders launch them, and every output equals the same
    builder's on the CPU; (c) `select_best_batch_device` on CUDA tensors:
    no host read, and the only transfer back is the winner payload."""
    import numpy as np
    import torch

    from repro_torch.analysis import ast_lint, graph_lint, registry
    from repro_torch.analysis.findings import load_baseline, split_baselined
    from repro_torch.core import batch as B

    t_phase = time.time()
    zero_launches()
    baseline = load_baseline(str(ROOT / "src" / "repro_torch" / "analysis" / "baseline.json"))
    t = time.time()
    findings = ast_lint.lint_paths([str(ROOT / "src" / "repro_torch")], root=str(ROOT))
    new, old = split_baselined(findings, baseline)
    check(not new, "lint (a): " + "; ".join(f.format() for f in new))
    print(f"lint (a) AST layer over src/repro_torch: {len(new)} new, {len(old)} baselined "
          f"finding(s) in {time.time() - t:.3f} s")

    launched = {}
    specs = registry.kernel_specs()
    t = time.time()
    for spec in specs:
        run = graph_lint.run_kernel(spec, dev)
        new, _ = split_baselined(graph_lint.findings_of(run), baseline)
        check(not new, f"lint (b): {spec.name}: " + "; ".join(f.format() for f in new))
        cpu = graph_lint.run_kernel(spec, "cpu")
        check(cpu.error is None and graph_lint.same_outputs(run.output, cpu.output),
              f"lint (b): {spec.name} on the card differs from the CPU")
        launched.update(run.launches)
        print(f"lint (b) {spec.module}.{spec.name}: {sum(run.ops.values())} aten ops "
              f"({len(run.ops)} kinds), syncs {run.syncs}, launches {json.dumps(run.launches)}; "
              f"card == CPU")
    graph_s = time.time() - t
    check(launched == {"eval_mega": 1, "sig_eval": 1, "cim": 1},
          f"lint (b): the hand kernels' builders launched {launched}")
    check(registry.launch_counts() == {"eval_mega": 1, "sig_eval": 1, "cim": 1,
                                       "decode_attn": 0},
          f"lint (b): the launch counters read {registry.launch_counts()}")

    rng = np.random.default_rng(7)
    host_energy = rng.random((4, 96))
    host_fits = np.ones((1, 96), dtype=bool)
    spec = registry.KernelSpec(
        name="select_best_batch_device", module="repro_torch.core.batch",
        build=lambda d: registry.KernelExample(
            fn=B.select_best_batch_device,
            args=(torch.from_numpy(host_energy).to(d), torch.from_numpy(host_fits).to(d)),
            kwargs=dict(device=d)))
    run = graph_lint.run_kernel(spec, dev)
    check(run.error is None and not run.escapes and not run.drift,
          f"lint (c): {run.error} {run.escapes} {run.drift}")
    check("aten._local_scalar_dense.default" not in run.ops,
          "lint (c): select_best_batch_device reads a device scalar on the host")
    check(run.transfers == [("aten._to_copy.default", (4,))],
          f"lint (c): transfers {run.transfers}, not the one (4,) winner payload")
    check(np.array_equal(run.output, B.select_best_batch(host_energy, host_fits)),
          "lint (c): select_best_batch_device's winners differ from the host filter's")
    wall = time.time() - t_phase
    print(f"lint (c) select_best_batch_device on (4, 96) CUDA operands: "
          f"{sum(run.ops.values())} aten ops, no host read, one transfer {run.transfers}")
    print(f"lint phase: wall {wall:.3f} s (graph layer over {len(specs)} kernels, card and "
          f"CPU, {graph_s:.3f} s); launches {json.dumps(launched)}")
    return wall


# ---------------------------------------------------------------------------
# Phase 15: the tables on the card, and training on a host mesh
# ---------------------------------------------------------------------------

#: calls timed per table entry point (each after one warm-up call)
TABLE_REPS = 5
#: (b): the torchrun run's steps (its wsd learning rates are those of phase
#: 12 (d)'s first three steps: 0, then the peak)
MESH_TRAIN_STEPS = 3


def ms_per_call(fn, reps: int = TABLE_REPS) -> float:
    """Host-clock ms of one ``fn()`` (each call ends in its read-back)."""
    fn()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) / reps * 1e3


def tables_on_card(dev, suite, cha, res, mc) -> None:
    """(a) `schedule_suite` / `schedule_batch` on the card in both
    disciplines over phase 2's characterization: equal to the CPU's, to
    `mapping.schedule_stats` cell by cell and (list) to phase 2's fused
    back half; `table2_batch` against `sram.table2_metrics` for the
    nominal model and phase 3's 1024-variant table."""
    import numpy as np
    from repro_torch.core import batch as B
    from repro_torch.core.mapping import schedule_stats
    from repro_torch.core.sram import TOPOLOGY_LIBRARY, EnergyModel, table2_metrics

    table = B.SuiteTable.from_cha(cha)
    topos = B.TopologyTable.from_topologies(TOPOLOGY_LIBRARY)
    names = list(suite)
    check(list(table.circuits) == names, "tables: the suite's circuit order")
    c, t, r = len(names), len(topos), len(table.recipes)
    for disc in ("list", "levels"):
        card = B.schedule_suite(table, topos, discipline=disc, device=dev)
        host = B.schedule_suite(table, topos, discipline=disc, device="cpu")
        for k in host:
            check(card[k].shape == (c, t, r) and np.array_equal(card[k], host[k]),
                  f"tables: schedule_suite {disc} {k}: card != CPU")
        for ci, name in enumerate(names):
            one = B.schedule_batch(table.workload(name), topos, discipline=disc, device=dev)
            for k in host:
                check(np.array_equal(one[k], card[k][ci]),
                      f"tables: schedule_batch {disc} {name} {k} != schedule_suite's")
            for ri, recipe in enumerate(table.recipes):
                for ti, topo in enumerate(TOPOLOGY_LIBRARY):
                    s = schedule_stats(cha[name][recipe], topo, discipline=disc)
                    check((card["cycles"][ci, ti, ri], card["active_macro_cycles"][ci, ti, ri],
                           card["fits"][ci, ti, ri]) == (s.total_cycles, s.active_macro_cycles,
                                                         s.fits),
                          f"tables: {disc} {name} {recipe} {topo.name} != schedule_stats")
            if disc == "list":  # phase 2's fused back half ran the list discipline
                g = res[name].grid
                for k, want in (("cycles", g.cycles), ("active_macro_cycles",
                                                       g.active_macro_cycles), ("fits", g.fits)):
                    check(np.array_equal(card[k][ci], want),
                          f"tables: {name} {k} != the fused back half's")
        suite_ms = ms_per_call(lambda: B.schedule_suite(table, topos, discipline=disc, device=dev))
        batch_ms = ms_per_call(lambda: B.schedule_batch(table.workload(names[0]), topos,
                                                        discipline=disc, device=dev))
        fused = " and phase 2's fused back half" if disc == "list" else ""
        print(f"tables (a) {disc}: schedule_suite ({c} circuits x {t} topologies x {r} recipes) "
              f"and schedule_batch per circuit on the card equal the CPU, "
              f"mapping.schedule_stats in all {c * t * r} cells{fused}; "
              f"schedule_suite {suite_ms:.3f} ms a call, schedule_batch ({names[0]}) "
              f"{batch_ms:.3f} ms a call (host clock, read-back included)")
    worst = 0.0
    for model, n in ((EnergyModel(), 1), (mc, len(mc))):
        got = B.table2_batch(topos, model)
        for v in range(n):
            for ti, topo in enumerate(TOPOLOGY_LIBRARY):
                m = model if n == 1 else model.model(v, topology=ti)
                for k, x in table2_metrics(topo, m).items():
                    y = got[k][ti] if n == 1 else got[k][v, ti]
                    worst = max(worst, abs(y - x) / abs(x) if x else abs(y))
        label = "EnergyModel" if n == 1 else f"{n}-variant Monte-Carlo table"
        call_ms = ms_per_call(lambda: B.table2_batch(topos, model))
        print(f"tables (a) table2_batch, {label}: {call_ms:.3f} ms a call (host numpy, as in "
              f"the reference)")
    print(f"tables (a) table2_batch against sram.table2_metrics: worst relative gap {worst:.3e} "
          f"(tol 1e-12)")
    check(worst <= 1e-12, f"tables: table2_batch {worst} from table2_metrics")


def torchrun_train(argv, timeout: int = 900) -> subprocess.CompletedProcess:
    """``python -m torch.distributed.run --standalone --nproc-per-node 1 -m
    repro_torch.launch.train ...`` from the repository root."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "1", "-m", "repro_torch.launch.train", *argv]
    return subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env,
                          cwd=ROOT)


def mesh_train_kernels(dev) -> "int | None":
    """One train step's CUDA kernels on a (1, 1) NCCL host mesh, in this
    process (a one-rank group): the launcher builds the model on the mesh
    in one step, and `profiled_device_ms` runs one more, as (d) profiles
    the one-device step."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.launch.mesh import destroy_fake_world
    from repro_torch.launch.specs import batch_logical
    from repro_torch.launch.train import shard_batch
    from repro_torch.optim.adamw import AdamWConfig, constant_schedule
    from repro_torch.train.steps import make_train_step

    destroy_fake_world()  # phase 13's dry-runs leave theirs up
    free()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        out, _ = run_train(["--arch", TRAIN_ARCH, "--preset", "full", "--batch",
                            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--steps", "1"])
        model, params, state = out["model"], out["params"], out["opt_state"]
        check(model.mesh is not None, "mesh train: the launcher built no mesh under a group")
        data = Pipeline(DataConfig(batch_per_host=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                   vocab_size=model.cfg.vocab_size))
        batch = shard_batch(on(dev, data.get_batch(1)), model, batch_logical(model.cfg, True))
        step = make_train_step(model, constant_schedule(out["lrs"][-1]), AdamWConfig())
        with implicit_replication():
            prof = profiled_device_ms(lambda: step(params, state, batch))
        del out, model, params, state, step, batch
    finally:
        dist.destroy_process_group()
        free()
    return prof[0] if prof else None


def phase_tables_mesh(dev, suite, cha, res, mc):
    """(a) `tables_on_card`; (b) minicpm-2b at published size trained by
    ``torchrun --standalone --nproc-per-node 1 -m repro_torch.launch.train``
    on a (1, 1) NCCL mesh (DTensor params), phase 12 (d)'s argv for 3
    steps: its losses, grad norms and learning rates against (d)'s first
    three (loss within 1e-4, grad norms within `TRAIN_GRAD_RTOL`, phase
    12's tolerances; bit-equality reported), ms a step, peak memory and a
    step's kernels beside (d)'s; ``--model-parallel 2`` on the one card
    refused with the `ValueError`.  Neither K1 nor K2 is launched."""
    import math
    import statistics

    t_phase = time.time()
    zero_launches()
    tables_on_card(dev, suite, cha, res, mc)

    free()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        metrics = os.path.join(tmp, "metrics.json")
        t = time.perf_counter()
        run = torchrun_train(["--arch", TRAIN_ARCH, "--preset", "full", "--batch",
                              str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--schedule", "wsd",
                              "--steps", str(MESH_TRAIN_STEPS), "--device", "cuda",
                              "--metrics-out", metrics])
        wall = time.perf_counter() - t
        if run.returncode != 0:
            print(run.stdout[-4000:], run.stderr[-8000:], file=sys.stderr)
        check(run.returncode == 0, f"mesh train: torchrun exited {run.returncode}")
        with open(metrics) as f:
            got = json.load(f)
    want = TRAIN_FULL
    n = MESH_TRAIN_STEPS
    check(got["mesh"] == {"data": 1, "model": 1}, f"mesh train: mesh {got['mesh']}")
    check(got["lrs"] == want["lrs"][:n], f"mesh train: lrs {got['lrs']} != {want['lrs'][:n]}")
    loss_gap = max(abs(a - b) for a, b in zip(got["losses"], want["losses"]))
    gn_gap = max(abs(a - b) / abs(b) for a, b in zip(got["grad_norms"], want["grad_norms"]))
    bit_equal = got["losses"] == want["losses"][:n] and got["grad_norms"] == want["grad_norms"][:n]
    ms = [1e3 * x for x in got["step_s"]]
    kernels = mesh_train_kernels(dev)
    print(f"mesh train (b) {TRAIN_ARCH} --preset full through torchrun on a (1, 1) NCCL mesh "
          f"(DTensor params), batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, wsd, {n} steps in "
          f"{wall:.3f} s (process start, NCCL and model init included)")
    for i in range(n):
        print(f"  step {i}: loss {got['losses'][i]!r} (phase 12 {want['losses'][i]!r}), grad norm "
              f"{got['grad_norms'][i]!r} ({want['grad_norms'][i]!r}), lr {got['lrs'][i]:.3e}, "
              f"{ms[i]:.3f} ms (phase 12 {want['ms'][i]:.3f})")
    verdict = ("losses and grad norms bit-equal" if bit_equal else
               f"losses within {loss_gap:.3e} (tol 1e-4), grad norms within {gn_gap:.3e} of "
               f"theirs (tol {TRAIN_GRAD_RTOL}), not bit-equal")
    print(f"  against phase 12 (d)'s one-device run: {verdict}; step ms p50 {statistics.median(ms[1:]):.3f} (phase 12 "
          f"{statistics.median(want['ms'][1:]):.3f}); peak device memory "
          f"{got['peak_device_bytes']} B (phase 12 {want['peak']} B); one step's CUDA kernels "
          f"{kernels} (phase 12 {want['kernels']})")
    check(all(math.isfinite(x) for x in got["losses"] + got["grad_norms"]),
          "mesh train: a non-finite loss or grad norm")
    check(loss_gap <= 1e-4, f"mesh train: losses {loss_gap} from phase 12's")
    check(gn_gap <= TRAIN_GRAD_RTOL, f"mesh train: grad norms {gn_gap} from phase 12's")

    run = torchrun_train(["--preset", "smoke", "--steps", "1", "--device", "cuda",
                          "--model-parallel", "2"], timeout=300)
    refusal = "ValueError: --model-parallel 2 does not divide the world size 1"
    check(run.returncode != 0 and refusal in run.stderr,
          f"mesh train: --model-parallel 2 on one card exited {run.returncode} without "
          f"the refusal:\n{run.stderr[-4000:]}")
    print(f"mesh train (b) --model-parallel 2 under torchrun on one card: exit "
          f"{run.returncode}, {refusal!r}")
    launched = k1_k2_idle("tables and host-mesh training")
    wall = time.time() - t_phase
    print(f"tables/mesh phase: wall {wall:.3f} s; K1/K2 launches {json.dumps(launched)}")
    return wall


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
    "decode_attn": (
        "decode_attn.decode_attention",
        "src/repro_torch/kernels/csrc/decode_attn.cu",
        None,  # the reference's decode attention is jnp, no Pallas kernel
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
    t_start = t0 = time.time()
    logs = build.build_all()
    print(f"build s {time.time() - t0:.3f}")
    for src, log in logs.items():
        print(f"== nvcc {src}.cu\n{log}", file=sys.stderr)

    rng = np.random.default_rng(0)
    times = phase_k1(dev, rng)
    suite, cha, res, netlists, vectors, launches, front_s, back_s = phase_main(dev, rng)
    mc, fused = phase_sweep(dev, suite, cha)
    times.update(phase_k2(dev, netlists, vectors))
    # Phases 5-15 run after the kernel line's launch counts were taken
    # (``launches`` is phase 2's); each phase sets the counts to 0 first.
    served = {n: suite[n] for n in SERVICE_CIRCUITS}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        service_s = phase_service(dev, served, cha, mc, f"{tmp}/cha")
        runner_s = phase_runner(dev, served, mc, fused, f"{tmp}/cha", f"{tmp}/journal")
        cli_s = phase_cli(suite, cha, res, fused, f"{tmp}/cli_warm", f"{tmp}/cli_cold")
        chaos_s = phase_chaos()
        t = time.time()
        journal_overhead(dev, suite, f"{tmp}/cli_warm", f"{tmp}/overhead")
        overhead_s = time.time() - t
    system_s = phase_system(dev, rng)
    llm_s, llm_times = phase_llm(dev, rng)
    launches = {**launches, "decode_attn": llm_times.pop("launches")}
    times["decode_attn"] = llm_times
    llm11_s = phase_llm11(dev, rng)
    llm12_s = phase_llm12(dev, rng)
    mesh_s = phase_mesh(dev)
    lint_s = phase_lint(dev)
    tables_s = phase_tables_mesh(dev, suite, cha, res, mc)
    print(f"phases 5-15 wall: service {service_s:.3f} s, sweep runner {runner_s:.3f} s, "
          f"CLI {cli_s:.3f} s, chaos {chaos_s:.3f} s, journal overhead {overhead_s:.3f} s, "
          f"system {system_s:.3f} s, LM serving {llm_s:.3f} s, MoE/recurrent LM serving "
          f"{llm11_s:.3f} s, enc-dec/VLM serving and training {llm12_s:.3f} s, mesh "
          f"explorer {mesh_s:.3f} s, lint {lint_s:.3f} s, tables and host-mesh training "
          f"{tables_s:.3f} s")

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
                bound_ms=t.get("bound_ms", t.get("bytes", 0) / HBM_BYTES_PER_S * 1e3),
                bound_by=t.get("bound_by", "bytes"),
                library_ms=t.get("library_ms"),
            )
        )
    print(f"chip_smoke wall {time.time() - t_start:.3f} s")
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
