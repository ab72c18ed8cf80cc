"""The port's hand-written CUDA kernels against their plain torch versions,
on the card.

Every test here is marked ``cuda`` and skips itself without a card.  The
file imports only the port (no jax, no reference package), so it runs on
a machine that has PyTorch for CUDA and ``nvcc`` but no jax::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Inputs are made from a seed with numpy.  Kernel and plain version run on
the same CUDA tensors and must be bit-equal; the launch counters move by
one per kernel launch; the host checks refuse row indices outside the
operands before upload.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.core import circuits as C
from repro_torch.core import transforms as T
from repro_torch.core.aig import Aig, lit
from repro_torch.kernels import aig_sim as A
from repro_torch.kernels import build
from repro_torch.kernels import cim_logic as K
from repro_torch.kernels import ops, ref


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def random_aig(rng, n_pis, n_ands) -> Aig:
    aig = Aig(n_pis)
    lits = [lit(i) for i in range(1, n_pis + 1)]
    for _ in range(n_ands):
        i, j = rng.integers(0, len(lits), size=2)
        out = aig.g_and(int(lits[i]) ^ int(rng.integers(2)), int(lits[j]) ^ int(rng.integers(2)))
        if out > 1:
            lits.append(out)
    aig.add_po(lits[-1])
    return aig


def k1_items(rng, aig, max_leaves_list=(4, 10, 14), n=40):
    ands = list(range(aig.n_pis + 1, aig.n_nodes))
    items = []
    for max_leaves in max_leaves_list:
        for node in rng.choice(ands, size=n, replace=False):
            root = lit(int(node), int(rng.integers(2)))
            items.append(((root,), T._reconv_cut(aig, int(node), max_leaves)))
    return items


@pytest.mark.cuda
@pytest.mark.parametrize("row_space", ["shared", "global"])
def test_k1_eval_mega_matches_plain_on_card(cuda_device, row_space, monkeypatch):
    """Every word tier (W = 1 / 32 / 512) as a multi-chunk batch through
    the kernel, with its rows in shared memory and forced into global
    memory, against the plain version; the decoded tables also equal
    `Aig.truth_table`.  One launch per tier."""
    if row_space == "global":
        monkeypatch.setattr(A, "MAX_SHARED_BYTES", 0)
    for w in (1, 32, 512):
        monkeypatch.setitem(A._MEGA_BUDGET, w, 256)
    rng = np.random.default_rng(14)
    aig = random_aig(rng, n_pis=14, n_ands=300)
    prog = A.compile_aig(aig)
    items = k1_items(rng, aig)
    tiers: dict[int, list[int]] = {}
    for i, (_, s) in enumerate(items):
        tiers.setdefault(A._tier_for(len(s))[1], []).append(i)
    assert set(tiers) == {1, 32, 512}
    before = dict(A.TIER_LAUNCHES), A.LAUNCHES["eval_mega"]
    for w, idxs in tiers.items():
        k_max = next(km for km, tw in A._TIERS if tw == w)
        mem = A._cone_members(aig, items, idxs)
        batch = A._pack_mega(aig, prog, items, idxs, w, mem)
        assert len(batch.meta) > 1
        A._check_chunks(batch.waves, batch.meta, len(batch.pin_rows), batch.max_rows, batch.rootp)
        ops_ = batch.operands(cuda_device, A._dev_elem(k_max, cuda_device))
        assert A._fits_shared(ops_[0].shape[1], batch.max_rows, batch.cw) == (row_space == "shared")
        got = A.eval_mega(*ops_)
        torch.cuda.synchronize()
        assert torch.equal(got, A.eval_mega_plain(*ops_[:5]))
        out = got.cpu().numpy().view(np.uint32)
        for pos, idx in enumerate(idxs):
            roots, sup = items[idx]
            mask = (1 << (1 << len(sup))) - 1
            row = out[int(batch.qoff[pos])]
            assert int.from_bytes(row.tobytes(), "little") & mask == aig.truth_table(roots[0], sup)
    assert A.LAUNCHES["eval_mega"] == before[1] + 3
    assert all(A.TIER_LAUNCHES[w] == before[0][w] + 1 for w in (1, 32, 512))


@pytest.mark.cuda
@pytest.mark.parametrize("row_space", ["shared", "global"])
@pytest.mark.parametrize("n_words,sig_slice", [(4, 2), (3, 4)])
def test_k1_signatures_and_eval_tts_on_card(
    cuda_device, row_space, n_words, sig_slice, monkeypatch
):
    """Signatures through `sig_eval` in both row spaces; (3 words, slice 4)
    leaves a ragged last column slice (W = 6).  Then `eval_tts` on the
    card equals the CPU's."""
    if row_space == "global":
        monkeypatch.setattr(A, "MAX_SHARED_BYTES", 0)
    monkeypatch.setattr(A, "_SIG_SLICE", sig_slice)
    rng = np.random.default_rng(15)
    aig = random_aig(rng, n_pis=10, n_ands=400)
    prog = A.compile_aig(aig)
    assert A._sig_cw(prog.waves.shape[1], prog.n_pad) == (sig_slice, row_space == "shared")
    patterns = rng.integers(0, 1 << 63, size=(aig.n_pis, n_words), dtype=np.int64).astype(np.uint64)
    before = A.LAUNCHES["sig_eval"]
    np.testing.assert_array_equal(
        A.node_signatures(aig, patterns, device=cuda_device), T._node_signatures(aig, patterns)
    )
    assert A.LAUNCHES["sig_eval"] == before + 1
    items = [((lit(n),), T._reconv_cut(aig, n, 8)) for n in range(aig.n_nodes - 1, aig.n_pis, -7)]
    assert A.eval_tts(aig, items, device=cuda_device) == A.eval_tts(aig, items, device="cpu")


@pytest.mark.cuda
def test_k1_eval_tts_wide_tier_on_card(cuda_device, monkeypatch):
    """k = 11..14 queries go through K1 on the card (no `Aig.truth_table`
    call) and equal `Aig.truth_table`."""
    rng = np.random.default_rng(16)
    aig = random_aig(rng, n_pis=14, n_ands=300)
    items = [
        ((lit(n), lit(n, 1)), T._reconv_cut(aig, n, 14))
        for n in range(aig.n_nodes - 1, aig.n_pis, -1)
    ]
    items = [it for it in items if 11 <= len(it[1]) <= 14]
    assert {11, 14} <= {len(s) for _, s in items}
    want = [tuple(aig.truth_table(rl, list(s)) for rl in r) for r, s in items]

    def no_host_tables(*args, **kw):
        raise AssertionError("Aig.truth_table called on the card's path")

    before = A.TIER_LAUNCHES[512]
    monkeypatch.setattr(Aig, "truth_table", no_host_tables)
    got = A.eval_tts(aig, items, device=cuda_device)
    monkeypatch.undo()
    assert got == want
    assert A.TIER_LAUNCHES[512] == before + 1


@pytest.mark.cuda
def test_k1_wide_tier_launches_in_resub_of_log2(cuda_device):
    """`_resub_device` on the default-scale log2 circuit (56 wide union
    supports) sends its W=512 queries through K1 and gives the python
    transform's output."""
    aig = C.benchmark_suite("default", only=["log2"])["log2"]
    before = A.TIER_LAUNCHES[512]
    out = T._resub_device(aig, device=cuda_device)
    assert A.TIER_LAUNCHES[512] > before
    assert out.fingerprint() == T.resub(aig).fingerprint()


@pytest.mark.cuda
@pytest.mark.parametrize("n_vec", [45, 1 << 16])
def test_k2_matches_plain_on_card(cuda_device, n_vec):
    rng = np.random.default_rng(9)
    net = C.gen_adder(16).to_gate_netlist()
    bits = rng.integers(0, 2, size=(32, n_vec), dtype=np.uint8)
    cc = ops.compile_netlist(net)
    planes, bw = ops.cim_planes(cc, ref.pack_vectors(bits))
    args = (torch.from_numpy(cc.instrs).to(cuda_device), torch.from_numpy(planes).to(cuda_device))
    kw = dict(n_rows=cc.n_rows, n_gates=cc.n_gates, n_pos=cc.n_pos, block_words=bw,
              program=ops.cim_program(cc).to(cuda_device))
    before = K.LAUNCHES["cim"]
    got = K.cim_call(*args, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["cim"] == before + 1
    assert torch.equal(got, K.cim_plain(*args, n_gates=cc.n_gates, n_pos=cc.n_pos))
    out = ops.cim_evaluate(net, bits, device=cuda_device)
    weights = [1 << i for i in range(16)]
    a = [sum(int(bits[i, v]) * weights[i] for i in range(16)) for v in range(min(n_vec, 500))]
    b = [sum(int(bits[16 + i, v]) * weights[i] for i in range(16)) for v in range(min(n_vec, 500))]
    got_sum = [sum(int(out[i, v]) << i for i in range(17)) for v in range(min(n_vec, 500))]
    assert got_sum == [x + y for x, y in zip(a, b)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_vec", [45, 1 << 16])
def test_k2_global_register_file_matches_plain_on_card(cuda_device, n_vec, monkeypatch):
    """K2's global-memory register file, taken by netlists whose register
    file does not fit a block's shared memory, forced here on adder-16."""
    rng = np.random.default_rng(10)
    net = C.gen_adder(16).to_gate_netlist()
    bits = rng.integers(0, 2, size=(32, n_vec), dtype=np.uint8)
    cc = ops.compile_netlist(net)
    planes, bw = ops.cim_planes(cc, ref.pack_vectors(bits))
    args = (torch.from_numpy(cc.instrs).to(cuda_device), torch.from_numpy(planes).to(cuda_device))
    monkeypatch.setattr(K, "MAX_SHARED_BYTES", 0)
    got = K.cim_call(*args, n_rows=cc.n_rows, n_gates=cc.n_gates, n_pos=cc.n_pos, block_words=bw,
                     program=ops.cim_program(cc).to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(got, K.cim_plain(*args, n_gates=cc.n_gates, n_pos=cc.n_pos))


def k2_operands(net, bits, device):
    """(cc, positional operands, keywords with the program) of `cim_call`."""
    cc = ops.compile_netlist(net)
    planes, bw = ops.cim_planes(cc, ref.pack_vectors(bits))
    args = (torch.from_numpy(cc.instrs).to(device), torch.from_numpy(planes).to(device))
    kw = dict(n_rows=cc.n_rows, n_gates=cc.n_gates, n_pos=cc.n_pos, block_words=bw,
              program=ops.cim_program(cc).to(device))
    return cc, args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("row_space", ["shared", "global"])
@pytest.mark.parametrize("n_vec", [45, 1 << 16])
def test_k2_program_matches_both_plain_versions_on_mac8(cuda_device, n_vec, row_space,
                                                        monkeypatch):
    """The level-scheduled kernel on the mac8 tile (54 levels) equals the
    reference stream's plain version and the program's, bit for bit, with
    either register file."""
    from repro_torch.core import workloads as W

    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2, size=(32, n_vec), dtype=np.uint8)
    cc, args, kw = k2_operands(W.primitive_aigs()["mac8"].to_gate_netlist(), bits, cuda_device)
    assert kw["program"].n_levels == 54
    if row_space == "global":
        monkeypatch.setattr(K, "MAX_SHARED_BYTES", 0)
    got = K.cim_call(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, K.cim_plain(*args, n_gates=cc.n_gates, n_pos=cc.n_pos))
    assert torch.equal(got, K.program_plain(kw["program"], args[1]))


@pytest.mark.cuda
def test_k2_tall_renamed_file_takes_the_global_register_file(cuda_device):
    """A level of 2,000 gates whose outputs all live to the last level:
    the renamed file is taller than a block's shared memory holds, so the
    wrapper hands the kernel the global register file."""
    from repro_torch.core.aig import GateNetlist

    n_pis, n_wide = 6, 2000
    net = GateNetlist()
    for _ in range(2 + n_pis):
        net._new_signal()
    net.pi_signals = list(range(2, 2 + n_pis))
    wide = [net._emit("nor" if i % 3 else "nand", 2 + i % n_pis, 2 + (i * 7 + 1) % n_pis, 0)
            for i in range(n_wide)]
    net.po_signals = [net._emit("nand", wide[i], wide[n_wide - 1 - i], 1) for i in range(n_wide)]
    rng = np.random.default_rng(12)
    bits = rng.integers(0, 2, size=(n_pis, 3000), dtype=np.uint8)
    cc, args, kw = k2_operands(net, bits, cuda_device)
    program = kw["program"]
    assert program.n_rows > n_wide
    assert K._k2().k2_shared_bytes(program.n_rows, K.CHUNK_SLOTS) > K.MAX_SHARED_BYTES
    got = K.cim_call(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, K.cim_plain(*args, n_gates=cc.n_gates, n_pos=cc.n_pos))


@pytest.mark.cuda
def test_k2_without_a_program_is_refused_on_card(cuda_device):
    """The CUDA path runs a program or raises naming `ops.cim_program`:
    no launch, no fallback to the plain version.  A program of another
    stream with the same shape is refused against the host stream."""
    rng = np.random.default_rng(13)
    bits = rng.integers(0, 2, size=(8, 100), dtype=np.uint8)
    cc, args, kw = k2_operands(C.gen_adder(4).to_gate_netlist(), bits, cuda_device)
    kw.pop("program")
    before = K.LAUNCHES["cim"]
    with pytest.raises(build.OperandError, match="ops.cim_program"):
        K.cim_call(*args, **kw)
    with pytest.raises(build.OperandError, match="is on cpu"):
        K.cim_call(*args, **kw, program=ops.cim_program(cc))
    other = cc.instrs.copy()
    other[0, 0] = 0 if other[0, 0] == 1 else 1  # another kind: same rows, gates, POs
    foreign = ops.cim_program(dataclasses.replace(cc, instrs=other)).to(cuda_device)
    with pytest.raises(build.OperandError, match="another instruction stream"):
        K.cim_call(torch.from_numpy(cc.instrs), args[1], **kw, program=foreign)
    assert K.LAUNCHES["cim"] == before


@pytest.mark.cuda
def test_service_request_on_card(cuda_device):
    """One cold and one warm request through the exploration service on
    the card: the cold one launches K1, the warm re-rank launches
    nothing, and both winners equal `explore_request` on the card."""
    from repro_torch.core.explorer import explore_request
    from repro_torch.core.sram import TOPOLOGY_LIBRARY
    from repro_torch.serve.explore_service import ExplorationService, ExploreRequest

    topos, recipes = TOPOLOGY_LIBRARY[:5], [(), ("Rw",), ("Rf",), ("Rs",)]
    rtl = C.gen_adder(8)
    with ExplorationService(sram_list=topos, recipes=recipes, device=cuda_device) as svc:
        before = A.LAUNCHES["eval_mega"]
        cold = svc.submit(ExploreRequest(rtl)).result(timeout=600)
        assert cold.ok, cold.error
        assert A.LAUNCHES["eval_mega"] > before
        launches = dict(A.LAUNCHES)
        warm = svc.submit(ExploreRequest(rtl, max_latency_ns=1e6)).result(timeout=600)
        assert warm.ok and warm.grid_cache_hit
        assert dict(A.LAUNCHES) == launches
        st = svc.stats()
        assert st["evaluate_calls"] == 1 and st.get("degraded", 0) == 0
    for resp, kw in ((cold, {}), (warm, dict(max_latency_ns=1e6))):
        off = explore_request(rtl, topos, recipes, device=cuda_device, **kw)
        cell = off.grid.cell(off.grid.topologies.index(off.best.topo),
                             off.grid.recipes.index(tuple(off.best.recipe)))
        assert (resp.winner.recipe, resp.winner.topology) == (tuple(off.best.recipe), off.best.topo)
        assert resp.winner.energy_nj == cell.energy_nj
        assert resp.winner.latency_ns == cell.latency_ns


@pytest.mark.cuda
@pytest.mark.parametrize("discipline", ["list", "levels"])
def test_schedule_tables_on_card_equal_cpu(cuda_device, discipline):
    """`batch.schedule_batch` and `batch.schedule_suite` on the card: the
    CPU's integers exactly, over three characterized circuits of different
    depths, every recipe of a short list and the 12 topologies."""
    from repro_torch.core import batch as B
    from repro_torch.core.sram import TOPOLOGY_LIBRARY

    recipes = [(), ("Rw",), ("Rf",), ("Rs",), ("Ba", "Rw")]
    suite = {"adder": C.gen_adder(8), "max": C.gen_max(8, 4), "mul": C.gen_multiplier(4)}
    cha = T.characterize_suite(suite, recipes, backend="python", n_jobs=1, device="cpu")
    table = B.SuiteTable.from_cha(cha)
    topos = B.TopologyTable.from_topologies(TOPOLOGY_LIBRARY)
    got = B.schedule_suite(table, topos, discipline=discipline, device=cuda_device)
    want = B.schedule_suite(table, topos, discipline=discipline, device="cpu")
    for i, name in enumerate(suite):
        one = B.schedule_batch(table.workload(name), topos, discipline=discipline,
                               device=cuda_device)
        for k in want:
            assert np.array_equal(got[k], want[k]), k
            assert np.array_equal(one[k], want[k][i]), (name, k)


@pytest.mark.cuda
def test_two_shard_journaled_sweep_on_card(cuda_device, tmp_path):
    """A two-shard journaled sweep on the card, crashed after its first
    shard and resumed, equals the uninterrupted run bit for bit."""
    from repro_torch.core.sram import TOPOLOGY_LIBRARY, ModelTable
    from repro_torch.core.sweep_runner import run_sweep
    from repro_torch.runtime import faults

    circuits = C.benchmark_suite("tiny", only=["adder", "max"])
    kw = dict(sram_list=TOPOLOGY_LIBRARY[:5], recipes=[(), ("Rw",), ("Rs",)],
              model=ModelTable.monte_carlo(n=16, sigma=0.1, seed=0),
              cache=tmp_path / "cha", n_jobs=1, device=cuda_device, shard_size=1)
    whole = run_sweep(circuits, **kw)
    with faults.injected(faults.FaultRule("sweep.shard", "raise", after=1)):
        with pytest.raises(faults.FaultError):
            run_sweep(circuits, journal_dir=tmp_path / "j", **kw)
    resumed = run_sweep(circuits, journal_dir=tmp_path / "j", **kw)
    assert resumed.shards_resumed == 1 and resumed.shards_run == 1
    a, b = resumed.selection, whole.selection
    assert np.array_equal(a.winner_idx, b.winner_idx)
    assert np.array_equal(a.nominal_latency_ns, b.nominal_latency_ns)
    assert np.array_equal(a.nominal_fits, b.nominal_fits)
    for k, v in b.winner_metrics.items():
        assert np.array_equal(a.winner_metrics[k], v), k


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().reshape(-1).view(torch.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("wal,n,layout", [(True, 256, "wal"), (False, 256, "file"),
                                          (False, 1024, "dir")])
def test_deferred_snapshot_of_device_tensors_restores_bit_equal(cuda_device, tmp_path, wal,
                                                                n, layout):
    """Device tensors saved with ``defer_snapshot`` cross to the host on
    the writer thread, after the event recorded on the stream that made
    them, and restore bit-equal on the card in each on-disk layout
    (bfloat16 and fp8 included)."""
    from repro_torch.ckpt.manager import CheckpointManager

    g = torch.Generator(device=cuda_device).manual_seed(0)
    side = torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(side):
        a = torch.randn(n, n, device=cuda_device, generator=g)
        tree = {"f32": a @ a, "bf16": (3 * a).to(torch.bfloat16),
                "fp8": a.to(torch.float8_e4m3fn), "i64": torch.arange(n, device=cuda_device),
                "s": [torch.tensor(7, dtype=torch.int32, device=cuda_device)]}
        m = CheckpointManager(str(tmp_path), wal=wal, defer_snapshot=True)
        m.save(0, tree, meta={"n": n})
    m.wait()
    side.synchronize()
    step = tmp_path / "step_0"
    assert {"wal": not step.exists(), "file": step.is_file(), "dir": step.is_dir()}[layout]
    back, meta = m.restore(tree, device=cuda_device)
    assert meta["meta"] == {"n": n}
    for got, want in zip((back["f32"], back["bf16"], back["fp8"], back["i64"], back["s"][0]),
                         (tree["f32"], tree["bf16"], tree["fp8"], tree["i64"], tree["s"][0])):
        assert got.device.type == "cuda" and got.dtype == want.dtype
        assert got.shape == want.shape and torch.equal(_bits(got), _bits(want))


#: operand widths of each primitive tile of `core.workloads`, in PI order
TILE_WIDTHS = {"mac8": (8, 8, 16), "add16": (16, 16), "max8": (8, 8)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TILE_WIDTHS))
def test_workload_tiles_on_k2(cuda_device, name, monkeypatch):
    """Each primitive tile's netlist through K2 at 2**16 random operands
    computes its integer function, with one launch, and K2 is bit-equal
    to its plain version with either register file."""
    from repro_torch.core import workloads as W

    rng = np.random.default_rng(17)
    vals = [rng.integers(0, 1 << w, 1 << 16, dtype=np.int64) for w in TILE_WIDTHS[name]]
    bits = np.concatenate([(v[None, :] >> np.arange(w)[:, None]) & 1
                           for v, w in zip(vals, TILE_WIDTHS[name])]).astype(np.uint8)
    want = {"mac8": lambda a, b, acc: (a * b + acc) % 65536,
            "add16": lambda a, b: (a + b) % 65536,
            "max8": np.maximum}[name](*vals)
    net = W.primitive_aigs()[name].to_gate_netlist()
    before = K.LAUNCHES["cim"]
    out = ops.cim_evaluate(net, bits, device=cuda_device)
    assert K.LAUNCHES["cim"] == before + 1
    got = (out.astype(np.int64) << np.arange(out.shape[0])[:, None]).sum(axis=0)
    np.testing.assert_array_equal(got, want)
    cc, args, kw = k2_operands(net, bits, cuda_device)
    plain = K.cim_plain(*args, n_gates=cc.n_gates, n_pos=cc.n_pos)
    assert torch.equal(K.cim_call(*args, **kw), plain)
    monkeypatch.setattr(K, "MAX_SHARED_BYTES", 0)
    assert torch.equal(K.cim_call(*args, **kw), plain)


@pytest.mark.cuda
def test_evaluate_lowered_and_compare_system_on_card_equal_cpu(cuda_device):
    """One zoo cell priced on the card and on the CPU: the same winners
    and bottleneck, every fp64 number within rtol=1e-12."""
    from repro_torch.configs import get_config
    from repro_torch.core import workloads as W
    from repro_torch.launch import system as S
    from repro_torch.models.config import SHAPES

    lowered = W.lower_config(get_config("gemma3-27b"), SHAPES["decode_32k"])
    for mode, discipline in (("physical", "list"), ("paper", "levels")):
        gpu = W.evaluate_lowered(lowered, mode=mode, discipline=discipline, device=cuda_device)
        cpu = W.evaluate_lowered(lowered, mode=mode, discipline=discipline, device="cpu")
        assert gpu.winners == cpu.winners
        for k in ("tile_energy_nj", "tile_latency_ns"):
            np.testing.assert_allclose([getattr(gpu, k)[p] for p in cpu.winners],
                                       [getattr(cpu, k)[p] for p in cpu.winners], rtol=1e-12)
        np.testing.assert_allclose(gpu.energy_per_token_j, cpu.energy_per_token_j, rtol=1e-12)
        np.testing.assert_allclose(gpu.latency_per_token_s, cpu.latency_per_token_s, rtol=1e-12)
    sweep = (4e11, 8e11, 1.6e12)
    gpu = S.compare_system("gemma3-27b", "decode_32k", hbm_bw_sweep=sweep, device=cuda_device)
    cpu = S.compare_system("gemma3-27b", "decode_32k", hbm_bw_sweep=sweep, device="cpu")
    assert gpu["baseline"]["bottleneck"] == cpu["baseline"]["bottleneck"]
    assert gpu["bw_sweep"]["bottleneck"] == cpu["bw_sweep"]["bottleneck"]
    for k in ("compute_s", "memory_s", "collective_s", "token_s"):
        np.testing.assert_allclose(gpu["bw_sweep"][k], cpu["bw_sweep"][k], rtol=1e-12)
    np.testing.assert_allclose(gpu["energy_ratio_rcim_over_accel"],
                               cpu["energy_ratio_rcim_over_accel"], rtol=1e-12)


def lm_extras(cfg, b) -> dict:
    """Encoder frames (whisper) or image patches (internvl2), seeded."""
    rng = np.random.default_rng(1)
    out = {}
    if cfg.is_encoder_decoder:
        out["frames"] = rng.standard_normal((b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.n_patches:
        out["patches"] = rng.standard_normal((b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def lm_card_against_cpu(cuda_device, cfg, S, P, atol=1e-4):
    """fp32 from one CPU init: the card's prefill logits, aligned caches
    (KV, cross KV, conv and recurrent states) and the teacher-forced
    decode steps equal the CPU's within ``atol`` (the logits' scale is
    about 1-2), and greedy `ServeEngine.generate` gives the CPU's tokens.
    A config that reads frames or patches gets them from `lm_extras`."""
    from repro_torch.models.config import ParallelConfig
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import ServeEngine, align_prefill_caches

    def build(dev):
        return Model(cfg, ParallelConfig(), compute_dtype=torch.float32,
                     q_chunk=8, kv_chunk=8, device=dev)

    cpu = build("cpu").init(torch.Generator().manual_seed(0))
    gpu = build(cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    B = 2
    toks = np.random.default_rng(0).integers(0, cpu.cfg.vocab_size, (B, S)).astype(np.int32)
    extra, npch = lm_extras(cfg, B), cfg.n_patches
    got = {}
    for name, m in (("cpu", cpu), ("gpu", gpu)):
        tt = torch.as_tensor(toks, dtype=torch.int64, device=m.device)
        ex = {k: torch.as_tensor(v, device=m.device) for k, v in extra.items()}
        with torch.inference_mode():
            last, caches = m.prefill(dict(tokens=tt[:, :P], **ex))
            caches = align_prefill_caches(m, caches, npch + P, npch + S, batch=B)
            # decode_step writes the caches in place: snapshot a copy
            aligned = [{k: x.to("cpu", copy=True) for k, x in c.items()} for c in caches]
            steps = [last.cpu()]
            for t in range(P, S):
                lg, caches = m.decode_step(caches, tt[:, t], npch + t)
                steps.append(lg.cpu())
        out = ServeEngine(m, batch=B, max_seq=S, device=m.device.type).generate(
            toks[:, :P], max_new=S - P, extra_batch=extra)
        got[name] = (torch.stack(steps), aligned, out)
    torch.testing.assert_close(got["gpu"][0], got["cpu"][0], rtol=0, atol=atol)
    for c_gpu, c_cpu in zip(got["gpu"][1], got["cpu"][1]):
        assert c_gpu.keys() == c_cpu.keys()
        for k in c_cpu:
            torch.testing.assert_close(c_gpu[k], c_cpu[k], rtol=1e-4,
                                       atol=1e-4 * float(c_cpu[k].abs().max()))
    np.testing.assert_array_equal(got["gpu"][2], got["cpu"][2])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minicpm-2b", "gemma3-27b"])
def test_dense_lm_on_card_equals_cpu(cuda_device, arch):
    """A dense smoke config, 8 decode steps (prompt 20 > gemma3's smoke
    window 16: the ring caches are cut and rotated)."""
    from repro_torch.configs import smoke_config

    lm_card_against_cpu(cuda_device, smoke_config(arch), 28, 20)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-780m", "recurrentgemma-9b"])
def test_moe_and_recurrent_lm_on_card_equals_cpu(cuda_device, arch):
    """A smoke config at depth 2 (deepseek: its dense layer 0 and one MoE
    layer; mamba2: two SSD blocks; recurrentgemma: two RG-LRU blocks),
    prompt 24 (three of mamba2's smoke SSD chunks), 8 decode steps."""
    import dataclasses

    from repro_torch.configs import smoke_config

    cfg = dataclasses.replace(smoke_config(arch), n_layers=2)
    lm_card_against_cpu(cuda_device, cfg, 32, 24)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-tiny", "internvl2-2b"])
def test_encoder_decoder_and_vlm_on_card(cuda_device, arch):
    """The smoke configs on the card: fp32 decode against the
    teacher-forced forward (the reference's 2e-3 prefill / 5e-3 decode),
    then the card against the CPU (whisper's cross keys and values and
    internvl2's patch prefix in the caches), the logits within 2e-4 (the
    dense family's CPU parity tolerance, ``tests/test_torch_models.py``):
    with the random frames whisper's decode logits move by 1.8e-5 under
    a one-ulp change of every param on the CPU, twice minicpm-2b's."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.config import ParallelConfig
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import align_prefill_caches

    cfg = smoke_config(arch)
    m = Model(cfg, ParallelConfig(), compute_dtype=torch.float32, q_chunk=8, kv_chunk=8,
              device=cuda_device).init(torch.Generator(device=cuda_device).manual_seed(0))
    B, S, P, npch = 2, 28, 20, cfg.n_patches
    tt = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)),
                         device=cuda_device)
    ex = {k: torch.as_tensor(v, device=cuda_device) for k, v in lm_extras(cfg, B).items()}
    with torch.inference_mode():
        full, _ = m.forward(dict(tokens=tt, **ex))
        last, caches = m.prefill(dict(tokens=tt[:, :P], **ex))
        caches = align_prefill_caches(m, caches, npch + P, npch + S, batch=B)
        assert float((last - full[:, P - 1]).abs().max()) < 2e-3
        for t in range(P, S):
            lg, caches = m.decode_step(caches, tt[:, t], npch + t)
            assert float((lg - full[:, t]).abs().max()) < 5e-3, t
    lm_card_against_cpu(cuda_device, cfg, S, P, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minicpm-2b", "whisper-tiny"])
def test_train_step_on_card_equals_cpu(cuda_device, arch):
    """One `make_train_step` from one CPU init, fp32, ``b1=0`` and no
    clipping (the first moment is then the grad): the loss within 1e-5,
    every grad within 1e-3 of its leaf's scale (the CPU tests' tolerance
    against the reference: with the reference's fan-in init the CPU's
    own fp32 grads are 1.6e-4 of scale off fp64 at this size), and the
    updated params within 1e-6 wherever |g| is above 1e-2 of its leaf's
    scale (where AdamW's first step, about ``lr * sign(g)``, cannot
    flip)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.config import ParallelConfig
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, constant_schedule
    from repro_torch.train.steps import make_train_step

    cfg = smoke_config(arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 33))
    batch = dict(tokens=toks[:, :-1], labels=toks[:, 1:], **lm_extras(cfg, 2))
    opt = AdamWConfig(b1=0.0, clip_norm=0.0)
    cpu = Model(cfg, ParallelConfig(), compute_dtype=torch.float32, q_chunk=8, kv_chunk=8,
                device="cpu").init(torch.Generator().manual_seed(0))
    gpu = Model(cfg, ParallelConfig(), compute_dtype=torch.float32, q_chunk=8, kv_chunk=8,
                device=cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    out = {}
    for name, m in (("cpu", cpu), ("gpu", gpu)):
        P = m.train_params()
        step = make_train_step(m, constant_schedule(1e-3), opt)
        tb = {k: torch.as_tensor(v, device=m.device) for k, v in batch.items()}
        P, state, metrics = step(P, adamw_init(P, opt), tb)
        out[name] = (float(metrics["loss"]), {n: x.cpu() for n, x in state["m"].items()},
                     {n: p.detach().cpu() for n, p in P.items()})
    assert abs(out["gpu"][0] - out["cpu"][0]) <= 1e-5
    for n, g in out["cpu"][1].items():
        scale = float(g.abs().max())
        assert float((out["gpu"][1][n] - g).abs().max()) <= 1e-3 * scale + 1e-30, n
        sure = g.abs() > 1e-2 * scale
        moved = (out["gpu"][2][n] - out["cpu"][2][n])[sure]
        assert float(torch.cat([moved, torch.zeros(1)]).abs().max()) <= 1e-6, n


@pytest.mark.cuda
def test_train_checkpoint_round_trip_of_card_tensors(cuda_device, tmp_path):
    """`launch.train` on the card saves through ``defer_snapshot`` (device
    snapshots crossing to the host on the writer thread): 4 steps with a
    checkpoint every 2, then ``--resume`` to 8, bit-equal to 8 steps
    straight; the restored step-8 checkpoint equals the final state."""
    import contextlib
    import io

    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.launch import train as train_cli
    from repro_torch.models import layers as L

    def run(*argv):
        with contextlib.redirect_stdout(io.StringIO()):
            return train_cli.main(["--device", "cuda", "--preset", "smoke", *argv])

    ck = str(tmp_path)
    straight = run("--steps", "8")
    run("--steps", "4", "--ckpt-dir", ck, "--ckpt-every", "2")
    resumed = run("--steps", "8", "--ckpt-dir", ck, "--ckpt-every", "2", "--resume")
    assert resumed["losses"] == straight["losses"][4:]
    for n, p in straight["params"].items():
        assert torch.equal(resumed["params"][n], p), n
    model = resumed["model"]
    like = dict(p=model.specs(), o=dict(step=0, m=model.specs(), v=model.specs()))
    tree, _ = CheckpointManager(ck).restore(like, device=cuda_device)
    want = dict(p=model.to_tree(resumed["params"]),
                o=dict(step=resumed["opt_state"]["step"], m=model.to_tree(resumed["opt_state"]["m"]),
                       v=model.to_tree(resumed["opt_state"]["v"])))
    for (path, got), (_, w) in zip(L.tree_leaves(tree), L.tree_leaves(want)):
        assert got.device.type == "cuda" and got.dtype == w.dtype and torch.equal(got, w), path


@pytest.mark.cuda
def test_mesh_variation_summary_on_card_equals_cpu(cuda_device):
    """The mesh explorer's constant sweep selects on the card exactly as on
    the CPU (winners, shares and yield), with and without a latency bound."""
    from repro_torch.core import mesh_explorer as MX

    rng = np.random.default_rng(3)
    evals = []
    for i in range(12):
        rec = dict(roofline=dict(flops=float(rng.uniform(1e15, 5e15)),
                                 hbm_bytes=float(rng.uniform(1e12, 9e12)),
                                 link_bytes=float(rng.uniform(1e11, 9e11))),
                   n_chips=(256, 512)[i % 2])
        evals.append(MX.MeshEvaluation(
            topo=f"t{i % 4}", recipe=f"r{i}", latency_s=float(rng.uniform(0.1, 2.0)),
            energy_j=MX.energy_proxy(rec), hbm_gb=float(rng.uniform(4, 20)),
            fits=bool(i % 3), bottleneck="compute", record=rec))
    variants = MX.constant_corners(0.4)
    for max_latency_s in (None, 1.0):
        card = MX.variation_summary(evals, variants, max_latency_s, device=cuda_device)
        assert card == MX.variation_summary(evals, variants, max_latency_s, device="cpu")


@pytest.mark.cuda
def test_dryrun_argument_bytes_match_the_card(cuda_device, tmp_path, monkeypatch):
    """The dry-run's argument bytes of a decode step on a (1, 1) mesh equal
    the bytes of the same arguments on the card, and the card's allocation
    for them within the caching allocator's rounding per tensor (512 B;
    a large tensor's block may keep the rest of its 2 MiB-rounded segment)
    -- chip_smoke.py phase 13 (c) at smoke size."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch import mesh as PM
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models.config import SHAPES, ShapeConfig
    from repro_torch.models.model import Model

    cfg = smoke_config("whisper-tiny")
    monkeypatch.setitem(SHAPES, "decode_32k", ShapeConfig("decode_32k", 256, 8, "decode"))
    s = SHAPES["decode_32k"]
    try:
        rec = run_cell("whisper-tiny", "decode_32k", False, str(tmp_path), mesh_shape=(1, 1),
                       overrides=dict(cfg=cfg))
    finally:
        PM.destroy_fake_world()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = Model(cfg, device=cuda_device, param_dtype=torch.bfloat16)
    caches = model.init_cache(s.global_batch, s.seq_len)
    token = torch.zeros(s.global_batch, dtype=torch.int32, device=cuda_device)
    real = torch.cuda.memory_allocated() - base
    sizes = [t.nbytes for t in (*model.parameters(), *(t for c in caches for t in c.values()),
                                token)]
    est = rec["memory"]["argument_size_in_bytes"]
    assert sum(sizes) == est
    slack = sum(512 if n <= 1 << 20 else 2 << 20 for n in sizes)
    assert abs(real - est) <= slack, (est, real, slack)
    assert rec["hbm_per_device_gb"] * 2**30 >= est - 2**30 * 5e-4  # rounded to 1e-3 GB


# ---------------------------------------------------------------------------
# the device-discipline analyzer on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_graph_lint_on_card(cuda_device):
    """Every registered kernel runs on the card with no finding, each hand
    kernel's builder launches it (no fallback to the plain version), and
    every output equals the same builder's on the CPU (bits, fp64 to
    1e-12)."""
    from repro_torch.analysis import graph_lint, registry

    launched = {}
    for spec in registry.kernel_specs():
        run = graph_lint.run_kernel(spec, cuda_device)
        assert graph_lint.findings_of(run) == [], spec.name
        launched.update(run.launches)
        cpu = graph_lint.run_kernel(spec, "cpu")
        assert graph_lint.same_outputs(run.output, cpu.output), spec.name
    assert launched == {"eval_mega": 1, "sig_eval": 1, "cim": 1}


@pytest.mark.cuda
def test_lint_cli_on_card(cuda_device):
    import os
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH="src")
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint", "--device", "cuda"],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith("0 new finding(s), 0 baselined, 0 total")


@pytest.mark.cuda
def test_softplus_backward_rule_on_a_card_dtensor(cuda_device):
    """`parallel.sharding`'s rule on a one-rank CUDA mesh: the op keeps
    ``Shard(0)`` and equals the plain op, directly and through autograd."""
    import torch.distributed as dist
    import torch.nn.functional as F
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.parallel import sharding  # noqa: F401  (registers the rule)

    if dist.is_initialized():
        pytest.skip("a default process group is up already")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = DeviceMesh("cuda", [0])
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.normal(scale=10.0, size=(8, 16))).to(cuda_device)
        g = torch.from_numpy(rng.normal(size=(8, 16))).to(cuda_device)
        want = torch.ops.aten.softplus_backward(g, x, 1.0, 20.0)
        dx, dg = (DTensor.from_local(t, mesh, (Shard(0),)) for t in (x, g))
        out = torch.ops.aten.softplus_backward(dg, dx, 1.0, 20.0)
        assert out.placements == (Shard(0),) and torch.equal(out.to_local(), want)
        leaf = dx.detach().requires_grad_()
        F.softplus(leaf).backward(dg)
        assert torch.equal(leaf.grad.to_local(), want)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Decode attention: the hand kernel against the plain version
# ---------------------------------------------------------------------------

#: (id, dtype, batch, slots, KV heads, n_rep, head_dim, kind, window, pos, sliced cache)
DECODE_CASES = [
    ("minicpm-cell-2048", torch.bfloat16, 32, 2176, 36, 1, 64, "attn", 0, 2048, False),
    ("minicpm-cell-2175", torch.bfloat16, 32, 2176, 36, 1, 64, "attn", 0, 2175, False),
    ("deepseek-cell", torch.bfloat16, 256, 384, 16, 1, 128, "attn", 0, 320, False),
    ("gqa2-ring-before-wrap", torch.bfloat16, 4, 1024, 16, 2, 128, "local", 1024, 700, False),
    ("gqa2-ring-after-wrap-sliced", torch.bfloat16, 4, 1024, 16, 2, 128, "local", 1024, 2500,
     True),
    ("mqa16-hd256-ring", torch.bfloat16, 4, 2048, 1, 16, 256, "local", 2048, 3000, False),
    ("gqa7-long-split-by-shared-memory", torch.bfloat16, 40, 4096, 8, 7, 128, "attn", 0, 3999,
     False),
    ("gqa7-one-sequence-split", torch.bfloat16, 1, 8192, 8, 7, 128, "attn", 0, 8000, False),
    ("windowed-not-ring", torch.bfloat16, 3, 300, 4, 1, 64, "local", 64, 250, False),
    ("smoke-hd16-gqa4", torch.bfloat16, 2, 28, 1, 4, 16, "attn", 0, 21, False),
    ("fp32-mha-hd64", torch.float32, 2, 100, 4, 1, 64, "attn", 0, 77, False),
    ("fp32-mqa16-hd256-split", torch.float32, 2, 2048, 1, 16, 256, "local", 2048, 2300, False),
    ("fp32-smoke-hd16-gqa2-ring", torch.float32, 2, 16, 2, 2, 16, "local", 16, 25, False),
]


def _decode_operands(dev, dtype, b, s, kv, n_rep, hd, sliced, seed):
    """Seeded q, new k and v (B, 1, *, D) and a cache; ``sliced``: the cache
    is the last ``s`` slots of a longer one (a ring cut from a prefill)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=g, device=dev).to(dtype)
    q, kn, vn = mk(b, 1, kv * n_rep, hd), mk(b, 1, kv, hd), mk(b, 1, kv, hd)
    extra = 7 if sliced else 0
    k, v = mk(b, s + extra, kv, hd)[:, extra:], mk(b, s + extra, kv, hd)[:, extra:]
    return q, kn, vn, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_decode_attention_kernel_matches_plain_on_card(cuda_device, case):
    """One kernel launch against `decode_attend` on the same CUDA tensors.
    The caches after the append are bit-equal (RoPE rounds as the eager
    ops do); the output lies within `decode_attn.tolerance` of the plain
    version's, element by element (in bf16 one unit in the last place of
    each output, plus 2^-8 of the mean output).  A launch that skips the
    oldest valid slot must leave that bound."""
    import types

    from repro_torch.kernels import decode_attn as DA
    from repro_torch.models import layers as L

    _, dtype, b, s, kv, n_rep, hd, kind, window, pos, sliced = case
    cfg = types.SimpleNamespace(n_heads=kv * n_rep, n_kv_heads=kv, window=window)
    q, kn, vn, k, v = _decode_operands(cuda_device, dtype, b, s, kv, n_rep, hd, sliced, pos)
    plain, kern = dict(k=k.clone(), v=v.clone()), dict(k=k, v=v)
    skip = dict(k=k.clone(), v=v.clone())
    want = L.decode_attend(q, kn, vn, plain, cfg, kind, 10000.0, pos)
    before = DA.LAUNCHES["decode_attn"]
    got = L.decode_attend_kernel(q, kn, vn, kern, cfg, kind, 10000.0, pos)
    torch.cuda.synchronize()
    assert DA.LAUNCHES["decode_attn"] == before + 1
    assert kern["k"].data_ptr() == k.data_ptr()  # in place, the slice too
    for name in ("k", "v"):
        assert torch.equal(_bits(kern[name].contiguous()), _bits(plain[name].contiguous())), name
    assert got.shape == want.shape and got.dtype == want.dtype
    tol = DA.tolerance(want, plain["v"])
    gap = (got.float() - want.float()).abs()
    print(f"{case[0]}: max |kernel - plain| = {float(gap.max()):.3e}, at most "
          f"{float((gap / tol).max()):.4f} of the tolerance")
    assert bool((gap <= tol).all())
    first, n = L.decode_window(kind, cfg, s, pos)
    inv_freq = L.rope_inv_freq(hd, 10000.0, cuda_device)
    off = DA.decode_attention(q, kn, vn, skip["k"], skip["v"], inv_freq, pos, (first + 1) % s,
                              n - 1, 1.0 / math.sqrt(hd))
    skipped = float(((off.float() - want.float()).abs() / tol).max())
    print(f"{case[0]}: the oldest slot skipped, {skipped:.2f}x the tolerance")
    assert skipped > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minicpm-2b", "gemma3-27b", "recurrentgemma-9b",
                                  "qwen1.5-4b"])
def test_decode_step_launches_the_kernel_once_an_attention_layer(cuda_device, arch):
    """A bf16 smoke model's `decode_step` on the card launches the kernel
    once per attention layer (global, local ring and windowed) and no
    more; the tracer's ``attn.decode_kernel`` counts the same only while
    it is on."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels import decode_attn as DA
    from repro_torch.models.config import ParallelConfig
    from repro_torch.models.model import Model
    from repro_torch.runtime import trace
    from repro_torch.serve.engine import align_prefill_caches

    cfg = smoke_config(arch)
    m = Model(cfg, ParallelConfig(), compute_dtype=torch.bfloat16, q_chunk=8, kv_chunk=8,
              device=cuda_device).init(torch.Generator(device=cuda_device).manual_seed(0))
    n_attn = sum(k in ("attn", "local", "xattn") for k in m.kinds)
    assert n_attn
    B, P = 2, 20
    tt = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, P + 4)),
                         device=cuda_device)
    with torch.inference_mode():
        _, caches = m.prefill(dict(tokens=tt[:, :P]))
        caches = align_prefill_caches(m, caches, P, P + 4, batch=B)
        before = DA.LAUNCHES["decode_attn"]
        _, caches = m.decode_step(caches, tt[:, P], P)
        assert DA.LAUNCHES["decode_attn"] == before + n_attn
        trace.reset()
        trace.enable()
        try:
            _, caches = m.decode_step(caches, tt[:, P + 1], P + 1)
        finally:
            trace.disable()
        assert trace.collect()["counters"].get("attn.decode_kernel") == n_attn
        trace.reset()
        _, caches = m.decode_step(caches, tt[:, P + 2], P + 2)
        assert trace.collect()["counters"] == {}
        assert DA.LAUNCHES["decode_attn"] == before + 3 * n_attn
