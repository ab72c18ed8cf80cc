"""The port's front-half engine (`repro_torch.kernels.aig_sim`, K1) against
the reference package.

On CPU tensors the K1 wrappers run their plain torch versions, which is
what these tests drive (``device="cpu"``).  Inputs are made from a seed
with numpy, built once as reference AIGs and carried into the port
through `repro_torch.core.interop`, so both packages see identical
operands.  Truth tables and signatures must be bit-identical to the
reference's jnp engine and to python-int `Aig.truth_table`; the port's
device-backend transforms must give the same output fingerprints as the
reference's python transforms.  The CUDA kernel itself is checked in
`tests/test_torch_cuda.py`.
"""

import numpy as np
import pytest
import torch

from repro.core import circuits as RC
from repro.core import transforms as RT
from repro.core.aig import Aig as RAig
from repro.core.aig import lit
from repro.kernels import aig_sim as RA
from repro_torch.core import circuits as PC
from repro_torch.core import transforms as PT
from repro_torch.core.interop import aig_from_dict
from repro_torch.kernels import aig_sim as PA

CPU = "cpu"


def random_aig(rng, n_pis=6, n_ands=60) -> RAig:
    """Random strashed reference AIG (each node ANDs two random prior
    literals with random phases, so cones reconverge)."""
    aig = RAig(n_pis)
    lits = [lit(i) for i in range(1, n_pis + 1)]
    for _ in range(n_ands):
        i, j = rng.integers(0, len(lits), size=2)
        out = aig.g_and(int(lits[i]) ^ int(rng.integers(2)), int(lits[j]) ^ int(rng.integers(2)))
        if out > 1:
            lits.append(out)
    aig.add_po(lits[-1])
    return aig


def cone_queries(rng, aig, n_queries, max_leaves):
    """Single-root queries over reconvergence cuts, shuffled support,
    random root phase."""
    ands = list(range(aig.n_pis + 1, aig.n_nodes))
    items = []
    for _ in range(n_queries):
        root = int(ands[rng.integers(len(ands))])
        support = list(RT._reconv_cut(aig, root, max_leaves=max_leaves))
        rng.shuffle(support)
        items.append(((lit(root, int(rng.integers(2))),), support))
    return items


def assert_port_matches(ref_aig, items):
    """Port (plain torch, CPU) == reference jnp engine == Aig.truth_table."""
    port_aig = aig_from_dict(ref_aig.to_dict())
    got = PA.eval_tts(port_aig, items, device=CPU)
    want = RA.eval_tts(ref_aig, items, engine="jnp")
    assert got == want
    for (roots, support), tts in zip(items, got):
        for rl, tt in zip(roots, tts):
            assert tt == ref_aig.truth_table(rl, list(support))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eval_tts_matches_reference_and_truth_table(seed):
    """Every word tier the device path packs (k <= 5 -> W=1, k <= 10 ->
    W=32) plus the host bigint path for k > DEVICE_MAX_VARS."""
    rng = np.random.default_rng(seed)
    aig = random_aig(rng, n_pis=12, n_ands=160)
    items = cone_queries(rng, aig, 24, max_leaves=4)
    items += cone_queries(rng, aig, 16, max_leaves=9)
    items += cone_queries(rng, aig, 4, max_leaves=12)
    ks = {len(s) for _, s in items}
    assert min(ks) <= 5 and any(5 < k <= 10 for k in ks)
    assert_port_matches(aig, items)


def test_eval_tts_multi_root_resub_cones():
    """resub-style items: several roots over one union support."""
    rng = np.random.default_rng(4)
    aig = random_aig(rng, n_pis=7, n_ands=70)
    ands = list(range(aig.n_pis + 1, aig.n_nodes))
    items = []
    for _ in range(10):
        n, m = sorted(int(ands[p]) for p in rng.integers(0, len(ands), size=2))
        sup = sorted(set(RT._reconv_cut(aig, n, 6)) | set(RT._reconv_cut(aig, m, 6)))
        items.append(((lit(n), lit(m, int(rng.integers(2)))), sup))
    assert_port_matches(aig, items)


def test_eval_tts_wide_support_fallback():
    """Supports wider than DEVICE_MAX_VARS mixed with device queries."""
    rng = np.random.default_rng(5)
    aig = random_aig(rng, n_pis=PA.DEVICE_MAX_VARS[CPU] + 3, n_ands=90)
    items = [((lit(aig.n_nodes - 1),), list(range(1, aig.n_pis + 1)))]
    items += cone_queries(rng, aig, 6, max_leaves=5)
    assert_port_matches(aig, items)
    port_aig = aig_from_dict(aig.to_dict())
    root = lit(aig.n_nodes - 2, 1)
    sup = list(RT._reconv_cut(aig, aig.n_nodes - 2, max_leaves=5))
    assert PA.eval_tt(port_aig, root, sup, device=CPU) == aig.truth_table(root, sup)


def _decode(out: np.ndarray, batch, items, idxs):
    """Truth tables of one packed batch's queries from its (Q, W) output."""
    out = out.view(np.uint32)
    tts = {}
    for pos, idx in enumerate(idxs):
        roots, sup = items[idx]
        mask = (1 << (1 << len(sup))) - 1
        tts[idx] = tuple(
            int.from_bytes(out[int(batch.qoff[pos]) + ri].tobytes(), "little") & mask
            for ri in range(len(roots))
        )
    return tts


def wide_items(ref_aig, n_max=12):
    """Two-root (resub-shaped) queries over reconvergence cuts of 11-14
    leaves, the W=512 tier."""
    items = [
        ((lit(n), lit(n, 1)), list(RT._reconv_cut(ref_aig, n, 14)))
        for n in range(ref_aig.n_nodes - 1, ref_aig.n_pis, -1)
    ]
    items = [it for it in items if 11 <= len(it[1]) <= 14][:n_max]
    assert items, "no wide cones in the random graph"
    return items


def assert_batch_matches_truth_table(ref_aig, items, w):
    """Pack ``items`` (all of tier ``w``) as one batch, run it through the
    wrapper on the CPU and hold every table against `Aig.truth_table`.
    Returns the batch."""
    aig = aig_from_dict(ref_aig.to_dict())
    idxs = list(range(len(items)))
    assert {PA._tier_for(len(s))[1] for _, s in items} == {w}
    prog = PA.compile_aig(aig)
    mem = PA._cone_members(aig, items, idxs)
    batch = PA._pack_mega(aig, prog, items, idxs, w, mem)
    k_max = next(km for km, tw in PA._TIERS if tw == w)
    out = PA.eval_mega(*batch.operands(torch.device(CPU), PA._dev_elem(k_max, torch.device(CPU))))
    for i, tts in _decode(out.numpy(), batch, items, idxs).items():
        roots, sup = items[i]
        assert tts == tuple(ref_aig.truth_table(rl, sup) for rl in roots)
    return batch


def test_w512_tier_plain_version_matches_truth_table(monkeypatch):
    """The W=512 (k = 11..14) tier, packed as a multi-chunk batch with the
    row budget and column slice forced small."""
    monkeypatch.setitem(PA._MEGA_BUDGET, 512, 64)
    monkeypatch.setitem(PA._MEGA_SLICE, 512, 2)
    rng = np.random.default_rng(11)
    ref_aig = random_aig(rng, n_pis=14, n_ands=220)
    batch = assert_batch_matches_truth_table(ref_aig, wide_items(ref_aig), 512)
    assert len(batch.meta) > 1 and batch.cw == 2


@pytest.mark.parametrize("w,max_leaves", [(1, 5), (32, 10)])
def test_multi_chunk_batch_matches_truth_table(monkeypatch, w, max_leaves):
    """The W=1 and W=32 tiers as multi-chunk batches (row budget forced
    small), decoded per chunk, against `Aig.truth_table`."""
    monkeypatch.setitem(PA._MEGA_BUDGET, w, 32)
    monkeypatch.setitem(PA._MEGA_SLICE, w, 1)
    rng = np.random.default_rng(20 + w)
    ref_aig = random_aig(rng, n_pis=12, n_ands=200)
    items = cone_queries(rng, ref_aig, 60, max_leaves=max_leaves)
    lo = 1 if w == 1 else 6
    items = [it for it in items if lo <= len(it[1]) <= max_leaves]
    batch = assert_batch_matches_truth_table(ref_aig, items, w)
    assert len(batch.meta) > 2


def test_sparse_row_lookup_matches_reference(monkeypatch):
    """The packer's sparse (query, node) -> row lookup on a random AIG,
    with queries whose root is one of its own support nodes (a pinned
    row) or const0, across chunk boundaries: same tables as the
    reference's jnp engine and `Aig.truth_table`."""
    monkeypatch.setitem(PA._MEGA_BUDGET, 1, 16)
    monkeypatch.setitem(PA._MEGA_BUDGET, 32, 48)
    rng = np.random.default_rng(21)
    ref_aig = random_aig(rng, n_pis=10, n_ands=150)
    items = cone_queries(rng, ref_aig, 30, max_leaves=4)
    items += cone_queries(rng, ref_aig, 20, max_leaves=9)
    for (_, sup) in items[:6]:
        items.append(((lit(sup[0], 1),), sup))  # root pinned to a support row
    items.append(((0, 1), [1, 2]))  # const0 / const1 roots read row 0
    assert_port_matches(ref_aig, items)


def test_eval_tts_w512_tier_through_the_engine(monkeypatch):
    """`eval_tts` routes k = 11..14 through `eval_mega` where the device
    takes that tier (CUDA); forced here on the CPU, with several chunks,
    so the W=512 packing and unpacking run against the reference."""
    monkeypatch.setitem(PA.DEVICE_MAX_VARS, "cpu", PA.MAX_VARS)
    monkeypatch.setitem(PA._MEGA_BUDGET, 512, 64)
    rng = np.random.default_rng(22)
    ref_aig = random_aig(rng, n_pis=14, n_ands=220)
    items = wide_items(ref_aig) + cone_queries(rng, ref_aig, 8, max_leaves=6)
    aig = aig_from_dict(ref_aig.to_dict())
    before = PA.TIER_LAUNCHES[512]

    def no_host_tables(*args, **kw):
        raise AssertionError("Aig.truth_table called for a tier the engine takes")

    monkeypatch.setattr(type(aig), "truth_table", no_host_tables)
    got = PA.eval_tts(aig, items, device=CPU)
    monkeypatch.undo()
    assert got == RA.eval_tts(ref_aig, items, engine="jnp")
    assert PA.TIER_LAUNCHES[512] == before  # the plain version is no launch


def test_device_max_vars_by_device():
    """K1 takes every tier on CUDA; the CPU's plain version stops at 10,
    as the reference's jnp engine does.  No card is needed to ask."""
    assert PA.DEVICE_MAX_VARS[torch.device("cuda").type] == 14 == PA.MAX_VARS
    assert PA.DEVICE_MAX_VARS[torch.device(CPU).type] == 10 == RA.DEVICE_MAX_VARS


def test_chunk_checks_refuse_out_of_range_rows():
    """The host checks run before upload refuse a wave or root row outside
    its chunk, a chunk range past its operand, and a chunk taller than
    the launch's ``max_rows``."""
    rng = np.random.default_rng(23)
    aig = aig_from_dict(random_aig(rng).to_dict())
    items = [((lit(n),), [1, 2, 3, 4]) for n in range(aig.n_nodes - 1, aig.n_nodes - 6, -1)]
    idxs = list(range(len(items)))
    batch = PA._pack_mega(aig, PA.compile_aig(aig), items, idxs, 1,
                          PA._cone_members(aig, items, idxs))
    args = (batch.waves, batch.meta, len(batch.pin_rows), batch.max_rows, batch.rootp)
    PA._check_chunks(*args)
    bad = batch.waves.copy()
    bad[0, 0, 1] = batch.meta[0, 3]  # one past chunk 0's rows
    with pytest.raises(ValueError, match="row index"):
        PA._check_chunks(bad, *args[1:])
    rootp = batch.rootp.copy()
    rootp[0] = batch.meta[0, 3] << 1
    with pytest.raises(ValueError, match="row index"):
        PA._check_chunks(*args[:4], rootp)
    meta = batch.meta.copy()
    meta[-1, 2] += 1  # the last chunk's rows run past the pin map
    with pytest.raises(ValueError, match="run past"):
        PA._check_chunks(batch.waves, meta, *args[2:])
    with pytest.raises(ValueError, match="max_rows"):
        PA._check_chunks(*args[:3], batch.max_rows - 1, batch.rootp)


def test_plain_versions_match_reference_jnp_engine_on_raw_operands(monkeypatch):
    """The K1 contracts on raw operands: the port's plain `eval_mega` /
    `sig_eval` on a one-chunk batch against the reference jnp engine's,
    bit for bit."""
    monkeypatch.setitem(PA._MEGA_BUDGET, 32, 1 << 20)
    rng = np.random.default_rng(12)
    ref_aig = random_aig(rng, n_pis=9, n_ands=120)
    aig = aig_from_dict(ref_aig.to_dict())
    items = cone_queries(rng, ref_aig, 40, max_leaves=8)
    idxs = [i for i, (_, s) in enumerate(items) if len(s) > 5]
    prog = PA.compile_aig(aig)
    mem = PA._cone_members(aig, items, idxs)
    jnp_mega, jnp_sig = RA._make_jnp_mega(), RA._make_jnp_sig()
    batch = PA._pack_mega(aig, prog, items, idxs, 32, mem)
    assert len(batch.meta) == 1
    got = PA.eval_mega(*batch.operands(torch.device(CPU), PA._dev_elem(10, torch.device(CPU))))
    want = np.asarray(jnp_mega(batch.waves, batch.pin_rows, RA._elem_words(10), batch.rootp))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    vals0 = rng.integers(0, 1 << 32, size=(prog.n_pad, 4), dtype=np.uint64).astype(np.uint32)
    meta = torch.tensor([[0, len(prog.waves), 0, prog.n_pad]], dtype=torch.int32)
    got = PA.sig_eval(
        torch.from_numpy(prog.waves), torch.from_numpy(vals0.view(np.int32)), meta, prog.n_pad
    )
    want = np.asarray(jnp_sig(prog.waves, vals0))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_sig_eval_plain_batch_of_graphs_matches_reference():
    """`sig_eval`'s batched contract over two graphs' row spaces back to
    back: each chunk equals the reference jnp engine on its own graph."""
    rng = np.random.default_rng(24)
    jnp_sig = RA._make_jnp_sig()
    progs = [PA.compile_aig(aig_from_dict(random_aig(rng, 6, n).to_dict())) for n in (40, 90)]
    width = max(p.waves.shape[1] for p in progs)
    waves, vals, meta, want = [], [], [], []
    for p in progs:
        wv = np.zeros((len(p.waves), width, 4), dtype=np.int32)
        wv[..., 3] = p.n_pad - 1
        wv[:, : p.waves.shape[1]] = p.waves
        v0 = rng.integers(0, 1 << 32, size=(p.n_pad, 3), dtype=np.uint64).astype(np.uint32)
        meta.append([sum(len(x) for x in waves), len(wv), sum(len(x) for x in vals), p.n_pad])
        waves.append(wv)
        vals.append(v0)
        want.append(np.asarray(jnp_sig(p.waves, v0)))
    got = PA.sig_eval(
        torch.from_numpy(np.concatenate(waves)),
        torch.from_numpy(np.concatenate(vals).view(np.int32)),
        torch.tensor(meta, dtype=torch.int32),
        max(p.n_pad for p in progs),
    )
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.concatenate(want))


@pytest.mark.parametrize("seed", [7, 8])
def test_node_signatures_match_reference(seed):
    rng = np.random.default_rng(seed)
    ref_aig = random_aig(rng, n_pis=8, n_ands=100)
    patterns = rng.integers(0, 1 << 63, size=(ref_aig.n_pis, 3), dtype=np.int64).astype(
        np.uint64
    )
    got = PA.node_signatures(aig_from_dict(ref_aig.to_dict()), patterns, device=CPU)
    np.testing.assert_array_equal(got, RT._node_signatures(ref_aig, patterns))
    np.testing.assert_array_equal(got, RA.node_signatures(ref_aig, patterns, engine="jnp"))


TRANSFORM_CIRCUITS = {
    "adder-8": ("gen_adder", (8,)),
    "max-8x4": ("gen_max", (8, 4)),
    "sqrt-8": ("gen_sqrt", (8,)),
}


@pytest.mark.parametrize("transform", ["Ba", "Rw", "Rf", "Rs"])
@pytest.mark.parametrize("circuit", list(TRANSFORM_CIRCUITS))
def test_device_transforms_match_reference_python(circuit, transform):
    """Port, device backend on the plain torch versions, against the
    reference's python transforms: the same output structure."""
    gen, args = TRANSFORM_CIRCUITS[circuit]
    ref_rtl = getattr(RC, gen)(*args)
    rtl = getattr(PC, gen)(*args)
    assert rtl.fingerprint() == ref_rtl.fingerprint()
    out = PT.transform_fns("device", device=CPU)[transform](rtl)
    want = RT.transform_fns("python")[transform](ref_rtl)
    assert out.fingerprint() == want.fingerprint()
    assert out.characterize().to_dict() == want.characterize().to_dict()


def test_launch_counter_untouched_by_plain_versions():
    rng = np.random.default_rng(13)
    aig = aig_from_dict(random_aig(rng).to_dict())
    before = dict(PA.LAUNCHES), dict(PA.TIER_LAUNCHES)
    PA.eval_tts(aig, [((lit(aig.n_nodes - 1),), list(range(1, aig.n_pis + 1)))], device=CPU)
    PA.node_signatures(aig, np.ones((aig.n_pis, 1), dtype=np.uint64), device=CPU)
    assert (PA.LAUNCHES, PA.TIER_LAUNCHES) == before


def test_device_faults_turn_cuda_errors_into_kernel_error():
    """A kernel fault surfaces at the next sync as torch's RuntimeError;
    on a CUDA device `device_faults` makes it a `KernelError`.  On the CPU
    errors pass through unchanged, and a `ValueError` never converts."""
    from repro_torch.kernels import build

    with pytest.raises(build.KernelError, match="illegal memory access"):
        with build.device_faults("eval_mega", torch.device("cuda")):
            raise torch.AcceleratorError("CUDA error: an illegal memory access")
    with pytest.raises(RuntimeError) as info:
        with build.device_faults("eval_mega", torch.device(CPU)):
            raise RuntimeError("shape mismatch")
    assert not isinstance(info.value, build.KernelError)
    with pytest.raises(ValueError):
        with build.device_faults("eval_mega", torch.device("cuda")):
            raise ValueError("row index")


def test_kernel_fault_is_never_quarantined(monkeypatch):
    """With ``failures=`` a circuit whose transforms raise is quarantined,
    but a `KernelError` from K1 ends the suite."""
    from repro_torch.kernels import build

    def fault(*args, **kw):
        raise build.KernelError("k1_eval_mega: CUDA error 700 at launch")

    suite = {"adder": PC.gen_adder(4)}
    failures = {}
    monkeypatch.setattr(PA, "eval_mega", fault)
    with pytest.raises(build.KernelError):
        PT.characterize_suite(suite, recipes=[("Rw",)], n_jobs=1, backend="device",
                              failures=failures, device=CPU)
    assert failures == {}

    def bad_netlist(*args, **kw):
        raise ValueError("not a kernel fault")

    monkeypatch.setattr(PA, "eval_mega", bad_netlist)
    out = PT.characterize_suite(suite, recipes=[("Rw",)], n_jobs=1, backend="device",
                                failures=failures, device=CPU)
    assert out == {} and set(failures) == {"adder"}
