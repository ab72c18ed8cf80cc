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
    aig = random_aig(rng, n_pis=PA.DEVICE_MAX_VARS + 3, n_ands=90)
    items = [((lit(aig.n_nodes - 1),), list(range(1, aig.n_pis + 1)))]
    items += cone_queries(rng, aig, 6, max_leaves=5)
    assert_port_matches(aig, items)
    port_aig = aig_from_dict(aig.to_dict())
    root = lit(aig.n_nodes - 2, 1)
    sup = list(RT._reconv_cut(aig, aig.n_nodes - 2, max_leaves=5))
    assert PA.eval_tt(port_aig, root, sup, device=CPU) == aig.truth_table(root, sup)


def _decode(out: np.ndarray, chunk, items, idxs):
    """Truth tables of one packed chunk's queries from its (Q, W) output."""
    out = out.view(np.uint32)
    tts = {}
    for bi, p in enumerate(chunk.positions):
        roots, sup = items[idxs[p]]
        mask = (1 << (1 << len(sup))) - 1
        tts[idxs[p]] = tuple(
            int.from_bytes(out[int(chunk.qoff[bi]) + ri].tobytes(), "little") & mask
            for ri in range(len(roots))
        )
    return tts


def test_w512_tier_plain_version_matches_truth_table():
    """The W=512 (k = 11..14) tier stays in the kernel's contract even
    though `eval_tts` keeps such queries on the host: pack it directly."""
    rng = np.random.default_rng(11)
    ref_aig = random_aig(rng, n_pis=14, n_ands=220)
    aig = aig_from_dict(ref_aig.to_dict())
    items = [
        ((lit(n), lit(n, 1)), list(RT._reconv_cut(ref_aig, n, 14)))
        for n in range(aig.n_nodes - 1, aig.n_pis, -1)
    ]
    items = [it for it in items if 11 <= len(it[1]) <= 14][:12]
    assert items, "no wide cones in the random graph"
    idxs = list(range(len(items)))
    prog = PA.compile_aig(aig)
    mem = PA._cone_members(aig, items, idxs)
    chunks = PA._pack_mega_chunks(aig, prog, items, idxs, 512, mem)
    elem = PA._dev_elem(14, torch.device(CPU))
    for ch in chunks:
        out = PA.eval_mega(
            torch.from_numpy(ch.waves), torch.from_numpy(ch.pin_rows), elem,
            torch.from_numpy(ch.rootp),
        ).numpy()
        for i, tts in _decode(out, ch, items, idxs).items():
            roots, sup = items[i]
            assert tts == tuple(ref_aig.truth_table(rl, sup) for rl in roots)


def test_plain_versions_match_reference_jnp_engine_on_raw_operands():
    """The K1 contracts on raw operands: the port's plain `eval_mega` /
    `sig_eval` against the reference jnp engine's, bit for bit."""
    rng = np.random.default_rng(12)
    ref_aig = random_aig(rng, n_pis=9, n_ands=120)
    aig = aig_from_dict(ref_aig.to_dict())
    items = cone_queries(rng, ref_aig, 40, max_leaves=8)
    idxs = [i for i, (_, s) in enumerate(items) if len(s) > 5]
    prog = PA.compile_aig(aig)
    mem = PA._cone_members(aig, items, idxs)
    jnp_mega, jnp_sig = RA._make_jnp_mega(), RA._make_jnp_sig()
    for ch in PA._pack_mega_chunks(aig, prog, items, idxs, 32, mem):
        got = PA.eval_mega(
            torch.from_numpy(ch.waves), torch.from_numpy(ch.pin_rows),
            PA._dev_elem(10, torch.device(CPU)), torch.from_numpy(ch.rootp),
        ).numpy()
        want = np.asarray(jnp_mega(ch.waves, ch.pin_rows, RA._elem_words(10), ch.rootp))
        np.testing.assert_array_equal(got.view(np.uint32), want)
    vals0 = rng.integers(0, 1 << 32, size=(prog.n_pad, 4), dtype=np.uint64).astype(np.uint32)
    got = PA.sig_eval(torch.from_numpy(prog.waves), torch.from_numpy(vals0.view(np.int32)))
    want = np.asarray(jnp_sig(prog.waves, vals0))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


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
    before = dict(PA.LAUNCHES)
    PA.eval_tts(aig, [((lit(aig.n_nodes - 1),), list(range(1, aig.n_pis + 1)))], device=CPU)
    PA.node_signatures(aig, np.ones((aig.n_pis, 1), dtype=np.uint64), device=CPU)
    assert PA.LAUNCHES == before


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
