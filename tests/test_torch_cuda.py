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

import numpy as np
import pytest
import torch

from repro_torch.core import circuits as C
from repro_torch.core import transforms as T
from repro_torch.core.aig import Aig, lit
from repro_torch.kernels import aig_sim as A
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


@pytest.mark.cuda
def test_k1_eval_mega_matches_plain_on_card(cuda_device):
    """Every word tier (W = 1 / 32 / 512) through the kernel and the plain
    version; the decoded tables also equal `Aig.truth_table`."""
    rng = np.random.default_rng(14)
    aig = random_aig(rng, n_pis=14, n_ands=300)
    prog = A.compile_aig(aig)
    ands = list(range(aig.n_pis + 1, aig.n_nodes))
    items = []
    for max_leaves in (4, 10, 14):
        for n in rng.choice(ands, size=40, replace=False):
            items.append(((lit(int(n), int(rng.integers(2))),), T._reconv_cut(aig, int(n), max_leaves)))
    tiers: dict[int, list[int]] = {}
    for i, (_, s) in enumerate(items):
        tiers.setdefault(A._tier_for(len(s))[1], []).append(i)
    assert set(tiers) == {1, 32, 512}
    before = A.LAUNCHES["eval_mega"]
    n_chunks = 0
    for w, idxs in tiers.items():
        k_max = next(km for km, tw in A._TIERS if tw == w)
        mem = A._cone_members(aig, items, idxs)
        for ch in A._pack_mega_chunks(aig, prog, items, idxs, w, mem):
            ops_ = (
                torch.from_numpy(ch.waves).to(cuda_device),
                torch.from_numpy(ch.pin_rows).to(cuda_device),
                A._dev_elem(k_max, cuda_device),
                torch.from_numpy(ch.rootp).to(cuda_device),
            )
            got = A.eval_mega(*ops_)
            torch.cuda.synchronize()
            n_chunks += 1
            assert torch.equal(got, A.eval_mega_plain(*ops_))
            out = got.cpu().numpy().view(np.uint32)
            for bi, p in enumerate(ch.positions):
                roots, sup = items[idxs[p]]
                mask = (1 << (1 << len(sup))) - 1
                row = out[int(ch.qoff[bi])]
                assert int.from_bytes(row.tobytes(), "little") & mask == aig.truth_table(roots[0], sup)
            bad = ch.waves.copy()
            bad[0, 0, 1] = len(ch.pin_rows)
            with pytest.raises(ValueError, match="row index"):
                A._check_mega_rows(bad, len(ch.pin_rows), ch.rootp)
    assert A.LAUNCHES["eval_mega"] == before + n_chunks


@pytest.mark.cuda
def test_k1_signatures_and_eval_tts_on_card(cuda_device):
    rng = np.random.default_rng(15)
    aig = random_aig(rng, n_pis=10, n_ands=400)
    patterns = rng.integers(0, 1 << 63, size=(aig.n_pis, 4), dtype=np.int64).astype(np.uint64)
    before = A.LAUNCHES["sig_eval"]
    np.testing.assert_array_equal(
        A.node_signatures(aig, patterns, device=cuda_device), T._node_signatures(aig, patterns)
    )
    assert A.LAUNCHES["sig_eval"] == before + 1
    items = [((lit(n),), T._reconv_cut(aig, n, 8)) for n in range(aig.n_nodes - 1, aig.n_pis, -7)]
    assert A.eval_tts(aig, items, device=cuda_device) == A.eval_tts(aig, items, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("n_vec", [45, 1 << 16])
def test_k2_matches_plain_on_card(cuda_device, n_vec):
    rng = np.random.default_rng(9)
    net = C.gen_adder(16).to_gate_netlist()
    bits = rng.integers(0, 2, size=(32, n_vec), dtype=np.uint8)
    cc = ops.compile_netlist(net)
    planes, bw = ops.cim_planes(cc, ref.pack_vectors(bits))
    args = (torch.from_numpy(cc.instrs).to(cuda_device), torch.from_numpy(planes).to(cuda_device))
    kw = dict(n_rows=cc.n_rows, n_gates=cc.n_gates, n_pos=cc.n_pos, block_words=bw)
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
    got = K.cim_call(*args, n_rows=cc.n_rows, n_gates=cc.n_gates, n_pos=cc.n_pos, block_words=bw)
    torch.cuda.synchronize()
    assert torch.equal(got, K.cim_plain(*args, n_gates=cc.n_gates, n_pos=cc.n_pos))
