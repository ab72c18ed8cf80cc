"""The port's CiM engine (`repro_torch.kernels.ops.cim_evaluate`, K2)
against the reference package and integer arithmetic.

On the CPU the K2 wrapper runs its plain torch version (an instruction
loop vectorized over words), which must be bit-equal to the reference's
pure-jnp oracle ``repro.kernels.ops.cim_reference_evaluate`` (the
reference's Pallas engine does not run in interpret mode under this jax)
and to the arithmetic the netlists implement.  Test vectors are made
from a seed with numpy; netlists come from the reference AIGs through
`repro_torch.core.interop`.  The CUDA kernel is checked in
`tests/test_torch_cuda.py`.
"""

import numpy as np
import pytest
import torch

from repro.core import circuits as RC
from repro.kernels import ops as ROPS
from repro_torch.core.interop import aig_from_dict
from repro_torch.kernels import build
from repro_torch.kernels import cim_logic as K
from repro_torch.kernels import ops, ref

CPU = "cpu"


def port_netlist(ref_aig):
    return aig_from_dict(ref_aig.to_dict()).to_gate_netlist()


def random_ref_aig(rng, n_pis=10, n_ands=120):
    from repro.core.aig import Aig, lit

    aig = Aig(n_pis)
    lits = [lit(i) for i in range(1, n_pis + 1)]
    for _ in range(n_ands):
        i, j = rng.integers(0, len(lits), size=2)
        out = aig.g_and(int(lits[i]) ^ int(rng.integers(2)), int(lits[j]) ^ int(rng.integers(2)))
        if out > 1:
            lits.append(out)
    for p in lits[-6:]:
        aig.add_po(int(p) ^ int(rng.integers(2)))
    return aig


def to_int(bits: np.ndarray) -> np.ndarray:
    """(n_bits, n_vec) LSB-first bit rows -> (n_vec,) python ints."""
    return np.array(
        [sum(int(bits[i, v]) << i for i in range(bits.shape[0])) for v in range(bits.shape[1])],
        dtype=object,
    )


@pytest.mark.parametrize("block_words", [128, 256, 512])
@pytest.mark.parametrize("n_vec", [1, 45, 1000])
def test_adder_matches_reference_and_arithmetic(n_vec, block_words):
    rng = np.random.default_rng(n_vec)
    n = 8
    ref_aig = RC.gen_adder(n)
    bits = rng.integers(0, 2, size=(2 * n, n_vec), dtype=np.uint8)
    got = ops.cim_evaluate(port_netlist(ref_aig), bits, block_words=block_words, device=CPU)
    want = ROPS.cim_reference_evaluate(ref_aig.to_gate_netlist(), bits)
    np.testing.assert_array_equal(got, want)
    a, b = to_int(bits[:n]), to_int(bits[n:])
    np.testing.assert_array_equal(to_int(got), a + b)


@pytest.mark.parametrize("block_words", [128, 512])
def test_max_matches_reference_and_arithmetic(block_words):
    rng = np.random.default_rng(3)
    n, k, n_vec = 6, 4, 300
    ref_aig = RC.gen_max(n, k)
    bits = rng.integers(0, 2, size=(n * k, n_vec), dtype=np.uint8)
    got = ops.cim_evaluate(port_netlist(ref_aig), bits, block_words=block_words, device=CPU)
    np.testing.assert_array_equal(got, ROPS.cim_reference_evaluate(ref_aig.to_gate_netlist(), bits))
    words = np.stack([to_int(bits[i * n : (i + 1) * n]) for i in range(k)])
    np.testing.assert_array_equal(to_int(got), words.max(axis=0))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_netlists_match_reference_and_truth_tables(seed):
    rng = np.random.default_rng(seed)
    ref_aig = random_ref_aig(rng)
    n_vec = 77
    bits = rng.integers(0, 2, size=(ref_aig.n_pis, n_vec), dtype=np.uint8)
    net = port_netlist(ref_aig)
    got = ops.cim_evaluate(net, bits, block_words=256, device=CPU)
    np.testing.assert_array_equal(got, ROPS.cim_reference_evaluate(ref_aig.to_gate_netlist(), bits))
    # Row reuse and the flat layout compute the same function; so does
    # the port's own oracle path.
    flat = ops.cim_evaluate(ops.compile_netlist(net, reuse_rows=False), bits, device=CPU)
    np.testing.assert_array_equal(got, flat)
    np.testing.assert_array_equal(got, ops.cim_reference_evaluate(net, bits, device=CPU))
    # And each PO against the AIG's own exhaustive truth table.
    support = list(range(1, ref_aig.n_pis + 1))
    idx = (bits.astype(np.int64) << np.arange(ref_aig.n_pis)[:, None]).sum(axis=0)
    for j, po in enumerate(ref_aig.pos):
        tt = ref_aig.truth_table(po, support)
        np.testing.assert_array_equal(got[j], [(tt >> int(i)) & 1 for i in idx])


def test_packed_words_round_trip():
    rng = np.random.default_rng(5)
    ref_aig = RC.gen_adder(6)
    bits = rng.integers(0, 2, size=(12, 64), dtype=np.uint8)
    net = port_netlist(ref_aig)
    words = ref.pack_vectors(bits)
    packed = ops.cim_evaluate(net, words, packed=True, device=CPU)
    np.testing.assert_array_equal(ref.unpack_vectors(packed, 64), ops.cim_evaluate(net, bits, device=CPU))


def test_cim_call_validates_operands():
    net = port_netlist(RC.gen_adder(4))
    cc = ops.compile_netlist(net)
    planes, bw = ops.cim_planes(cc, ref.pack_vectors(np.zeros((8, 40), np.uint8)))
    instrs = torch.from_numpy(cc.instrs)
    kw = dict(n_rows=cc.n_rows, n_gates=cc.n_gates, n_pos=cc.n_pos)
    with pytest.raises(ValueError):
        K.cim_call(instrs, torch.from_numpy(planes[:, :-1].copy()), block_words=bw, **kw)
    with pytest.raises(build.OperandError, match="int32"):
        K.cim_call(instrs.long(), torch.from_numpy(planes), block_words=bw, **kw)
    with pytest.raises(ValueError):
        K.cim_call(instrs[1:].contiguous(), torch.from_numpy(planes), block_words=bw, **kw)
    bad = instrs.clone()
    bad[0, 3] = planes.shape[0]
    with pytest.raises(ValueError, match="row index"):
        K.cim_call(bad, torch.from_numpy(planes), block_words=bw, **kw)
    with pytest.raises(ValueError, match="row index"):
        K.check_rows(bad.numpy(), planes.shape[0])  # the host check before upload
    before = dict(K.LAUNCHES)
    out = K.cim_call(instrs, torch.from_numpy(planes), block_words=bw, **kw)
    assert tuple(out.shape) == (K._round_up(cc.n_pos, K.SUBLANE), planes.shape[1])
    assert K.LAUNCHES == before  # the plain version is no launch
