"""K2's level schedule (`repro_torch.kernels.ops.cim_program`) against
the reference stream it is built from.

The CUDA kernel runs a `CimProgram`, not the reference's instruction
stream: the stream's gates in levels over a renamed register file.  On
the CPU these tests hold the program's structure (each level's gates
independent, every read row defined before its level, the level count
equal to the stream's true depth) and its plain executor
(`cim_logic.program_plain`) bit for bit against the stream's plain
version (`cim_logic.cim_plain`) and the reference package's pure-jnp
oracle ``repro.kernels.ops.cim_reference_evaluate``.  Netlists come from
the reference AIGs through `repro_torch.core.interop`, or are built gate
by gate in both packages; test vectors are made from a seed with numpy.
The kernel itself is held against both plain versions on the card in
`tests/test_torch_cuda.py`.
"""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import circuits as RC
from repro.core.aig import GateNetlist as RNet
from repro.kernels import ops as ROPS
from repro_torch.core import workloads as W
from repro_torch.core.aig import GateNetlist as PNet
from repro_torch.core.interop import aig_from_dict
from repro_torch.kernels import build
from repro_torch.kernels import cim_logic as K
from repro_torch.kernels import ops, ref

TILE_DEPTH = {"mac8": 54, "add16": 25, "max8": 19}
#: Depth of a level schedule that keeps the reference's reused rows.
KEPT_ROWS_DEPTH = {"mac8": 659, "add16": 169, "max8": 90}


def port_netlist(ref_aig):
    return aig_from_dict(ref_aig.to_dict()).to_gate_netlist()


def reference_netlists():
    """name -> (port netlist, reference netlist): the adder and max of the
    reference's circuits and the three workload tiles."""
    from repro.core import workloads as RW

    aigs = {"adder8": RC.gen_adder(8), "max6x4": RC.gen_max(6, 4), **RW.primitive_aigs()}
    return {name: (port_netlist(a), a.to_gate_netlist()) for name, a in aigs.items()}


NETS = reference_netlists()


def true_depth(cc) -> int:
    """Depth of the stream from read-after-write dependences alone."""
    level: dict[int, int] = {}
    depth = 0
    for _, a, b, o in cc.instrs[: cc.n_gates].tolist():
        level[o] = 1 + max(level.get(a, 0), level.get(b, 0))
        depth = max(depth, level[o])
    return depth


def depth_keeping_rows(cc) -> int:
    """Depth of the ASAP level schedule of the stream on its own rows:
    besides read-after-write, a gate waits for the last write of its
    output row (write after write) and, since a level loads before it
    stores, may share a level with the last read of that row's old value
    (write after read)."""
    written: dict[int, int] = {}
    read: dict[int, int] = {}
    depth = 0
    for _, a, b, o in cc.instrs[: cc.n_gates].tolist():
        level = max(1 + written.get(a, 0), 1 + written.get(b, 0), 1 + written.get(o, 0),
                    read.get(o, 0))
        read[a] = max(read.get(a, 0), level)
        read[b] = max(read.get(b, 0), level)
        written[o], read[o] = level, 0
        depth = max(depth, level)
    return depth


def check_schedule(p: K.CimProgram) -> None:
    """The program's structural invariants."""
    slots = p.section("slots").numpy()
    assert len(p.code) == 4 * p.n_slots + p.n_steps + 1 + p.n_chunks + 1 + p.n_in + p.n_pos
    assert p.levels[0] == 0 and p.levels[-1] == p.n_slots
    defined = set(range(p.n_in))  # rows holding a value a later level may read
    for lo, hi in zip(p.levels[:-1], p.levels[1:]):
        assert 0 < hi - lo and (hi - lo) % K.BATCH == 0
        level = slots[lo:hi]
        pad = level[:, 3] == p.pad_row
        assert (level[pad, :3] == (0, p.pad_row, p.pad_row)).all()
        real = level[~pad]
        assert len(real) > hi - lo - K.BATCH  # padding fills one batch at most
        outs = real[:, 3].tolist()
        reads = set(real[:, 1].tolist()) | set(real[:, 2].tolist())
        assert len(set(outs)) == len(outs), "two gates of a level write one row"
        assert not reads & set(outs), "a level reads a row it writes"
        assert reads <= defined, "a level reads a row no earlier level wrote"
        assert (real[:, 1:] < p.pad_row).all()
        defined |= set(outs)
    assert set(p.section("po_rows").tolist()) <= defined
    # Steps cut levels only at CHUNK_SLOTS; chunks of whole steps fit it.
    steps = p.section("steps").tolist()
    assert set(p.levels) <= set(steps)
    chunks = p.section("chunks").tolist()
    assert chunks[0] == 0 and chunks[-1] == p.n_steps
    for c0, c1 in zip(chunks[:-1], chunks[1:]):
        assert c0 < c1 and steps[c1] - steps[c0] <= K.CHUNK_SLOTS


def reference_bits(ref_net, bits) -> np.ndarray:
    """The reference's answer: its pure-jnp oracle, or, for a netlist with
    no gates (whose empty stream that oracle cannot index under this
    jax), the PO signals read off the PI bits and the constants."""
    if ref_net.gates:
        return ROPS.cim_reference_evaluate(ref_net, bits)
    signals = np.concatenate([np.zeros_like(bits[:1]), np.ones_like(bits[:1]), bits])
    return signals[ref_net.po_signals]


def run_both(cc, bits):
    """(program_plain, cim_plain) outputs over the packed vectors."""
    planes, _ = ops.cim_planes(cc, ref.pack_vectors(bits))
    planes = torch.from_numpy(planes)
    p = ops.cim_program(cc)
    got = K.program_plain(p, planes)
    want = K.cim_plain(torch.from_numpy(cc.instrs), planes, cc.n_gates, cc.n_pos)
    return got, want


@pytest.mark.parametrize("name", list(TILE_DEPTH))
def test_tile_levels_equal_true_depth(name):
    cc = ops.compile_netlist(W.primitive_aigs()[name].to_gate_netlist())
    p = ops.cim_program(cc)
    assert p.n_levels == true_depth(cc) == TILE_DEPTH[name]
    assert p.n_gates == cc.n_gates
    assert p.n_slots - p.n_gates < K.BATCH * p.n_levels


@pytest.mark.parametrize("name", list(KEPT_ROWS_DEPTH))
def test_reference_rows_would_serialize_the_levels(name):
    """The reference's allocator reuses rows from a LIFO free list, so on
    its own rows the tiles' gates would take 12x / 7x / 5x their true
    depth in levels: the program renames the rows."""
    cc = ops.compile_netlist(W.primitive_aigs()[name].to_gate_netlist())
    assert depth_keeping_rows(cc) == KEPT_ROWS_DEPTH[name]
    assert ops.cim_program(cc).n_levels == TILE_DEPTH[name]


@pytest.mark.parametrize("name", list(NETS))
def test_schedule_invariants(name):
    cc = ops.compile_netlist(NETS[name][0])
    check_schedule(ops.cim_program(cc))


@pytest.mark.parametrize("n_vec", [45, 1000])
@pytest.mark.parametrize("name", list(NETS))
def test_program_plain_matches_stream_and_reference(name, n_vec):
    net, ref_net = NETS[name]
    rng = np.random.default_rng(n_vec)
    bits = rng.integers(0, 2, size=(len(net.pi_signals), n_vec), dtype=np.uint8)
    cc = ops.compile_netlist(net)
    got, want = run_both(cc, bits)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        ref.unpack_vectors(got[: cc.n_pos].numpy(), n_vec),
        reference_bits(ref_net, bits),
    )


def test_adder_program_adds():
    n, n_vec = 8, 300
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, size=(2 * n, n_vec), dtype=np.uint8)
    cc = ops.compile_netlist(NETS["adder8"][0])
    got, _ = run_both(cc, bits)
    out = ref.unpack_vectors(got[: cc.n_pos].numpy(), n_vec).astype(np.int64)
    weights = 1 << np.arange(n, dtype=np.int64)
    total = (out * (1 << np.arange(out.shape[0], dtype=np.int64))[:, None]).sum(axis=0)
    a, b = (bits[:n] * weights[:, None]).sum(axis=0), (bits[n:] * weights[:, None]).sum(axis=0)
    np.testing.assert_array_equal(total, a + b)


def build_pair(n_pis: int, gates, pos):
    """The same netlist in both packages: signals 0 / 1 are const0 /
    const1, then the PIs, then one signal per gate (kind, a, b)."""
    nets = (PNet(), RNet())
    for net in nets:
        for _ in range(2 + n_pis):
            net._new_signal()
        net.pi_signals = list(range(2, 2 + n_pis))
        level = [0] * (2 + n_pis)
        for kind, a, b in gates:
            level.append(1 + max(level[a], level[b]))
            net._emit(kind, a, b, level[-1] - 1)
        net.po_signals = list(pos)
    return nets


@st.composite
def netlists(draw):
    n_pis = draw(st.integers(1, 6))
    gates = []
    for _ in range(draw(st.integers(0, 40))):
        n_sig = 2 + n_pis + len(gates)
        kind = draw(st.sampled_from(["nand", "nor", "inv"]))
        a = draw(st.integers(0, n_sig - 1))
        b = a if kind == "inv" else draw(st.integers(0, n_sig - 1))
        gates.append((kind, a, b))
    n_sig = 2 + n_pis + len(gates)
    pos = draw(st.lists(st.integers(0, n_sig - 1), min_size=1, max_size=8))
    return n_pis, gates, pos


@settings(max_examples=40, deadline=None, derandomize=True)
@given(netlists(), st.integers(1, 100), st.integers(0, 2**32 - 1))
def test_random_netlists(spec, n_vec, seed):
    """Random netlists: NOT gates, gates no PO reads, POs on PIs and on
    const0 / const1, duplicate POs, no gates at all, ragged vectors."""
    n_pis, gates, pos = spec
    net, ref_net = build_pair(n_pis, gates, pos)
    bits = np.random.default_rng(seed).integers(0, 2, size=(n_pis, n_vec), dtype=np.uint8)
    cc = ops.compile_netlist(net)
    p = ops.cim_program(cc)
    check_schedule(p)
    assert p.n_levels == true_depth(cc)
    got, want = run_both(cc, bits)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        ref.unpack_vectors(got[: cc.n_pos].numpy(), n_vec),
        reference_bits(ref_net, bits),
    )


@pytest.mark.parametrize("pos", [[2], [0], [1], [1, 0, 2, 2, 1], [3, 0, 1, 3]],
                         ids=["pi", "const0", "const1", "dups", "pis-consts"])
def test_programs_without_gates(pos):
    """A netlist with no gates: every PO is an input row, loaded and
    gathered as it stands."""
    net, ref_net = build_pair(2, [], pos)
    bits = np.random.default_rng(3).integers(0, 2, size=(2, 37), dtype=np.uint8)
    cc = ops.compile_netlist(net)
    p = ops.cim_program(cc)
    assert (p.n_slots, p.n_steps, p.n_chunks, p.n_levels) == (0, 0, 0, 0)
    got, want = run_both(cc, bits)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        ref.unpack_vectors(got[: cc.n_pos].numpy(), 37), reference_bits(ref_net, bits)
    )


def test_wide_levels_split_into_chunk_steps():
    """A level wider than CHUNK_SLOTS is cut into steps that fit a chunk,
    and the renamed file holds every live output of that level."""
    n_pis = 4
    wide = [("nand" if i % 2 else "nor", 2 + i % n_pis, 2 + (i + 1) % n_pis)
            for i in range(K.CHUNK_SLOTS + 100)]
    first = 2 + n_pis
    tree = [("nand", first + i, first + i + 1) for i in range(0, len(wide) - 1, 2)]
    net, ref_net = build_pair(n_pis, wide + tree, [first + len(wide) + i for i in range(len(tree))])
    cc = ops.compile_netlist(net)
    p = ops.cim_program(cc)
    check_schedule(p)
    assert p.n_levels == 2 and p.n_steps > p.n_levels
    assert p.n_rows >= len(wide)
    bits = np.random.default_rng(5).integers(0, 2, size=(n_pis, 64), dtype=np.uint8)
    got, want = run_both(cc, bits)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        ref.unpack_vectors(got[: cc.n_pos].numpy(), 64), reference_bits(ref_net, bits)
    )


def test_program_is_built_once_per_compiled_netlist():
    cc = ops.compile_netlist(NETS["max8"][0])
    p = ops.cim_program(cc)
    assert ops.cim_program(cc) is p
    assert ops.cim_program(ops.compile_netlist(NETS["max8"][0])) is not p
    moved = p.to("cpu")
    assert moved.code.data_ptr() == p.code.data_ptr() and moved.n_levels == p.n_levels


def test_cuda_path_refuses_a_missing_or_foreign_program():
    """The CUDA path of `cim_call` runs a program and names
    `ops.cim_program` when none is given; a program built for other
    operands is refused before any launch (host metadata only)."""
    cc = ops.compile_netlist(NETS["add16"][0])
    p = ops.cim_program(cc)
    instrs = torch.from_numpy(cc.instrs)
    cuda = torch.device("cuda")
    with pytest.raises(build.OperandError, match="ops.cim_program"):
        K._validate_program(None, cuda)
    with pytest.raises(build.OperandError, match="is on cpu"):
        K._validate_program(p, cuda)
    K._validate_program(p, torch.device("cpu"))
    K.check_program(p, instrs, cc.n_rows_padded, cc.n_gates, cc.n_pos)
    with pytest.raises(build.OperandError, match="built for"):
        K.check_program(p, instrs, cc.n_rows_padded + 8, cc.n_gates, cc.n_pos)
    with pytest.raises(build.OperandError, match="built for"):
        K.check_program(p, instrs, cc.n_rows_padded, cc.n_gates, cc.n_pos + 1)
    with pytest.raises(build.OperandError, match="built for"):
        K.check_program(p, instrs, cc.n_rows_padded, cc.n_gates - 1, cc.n_pos)


def test_program_is_held_to_the_stream_it_was_built_from():
    """A program of another stream with the same rows, gates and POs (one
    gate's kind changed) is refused by `cim_call` against the host stream,
    and so is the program kept on a `CompiledCim` whose stream was changed
    in place after it was built; a stream on the card is held by its
    shape only (reading it would sync)."""
    cc = ops.compile_netlist(NETS["add16"][0])
    bits = np.random.default_rng(6).integers(0, 2, size=(len(cc.pi_rows), 64), dtype=np.uint8)
    planes, bw = ops.cim_planes(cc, ref.pack_vectors(bits))
    instrs, planes = torch.from_numpy(cc.instrs), torch.from_numpy(planes)
    kw = dict(n_rows=cc.n_rows, n_gates=cc.n_gates, n_pos=cc.n_pos, block_words=bw)
    other = cc.instrs.copy()
    other[0, 0] = 0 if other[0, 0] == 1 else 1
    foreign = ops.cim_program(dataclasses.replace(cc, instrs=other))
    assert (foreign.n_gates, foreign.n_pos, foreign.ref_rows) == (cc.n_gates, cc.n_pos,
                                                                  cc.n_rows_padded)
    assert not np.array_equal(foreign.stream, ops.cim_program(cc).stream)
    want = K.cim_plain(instrs, planes, cc.n_gates, cc.n_pos)
    assert torch.equal(K.cim_call(instrs, planes, **kw, program=ops.cim_program(cc)), want)
    with pytest.raises(build.OperandError, match="another instruction stream"):
        K.cim_call(instrs, planes, **kw, program=foreign)
    K.check_program(foreign, instrs.to("meta"), cc.n_rows_padded, cc.n_gates, cc.n_pos)
    ops.cim_evaluate(cc, bits, device="cpu")
    cc.instrs[0, 0] = other[0, 0]
    with pytest.raises(build.OperandError, match="another instruction stream"):
        ops.cim_evaluate(cc, bits, device="cpu")
