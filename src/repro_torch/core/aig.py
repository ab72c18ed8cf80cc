"""And-Inverter Graph (AIG) engine.

This is the substrate of the paper's Algorithm I: the ABC tool is not
available offline, so we re-implement the parts the paper uses —

  * an AIG DAG with structural hashing ("strash"),
  * bit-parallel simulation (the CiM engine's functional oracle),
  * truth-table extraction for small cones (used by rewrite/refactor),
  * level / per-level op-count characterization ("ChaAIG" in Alg. I),
  * conversion to a NAND2/NOR2/NOT gate netlist — the op types the rCiM
    macro executes natively (§III-B of the paper).

Representation: ABC-style literals.  A literal is ``2*node + phase`` where
``phase=1`` means complemented.  Node 0 is the constant-FALSE node, so
literal 0 = const0 and literal 1 = const1.  Primary inputs are nodes
1..n_pi; AND nodes follow.
"""

from __future__ import annotations

import dataclasses
import hashlib
from functools import lru_cache
from typing import Callable, Iterable, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Literal helpers
# ---------------------------------------------------------------------------

CONST0 = 0
CONST1 = 1


def lit(node: int, phase: int = 0) -> int:
    return (node << 1) | phase


def lit_node(l: int) -> int:
    return l >> 1


def lit_phase(l: int) -> int:
    return l & 1


def lit_not(l: int) -> int:
    return l ^ 1


def lit_regular(l: int) -> int:
    return l & ~1


@dataclasses.dataclass
class AigStats:
    """Characterization record — ``ChaAIG`` of Algorithm I."""

    n_pis: int
    n_pos: int
    n_ands: int
    n_levels: int
    # ops_per_level[i] = dict(nand=?, nor=?, inv=?) for gate-netlist level i.
    ops_per_level: list[dict[str, int]]
    nand_count: int
    nor_count: int
    inv_count: int

    @property
    def total_gates(self) -> int:
        """Total mapped gate count (NAND2 + NOR2 + NOT)."""
        return self.nand_count + self.nor_count + self.inv_count

    def to_dict(self) -> dict:
        """JSON-safe form (used by the on-disk characterization cache)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "AigStats":
        d = dict(d)
        d["ops_per_level"] = [
            {k: int(v) for k, v in lvl.items()} for lvl in d["ops_per_level"]
        ]
        return cls(**d)

    @property
    def max_ops_in_level(self) -> int:
        if not self.ops_per_level:
            return 0
        return max(sum(d.values()) for d in self.ops_per_level)

    def ops_matrix(self) -> np.ndarray:
        """Per-level op counts as an ``(n_levels, 3)`` int array in
        (nand, nor, inv) order — the row format the batched exploration
        engine (core/batch.py) stacks into its workload tensor."""
        out = np.zeros((len(self.ops_per_level), 3), dtype=np.int64)
        for i, level in enumerate(self.ops_per_level):
            out[i, 0] = level.get("nand", 0)
            out[i, 1] = level.get("nor", 0)
            out[i, 2] = level.get("inv", 0)
        return out


class Aig:
    """A mutable AIG with structural hashing.

    Nodes are stored in topological order (fanins always precede fanouts);
    all graph surgery goes through rebuilding (`rebuild_mapped`) which
    re-strashes, so the invariant is preserved by construction.
    """

    def __init__(self, n_pis: int = 0, name: str = "aig"):
        self.name = name
        # fanin literal arrays; entry i corresponds to node i.
        # Nodes 0..n_pis are const/PI and have fanins (-1, -1).
        self._f0: list[int] = [-1] * (1 + n_pis)
        self._f1: list[int] = [-1] * (1 + n_pis)
        self.n_pis = n_pis
        self.pos: list[int] = []  # output literals
        self._strash: dict[tuple[int, int], int] = {}

    # -- construction -------------------------------------------------------

    def add_pi(self) -> int:
        """Append one primary input; returns its (positive) literal."""
        self._f0.append(-1)
        self._f1.append(-1)
        self.n_pis += 1
        node = len(self._f0) - 1
        # PIs must precede AND nodes; enforce.
        if self.n_ands:
            raise ValueError("add_pi after AND nodes were created")
        return lit(node)

    @property
    def n_nodes(self) -> int:
        return len(self._f0)

    @property
    def n_ands(self) -> int:
        return self.n_nodes - 1 - self.n_pis

    def is_pi(self, node: int) -> bool:
        return 1 <= node <= self.n_pis

    def is_and(self, node: int) -> bool:
        return node > self.n_pis

    def fanins(self, node: int) -> tuple[int, int]:
        return self._f0[node], self._f1[node]

    def g_and(self, a: int, b: int) -> int:
        """Strashed AND of two literals (with constant folding)."""
        # Constant / trivial folding.
        if a == CONST0 or b == CONST0:
            return CONST0
        if a == CONST1:
            return b
        if b == CONST1:
            return a
        if a == b:
            return a
        if a == lit_not(b):
            return CONST0
        if a > b:
            a, b = b, a
        key = (a, b)
        hit = self._strash.get(key)
        if hit is not None:
            return hit
        self._f0.append(a)
        self._f1.append(b)
        node = len(self._f0) - 1
        out = lit(node)
        self._strash[key] = out
        return out

    # Derived gates --------------------------------------------------------

    def g_or(self, a: int, b: int) -> int:
        return lit_not(self.g_and(lit_not(a), lit_not(b)))

    def g_nand(self, a: int, b: int) -> int:
        return lit_not(self.g_and(a, b))

    def g_nor(self, a: int, b: int) -> int:
        return self.g_and(lit_not(a), lit_not(b))

    def g_xor(self, a: int, b: int) -> int:
        return self.g_or(self.g_and(a, lit_not(b)), self.g_and(lit_not(a), b))

    def g_xnor(self, a: int, b: int) -> int:
        return lit_not(self.g_xor(a, b))

    def g_mux(self, sel: int, t: int, f: int) -> int:
        """sel ? t : f"""
        return self.g_or(self.g_and(sel, t), self.g_and(lit_not(sel), f))

    def g_maj(self, a: int, b: int, c: int) -> int:
        return self.g_or(
            self.g_and(a, b), self.g_or(self.g_and(b, c), self.g_and(a, c))
        )

    def g_and_multi(self, lits: Sequence[int]) -> int:
        acc = CONST1
        for l in lits:
            acc = self.g_and(acc, l)
        return acc

    def g_or_multi(self, lits: Sequence[int]) -> int:
        acc = CONST0
        for l in lits:
            acc = self.g_or(acc, l)
        return acc

    def add_po(self, l: int) -> None:
        self.pos.append(l)

    # -- analysis -----------------------------------------------------------

    def levels(self) -> np.ndarray:
        """AIG level per node (PIs/const at level 0)."""
        lv = np.zeros(self.n_nodes, dtype=np.int32)
        f0, f1 = self._f0, self._f1
        for n in range(self.n_pis + 1, self.n_nodes):
            lv[n] = 1 + max(lv[f0[n] >> 1], lv[f1[n] >> 1])
        return lv

    def depth(self) -> int:
        if self.n_nodes == 1 + self.n_pis:
            return 0
        lv = self.levels()
        if not self.pos:
            return int(lv.max(initial=0))
        return int(max(lv[lit_node(p)] for p in self.pos))

    def fanout_counts(self) -> np.ndarray:
        fo = np.zeros(self.n_nodes, dtype=np.int64)
        for n in range(self.n_pis + 1, self.n_nodes):
            fo[self._f0[n] >> 1] += 1
            fo[self._f1[n] >> 1] += 1
        for p in self.pos:
            fo[lit_node(p)] += 1
        return fo

    # -- simulation ---------------------------------------------------------

    def simulate(self, pi_values: np.ndarray) -> np.ndarray:
        """Bit-parallel simulation.

        ``pi_values``: uint64 array of shape (n_pis, W) — W 64-bit pattern
        words per input.  Returns (n_pos, W) uint64 of output patterns.
        This is the functional oracle the CUDA CiM kernel and its plain
        torch version (kernels/ref.py) are checked against.
        """
        pi_values = np.asarray(pi_values, dtype=np.uint64)
        if pi_values.ndim == 1:
            pi_values = pi_values[:, None]
        n_pis, width = pi_values.shape
        if n_pis != self.n_pis:
            raise ValueError(f"expected {self.n_pis} PI rows, got {n_pis}")
        vals = np.zeros((self.n_nodes, width), dtype=np.uint64)
        vals[1 : 1 + self.n_pis] = pi_values
        f0 = np.asarray(self._f0[self.n_pis + 1 :], dtype=np.int64)
        f1 = np.asarray(self._f1[self.n_pis + 1 :], dtype=np.int64)
        full = np.uint64(0xFFFFFFFFFFFFFFFF)
        # Vectorized level-order evaluation: nodes are already topologically
        # sorted, but python-loop per node is slow for big graphs; evaluate
        # in topological "waves" using the level structure.
        lv = self.levels()
        order = np.arange(self.n_pis + 1, self.n_nodes)
        if order.size:
            node_lv = lv[order]
            for level in range(1, node_lv.max(initial=0) + 1):
                ns = order[node_lv == level]
                if not ns.size:
                    continue
                i = ns - (self.n_pis + 1)
                a = vals[f0[i] >> 1] ^ np.where((f0[i] & 1).astype(bool), full, np.uint64(0))[:, None]
                b = vals[f1[i] >> 1] ^ np.where((f1[i] & 1).astype(bool), full, np.uint64(0))[:, None]
                vals[ns] = a & b
        out = np.zeros((len(self.pos), width), dtype=np.uint64)
        for k, p in enumerate(self.pos):
            v = vals[lit_node(p)]
            out[k] = (v ^ full) if lit_phase(p) else v
        return out

    def eval_ints(self, pi_bits: Sequence[int]) -> list[int]:
        """Single-pattern convenience evaluation (0/1 per PI)."""
        pv = np.array([[np.uint64(0xFFFFFFFFFFFFFFFF if b else 0)] for b in pi_bits],
                      dtype=np.uint64)
        out = self.simulate(pv)
        return [int(v[0] & np.uint64(1)) for v in out]

    # -- cone / truth-table utilities ---------------------------------------

    def cone_nodes(self, root: int, leaves: set[int]) -> list[int]:
        """Topo-ordered AND nodes of the cone of ``root`` stopping at leaves."""
        seen: set[int] = set()
        out: list[int] = []

        stack = [root]
        while stack:
            n = stack.pop()
            if n in seen or n in leaves or not self.is_and(n):
                continue
            a, b = self._f0[n] >> 1, self._f1[n] >> 1
            need = [m for m in (a, b) if m not in seen and m not in leaves and self.is_and(m)]
            if need:
                stack.append(n)
                stack.extend(need)
            else:
                seen.add(n)
                out.append(n)
        return out

    def truth_table(
        self,
        root_lit: int,
        support: Sequence[int],
        cone: Sequence[int] | None = None,
    ) -> int:
        """Exact truth table of ``root_lit`` over ``support`` node ids.

        Supports up to 16 inputs; returns an int with 2**k bits (pattern p
        is bit p, LSB-first, support[i] driving bit i of the pattern index).
        Assumes the cone of root_lit is fully covered by ``support``.
        ``cone`` may supply a precomputed ``cone_nodes(root, set(support))``
        topo order so callers that also need the cone walk it only once.

        The whole simulation runs on arbitrary-precision python ints (one
        int per node), which beats per-node numpy word arrays by a wide
        margin for the k <= 16 cones the transforms use.
        """
        k = len(support)
        if k > 16:
            raise ValueError("truth_table limited to 16 inputs")
        n_pat = 1 << k
        full = (1 << n_pat) - 1
        vals: dict[int, int] = {0: 0}
        for i, s in enumerate(support):
            vals[s] = _elementary_int(i, k)

        if cone is None:
            cone = self.cone_nodes(lit_node(root_lit), set(support))
        f0, f1 = self._f0, self._f1
        for n in cone:
            fa, fb = f0[n], f1[n]
            va = vals[fa >> 1] ^ (full if (fa & 1) else 0)
            vb = vals[fb >> 1] ^ (full if (fb & 1) else 0)
            vals[n] = va & vb
        root_node = lit_node(root_lit)
        if root_node not in vals:
            raise ValueError("support does not cover the cone")
        v = vals[root_node]
        if lit_phase(root_lit):
            v ^= full
        return v

    # -- rebuilding ---------------------------------------------------------

    def rebuild_mapped(
        self, build: Callable[["Aig", "Aig", dict[int, int]], None] | None = None
    ) -> "Aig":
        """Create a compacted, re-strashed copy containing only the nodes
        reachable from the POs.  ``build`` may customize the copy.
        """
        new = Aig(self.n_pis, name=self.name)
        mapping: dict[int, int] = {0: CONST0}
        for i in range(1, 1 + self.n_pis):
            mapping[i] = lit(i)
        if build is not None:
            build(self, new, mapping)
        else:
            self._copy_cones(new, mapping)
        return new

    def _copy_cones(self, new: "Aig", mapping: dict[int, int]) -> None:
        # Mark reachable nodes.
        reach = np.zeros(self.n_nodes, dtype=bool)
        stack = [lit_node(p) for p in self.pos]
        while stack:
            n = stack.pop()
            if reach[n] or not self.is_and(n):
                continue
            reach[n] = True
            stack.append(self._f0[n] >> 1)
            stack.append(self._f1[n] >> 1)
        for n in range(self.n_pis + 1, self.n_nodes):
            if not reach[n]:
                continue
            fa, fb = self._f0[n], self._f1[n]
            a = mapping[fa >> 1] ^ (fa & 1)
            b = mapping[fb >> 1] ^ (fb & 1)
            mapping[n] = new.g_and(a, b)
        for p in self.pos:
            new.add_po(mapping[lit_node(p)] ^ lit_phase(p))

    def clone(self) -> "Aig":
        return self.rebuild_mapped()

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        """JSON-safe exact structure (fanin literal arrays + POs).

        Round-trips through `from_dict` node-for-node, so the
        `fingerprint` is preserved — the property the persistent
        characterization cache relies on to warm-start the recipe DAG
        from on-disk intermediate structures."""
        return dict(
            n_pis=self.n_pis,
            f0=[int(x) for x in self._f0],
            f1=[int(x) for x in self._f1],
            pos=[int(p) for p in self.pos],
            name=self.name,
        )

    @classmethod
    def from_dict(cls, d: dict) -> "Aig":
        """Rebuild the exact structure (same node order, same fingerprint)."""
        aig = cls(int(d["n_pis"]), name=d.get("name", "aig"))
        aig._f0 = [int(x) for x in d["f0"]]
        aig._f1 = [int(x) for x in d["f1"]]
        aig.pos = [int(p) for p in d["pos"]]
        for node in range(aig.n_pis + 1, aig.n_nodes):
            aig._strash[(aig._f0[node], aig._f1[node])] = lit(node)
        return aig

    def fingerprint(self) -> str:
        """Hex digest of the exact structure (PIs, fanin arrays, POs).

        Two AIGs share a fingerprint iff they are node-for-node identical,
        so — the transforms being deterministic functions of structure —
        equal fingerprints imply equal transform results and equal
        characterizations.  This is the key of the shared-prefix DAG
        (transforms.RecipeRunner) and of the on-disk characterization
        cache (transforms.CharacterizationCache).  ``name`` is excluded.
        """
        h = hashlib.sha256()
        h.update(np.asarray([self.n_pis], dtype=np.int64).tobytes())
        h.update(np.asarray(self._f0, dtype=np.int64).tobytes())
        h.update(np.asarray(self._f1, dtype=np.int64).tobytes())
        h.update(np.asarray(self.pos, dtype=np.int64).tobytes())
        return h.hexdigest()

    # -- gate netlist (NAND2 / NOR2 / NOT) -----------------------------------

    def to_gate_netlist(self) -> "GateNetlist":
        return GateNetlist.from_aig(self)

    def characterize(self) -> AigStats:
        """``ChaAIG`` of Algorithm I: stage counts + ops per stage."""
        net = self.to_gate_netlist()
        return AigStats(
            n_pis=self.n_pis,
            n_pos=len(self.pos),
            n_ands=self.n_ands,
            n_levels=net.n_levels,
            ops_per_level=net.ops_per_level(),
            nand_count=net.counts["nand"],
            nor_count=net.counts["nor"],
            inv_count=net.counts["inv"],
        )


@lru_cache(maxsize=None)
def _elementary_int(i: int, k: int) -> int:
    """Truth table of variable i over k vars as a 2**k-bit int (bit p set
    iff pattern p has var i = 1).  Built by block doubling: O(k) int ops."""
    half = 1 << i
    block = ((1 << half) - 1) << half  # 2**i zeros then 2**i ones
    width = half * 2
    n_pat = 1 << k
    while width < n_pat:
        block |= block << width
        width *= 2
    return block


def _elementary_tables(k: int) -> np.ndarray:
    """Elementary truth tables for k vars as uint64 word arrays."""
    n_pat = 1 << k
    words = max(1, n_pat // 64)
    out = np.zeros((k, words), dtype=np.uint64)
    masks64 = [
        np.uint64(0xAAAAAAAAAAAAAAAA),
        np.uint64(0xCCCCCCCCCCCCCCCC),
        np.uint64(0xF0F0F0F0F0F0F0F0),
        np.uint64(0xFF00FF00FF00FF00),
        np.uint64(0xFFFF0000FFFF0000),
        np.uint64(0xFFFFFFFF00000000),
    ]
    for i in range(k):
        if i < 6:
            out[i, :] = masks64[i]
        else:
            stride = 1 << (i - 6)
            w = np.arange(words)
            sel = (w // stride) % 2 == 1
            out[i, sel] = np.uint64(0xFFFFFFFFFFFFFFFF)
    if n_pat < 64:
        mask = np.uint64((1 << n_pat) - 1)
        out &= mask
    return out


# ---------------------------------------------------------------------------
# NAND2/NOR2/NOT netlist — the ops the rCiM macro executes natively
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Gate:
    kind: str  # "nand" | "nor" | "inv"
    a: int  # signal ids
    b: int  # == a for inv
    out: int
    level: int


class GateNetlist:
    """Polarity-aware mapping of an AIG onto {NAND2, NOR2, NOT}.

    Each AND node ``v = f(a,b)`` is realized by exactly one 2-input gate:

      * both fanin edges complemented  → NOR2(a,b)  computes v directly,
      * no fanin edge complemented     → NAND2(a,b) computes v̄,
      * mixed                          → NOT on the complemented side,
                                          then NAND2 computes v̄.

    A phase-demand pass then inserts the minimum number of NOT gates so that
    every consumer sees the phase it needs.  This mirrors how the paper's
    macro executes an AIG level: NAND2/NOR2/NOT are the only primitive ops
    (§III-B), and Table I reports exactly these three gate counts.
    """

    def __init__(self) -> None:
        self.gates: list[Gate] = []
        self.n_signals = 0
        self.pi_signals: list[int] = []
        self.po_signals: list[int] = []
        self.counts = {"nand": 0, "nor": 0, "inv": 0}
        self.n_levels = 0

    def _new_signal(self) -> int:
        self.n_signals += 1
        return self.n_signals - 1

    def _emit(self, kind: str, a: int, b: int, level: int) -> int:
        out = self._new_signal()
        self.gates.append(Gate(kind, a, b, out, level))
        self.counts[kind] += 1
        self.n_levels = max(self.n_levels, level + 1)
        return out

    @classmethod
    def from_aig(cls, aig: Aig) -> "GateNetlist":
        net = cls()
        # signal/level bookkeeping per (node, phase) demand
        sig: dict[tuple[int, int], int] = {}
        sig_level: dict[tuple[int, int], int] = {}

        # Constants: model as signals at level 0 (tied cells, no gate cost).
        c0 = net._new_signal()
        c1 = net._new_signal()
        sig[(0, 0)] = c0
        sig_level[(0, 0)] = 0
        sig[(0, 1)] = c1
        sig_level[(0, 1)] = 0
        for n in range(1, 1 + aig.n_pis):
            s = net._new_signal()
            net.pi_signals.append(s)
            sig[(n, 0)] = s
            sig_level[(n, 0)] = 0

        def get(node: int, phase: int) -> tuple[int, int]:
            """Return (signal, level) for node in the given phase, inserting
            a NOT if only the opposite phase is realized."""
            key = (node, phase)
            if key in sig:
                return sig[key], sig_level[key]
            okey = (node, phase ^ 1)
            if okey not in sig:
                raise KeyError(f"signal for node {node} not realized yet")
            src, lv = sig[okey], sig_level[okey]
            s = net._emit("inv", src, src, lv)
            sig[key] = s
            sig_level[key] = lv + 1
            return s, lv + 1

        for n in range(aig.n_pis + 1, aig.n_nodes):
            fa, fb = aig.fanins(n)
            na, pa = fa >> 1, fa & 1
            nb, pb = fb >> 1, fb & 1
            if pa and pb:
                # v = ā·b̄ = NOR(a,b)
                sa, la = get(na, 0)
                sb, lb = get(nb, 0)
                lv = max(la, lb)
                s = net._emit("nor", sa, sb, lv)
                sig[(n, 0)] = s
                sig_level[(n, 0)] = lv + 1
            elif not pa and not pb:
                # v̄ = NAND(a,b)
                sa, la = get(na, 0)
                sb, lb = get(nb, 0)
                lv = max(la, lb)
                s = net._emit("nand", sa, sb, lv)
                sig[(n, 1)] = s
                sig_level[(n, 1)] = lv + 1
            else:
                # mixed: v = ā·b  →  NOR(a, b̄); realize b̄ via phase demand.
                if pa:
                    s_pos, l_pos = get(nb, 0)
                    s_neg, l_neg = get(na, 1)
                else:
                    s_pos, l_pos = get(na, 0)
                    s_neg, l_neg = get(nb, 1)
                # v = s_neg AND s_pos = NAND + INV; cheaper: NOR(s_neg', s_pos')
                # needs two inverters.  Use NAND producing v̄.
                lv = max(l_pos, l_neg)
                s = net._emit("nand", s_neg, s_pos, lv)
                sig[(n, 1)] = s
                sig_level[(n, 1)] = lv + 1

        for p in aig.pos:
            s, _ = get(lit_node(p), lit_phase(p))
            net.po_signals.append(s)
        return net

    def ops_per_level(self) -> list[dict[str, int]]:
        out = [dict(nand=0, nor=0, inv=0) for _ in range(self.n_levels)]
        for g in self.gates:
            out[g.level][g.kind] += 1
        return out

    @property
    def n_gates(self) -> int:
        return len(self.gates)

    def simulate(self, pi_values: np.ndarray) -> np.ndarray:
        """Bit-parallel gate-netlist simulation (oracle for the CiM kernel)."""
        pi_values = np.asarray(pi_values, dtype=np.uint64)
        if pi_values.ndim == 1:
            pi_values = pi_values[:, None]
        width = pi_values.shape[1]
        full = np.uint64(0xFFFFFFFFFFFFFFFF)
        vals = np.zeros((self.n_signals, width), dtype=np.uint64)
        vals[1] = full  # const1 signal
        for i, s in enumerate(self.pi_signals):
            vals[s] = pi_values[i]
        for g in self.gates:
            if g.kind == "nand":
                vals[g.out] = (vals[g.a] & vals[g.b]) ^ full
            elif g.kind == "nor":
                vals[g.out] = (vals[g.a] | vals[g.b]) ^ full
            else:
                vals[g.out] = vals[g.a] ^ full
        return vals[np.asarray(self.po_signals, dtype=np.int64)]

    def level_schedule(self) -> list[list[Gate]]:
        sched: list[list[Gate]] = [[] for _ in range(self.n_levels)]
        for g in self.gates:
            sched[g.level].append(g)
        return sched


# ---------------------------------------------------------------------------
# Random AIG generation (for property tests)
# ---------------------------------------------------------------------------


def random_aig(
    n_pis: int, n_ands: int, n_pos: int, seed: int = 0
) -> Aig:
    rng = np.random.default_rng(seed)
    aig = Aig(n_pis)
    lits = [lit(i) for i in range(1, 1 + n_pis)]
    for _ in range(n_ands):
        a = int(rng.integers(0, len(lits)))
        b = int(rng.integers(0, len(lits)))
        pa = int(rng.integers(0, 2))
        pb = int(rng.integers(0, 2))
        l = aig.g_and(lits[a] ^ pa, lits[b] ^ pb)
        lits.append(l)
    for _ in range(n_pos):
        p = int(rng.integers(0, len(lits)))
        ph = int(rng.integers(0, 2))
        aig.add_po(lits[p] ^ ph)
    return aig.clone()
