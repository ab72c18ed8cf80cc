"""AIG sub-graph optimizations — Balance, Rewrite, Refactor, Resub.

Re-implementations of the four ABC transforms the paper uses to generate
its 64 unique synthesis recipes (ordered permutations of non-empty subsets
of {B_a, R_f, R_w, R_s}: sum_{i=1..4} P(4,i) = 4+12+24+24 = 64).

All transforms are *semantics-preserving*: tests/test_transforms.py checks
functional equivalence by exhaustive truth tables (small circuits) and by
bit-parallel random simulation (large circuits).

Faithfulness notes vs ABC:
  * ``balance``  — AND-tree collapse + level-greedy rebuild (ABC `balance`).
  * ``rewrite``  — 4-feasible-cut enumeration + truth-table resynthesis with
    memoized Shannon/decomposition plans (ABC `rewrite` uses precomputed
    NPN-class subgraphs; ours synthesizes plans on the fly, same contract:
    replace a cut cone if the new cone adds fewer nodes than the old MFFC).
  * ``refactor`` — reconvergence-driven cuts up to 10 leaves, ISOP
    (Minato–Morreale) + quick algebraic factoring (ABC `refactor`).
  * ``resub``    — window-exact resubstitution: truth tables over a shared
    structural cut; replaces a node by an equivalent existing divisor or an
    AND/OR of two divisors (ABC `resub` k=0/1).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import json
import os
import tempfile
import time
from functools import lru_cache, partial
from pathlib import Path
from random import Random
from typing import Callable, Mapping, Sequence

import numpy as np

from ..device import resolve_device
from ..kernels import aig_sim
from ..kernels.build import KernelError
from ..runtime import faults

from .aig import (
    CONST0,
    CONST1,
    Aig,
    AigStats,
    lit,
    lit_node,
    lit_not,
    lit_phase,
)

TRANSFORM_NAMES = ("Ba", "Rf", "Rw", "Rs")

#: Version of the transform implementations.  Any change that can alter a
#: transform's output (even a tie-break) MUST bump this: it keys the
#: persistent characterization cache, so a bump invalidates every on-disk
#: entry (CharacterizationCache stores under a per-version directory).
TRANSFORM_VERSION = 2


# ===========================================================================
# Truth-table plan synthesis (shared by rewrite/refactor)
# ===========================================================================
#
# A "plan" is a nested tuple expression over leaf indices:
#   ("leaf", i) | ("const", 0|1) | ("not", p) | ("and", p, q) | ("or", p, q)
#   | ("xor", p, q) | ("mux", i, p_then, p_else)
# Cost = number of AIG AND nodes the plan lowers to.

_PLAN_CACHE: dict[tuple[int, int], tuple[int, tuple]] = {}


def _tt_mask(k: int) -> int:
    return (1 << (1 << k)) - 1


@lru_cache(maxsize=None)
def _elem_tt(i: int, k: int) -> int:
    """Truth table of variable i over k vars (LSB-first pattern order)."""
    acc = 0
    for p in range(1 << k):
        if (p >> i) & 1:
            acc |= 1 << p
    return acc


def _cofactors(tt: int, i: int, k: int) -> tuple[int, int]:
    """Negative/positive cofactors w.r.t. var i, each over the same k vars
    (cofactor truth tables are var-i-independent).

    Patterns p and p|(1<<i) sit 2^i bit positions apart, so each cofactor is
    a mask + one shift — O(1) big-int ops instead of a per-block loop.
    """
    e = _elem_tt(i, k)  # positions with var_i = 1
    full = _tt_mask(k)
    step = 1 << i
    lo = tt & (e ^ full)
    hi = tt & e
    neg = lo | (lo << step)
    pos = hi | (hi >> step)
    return neg, pos


def synth_plan(tt: int, k: int) -> tuple[int, tuple]:
    """Memoized (cost, plan) synthesis of a k-var truth table."""
    tt &= _tt_mask(k)
    key = (tt, k)
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        return hit
    full = _tt_mask(k)
    if tt == 0:
        res = (0, ("const", 0))
    elif tt == full:
        res = (0, ("const", 1))
    else:
        res = None
        for i in range(k):
            e = _elem_tt(i, k)
            if tt == e:
                res = (0, ("leaf", i))
                break
            if tt == (e ^ full):
                res = (0, ("not", ("leaf", i)))
                break
        if res is None:
            best: tuple[int, tuple] | None = None
            for i in range(k):
                neg, pos = _cofactors(tt, i, k)
                if neg == pos:
                    # tt does not depend on var i — nothing to split on.
                    continue
                if neg == 0:
                    c, p = synth_plan(pos, k)
                    cand = (c + 1, ("and", ("leaf", i), p))
                elif pos == 0:
                    c, p = synth_plan(neg, k)
                    cand = (c + 1, ("and", ("not", ("leaf", i)), p))
                elif neg == full:
                    c, p = synth_plan(pos, k)
                    cand = (c + 1, ("or", ("not", ("leaf", i)), p))
                elif pos == full:
                    c, p = synth_plan(neg, k)
                    cand = (c + 1, ("or", ("leaf", i), p))
                elif neg == (pos ^ full):
                    c, p = synth_plan(neg, k)
                    cand = (c + 3, ("xor", ("leaf", i), p))
                else:
                    c0, p0 = synth_plan(neg, k)
                    c1, p1 = synth_plan(pos, k)
                    cand = (c0 + c1 + 3, ("mux", i, p1, p0))
                if best is None or cand[0] < best[0]:
                    best = cand
            res = best
    _PLAN_CACHE[key] = res
    return res


def build_plan(aig: Aig, plan: tuple, leaves: Sequence[int]) -> int:
    """Lower a plan to AIG nodes; ``leaves`` are literals."""
    op = plan[0]
    if op == "const":
        return CONST1 if plan[1] else CONST0
    if op == "leaf":
        return leaves[plan[1]]
    if op == "not":
        return lit_not(build_plan(aig, plan[1], leaves))
    if op == "and":
        return aig.g_and(build_plan(aig, plan[1], leaves), build_plan(aig, plan[2], leaves))
    if op == "or":
        return aig.g_or(build_plan(aig, plan[1], leaves), build_plan(aig, plan[2], leaves))
    if op == "xor":
        return aig.g_xor(build_plan(aig, plan[1], leaves), build_plan(aig, plan[2], leaves))
    if op == "mux":
        sel = leaves[plan[1]]
        return aig.g_mux(sel, build_plan(aig, plan[2], leaves), build_plan(aig, plan[3], leaves))
    raise ValueError(f"bad plan op {op}")


# ===========================================================================
# Balance (B_a)
# ===========================================================================


def balance(aig: Aig) -> Aig:
    """Depth-oriented AND-tree rebalancing (ABC ``balance``).

    Collapses maximal AND trees (through non-complemented AND edges) and
    rebuilds each as a balanced tree, combining lowest-level leaves first.
    """
    new = Aig(aig.n_pis, name=aig.name)
    mapping: dict[int, int] = {0: CONST0}
    for i in range(1, 1 + aig.n_pis):
        mapping[i] = lit(i)
    level: dict[int, int] = {}

    def new_level(l: int) -> int:
        n = lit_node(l)
        return level.get(n, 0)

    fanout = aig.fanout_counts()

    def collect_leaves(n: int, leaves: list[int]) -> None:
        """Leaves of the maximal AND tree rooted at node n."""
        for f in aig.fanins(n):
            fn = lit_node(f)
            if (
                lit_phase(f) == 0
                and aig.is_and(fn)
                and fanout[fn] == 1
            ):
                collect_leaves(fn, leaves)
            else:
                leaves.append(f)

    reach = _reachable(aig)
    order = [n for n in range(aig.n_pis + 1, aig.n_nodes) if reach[n]]
    processed: set[int] = set()

    def map_lit(f: int) -> int:
        return mapping[lit_node(f)] ^ lit_phase(f)

    for n in order:
        if n in processed:
            continue
        # Only build roots: nodes that are not absorbed into a parent tree.
        # A node is absorbed if it has a single fanout which consumes it
        # through a non-complemented edge from another AND node — but since
        # we map every reachable node anyway (cheap), just build all.
        leaves: list[int] = []
        collect_leaves(n, leaves)
        # Map leaves into the new AIG and combine by level (two lowest first).
        heap = sorted((new_level(map_lit(f)), i, map_lit(f)) for i, f in enumerate(leaves))
        import heapq

        h = [(lv, i, l) for i, (lv, _, l) in enumerate(heap)]
        heapq.heapify(h)
        cnt = len(h)
        while len(h) > 1:
            lv_a, _, a = heapq.heappop(h)
            lv_b, _, b = heapq.heappop(h)
            out = new.g_and(a, b)
            lv = max(lv_a, lv_b) + 1
            level[lit_node(out)] = lv
            cnt += 1
            heapq.heappush(h, (lv, cnt, out))
        mapping[n] = h[0][2] if h else CONST1
        processed.add(n)

    for p in aig.pos:
        new.add_po(mapping[lit_node(p)] ^ lit_phase(p))
    return new.clone()


def _reachable(aig: Aig) -> np.ndarray:
    reach = np.zeros(aig.n_nodes, dtype=bool)
    stack = [lit_node(p) for p in aig.pos]
    while stack:
        n = stack.pop()
        if reach[n] or not aig.is_and(n):
            continue
        reach[n] = True
        a, b = aig.fanins(n)
        stack.append(a >> 1)
        stack.append(b >> 1)
    return reach


# ===========================================================================
# Cut enumeration (shared by rewrite)
# ===========================================================================


def _enumerate_cuts(
    aig: Aig, k: int = 4, max_cuts: int = 8
) -> list[list[frozenset[int]]]:
    """Bottom-up k-feasible cut enumeration; cuts[n] = list of leaf sets."""
    cuts: list[list[frozenset[int]]] = [[] for _ in range(aig.n_nodes)]
    for n in range(1, 1 + aig.n_pis):
        cuts[n] = [frozenset((n,))]
    for n in range(aig.n_pis + 1, aig.n_nodes):
        fa, fb = aig.fanins(n)
        na, nb = fa >> 1, fb >> 1
        got: set[frozenset[int]] = set()
        merged: list[frozenset[int]] = []
        ca = cuts[na] if na else [frozenset()]
        cb = cuts[nb] if nb else [frozenset()]
        for c1 in ca:
            for c2 in cb:
                u = c1 | c2
                if len(u) <= k and u not in got:
                    got.add(u)
                    merged.append(u)
        merged.sort(key=len)
        trivial = frozenset((n,))
        cuts[n] = merged[: max_cuts - 1] + [trivial]
    return cuts


def _mffc_size(
    aig: Aig,
    root: int,
    leaves: frozenset[int],
    fanout: np.ndarray,
    cone: list[int] | None = None,
) -> int:
    """Nodes in the cone of ``root`` (stopping at leaves) whose every fanout
    stays inside the cone — i.e. nodes freed if the root is replaced.
    ``cone`` may supply a precomputed ``cone_nodes`` walk."""
    if cone is None:
        cone = aig.cone_nodes(root, set(leaves))
    cone_set = set(cone)
    # Count fanout references from inside the cone.
    internal_refs: dict[int, int] = {}
    for n in cone:
        for f in aig.fanins(n):
            fn = f >> 1
            internal_refs[fn] = internal_refs.get(fn, 0) + 1
    freed = 0
    for n in cone:
        if n == root:
            freed += 1
        elif internal_refs.get(n, 0) >= fanout[n]:
            freed += 1
    return freed


# ===========================================================================
# Rewrite (R_w)
# ===========================================================================


def rewrite(
    aig: Aig, k: int = 4, max_cuts: int = 8, backend: str = "python", device=None
) -> Aig:
    """DAG-aware cut rewriting (ABC ``rewrite``): for every node, try to
    replace its best k-cut cone with a smaller synthesized cone.

    ``backend="device"`` batches the truth-table/MFFC queries through
    `kernels.aig_sim` on ``device`` with bit-identical output (the python
    path is the parity reference); ``auto`` picks device.
    """
    if resolve_backend(backend) == "device":
        return _rewrite_device(aig, k=k, max_cuts=max_cuts, device=device)
    cuts = _enumerate_cuts(aig, k=k, max_cuts=max_cuts)
    fanout = aig.fanout_counts()
    new = Aig(aig.n_pis, name=aig.name)
    mapping: dict[int, int] = {0: CONST0}
    for i in range(1, 1 + aig.n_pis):
        mapping[i] = lit(i)

    reach = _reachable(aig)
    for n in range(aig.n_pis + 1, aig.n_nodes):
        if not reach[n]:
            continue
        fa, fb = aig.fanins(n)
        default = new.g_and(
            mapping[fa >> 1] ^ (fa & 1), mapping[fb >> 1] ^ (fb & 1)
        )
        mapping[n] = default
        best_gain = 0
        best: tuple[tuple, list[int]] | None = None
        for cut in cuts[n]:
            if len(cut) < 2 or n in cut:
                continue
            if any(m not in mapping for m in cut):
                continue
            support = sorted(cut)
            cone = aig.cone_nodes(n, set(cut))
            tt = aig.truth_table(lit(n), support, cone=cone)
            cost, plan = synth_plan(tt, len(support))
            old_cost = _mffc_size(aig, n, frozenset(cut), fanout, cone=cone)
            gain = old_cost - cost
            if gain > best_gain:
                best_gain = gain
                best = (plan, [mapping[m] for m in support])
        if best is not None:
            plan, leaf_lits = best
            mapping[n] = build_plan(new, plan, leaf_lits)

    for p in aig.pos:
        new.add_po(mapping[lit_node(p)] ^ lit_phase(p))
    out = new.clone()
    return out if out.n_ands <= aig.n_ands else aig


# ===========================================================================
# Refactor (R_f)
# ===========================================================================


def _reconv_cut(aig: Aig, root: int, max_leaves: int = 10) -> list[int]:
    """Reconvergence-driven cut (ABC ``abcReconv``-style greedy expansion)."""
    leaves = {root}
    while True:
        # pick expandable leaf with minimal "cost" = #new leaves added
        best_leaf, best_cost, best_new = None, None, None
        for lf in leaves:
            if not aig.is_and(lf):
                continue
            fa, fb = aig.fanins(lf)
            cand = {fa >> 1, fb >> 1}
            newset = (leaves - {lf}) | cand
            cost = len(newset) - len(leaves)
            if len(newset) > max_leaves:
                continue
            if best_cost is None or cost < best_cost:
                best_leaf, best_cost, best_new = lf, cost, newset
        if best_leaf is None:
            break
        leaves = best_new
        if best_cost is not None and best_cost >= 0 and len(leaves) >= max_leaves:
            break
    return sorted(leaves)


#: Global memo for `_isop` — the Minato–Morreale recursion re-derives the
#: same (tt, care) subproblems across cones, circuits, and recipes (it is
#: the single hottest part of a cold ``refactor`` pass).  The function is
#: a pure map from (tt, care, k) to its cube list, so memoization cannot
#: change any transform output (TRANSFORM_VERSION stays put).  Entries are
#: capped to bound memory; the cap is far above a full-suite run.
_ISOP_CACHE: dict[tuple[int, int, int], tuple[tuple[int, int], ...]] = {}
_ISOP_CACHE_MAX = 1_000_000


def _isop(tt: int, care: int, k: int) -> list[tuple[int, int]]:
    """Minato–Morreale irredundant SOP.  Returns cubes as (pos_mask, neg_mask)
    over variable indices; cube covers patterns where all pos vars=1, neg=0."""
    full = _tt_mask(k)
    tt &= full
    care &= full
    key = (tt, care, k)
    hit = _ISOP_CACHE.get(key)
    if hit is not None:
        return list(hit)
    res = _isop_uncached(tt, care, k)
    if len(_ISOP_CACHE) < _ISOP_CACHE_MAX:
        _ISOP_CACHE[key] = tuple(res)
    return res


def _isop_uncached(tt: int, care: int, k: int) -> list[tuple[int, int]]:
    if care == 0:
        return []
    if tt & care == 0:
        return []
    if (tt & care) == care:
        return [(0, 0)]

    # pick the top variable on which (tt, care) actually depends; if none,
    # the base cases above would have fired (tt&care constant over care).
    i = -1
    for j in range(k - 1, -1, -1):
        t0, t1 = _cofactors(tt, j, k)
        c0, c1 = _cofactors(care, j, k)
        if t0 != t1 or c0 != c1:
            i = j
            break
    if i < 0:
        # tt constant within care but mixed outside: cover all care points.
        return [(0, 0)] if (tt & care) else []
    t0, t1 = _cofactors(tt, i, k)
    c0, c1 = _cofactors(care, i, k)
    # cubes needed only in the 0-half / 1-half
    isop0 = _isop(t0 & ~(t1 & c1), c0, k)
    isop1 = _isop(t1 & ~(t0 & c0), c1, k)
    cov0 = _cover_tt(isop0, k)
    cov1 = _cover_tt(isop1, k)
    rem = (t0 & c0 & ~cov0) | (t1 & c1 & ~cov1)
    isop2 = _isop(rem, (c0 & ~cov0) | (c1 & ~cov1), k)
    cubes = (
        [(p, nmask | (1 << i)) for (p, nmask) in isop0]
        + [(p | (1 << i), nmask) for (p, nmask) in isop1]
        + isop2
    )
    return cubes


def _cover_tt(cubes: list[tuple[int, int]], k: int) -> int:
    full = _tt_mask(k)
    acc = 0
    for pos, neg in cubes:
        cube_tt = full
        for i in range(k):
            if pos & (1 << i):
                cube_tt &= _elem_tt(i, k)
            elif neg & (1 << i):
                cube_tt &= full ^ _elem_tt(i, k)
        acc |= cube_tt
    return acc


def _factor_cubes(aig: Aig, cubes: list[tuple[int, int]], leaves: list[int]) -> int:
    """Quick algebraic factoring of an SOP (most-common-literal division)."""
    if not cubes:
        return CONST0
    if cubes == [(0, 0)]:
        return CONST1

    def cube_lits(c: tuple[int, int]) -> list[int]:
        pos, neg = c
        out = []
        for i in range(len(leaves)):
            if pos & (1 << i):
                out.append(leaves[i])
            elif neg & (1 << i):
                out.append(lit_not(leaves[i]))
        return out

    if len(cubes) == 1:
        return aig.g_and_multi(cube_lits(cubes[0]))

    # most common literal across cubes
    count: dict[int, int] = {}
    for pos, neg in cubes:
        for i in range(len(leaves)):
            if pos & (1 << i):
                count[lit(i + 1)] = count.get(lit(i + 1), 0) + 1  # key only
            elif neg & (1 << i):
                count[lit(i + 1) ^ 1] = count.get(lit(i + 1) ^ 1, 0) + 1
    best_key, best_cnt = None, 1
    for key, c in count.items():
        if c > best_cnt:
            best_key, best_cnt = key, c
    if best_key is None:
        # no sharing: balanced OR of cube ANDs
        terms = [aig.g_and_multi(cube_lits(c)) for c in cubes]
        return aig.g_or_multi(terms)
    var_i = (best_key >> 1) - 1
    is_neg = best_key & 1
    with_lit, without = [], []
    for pos, neg in cubes:
        has = (neg if is_neg else pos) & (1 << var_i)
        if has:
            if is_neg:
                with_lit.append((pos, neg & ~(1 << var_i)))
            else:
                with_lit.append((pos & ~(1 << var_i), neg))
        else:
            without.append((pos, neg))
    lit_l = lit_not(leaves[var_i]) if is_neg else leaves[var_i]
    quot = _factor_cubes(aig, with_lit, leaves)
    rest = _factor_cubes(aig, without, leaves) if without else CONST0
    return aig.g_or(aig.g_and(lit_l, quot), rest)


def refactor(
    aig: Aig, max_leaves: int = 10, backend: str = "python", device=None
) -> Aig:
    """Collapse + refactor large cones (ABC ``refactor``).

    ``backend="device"`` batches cone truth tables through
    `kernels.aig_sim` on ``device``; output is bit-identical to the python
    path.
    """
    if resolve_backend(backend) == "device":
        return _refactor_device(aig, max_leaves=max_leaves, device=device)
    fanout = aig.fanout_counts()
    new = Aig(aig.n_pis, name=aig.name)
    mapping: dict[int, int] = {0: CONST0}
    for i in range(1, 1 + aig.n_pis):
        mapping[i] = lit(i)
    reach = _reachable(aig)
    lv = aig.levels()

    for n in range(aig.n_pis + 1, aig.n_nodes):
        if not reach[n]:
            continue
        fa, fb = aig.fanins(n)
        default = new.g_and(mapping[fa >> 1] ^ (fa & 1), mapping[fb >> 1] ^ (fb & 1))
        mapping[n] = default
        # Refactor only at "root-ish" nodes: multi-fanout or PO drivers, and
        # deep enough to have a real cone.
        if fanout[n] < 2 and lv[n] % 3 != 0:
            continue
        leaves = _reconv_cut(aig, n, max_leaves)
        if len(leaves) < 3 or n in leaves:
            continue
        k = len(leaves)
        if k > 12:
            continue
        cone = aig.cone_nodes(n, set(leaves))
        tt = aig.truth_table(lit(n), leaves, cone=cone)
        cubes = _isop(tt, _tt_mask(k), k)
        old_cost = _mffc_size(aig, n, frozenset(leaves), fanout, cone=cone)
        # Estimate new cost: literals-1 per cube + cubes-1 ORs (upper bound).
        est = sum(bin(p | q).count("1") for p, q in cubes) + max(0, len(cubes) - 1)
        if est >= old_cost + 2:
            continue
        before = new.n_ands
        cand = _factor_cubes(new, cubes, [mapping[m] for m in leaves])
        added = new.n_ands - before
        if added <= old_cost:
            mapping[n] = cand
    for p in aig.pos:
        new.add_po(mapping[lit_node(p)] ^ lit_phase(p))
    out = new.clone()
    return out if out.n_ands <= aig.n_ands else aig


# ===========================================================================
# Resub (R_s)
# ===========================================================================


def resub(
    aig: Aig, n_words: int = 32, seed: int = 7, backend: str = "python",
    device=None,
) -> Aig:
    """Simulation-guided, window-exact resubstitution (ABC ``resub``).

    1. Global random simulation produces a signature per node.
    2. Signature-equal (or complement) node pairs are *candidate* equivalences,
       verified exactly over the union of structural supports (≤14 PIs) —
       verified pairs merge (0-resub / functional reduction).

    ``backend="device"`` runs signatures and verification truth tables
    through `kernels.aig_sim` on ``device``; output is bit-identical to the
    python path.
    """
    if resolve_backend(backend) == "device":
        return _resub_device(aig, n_words=n_words, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    if aig.n_pis == 0 or aig.n_ands == 0:
        return aig
    patterns = rng.integers(0, 1 << 63, size=(aig.n_pis, n_words), dtype=np.int64).astype(np.uint64)
    # include "elementary-ish" structured patterns for better separation
    sig = _node_signatures(aig, patterns)

    # Bucket by signature (and complemented signature).
    buckets: dict[bytes, list[int]] = {}
    for n in range(1, aig.n_nodes):
        buckets.setdefault(sig[n].tobytes(), []).append(n)

    supports = _supports(aig, cap=14)
    replace: dict[int, int] = {}  # node -> literal of replacement
    full = np.uint64(0xFFFFFFFFFFFFFFFF)
    for n in range(aig.n_pis + 1, aig.n_nodes):
        if n in replace:
            continue
        cands = buckets.get(sig[n].tobytes(), [])
        comp = (sig[n] ^ full).tobytes()
        cands = [m for m in cands if m < n] + [m for m in buckets.get(comp, []) if m < n]
        for m in cands:
            neg = sig[m].tobytes() != sig[n].tobytes()
            if supports[n] is None or supports[m] is None:
                continue
            sup = sorted(supports[n] | supports[m])
            if len(sup) > 14:
                continue
            tt_n = aig.truth_table(lit(n), sup)
            tt_m = aig.truth_table(lit(m), sup)
            if tt_n == tt_m and not neg:
                replace[n] = lit(m)
                break
            if tt_n == (tt_m ^ _tt_mask(len(sup))) and neg:
                replace[n] = lit_not(lit(m))
                break

    if not replace:
        return aig
    new = Aig(aig.n_pis, name=aig.name)
    mapping: dict[int, int] = {0: CONST0}
    for i in range(1, 1 + aig.n_pis):
        mapping[i] = lit(i)
    for n in range(aig.n_pis + 1, aig.n_nodes):
        if n in replace:
            r = replace[n]
            mapping[n] = mapping[lit_node(r)] ^ lit_phase(r)
        else:
            fa, fb = aig.fanins(n)
            mapping[n] = new.g_and(mapping[fa >> 1] ^ (fa & 1), mapping[fb >> 1] ^ (fb & 1))
    for p in aig.pos:
        new.add_po(mapping[lit_node(p)] ^ lit_phase(p))
    out = new.clone()
    return out if out.n_ands <= aig.n_ands else aig


def _node_signatures(aig: Aig, patterns: np.ndarray) -> np.ndarray:
    n_words = patterns.shape[1]
    vals = np.zeros((aig.n_nodes, n_words), dtype=np.uint64)
    vals[1 : 1 + aig.n_pis] = patterns
    full = np.uint64(0xFFFFFFFFFFFFFFFF)
    for n in range(aig.n_pis + 1, aig.n_nodes):
        fa, fb = aig.fanins(n)
        va = vals[fa >> 1] ^ (full if (fa & 1) else np.uint64(0))
        vb = vals[fb >> 1] ^ (full if (fb & 1) else np.uint64(0))
        vals[n] = va & vb
    return vals


def _supports(aig: Aig, cap: int = 14) -> list[set[int] | None]:
    """Structural PI support per node; None if larger than cap."""
    sup: list[set[int] | None] = [set() for _ in range(aig.n_nodes)]
    for n in range(1, 1 + aig.n_pis):
        sup[n] = {n}
    for n in range(aig.n_pis + 1, aig.n_nodes):
        fa, fb = aig.fanins(n)
        sa, sb = sup[fa >> 1], sup[fb >> 1]
        if sa is None or sb is None:
            sup[n] = None
            continue
        u = sa | sb
        sup[n] = None if len(u) > cap else u
    return sup


# ===========================================================================
# Device backend (kernels/aig_sim) — batched truth-table characterization
# ===========================================================================
#
# The device variants below are *bit-identical* re-stagings of the python
# transforms: every decision (truth table, MFFC size, plan, ISOP cubes,
# resub candidate order) is a pure function of the ORIGINAL AIG, so each
# transform splits into a precompute phase — one batched device call per
# query family instead of per-node python cone walks — and a sequential
# rebuild phase that replays the python path's decisions in its exact
# order.  Because outputs are identical, TRANSFORM_VERSION does not bump
# and on-disk cache entries stay valid across backends (CI asserts this).


def resolve_backend(backend: str | None) -> str:
    """Resolve a characterization backend name to ``python`` or ``device``.

    ``auto`` (or None) picks ``device``: torch always imports, and the
    device backend runs the plain torch versions on ``device="cpu"``.
    """
    if backend is None or backend == "auto":
        return "device"
    if backend not in ("python", "device"):
        raise ValueError(f"unknown characterization backend {backend!r}")
    return backend


def _cone_matrix(
    aig: Aig, roots: Sequence[int], leaves_list: Sequence[Sequence[int]]
) -> np.ndarray:
    """(B, n_nodes) bool cone membership for a batch of (root, leaves)
    queries — the vectorized counterpart of `Aig.cone_nodes` (AND nodes
    only, stopping at and excluding the leaves).

    One descending-index scan over the node array serves the whole batch:
    node indices are topological, so by the time the scan reaches ``n``
    every cone that contains ``n`` has already marked it.
    """
    n = aig.n_nodes
    n_b = len(roots)
    roots_a = np.asarray(roots, dtype=np.int64)
    f0 = np.asarray(aig._f0, dtype=np.int64)
    f1 = np.asarray(aig._f1, dtype=np.int64)
    # (n_nodes, batch) scan layout: node rows are contiguous (see
    # `aig_sim._cone_members`), transposed back on return.
    vis = np.zeros((n, n_b), dtype=bool)
    leaf = np.zeros((n, n_b), dtype=bool)
    for i, lvs in enumerate(leaves_list):
        leaf[list(lvs), i] = True
    vis[roots_a, np.arange(n_b)] = True
    for node in range(int(roots_a.max()), aig.n_pis, -1):
        act = vis[node] & ~leaf[node]
        if act.any():
            vis[f0[node] >> 1][act] = True
            vis[f1[node] >> 1][act] = True
    members = vis & ~leaf
    members[: aig.n_pis + 1] = False
    return np.ascontiguousarray(members.T)


def _mffc_sizes_batch(
    aig: Aig,
    roots: Sequence[int],
    members: np.ndarray,
    fanout: np.ndarray,
) -> np.ndarray:
    """(B,) MFFC sizes matching `_mffc_size` for each (root, cone) row of
    ``members`` (from `_cone_matrix`): cone nodes whose every fanout
    reference comes from inside the cone, the root always counted."""
    n = aig.n_nodes
    n_b = members.shape[0]
    f0 = np.asarray(aig._f0, dtype=np.int64) >> 1
    f1 = np.asarray(aig._f1, dtype=np.int64) >> 1
    # Cones are tiny relative to the graph, so work on the sparse member
    # entries: bincount the two fanin edges of every (item, cone node)
    # pair into per-item reference counts, then test each member entry.
    b_idx, node_idx = np.nonzero(members)
    keys = np.concatenate([b_idx * n + f0[node_idx], b_idx * n + f1[node_idx]])
    refs = np.bincount(keys, minlength=n_b * n)
    mkeys = b_idx * n + node_idx
    freed_mask = refs[mkeys] >= fanout[node_idx]
    freed = np.bincount(b_idx[freed_mask], minlength=n_b)
    roots_a = np.asarray(roots, dtype=np.int64)
    root_pass = refs[np.arange(n_b) * n + roots_a] >= fanout[roots_a]
    return freed - root_pass.astype(np.int64) + 1


def _rewrite_device(aig: Aig, k: int = 4, max_cuts: int = 8, device=None) -> Aig:
    """`rewrite` with batched device truth tables + vectorized MFFC."""
    cuts = _enumerate_cuts(aig, k=k, max_cuts=max_cuts)
    fanout = aig.fanout_counts()
    reach = _reachable(aig)

    # Phase A — precompute: every (node, cut) query in python iteration
    # order; all decisions below depend only on the original AIG.
    items: list[tuple[int, list[int]]] = []
    for n in range(aig.n_pis + 1, aig.n_nodes):
        if not reach[n]:
            continue
        for cut in cuts[n]:
            if len(cut) < 2 or n in cut:
                continue
            items.append((n, sorted(cut)))

    best_for: dict[int, tuple[tuple, list[int]]] = {}
    if items:
        prog = aig_sim.compile_aig(aig)
        members = _cone_matrix(aig, [n for n, _ in items], [s for _, s in items])
        tts = aig_sim.eval_tts(
            aig,
            [((lit(n),), sup) for n, sup in items],
            program=prog,
            members=members,
            device=device,
        )
        old_costs = _mffc_sizes_batch(aig, [n for n, _ in items], members, fanout)
        best_gain: dict[int, int] = {}
        for (n, sup), (tt,), old_cost in zip(items, tts, old_costs):
            cost, plan = synth_plan(tt, len(sup))
            gain = int(old_cost) - cost
            if gain > best_gain.get(n, 0):
                best_gain[n] = gain
                best_for[n] = (plan, sup)

    # Phase B — sequential rebuild, replaying the python path's choices.
    new = Aig(aig.n_pis, name=aig.name)
    mapping: dict[int, int] = {0: CONST0}
    for i in range(1, 1 + aig.n_pis):
        mapping[i] = lit(i)
    for n in range(aig.n_pis + 1, aig.n_nodes):
        if not reach[n]:
            continue
        fa, fb = aig.fanins(n)
        mapping[n] = new.g_and(
            mapping[fa >> 1] ^ (fa & 1), mapping[fb >> 1] ^ (fb & 1)
        )
        hit = best_for.get(n)
        if hit is not None:
            plan, support = hit
            mapping[n] = build_plan(new, plan, [mapping[m] for m in support])
    for p in aig.pos:
        new.add_po(mapping[lit_node(p)] ^ lit_phase(p))
    out = new.clone()
    return out if out.n_ands <= aig.n_ands else aig


def _refactor_device(aig: Aig, max_leaves: int = 10, device=None) -> Aig:
    """`refactor` with batched device truth tables + vectorized MFFC.

    The `_factor_cubes` trial must stay in the sequential phase: rejected
    trials still leave strashed nodes in the new AIG, which later nodes'
    ``added`` accounting observes — so only the cone/tt/ISOP/estimate work
    moves to the precompute phase.
    """
    fanout = aig.fanout_counts()
    reach = _reachable(aig)
    lv = aig.levels()

    cand_items: list[tuple[int, list[int]]] = []
    for n in range(aig.n_pis + 1, aig.n_nodes):
        if not reach[n]:
            continue
        if fanout[n] < 2 and lv[n] % 3 != 0:
            continue
        leaves = _reconv_cut(aig, n, max_leaves)
        if len(leaves) < 3 or n in leaves:
            continue
        if len(leaves) > 12:
            continue
        cand_items.append((n, leaves))

    plans: dict[int, tuple[list[tuple[int, int]], list[int], int]] = {}
    if cand_items:
        prog = aig_sim.compile_aig(aig)
        members = _cone_matrix(
            aig, [n for n, _ in cand_items], [l for _, l in cand_items]
        )
        tts = aig_sim.eval_tts(
            aig,
            [((lit(n),), lvs) for n, lvs in cand_items],
            program=prog,
            members=members,
            device=device,
        )
        old_costs = _mffc_sizes_batch(
            aig, [n for n, _ in cand_items], members, fanout
        )
        for (n, leaves), (tt,), old_cost in zip(cand_items, tts, old_costs):
            kk = len(leaves)
            cubes = _isop(tt, _tt_mask(kk), kk)
            est = sum(bin(p | q).count("1") for p, q in cubes) + max(0, len(cubes) - 1)
            if est >= int(old_cost) + 2:
                continue
            plans[n] = (cubes, leaves, int(old_cost))

    new = Aig(aig.n_pis, name=aig.name)
    mapping: dict[int, int] = {0: CONST0}
    for i in range(1, 1 + aig.n_pis):
        mapping[i] = lit(i)
    for n in range(aig.n_pis + 1, aig.n_nodes):
        if not reach[n]:
            continue
        fa, fb = aig.fanins(n)
        mapping[n] = new.g_and(mapping[fa >> 1] ^ (fa & 1), mapping[fb >> 1] ^ (fb & 1))
        hit = plans.get(n)
        if hit is None:
            continue
        cubes, leaves, old_cost = hit
        before = new.n_ands
        cand = _factor_cubes(new, cubes, [mapping[m] for m in leaves])
        added = new.n_ands - before
        if added <= old_cost:
            mapping[n] = cand
    for p in aig.pos:
        new.add_po(mapping[lit_node(p)] ^ lit_phase(p))
    out = new.clone()
    return out if out.n_ands <= aig.n_ands else aig


def _resub_device(aig: Aig, n_words: int = 32, seed: int = 7, device=None) -> Aig:
    """`resub` with device node signatures + round-batched verification.

    The python path verifies each node's candidate list in order and stops
    at the first match.  Candidate lists are independent across nodes, so
    rounds preserve that order exactly: round ``i`` verifies the first
    still-untried candidate of every unresolved node as one batched device
    call; a node drops out when it matches or exhausts its list.
    """
    rng = np.random.default_rng(seed)
    if aig.n_pis == 0 or aig.n_ands == 0:
        return aig
    patterns = rng.integers(0, 1 << 63, size=(aig.n_pis, n_words), dtype=np.int64).astype(np.uint64)
    prog = aig_sim.compile_aig(aig)
    sig = aig_sim.node_signatures(aig, patterns, program=prog, device=device)

    buckets: dict[bytes, list[int]] = {}
    for n in range(1, aig.n_nodes):
        buckets.setdefault(sig[n].tobytes(), []).append(n)

    supports = _supports(aig, cap=14)
    full = np.uint64(0xFFFFFFFFFFFFFFFF)
    cand_lists: dict[int, list[tuple[int, bool, list[int]]]] = {}
    for n in range(aig.n_pis + 1, aig.n_nodes):
        if supports[n] is None:
            continue
        cands = buckets.get(sig[n].tobytes(), [])
        comp = (sig[n] ^ full).tobytes()
        cands = [m for m in cands if m < n] + [m for m in buckets.get(comp, []) if m < n]
        flist: list[tuple[int, bool, list[int]]] = []
        for m in cands:
            if supports[m] is None:
                continue
            neg = sig[m].tobytes() != sig[n].tobytes()
            sup = sorted(supports[n] | supports[m])
            if len(sup) > 14:
                continue
            flist.append((m, neg, sup))
        if flist:
            cand_lists[n] = flist

    replace: dict[int, int] = {}
    pos_i = {n: 0 for n in cand_lists}
    active = sorted(cand_lists)
    while active:
        batch = [(n,) + cand_lists[n][pos_i[n]] for n in active]
        tts = aig_sim.eval_tts(
            aig,
            [((lit(n), lit(m)), sup) for n, m, _, sup in batch],
            program=prog,
            device=device,
        )
        nxt: list[int] = []
        for (n, m, neg, sup), (tt_n, tt_m) in zip(batch, tts):
            if tt_n == tt_m and not neg:
                replace[n] = lit(m)
            elif neg and tt_n == (tt_m ^ _tt_mask(len(sup))):
                replace[n] = lit_not(lit(m))
            else:
                pos_i[n] += 1
                if pos_i[n] < len(cand_lists[n]):
                    nxt.append(n)
        active = nxt

    if not replace:
        return aig
    new = Aig(aig.n_pis, name=aig.name)
    mapping: dict[int, int] = {0: CONST0}
    for i in range(1, 1 + aig.n_pis):
        mapping[i] = lit(i)
    for n in range(aig.n_pis + 1, aig.n_nodes):
        if n in replace:
            r = replace[n]
            mapping[n] = mapping[lit_node(r)] ^ lit_phase(r)
        else:
            fa, fb = aig.fanins(n)
            mapping[n] = new.g_and(mapping[fa >> 1] ^ (fa & 1), mapping[fb >> 1] ^ (fb & 1))
    for p in aig.pos:
        new.add_po(mapping[lit_node(p)] ^ lit_phase(p))
    out = new.clone()
    return out if out.n_ands <= aig.n_ands else aig


# ===========================================================================
# Recipes — Algorithm I line 3 (CreateAIG)
# ===========================================================================

_TRANSFORM_FNS: dict[str, Callable[[Aig], Aig]] = {
    "Ba": balance,
    "Rf": refactor,
    "Rw": rewrite,
    "Rs": resub,
}


def transform_fns(
    backend: str = "python", device=None
) -> dict[str, Callable[[Aig], Aig]]:
    """Transform-name -> callable map for a characterization backend.

    ``balance`` has no truth-table inner loop, so it is shared; the other
    three dispatch to their `kernels.aig_sim`-batched variants on
    ``device`` under the ``device`` backend (bit-identical outputs either
    way).
    """
    resolved = resolve_backend(backend)
    if resolved == "python":
        return dict(_TRANSFORM_FNS)
    return {
        "Ba": balance,
        "Rf": partial(refactor, backend=resolved, device=device),
        "Rw": partial(rewrite, backend=resolved, device=device),
        "Rs": partial(resub, backend=resolved, device=device),
    }


def enumerate_recipes(
    names: Sequence[str] = TRANSFORM_NAMES,
) -> list[tuple[str, ...]]:
    """All ordered permutations of non-empty subsets — 64 for 4 transforms."""
    out: list[tuple[str, ...]] = []
    for r in range(1, len(names) + 1):
        out.extend(itertools.permutations(names, r))
    return out


def prefix_nodes(recipes: Sequence[tuple[str, ...]]) -> list[tuple[str, ...]]:
    """Non-empty prefixes of ``recipes``, deduplicated and ordered by depth
    — the nodes of the shared-prefix DAG in a valid evaluation order (a
    node's parent always precedes it)."""
    seen: set[tuple[str, ...]] = set()
    out: list[tuple[str, ...]] = []
    for r in recipes:
        for i in range(1, len(r) + 1):
            p = tuple(r[:i])
            if p not in seen:
                seen.add(p)
                out.append(p)
    out.sort(key=lambda p: (len(p), p))
    return out


class RecipeRunner:
    """Applies recipes over the shared-prefix DAG of the recipe set.

    Two memo layers:

      * *prefix* — recipes share prefixes (``Ba,Rf,Rw`` reuses the ``Ba,Rf``
        intermediate), so the 64-recipe sweep needs at most 64 transform
        applications instead of 129 chained ones;
      * *structural* — ``(input fingerprint, transform) -> output
        fingerprint``.  The transforms are deterministic functions of AIG
        structure, so when two prefixes converge to the identical AIG
        (common: transforms hit fixpoints and return their input), their
        entire subtrees coincide and are computed once.  On the tiny suite
        this cuts the 64 applications per circuit to 4-55 (`n_applied`).

    Characterizations (`stats`) are memoized per distinct structure, so a
    circuit whose recipes converge to D distinct AIGs pays D ``ChaAIG``
    passes, not 65.
    """

    def __init__(
        self,
        base: Aig,
        backend: str = "python",
        on_apply: "Callable[[str, str, str, Aig, AigStats | None], None] | None" = None,
        device=None,
    ):
        self.base = base
        self.backend = resolve_backend(backend)
        #: Where the device backend's truth tables run (a device string,
        #: so it travels to pool workers); resolved eagerly so a missing
        #: card raises here, not at the first transform.
        self.device = str(resolve_device(device))
        self._fns = transform_fns(self.backend, self.device)
        #: Called after every *fresh* application (not preloads) with
        #: (src_fp, transform, out_fp, out AIG, stats-or-None) — the hook
        #: `characterize_suite` uses for incremental cache persistence.
        self.on_apply = on_apply
        base_fp = base.fingerprint()
        self._node_fp: dict[tuple[str, ...], str] = {(): base_fp}
        self._store: dict[str, Aig] = {base_fp: base}
        self._applied: dict[tuple[str, str], str] = {}
        self._stats: dict[str, AigStats] = {}
        self.n_applied = 0  # real transform runs (structural misses)
        self.n_preloaded = 0  # applications installed from the disk cache

    # -- DAG resolution ------------------------------------------------------

    def run_fp(self, recipe: Sequence[str]) -> str:
        """Fingerprint of the recipe's result, applying transforms as needed."""
        recipe = tuple(recipe)
        hit = self._node_fp.get(recipe)
        if hit is not None:
            return hit
        src_fp = self.run_fp(recipe[:-1])
        out_fp = self.apply_fp(src_fp, recipe[-1])
        self._node_fp[recipe] = out_fp
        return out_fp

    def apply_fp(self, src_fp: str, transform: str) -> str:
        """Structural-memo transform application on a stored AIG."""
        key = (src_fp, transform)
        hit = self._applied.get(key)
        if hit is not None:
            return hit
        out = self._fns[transform](self._store[src_fp])
        self.n_applied += 1
        out_fp = out.fingerprint()
        self._applied[key] = out_fp
        self._store.setdefault(out_fp, out)
        if self.on_apply is not None:
            self.on_apply(src_fp, transform, out_fp, out, None)
        return out_fp

    def record(
        self, src_fp: str, transform: str, out: Aig,
        stats: AigStats | None = None,
    ) -> str:
        """Install an externally computed application (process-pool path)."""
        out_fp = out.fingerprint()
        self.n_applied += 1
        self._applied[(src_fp, transform)] = out_fp
        self._store.setdefault(out_fp, out)
        if stats is not None:
            self._stats.setdefault(out_fp, stats)
        if self.on_apply is not None:
            self.on_apply(src_fp, transform, out_fp, out, stats)
        return out_fp

    def preload_application(
        self, src_fp: str, transform: str, out: Aig,
        stats: AigStats | None = None,
    ) -> str:
        """Install a cached application as a warm start: does not count as
        work (`n_applied`) and does not re-notify ``on_apply``."""
        out_fp = out.fingerprint()
        self._applied.setdefault((src_fp, transform), out_fp)
        self._store.setdefault(out_fp, out)
        if stats is not None:
            self._stats.setdefault(out_fp, stats)
        self.n_preloaded += 1
        return out_fp

    def aig_for(self, fp: str) -> Aig:
        return self._store[fp]

    def has_applied(self, src_fp: str, transform: str) -> bool:
        return (src_fp, transform) in self._applied

    # -- public API ----------------------------------------------------------

    def run(self, recipe: Sequence[str]) -> Aig:
        """The recipe's result AIG (Alg. I line 3, ``CreateAIG``)."""
        return self._store[self.run_fp(recipe)]

    def stats(self, recipe: Sequence[str]) -> AigStats:
        """The recipe's characterization (Alg. I line 4, ``ChaAIG``),
        memoized per distinct result structure."""
        fp = self.run_fp(recipe)
        hit = self._stats.get(fp)
        if hit is None:
            hit = self._stats[fp] = self._store[fp].characterize()
        return hit


def apply_recipe(aig: Aig, recipe: Sequence[str]) -> Aig:
    return RecipeRunner(aig).run(tuple(recipe))


# ===========================================================================
# Persistent characterization cache
# ===========================================================================


def _recipe_key(recipe: tuple[str, ...]) -> str:
    return ",".join(recipe)


def _atomic_json(path: Path, payload: dict) -> None:
    """Write JSON via tempfile + ``os.replace`` (crash/concurrency safe)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    # Serialize first, write bytes: the chaos harness can then model a
    # torn write (truncated payload surviving the atomic replace) that
    # the tolerant load paths below must absorb as a cache miss.
    data = faults.corrupt(
        "cache.store", json.dumps(payload).encode(), detail=str(path)
    )
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class CharacterizationCache:
    """On-disk ``ChaAIG`` cache keyed by (circuit, recipe, transform version).

    Layout: one JSON file per circuit fingerprint under
    ``{root}/v{TRANSFORM_VERSION}/{fp}.json``, mapping recipe keys
    (``"Ba,Rf"``; ``""`` is the baseline) to `AigStats` dicts.  The
    transform version is both the directory name and embedded in each file,
    so bumping `TRANSFORM_VERSION` orphans every stale entry instead of
    serving results from outdated transform implementations.

    Writes are atomic (tempfile + ``os.replace``), so concurrent
    characterizations at worst redo work — they never corrupt the cache.
    ``hits`` / ``misses`` count circuit-level lookups (for tests and the
    cold/warm benchmark reporting).
    """

    def __init__(self, root: str | os.PathLike):
        self.root = Path(root)
        self.hits = 0
        self.misses = 0

    def _path(self, circuit_fp: str) -> Path:
        return self.root / f"v{TRANSFORM_VERSION}" / f"{circuit_fp}.json"

    def load(self, circuit_fp: str) -> dict[tuple[str, ...], AigStats]:
        """All cached characterizations for a circuit (empty dict on miss).

        Corruption-tolerant: a truncated or otherwise unparseable file is
        a whole-circuit miss, and a schema-corrupt *entry* (wrong keys /
        types inside valid JSON) is an entry-level miss — either way the
        caller re-characterizes and `store` atomically rewrites the file,
        so a torn write never wedges the cache."""
        path = self._path(circuit_fp)
        try:
            with open(path) as f:
                raw = json.load(f)
            if raw.get("transform_version") != TRANSFORM_VERSION:
                return {}
            items = list(raw.get("recipes", {}).items())
        except (OSError, json.JSONDecodeError, TypeError, AttributeError):
            return {}
        out: dict[tuple[str, ...], AigStats] = {}
        for key, d in items:
            try:
                recipe = tuple(key.split(",")) if key else ()
                out[recipe] = AigStats.from_dict(d)
            except (KeyError, TypeError, ValueError, AttributeError):
                continue  # corrupt entry -> miss for that recipe only
        return out

    def store(
        self, circuit_fp: str, cha: Mapping[tuple[str, ...], AigStats]
    ) -> None:
        """Merge ``cha`` into the circuit's cache file (atomic replace)."""
        merged = self.load(circuit_fp)
        merged.update(cha)
        payload = dict(
            transform_version=TRANSFORM_VERSION,
            circuit=circuit_fp,
            recipes={
                _recipe_key(r): s.to_dict() for r, s in sorted(merged.items())
            },
        )
        _atomic_json(self._path(circuit_fp), payload)

    # -- per-application persistence (partial warm starts) -------------------
    #
    # Recipe-endpoint stats alone only help once a whole circuit finished:
    # a run that dies mid-suite redoes every transform.  The application
    # index below persists each (src fingerprint, transform) -> output as
    # soon as it is computed, with the output AIG *structure* stored once
    # per distinct fingerprint — the next run preloads them into the
    # `RecipeRunner` memo and only runs the applications it never reached.

    def _apps_path(self, circuit_fp: str) -> Path:
        return self.root / f"v{TRANSFORM_VERSION}" / f"{circuit_fp}.apps.json"

    def _aig_path(self, fp: str) -> Path:
        return self.root / f"v{TRANSFORM_VERSION}" / "aigs" / f"{fp}.json"

    def load_applications(
        self, circuit_fp: str
    ) -> dict[tuple[str, str], tuple[str, AigStats | None]]:
        """Persisted applications for a circuit:
        ``{(src_fp, transform): (out_fp, stats-or-None)}``."""
        try:
            with open(self._apps_path(circuit_fp)) as f:
                raw = json.load(f)
            if raw.get("transform_version") != TRANSFORM_VERSION:
                return {}
            items = list(raw.get("apps", {}).items())
        except (OSError, json.JSONDecodeError, TypeError, AttributeError):
            return {}
        out: dict[tuple[str, str], tuple[str, AigStats | None]] = {}
        for key, d in items:
            try:
                src_fp, _, transform = key.rpartition(":")
                if not src_fp or transform not in TRANSFORM_NAMES:
                    continue
                stats = (
                    AigStats.from_dict(d["stats"]) if d.get("stats") else None
                )
                out[(src_fp, transform)] = (d["out"], stats)
            except (KeyError, TypeError, ValueError, AttributeError):
                continue  # corrupt application entry -> redo that one
        return out

    def load_aig(self, fp: str) -> Aig | None:
        """A persisted AIG structure by fingerprint (None on miss/corruption)."""
        try:
            with open(self._aig_path(fp)) as f:
                raw = json.load(f)
            aig = Aig.from_dict(raw)
        except (OSError, json.JSONDecodeError, KeyError, ValueError,
                IndexError, TypeError, AttributeError):
            return None
        return aig if aig.fingerprint() == fp else None

    def store_application(
        self,
        circuit_fp: str,
        src_fp: str,
        transform: str,
        out: Aig,
        stats: AigStats | None = None,
    ) -> None:
        """Persist one transform application and its output structure.

        The AIG file is written first so a crash between the two writes
        leaves at worst an unreferenced structure, never a dangling index
        entry."""
        out_fp = out.fingerprint()
        aig_path = self._aig_path(out_fp)
        if not aig_path.exists():
            _atomic_json(aig_path, out.to_dict())
        apps_path = self._apps_path(circuit_fp)
        try:
            with open(apps_path) as f:
                raw = json.load(f)
            if raw.get("transform_version") != TRANSFORM_VERSION:
                raw = {}
        except (OSError, json.JSONDecodeError, TypeError, AttributeError):
            raw = {}
        apps = raw.get("apps", {})
        if not isinstance(apps, dict):
            apps = {}
        entry = apps.get(f"{src_fp}:{transform}", {})
        if not isinstance(entry, dict):
            entry = {}
        apps[f"{src_fp}:{transform}"] = dict(
            out=out_fp,
            stats=stats.to_dict() if stats is not None else entry.get("stats"),
        )
        _atomic_json(
            apps_path,
            dict(
                transform_version=TRANSFORM_VERSION,
                circuit=circuit_fp,
                apps=apps,
            ),
        )


def _as_cache(
    cache: "CharacterizationCache | str | os.PathLike | None",
) -> "CharacterizationCache | None":
    if cache is None or isinstance(cache, CharacterizationCache):
        return cache
    return CharacterizationCache(cache)


# ===========================================================================
# Suite-level characterization (parallel front half of Algorithm I)
# ===========================================================================


def _characterize_task(task):
    """Process-pool worker: apply one transform and characterize the result.

    ``task`` = (circuit name, input fingerprint, transform, input Aig,
    backend, device).  Returns (name, input fingerprint, transform, result
    Aig, AigStats) — the parent installs it via `RecipeRunner.record`.
    """
    name, src_fp, transform, aig, backend, device = task
    faults.inject("pool.task", detail=f"{name}:{transform}")
    out = transform_fns(backend, device)[transform](aig)
    return name, src_fp, transform, out, out.characterize()


@dataclasses.dataclass(frozen=True)
class PoolPolicy:
    """Fault posture of the characterization pool scheduler.

    ``task_deadline_s``: wall-clock budget per dispatched application;
    exceeding it counts as one failed attempt and — since a running
    `ProcessPoolExecutor` task cannot be cancelled — forces a pool
    rebuild so the stuck worker is actually killed.  ``max_retries`` is
    *additional* attempts after the first (so 2 means up to 3 runs);
    retries wait ``backoff_s * 2**attempt`` seconds (capped) scaled by a
    deterministic per-(task, attempt) jitter in [0.5, 1.5) keyed on
    ``seed``, so a chaos failure replays exactly.
    """

    task_deadline_s: float | None = None
    max_retries: int = 2
    backoff_s: float = 0.05
    backoff_cap_s: float = 2.0
    seed: int = 0

    def backoff(self, key: str, attempt: int) -> float:
        base = min(self.backoff_cap_s, self.backoff_s * (2.0 ** attempt))
        return base * (0.5 + Random(f"{self.seed}:{key}:{attempt}").random())


class CharacterizationError(RuntimeError):
    """A circuit's characterization failed permanently (poisoned task:
    retries exhausted, or repeated worker crashes/hangs attributed to
    it).  Carries the circuit so suite-level callers can quarantine it
    instead of aborting the whole sweep."""

    def __init__(self, circuit: str, message: str):
        super().__init__(f"{circuit}: {message}")
        self.circuit = circuit


def _resolve_jobs(n_jobs: int | None, backend: str = "python") -> int:
    if n_jobs is None:
        env = os.environ.get("REPRO_CHA_JOBS")
        if env is not None:
            n_jobs = int(env)
        elif backend == "device":
            # The device path is already batched, and CUDA work stays in
            # the parent process (one context on the card), so serial.
            n_jobs = 1
        else:
            n_jobs = min(4, os.cpu_count() or 1)
    if n_jobs > 1 and not _spawn_safe():
        n_jobs = 1
    return max(1, n_jobs)


def _spawn_safe() -> bool:
    """The ``spawn`` start method re-runs ``__main__`` in each worker; when
    the parent was fed from a pipe/stdin (``__file__`` points nowhere) that
    re-run crashes, so fall back to serial execution in that case."""
    import sys

    main_file = getattr(sys.modules.get("__main__"), "__file__", None)
    return main_file is None or os.path.exists(main_file)


def characterize_suite(
    circuits: Mapping[str, Aig],
    recipes: Sequence[tuple[str, ...]] | None = None,
    cache: "CharacterizationCache | str | os.PathLike | None" = None,
    n_jobs: int | None = None,
    backend: str = "auto",
    policy: "PoolPolicy | None" = None,
    failures: "dict[str, CharacterizationError] | None" = None,
    device=None,
) -> dict[str, dict[tuple[str, ...], AigStats]]:
    """Front half of Algorithm I (lines 3-6) over a whole benchmark suite.

    For every circuit, creates and characterizes the recipe AIGs (baseline
    ``()`` included) and returns ``{circuit: {recipe: AigStats}}`` — the
    input `core.batch.SuiteTable.from_cha` stacks for the batched sweep.

    Three cost-reduction layers over naive per-recipe runs:

      * the shared-prefix DAG with structural dedup (`RecipeRunner`);
      * a persistent on-disk cache (``cache``: a `CharacterizationCache`
        or a directory path) keyed by (circuit fingerprint, recipe,
        `TRANSFORM_VERSION`) — warm lookups skip the transforms entirely;
      * a process pool (``n_jobs`` workers, default
        ``min(4, cpu_count)``, env override ``REPRO_CHA_JOBS``; ``1``
        disables) driven by an *as-completed futures scheduler*: a
        transform application is submitted the moment its parent's
        fingerprint is known, so independent prefix branches and
        circuits overlap freely and a deep chain (the sine-dominated
        tail) no longer waits for the rest of its DAG level.

    The pool uses the ``spawn`` start method: characterization is pure
    numpy/python, but the parent may hold a CUDA context and torch
    threads, and forking such a process is unsafe.

    ``backend`` selects the transform implementation (`resolve_backend`):
    ``device`` batches the truth-table inner loops through
    `kernels.aig_sim` on ``device`` (default ``cuda``, raising without a
    card; ``"cpu"`` runs the plain torch versions) — bit-identical
    outputs, so cache entries are shared across backends and with the
    reference package.  The default ``auto`` is ``device``.
    Cache-backed runs also persist every *application* as it completes
    (`CharacterizationCache.store_application`), so a run that dies
    mid-suite warm-starts from the applications it already did.

    ``policy`` sets the pool's fault posture (`PoolPolicy`: per-task
    deadlines, bounded retry with deterministic backoff + jitter, pool
    rebuild on worker loss).  ``failures``: pass a dict to opt into
    *quarantine* mode — a circuit whose characterization fails
    permanently is dropped from the returned mapping and recorded there
    as ``{name: CharacterizationError}`` instead of aborting the whole
    suite; with the default ``None`` the first permanent failure raises.
    """
    recipes = [
        tuple(r) for r in (recipes if recipes is not None else enumerate_recipes())
    ]
    wanted = list(dict.fromkeys([()] + recipes))
    cache = _as_cache(cache)
    backend = resolve_backend(backend)
    device = str(resolve_device(device))
    failed: dict[str, CharacterizationError] = {}

    out: dict[str, dict[tuple[str, ...], AigStats]] = {}
    runners: dict[str, RecipeRunner] = {}
    fps: dict[str, str] = {}
    for name, rtl in circuits.items():
        try:
            faults.inject("cha.backend", detail=f"{backend}:{name}")
            fps[name] = rtl.fingerprint()
            cached = cache.load(fps[name]) if cache is not None else {}
            if cached and all(r in cached for r in wanted):
                if cache is not None:
                    cache.hits += 1
                out[name] = {r: cached[r] for r in wanted}
                continue
            if cache is not None:
                cache.misses += 1
            runner = RecipeRunner(rtl, backend=backend, device=device)
            if cache is not None:
                # Partial warm start: replay persisted applications into the
                # structural memo, then persist every fresh one incrementally.
                for (src_fp, t), (out_fp, st) in cache.load_applications(
                    fps[name]
                ).items():
                    out_aig = cache.load_aig(out_fp)
                    if out_aig is not None:
                        runner.preload_application(src_fp, t, out_aig, st)
                runner.on_apply = partial(
                    _persist_application, cache, fps[name], runner
                )
            runners[name] = runner
        except KernelError:
            raise  # a kernel fault is never quarantined
        except Exception as e:  # noqa: BLE001 — quarantine, don't abort
            err = CharacterizationError(name, f"{type(e).__name__}: {e}")
            if failures is None:
                raise err from e
            failed[name] = err

    if runners:
        _run_suite_dag(runners, wanted, n_jobs, backend, policy=policy,
                       failed=failed if failures is not None else None,
                       device=device)
        for name, runner in runners.items():
            if name in failed:
                continue
            try:
                cha = {r: runner.stats(r) for r in wanted}
            except KernelError:
                raise
            except Exception as e:  # noqa: BLE001
                err = CharacterizationError(name, f"{type(e).__name__}: {e}")
                if failures is None:
                    raise err from e
                failed[name] = err
                continue
            out[name] = cha
            if cache is not None:
                cache.store(fps[name], cha)

    if failed:
        if failures is None:
            raise next(iter(failed.values()))
        failures.update(failed)
    # Preserve the caller's circuit order; quarantined circuits are absent.
    return {name: out[name] for name in circuits if name in out}


def _persist_application(
    cache: CharacterizationCache,
    circuit_fp: str,
    runner: RecipeRunner,
    src_fp: str,
    transform: str,
    out_fp: str,
    out: Aig,
    stats: AigStats | None,
) -> None:
    """`RecipeRunner.on_apply` hook: persist the application immediately.

    Characterizes the output if the pool didn't already, seeding the
    runner's stats memo so `RecipeRunner.stats` never repeats the work.
    """
    if stats is None:
        stats = runner._stats.get(out_fp)
        if stats is None:
            stats = out.characterize()
        runner._stats.setdefault(out_fp, stats)
    cache.store_application(circuit_fp, src_fp, transform, out, stats)


def _run_suite_dag(
    runners: Mapping[str, RecipeRunner],
    wanted: Sequence[tuple[str, ...]],
    n_jobs: int | None,
    backend: str = "python",
    policy: "PoolPolicy | None" = None,
    failed: "dict[str, CharacterizationError] | None" = None,
    device: "str | None" = None,
) -> None:
    """Evaluate every prefix node of ``wanted`` in all runners on an
    as-completed futures scheduler.

    A transform application is dispatched to the process pool the moment
    its parent prefix's fingerprint is known — there is no level barrier,
    so while one worker grinds through a deep chain (sine's recipes
    dominate the cold front half) the others drain every independent
    branch and circuit instead of idling at the end of each DAG depth.
    Structural dedup is preserved: distinct nodes that resolve to the
    same (circuit, input fingerprint, transform) application share one
    in-flight future, and applications a runner already knows resolve
    instantly and cascade into their children.

    Fault posture (``policy``, default `PoolPolicy`):

      * a task raising in the worker is retried up to ``max_retries``
        times with deterministic exponential backoff + jitter;
      * a task exceeding ``task_deadline_s`` forces a **pool rebuild**
        (running `ProcessPoolExecutor` tasks cannot be cancelled, so the
        stuck workers are terminated) and counts as a failed attempt;
      * `BrokenProcessPool` — a worker died (OOM-kill, hard crash) —
        also rebuilds the pool; every other in-flight task is
        re-dispatched at its current attempt count, the task whose
        future broke is charged one attempt;
      * a task out of attempts poisons its *circuit*: with ``failed``
        provided the circuit is quarantined there
        (`CharacterizationError`) and the rest of the suite proceeds;
        otherwise the error raises.
    """
    nodes = prefix_nodes(wanted)
    if not nodes:
        return
    policy = policy or PoolPolicy()
    n_jobs = _resolve_jobs(n_jobs, backend)
    if n_jobs == 1:
        # Serial: the memoized DAG walk itself (depth order from
        # prefix_nodes guarantees parents resolve first).  Quarantine is
        # per circuit here too — one poisoned netlist cannot sink the
        # suite when the caller opted in.
        for name, runner in runners.items():
            try:
                for node in nodes:
                    runner.run_fp(node)
            except KernelError:
                raise  # a kernel fault is never quarantined
            except Exception as e:  # noqa: BLE001
                err = CharacterizationError(name, f"{type(e).__name__}: {e}")
                if failed is None:
                    raise err from e
                failed[name] = err
        return

    import multiprocessing as mp
    from concurrent.futures import FIRST_COMPLETED, ProcessPoolExecutor, wait
    from concurrent.futures.process import BrokenProcessPool

    # DAG edges: parent prefix -> the nodes it unblocks.  prefix_nodes
    # includes every non-empty prefix, so each node's parent is () or
    # another node and the roots are exactly children[()].
    children: dict[tuple[str, ...], list[tuple[str, ...]]] = {}
    for node in nodes:
        children.setdefault(node[:-1], []).append(node)

    # (circuit, src_fp, transform) -> nodes whose resolution awaits the
    # in-flight application's result.
    waiting: dict[tuple[str, str, str], list[tuple[str, ...]]] = {}

    def advance(name, runner, node, tasks):
        """Node's parent fp is known: resolve through the memo, or queue
        the one application it is blocked on; cascades into children of
        instantly-resolved nodes."""
        src_fp = runner.run_fp(node[:-1])
        t = node[-1]
        if runner.has_applied(src_fp, t):
            runner.run_fp(node)
            for child in children.get(node, []):
                advance(name, runner, child, tasks)
            return
        key = (name, src_fp, t)
        if key in waiting:
            waiting[key].append(node)
            return
        waiting[key] = [node]
        tasks.append((name, src_fp, t, runner.aig_for(src_fp), backend, device))

    def task_key(task) -> str:
        return f"{task[0]}:{task[1]}:{task[2]}"

    dead: set[str] = set()

    def quarantine(name: str, reason: str) -> None:
        err = CharacterizationError(name, reason)
        if failed is None:
            raise err
        failed[name] = err
        dead.add(name)
        # Nothing waiting on a dead circuit resolves; drop its
        # bookkeeping so the scheduler can drain.
        for key in [k for k in waiting if k[0] == name]:
            del waiting[key]

    ex = ProcessPoolExecutor(
        max_workers=n_jobs, mp_context=mp.get_context("spawn")
    )
    # fut -> (task, attempt, dispatch wall time)
    inflight: dict = {}
    # min-heap of (ready_at, seq, task, attempt) retry reservations — the
    # scheduler sleeps in `wait` timeouts instead of blocking on backoff.
    retries: list = []
    seq = 0

    def submit(task, attempt):
        inflight[ex.submit(_characterize_task, task)] = (
            task, attempt, time.monotonic(),
        )

    def schedule_retry(task, attempt, reason):
        nonlocal seq
        if attempt > policy.max_retries:
            quarantine(task[0], f"task {task[2]} failed permanently: {reason}")
            return
        ready = time.monotonic() + policy.backoff(task_key(task), attempt - 1)
        heapq.heappush(retries, (ready, seq, task, attempt))
        seq += 1

    def rebuild_pool():
        """Terminate every worker and start a fresh pool; the caller
        re-dispatches whatever was in flight."""
        nonlocal ex
        for p in list(getattr(ex, "_processes", {}).values()):
            try:
                p.terminate()
            except OSError:
                pass
        ex.shutdown(wait=False, cancel_futures=True)
        ex = ProcessPoolExecutor(
            max_workers=n_jobs, mp_context=mp.get_context("spawn")
        )

    def redispatch_inflight(charge: dict) -> None:
        """Move every in-flight task onto the fresh pool.  ``charge``
        maps a task key to the failure reason for tasks that burned an
        attempt (broken future, expired deadline); the rest resubmit at
        their current attempt count."""
        moved = list(inflight.values())
        inflight.clear()
        for task, attempt, _ in moved:
            if task[0] in dead:
                continue
            reason = charge.get(task_key(task))
            if reason is not None:
                schedule_retry(task, attempt + 1, reason)
            else:
                submit(task, attempt)

    try:
        tasks: list[tuple] = []
        for name, runner in runners.items():
            for node in children.get((), []):
                advance(name, runner, node, tasks)
        for t in tasks:
            submit(t, 0)
        while inflight or retries:
            now = time.monotonic()
            # Launch due retries; the earliest pending one bounds the wait.
            while retries and retries[0][0] <= now:
                _, _, task, attempt = heapq.heappop(retries)
                if task[0] not in dead:
                    submit(task, attempt)
            timeout = None
            if retries:
                timeout = max(0.0, retries[0][0] - now)
            if policy.task_deadline_s is not None and inflight:
                oldest = min(t0 for _, _, t0 in inflight.values())
                expiry = oldest + policy.task_deadline_s - now
                timeout = expiry if timeout is None else min(timeout, expiry)
            if not inflight:
                if timeout:
                    time.sleep(timeout)
                continue
            done, _ = wait(
                inflight, timeout=timeout, return_when=FIRST_COMPLETED
            )
            tasks = []
            broken: list[tuple] = []
            for fut in done:
                task, attempt, _ = inflight.pop(fut)
                try:
                    name, src_fp, t, aig, stats = fut.result()
                except BrokenProcessPool as e:
                    broken.append((task, attempt, f"worker died: {e}"))
                    continue
                except KernelError:
                    raise  # a kernel fault is never retried or quarantined
                except Exception as e:  # noqa: BLE001 — task raised in worker
                    schedule_retry(
                        task, attempt + 1, f"{type(e).__name__}: {e}"
                    )
                    continue
                if name in dead:
                    continue
                runner = runners[name]
                runner.record(src_fp, t, aig, stats)
                for node in waiting.pop((name, src_fp, t), []):
                    runner.run_fp(node)
                    for child in children.get(node, []):
                        advance(name, runner, child, tasks)
            if broken:
                rebuild_pool()
                redispatch_inflight({})
                for task, attempt, reason in broken:
                    if task[0] not in dead:
                        schedule_retry(task, attempt + 1, reason)
            elif policy.task_deadline_s is not None:
                now = time.monotonic()
                expired = {
                    task_key(task): f"deadline {policy.task_deadline_s}s "
                    f"exceeded"
                    for task, _, t0 in inflight.values()
                    if now - t0 > policy.task_deadline_s
                }
                if expired:
                    rebuild_pool()
                    redispatch_inflight(expired)
            for t in tasks:
                if t[0] not in dead:
                    submit(t, 0)
    finally:
        for p in list(getattr(ex, "_processes", {}).values()):
            try:
                p.terminate()
            except OSError:
                pass
        ex.shutdown(wait=False, cancel_futures=True)
