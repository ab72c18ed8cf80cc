"""EPFL-like combinational benchmark circuit generators.

The paper evaluates Algorithm I on the EPFL combinational benchmark suite
(Amaru et al., IWLS'15).  The EPFL netlists are not redistributable here, so
we generate gate-accurate circuits of the same nine families used in the
paper's Table I / Fig 9:

    adder-128, barrel-shifter, multiplier, sine, max, divisor,
    square-root, square, log2

Arithmetic circuits (adder / shifter / multiplier / max / divisor / sqrt /
square) are exact constructions with verified semantics (tests check them
against Python integer arithmetic).  ``sine`` is a fixed-point CORDIC
construction and ``log2`` a priority-encoder + polynomial-fraction
construction — same circuit *family* and comparable gate/level structure as
the EPFL versions (documented deviation; the exploration tool is agnostic to
the exact netlist).

Default bit-widths are scaled down from the EPFL sizes so the 64-recipe sweep
runs in CPU-minutes (the paper used server-class runs); ``scale="paper"``
restores full sizes.  Gate-count ORDER matches the paper (multiplier/divisor/
log2 largest; adder/shifter smallest).
"""

from __future__ import annotations

from typing import Callable, Sequence

from .aig import CONST0, CONST1, Aig, lit_not

Word = list[int]  # literals, LSB first


# ---------------------------------------------------------------------------
# Word-level builder helpers
# ---------------------------------------------------------------------------


def new_inputs(aig: Aig, n: int) -> Word:
    return [aig.add_pi() for _ in range(n)]


def full_adder(aig: Aig, a: int, b: int, c: int) -> tuple[int, int]:
    s = aig.g_xor(aig.g_xor(a, b), c)
    co = aig.g_maj(a, b, c)
    return s, co


def ripple_add(aig: Aig, a: Word, b: Word, cin: int = CONST0) -> tuple[Word, int]:
    assert len(a) == len(b)
    out: Word = []
    c = cin
    for x, y in zip(a, b):
        s, c = full_adder(aig, x, y, c)
        out.append(s)
    return out, c


def ripple_sub(aig: Aig, a: Word, b: Word) -> tuple[Word, int]:
    """a - b; returns (diff, no_borrow) where no_borrow=1 iff a >= b."""
    nb = [lit_not(x) for x in b]
    diff, c = ripple_add(aig, a, nb, CONST1)
    return diff, c


def brent_kung_add(aig: Aig, a: Word, b: Word, cin: int = CONST0) -> tuple[Word, int]:
    """Parallel-prefix (Brent-Kung) adder: depth O(log n), wide levels.

    This matches the level structure of the paper's benchmarks (Table I
    reports few, *wide* levels — e.g. adder-128 with ~350 ops/level),
    unlike a ripple adder whose AIG is deep and narrow.
    """
    n = len(a)
    assert len(b) == n
    g = [aig.g_and(x, y) for x, y in zip(a, b)]
    p = [aig.g_xor(x, y) for x, y in zip(a, b)]
    if cin != CONST0:
        g[0] = aig.g_or(g[0], aig.g_and(p[0], cin))
    # Up-sweep.
    gg = list(g)
    pp = list(p)
    span = 1
    while span < n:
        for i in range(2 * span - 1, n, 2 * span):
            j = i - span
            gg[i] = aig.g_or(gg[i], aig.g_and(pp[i], gg[j]))
            pp[i] = aig.g_and(pp[i], pp[j])
        span *= 2
    # Down-sweep.
    span //= 2
    while span >= 1:
        for i in range(3 * span - 1, n, 2 * span):
            j = i - span
            gg[i] = aig.g_or(gg[i], aig.g_and(pp[i], gg[j]))
        span //= 2
    # Sum bits: s_i = p_i ^ carry_{i-1}; carry_{i-1} = gg[i-1] (prefix G).
    s: Word = [p[0] if cin == CONST0 else aig.g_xor(p[0], cin)]
    for i in range(1, n):
        s.append(aig.g_xor(p[i], gg[i - 1]))
    return s, gg[n - 1]


def bk_sub(aig: Aig, a: Word, b: Word) -> tuple[Word, int]:
    """Parallel-prefix a - b; returns (diff, no_borrow)."""
    nb = [lit_not(x) for x in b]
    return brent_kung_add(aig, a, nb, CONST1)


def csa_reduce(aig: Aig, rows: list[Word], width: int) -> tuple[Word, Word]:
    """Wallace/CSA 3:2 reduction of addend rows down to two (wide levels)."""
    rows = [list(r[:width]) + [CONST0] * (width - len(r)) for r in rows]
    while len(rows) > 2:
        nxt: list[Word] = []
        i = 0
        while i + 2 < len(rows):
            x, y, z = rows[i], rows[i + 1], rows[i + 2]
            s_row: Word = []
            c_row: Word = [CONST0]
            for k in range(width):
                s, c = full_adder(aig, x[k], y[k], z[k])
                s_row.append(s)
                if k + 1 < width:
                    c_row.append(c)
            nxt.append(s_row)
            nxt.append(c_row[:width])
            i += 3
        nxt.extend(rows[i:])
        rows = nxt
    return rows[0], rows[1]


def mux_word(aig: Aig, sel: int, t: Word, f: Word) -> Word:
    assert len(t) == len(f)
    return [aig.g_mux(sel, x, y) for x, y in zip(t, f)]


def shift_left_const(w: Word, k: int) -> Word:
    n = len(w)
    return ([CONST0] * k + w)[:n]


def shift_right_const(w: Word, k: int, fill: int = CONST0) -> Word:
    n = len(w)
    return (w[k:] + [fill] * k)[:n]


def greater_equal(aig: Aig, a: Word, b: Word) -> int:
    _, ge = bk_sub(aig, a, b)
    return ge


def const_word(value: int, n: int) -> Word:
    return [CONST1 if (value >> i) & 1 else CONST0 for i in range(n)]


# ---------------------------------------------------------------------------
# Circuit generators
# ---------------------------------------------------------------------------


def gen_adder(n: int = 128) -> Aig:
    """Parallel-prefix (Brent-Kung) adder — few wide levels, like the
    paper's adder-128 (Table I: 4 levels, ~1400 gates)."""
    aig = Aig(name=f"adder-{n}")
    a = new_inputs(aig, n)
    b = new_inputs(aig, n)
    s, c = brent_kung_add(aig, a, b)
    for x in s:
        aig.add_po(x)
    aig.add_po(c)
    return aig.clone()


def gen_barrel_shifter(n: int = 64) -> Aig:
    """Logical right barrel shifter, log2(n) mux stages."""
    import math

    k = int(math.log2(n))
    assert (1 << k) == n
    aig = Aig(name=f"bar-{n}")
    data = new_inputs(aig, n)
    shamt = new_inputs(aig, k)
    w = data
    for i in range(k):
        shifted = shift_right_const(w, 1 << i)
        w = mux_word(aig, shamt[i], shifted, w)
    for x in w:
        aig.add_po(x)
    return aig.clone()


def gen_multiplier(n: int = 16) -> Aig:
    """n x n Wallace-tree multiplier (CSA reduction + prefix final add)."""
    aig = Aig(name=f"mult-{n}")
    a = new_inputs(aig, n)
    b = new_inputs(aig, n)
    rows: list[Word] = []
    for i in range(n):
        pp = [aig.g_and(a[j], b[i]) for j in range(n)]
        rows.append([CONST0] * i + pp)
    s, c = csa_reduce(aig, rows, 2 * n)
    out, _ = brent_kung_add(aig, s, c)
    for x in out:
        aig.add_po(x)
    return aig.clone()


def gen_square(n: int = 24) -> Aig:
    """Squarer: Wallace tree over shared partial products."""
    aig = Aig(name=f"square-{n}")
    a = new_inputs(aig, n)
    rows: list[Word] = []
    for i in range(n):
        pp = [aig.g_and(a[j], a[i]) for j in range(n)]
        rows.append([CONST0] * i + pp)
    s, c = csa_reduce(aig, rows, 2 * n)
    out, _ = brent_kung_add(aig, s, c)
    for x in out:
        aig.add_po(x)
    return aig.clone()


def gen_max(n: int = 32, k: int = 4) -> Aig:
    """Max of k unsigned n-bit words (tournament of compare+mux)."""
    aig = Aig(name=f"max-{k}x{n}")
    words = [new_inputs(aig, n) for _ in range(k)]
    cur = words[0]
    for w in words[1:]:
        ge = greater_equal(aig, cur, w)
        cur = mux_word(aig, ge, cur, w)
    for x in cur:
        aig.add_po(x)
    return aig.clone()


def gen_divisor(n: int = 16) -> Aig:
    """Restoring divider: n-bit dividend / n-bit divisor → quotient, rem."""
    aig = Aig(name=f"div-{n}")
    num = new_inputs(aig, n)
    den = new_inputs(aig, n)
    rem: Word = const_word(0, n)
    quo: Word = [CONST0] * n
    for i in range(n - 1, -1, -1):
        # rem = (rem << 1) | num[i]
        rem = [num[i]] + rem[: n - 1]
        diff, ge = bk_sub(aig, rem, den)
        rem = mux_word(aig, ge, diff, rem)
        quo[i] = ge
    for x in quo:
        aig.add_po(x)
    for x in rem:
        aig.add_po(x)
    return aig.clone()


def gen_sqrt(n: int = 32) -> Aig:
    """Restoring square root: n-bit radicand → n/2-bit root."""
    assert n % 2 == 0
    aig = Aig(name=f"sqrt-{n}")
    x = new_inputs(aig, n)
    h = n // 2
    rem: Word = const_word(0, h + 2)
    root: Word = [CONST0] * h
    for i in range(h - 1, -1, -1):
        # bring down two bits of x
        two = [x[2 * i], x[2 * i + 1]]
        rem = two + rem[: h]
        # trial = (root << 2) | 01
        trial: Word = [CONST1, CONST0] + root[: h]
        diff, ge = bk_sub(aig, rem, trial)
        rem = mux_word(aig, ge, diff, rem)
        root = [ge] + root[: h - 1]
    for r in root:
        aig.add_po(r)
    return aig.clone()


def gen_sine(n: int = 12, iters: int | None = None) -> Aig:
    """Fixed-point sine via CORDIC (rotation mode).

    Input: n-bit angle in [0, pi/2) as fraction of pi/2.  Output: n-bit
    sin value.  Built purely from adders/subtractors/shifts/muxes — the
    same adder-dominated structure as the EPFL ``sin`` netlist.
    """
    import math

    iters = iters or n - 2
    w = n + 2  # internal width (guard bits)
    aig = Aig(name=f"sine-{n}")
    theta = new_inputs(aig, n)

    # angle accumulator in units of (pi/2)/2^n, widened
    z: Word = theta[:] + [CONST0] * (w - n)
    # x = K (CORDIC gain compensated), y = 0
    K = 0.6072529350088813
    x: Word = const_word(int(K * (1 << n)), w)
    y: Word = const_word(0, w)
    for i in range(iters):
        ang = math.atan(2.0**-i) / (math.pi / 2) * (1 << n)
        ang_w = const_word(int(round(ang)), w)
        d = lit_not(z[w - 1])  # rotate +1 if z >= 0 (sign bit clear)
        xs = shift_right_const(x, i, fill=x[w - 1])
        ys = shift_right_const(y, i, fill=y[w - 1])
        x_plus, _ = ripple_sub(aig, x, ys)
        x_minus, _ = ripple_add(aig, x, ys)
        y_plus, _ = ripple_add(aig, y, xs)
        y_minus, _ = ripple_sub(aig, y, xs)
        z_plus, _ = ripple_sub(aig, z, ang_w)
        z_minus, _ = ripple_add(aig, z, ang_w)
        x = mux_word(aig, d, x_plus, x_minus)
        y = mux_word(aig, d, y_plus, y_minus)
        z = mux_word(aig, d, z_plus, z_minus)
    for i in range(n):
        aig.add_po(y[i])
    return aig.clone()


def gen_log2(n: int = 32, frac_bits: int = 8) -> Aig:
    """log2: integer part via priority encoder + normalized-mantissa
    polynomial fraction (log2(1+m) ≈ m - m^2/2 + m^3/4 truncated)."""
    import math

    aig = Aig(name=f"log2-{n}")
    x = new_inputs(aig, n)
    k = max(1, int(math.ceil(math.log2(n))))

    # Leading-one position (priority encoder, MSB first).
    pos: Word = [CONST0] * k
    found = CONST0
    for i in range(n - 1, -1, -1):
        here = aig.g_and(x[i], lit_not(found))
        for b in range(k):
            if (i >> b) & 1:
                pos[b] = aig.g_or(pos[b], here)
        found = aig.g_or(found, x[i])

    # Normalize: barrel-shift left by (n-1-pos) == shift right by pos then ...
    # Simpler: barrel shift right by pos, giving mantissa bits below leading 1.
    w = x
    for b in range(k):
        shifted = shift_right_const(w, 1 << b)
        w = mux_word(aig, pos[b], shifted, w)
    # w now has leading one at bit 0; mantissa m = next frac_bits bits... they
    # are ABOVE bit0 only if we shifted fully; take bits [1..frac_bits].
    # Recompute: after shifting right by pos, leading 1 sits at bit 0 and the
    # fraction is lost.  Instead shift LEFT by (n-1-pos): do via mux on ~pos.
    w = x
    for b in range(k):
        shifted = shift_left_const(w, 1 << b)
        w = mux_word(aig, lit_not(pos[b]), shifted, w)
    # Now leading one is at bit n-1 (when x != 0); mantissa = bits below it.
    m: Word = [w[n - 1 - frac_bits + i] for i in range(frac_bits)]  # top frac bits

    # fraction ≈ m - m^2/2 (+ m^2 terms keep the circuit mult-flavored)
    rows: list[Word] = []
    for i in range(frac_bits):
        pp = [aig.g_and(m[j], m[i]) for j in range(frac_bits)]
        rows.append([CONST0] * i + pp)
    s_r, c_r = csa_reduce(aig, rows, 2 * frac_bits)
    sq, _ = brent_kung_add(aig, s_r, c_r)
    half_sq = shift_right_const(sq[frac_bits:], 1)  # m^2/2, top bits
    frac, _ = bk_sub(aig, m, half_sq[:frac_bits])

    for b in pos:
        aig.add_po(b)
    for f in frac:
        aig.add_po(f)
    return aig.clone()


# ---------------------------------------------------------------------------
# Suite assembly
# ---------------------------------------------------------------------------

_GENERATORS: dict[str, Callable[..., Aig]] = {
    "adder": gen_adder,
    "bar": gen_barrel_shifter,
    "mult": gen_multiplier,
    "sine": gen_sine,
    "max": gen_max,
    "div": gen_divisor,
    "sqrt": gen_sqrt,
    "square": gen_square,
    "log2": gen_log2,
}

# (kwargs_default, kwargs_paper) per circuit; paper sizes mirror EPFL.
_SIZES: dict[str, tuple[dict, dict]] = {
    "adder": (dict(n=128), dict(n=128)),
    "bar": (dict(n=64), dict(n=128)),
    "mult": (dict(n=16), dict(n=64)),
    "sine": (dict(n=12), dict(n=24)),
    "max": (dict(n=32, k=4), dict(n=128, k=4)),
    "div": (dict(n=16), dict(n=64)),
    "sqrt": (dict(n=32), dict(n=128)),
    "square": (dict(n=24), dict(n=64)),
    "log2": (dict(n=32), dict(n=32)),
}


def benchmark_suite(scale: str = "default", only: Sequence[str] | None = None) -> dict[str, Aig]:
    """The 9-circuit suite.  scale: "default" (CPU-friendly), "paper", "tiny"."""
    out: dict[str, Aig] = {}
    names = list(_GENERATORS) if only is None else list(only)
    for name in names:
        gen = _GENERATORS[name]
        kw_def, kw_paper = _SIZES[name]
        if scale == "paper":
            kw = kw_paper
        elif scale == "tiny":
            kw = {k: (max(4, v // 4) if isinstance(v, int) else v) for k, v in kw_def.items()}
            if name == "bar":
                kw = dict(n=16)
            if name == "sqrt":
                kw = dict(n=8)
            if name == "max":
                kw = dict(n=8, k=4)
            if name == "sine":
                kw = dict(n=8)  # below 8 bits CORDIC folds to constants
            if name == "log2":
                kw = dict(n=16, frac_bits=4)
        else:
            kw = kw_def
        out[name] = gen(**kw)
    return out
