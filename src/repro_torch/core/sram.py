"""rCiM SRAM topology library + calibrated analytical energy/latency model.

The paper (§III-D, Alg. I lines 11-12) derives power/latency/energy "through
an analytical estimation approach combined with initial simulation data"
(post-layout Cadence characterization of each macro).  We cannot re-run
Spectre, so the per-op / per-cycle constants below are *calibrated against
the paper's published numbers*:

  * 65 fJ / NAND2, 116 fJ / NOR2 (Table II, §IV-D)
  * 1 GHz global clock, TSMC 28 nm, 1.66 um^2 / 10T bitcell
  * 8 KB single macro: 88.2-106.6 GOPS, 8.64-10.45 TOPS/W
  * Fig 9 / Table I relative trends (see tests/test_explorer.py)

Two accounting modes:

  * ``paper``   — reproduces the paper's own Table I arithmetic.  Reverse-
    engineering Table I shows its power column is almost exactly
    ``P[mW] = 1.157 mW x level_count`` for every benchmark/topology pair
    (adder L=4 -> 4.62 mW ... square L=21 -> 24.3 mW), with
    ``E = P x latency``.  This mode exists to replicate the paper's tables.
  * ``physical`` — a self-consistent decomposition
        E = T x P_ctrl + (active macro-cycles) x (k_macro + k_col x cols)
              + sum_ops E_op(type)
    with constants fitted to the paper's headline ratios.  NOTE (documented
    deviation): the paper's §IV-B six-macro claims are internally
    inconsistent (it states both "clock cycles remain the same as
    three-macro" and "47% lower latency than three-macro"); under the
    physical model six-macro energy lands between -40%..+6% of three-macro
    rather than the paper's +15%.  All other headline trends reproduce.

Geometry: one bank is 128x128 (2 KB) as in the paper ("a 2KB SRAM bank with
128x128 SRAM bit cells can perform 64 logical operations in a single
computational cycle").  Macro sizes follow Table II ((256x256)=8KB,
(512x256)=16KB):

    4 KB  = 256 rows x 128 cols      16 KB = 512 rows x 256 cols
    8 KB  = 256 rows x 256 cols      32 KB = 512 rows x 512 cols

``ops_per_cycle = cols / 2`` (one sense amplifier per column pair).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Topology library — 12 entries: {4, 8, 16, 32} KB x {1, 3, 6} macros
# ---------------------------------------------------------------------------

# (rows, cols) per macro size.  A macro is a grid of 128x128 (2 KB) banks
# organized WIDE (more columns -> more sense amplifiers -> more parallel
# ops), which is the only organization consistent with the paper's own
# numbers: Table II's (512x256)x3 = 16 KB macro delivers 2x the GOPS of
# (256x256)x3 = 8 KB (so the 512 counts columns), and Fig 9(b)'s latency
# drops on macro doubling require column count to grow with size.
_GEOMETRY = {
    4: (256, 128),
    8: (256, 256),
    16: (256, 512),
    32: (256, 1024),
}

MACRO_SIZES_KB = (4, 8, 16, 32)
MACRO_COUNTS = (1, 3, 6)

OP_TYPES = ("nand", "nor", "inv")


@dataclasses.dataclass(frozen=True)
class SramTopology:
    """One rCiM design point: ``n_macros`` macros of ``macro_kb`` KB each.

    Library entries derive (rows, cols) from ``macro_kb`` via the paper's
    geometry table; ``geometry=(rows, cols)`` overrides it for programmatic
    design points outside the table (see `topology_grid` /
    `from_geometry`).  Macro counts must be 1 (time-multiplexed op types)
    or a multiple of 3 (op types on dedicated macro groups) — see
    `mapping.macros_per_type`.
    """

    macro_kb: int
    n_macros: int
    geometry: tuple[int, int] | None = None

    @classmethod
    def from_geometry(
        cls, rows: int, cols: int, n_macros: int
    ) -> "SramTopology":
        """Topology from an explicit (rows, cols) macro geometry.

        The macro must hold a whole number of KB (rows*cols % 8192 == 0) so
        capacity bookkeeping stays exact.
        """
        bits = rows * cols
        if bits <= 0 or bits % 8192:
            raise ValueError(
                f"macro geometry {rows}x{cols} is not a whole number of KB"
            )
        return cls(bits // 8192, n_macros, geometry=(rows, cols))

    @property
    def rows(self) -> int:
        if self.geometry is not None:
            return self.geometry[0]
        return _GEOMETRY[self.macro_kb][0]

    @property
    def cols(self) -> int:
        if self.geometry is not None:
            return self.geometry[1]
        return _GEOMETRY[self.macro_kb][1]

    @property
    def total_kb(self) -> int:
        return self.macro_kb * self.n_macros

    @property
    def total_bits(self) -> int:
        return self.total_kb * 1024 * 8

    @property
    def ops_per_cycle_per_macro(self) -> int:
        return self.cols // 2

    @property
    def name(self) -> str:
        if self.geometry is not None:
            return f"({self.rows}x{self.cols})x{self.n_macros}"
        return f"({self.macro_kb}KB)x{self.n_macros}"

    @property
    def n_banks_per_macro(self) -> int:
        return max(1, self.macro_kb // 2)

    def area_mm2(self, model: "EnergyModel") -> float:
        return area_mm2_arrays(
            self.total_bits, model.bitcell_um2, model.periphery_overhead
        )


TOPOLOGY_LIBRARY: tuple[SramTopology, ...] = tuple(
    SramTopology(kb, m) for kb in MACRO_SIZES_KB for m in MACRO_COUNTS
)


def topology_grid(
    rows: Sequence[int] = (128, 256, 512),
    cols: Sequence[int] = (128, 256, 512, 1024),
    macro_counts: Sequence[int] = MACRO_COUNTS,
) -> tuple[SramTopology, ...]:
    """Programmatic (rows x cols x macros) topology space — the open design
    grid beyond the paper's 12-entry library.

    Every combination whose macro is a whole number of KB and whose macro
    count the mapping model supports (1 or a multiple of 3) becomes a
    design point; the batched engine sweeps the whole grid in one device
    call (``evaluate_batch`` / ``evaluate_suite``), so grid size is cheap.
    Deduplicates against geometry collisions and keeps the given order
    (rows-major, then cols, then macro count).
    """
    out: list[SramTopology] = []
    seen: set[tuple[int, int, int]] = set()
    for r in rows:
        for c in cols:
            if (r * c) % 8192:
                continue
            for m in macro_counts:
                if m != 1 and m % 3:
                    continue
                key = (r, c, m)
                if key in seen:
                    continue
                seen.add(key)
                out.append(SramTopology.from_geometry(r, c, m))
    if not out:
        raise ValueError("topology grid is empty")
    return tuple(out)


# ---------------------------------------------------------------------------
# Energy / latency model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    """Calibrated constants (TSMC 28 nm, 1 V, 1 GHz — paper §IV-A)."""

    f_clk_hz: float = 1e9
    # Per-op all-in energies (compute + resonant writeback), Table II.
    e_op_fj: tuple[float, float, float] = (65.0, 116.0, 65.0)  # nand, nor, inv
    # Marginal per-op energies used in the physical-mode TOTAL energy
    # decomposition.  NOTE: the paper's Table I totals are inconsistent with
    # its own 65 fJ/op figure (e.g. multiplier worst case: 35.6k gates x
    # 65 fJ = 2.3 nJ > the reported 0.90 nJ total), so total-energy
    # accounting cannot charge the standalone per-op energy per gate.  We
    # charge a calibrated post-recycling marginal energy instead; the
    # standalone figures above are still used for Table II-style per-op
    # metrics.
    e_op_marginal_fj: tuple[float, float, float] = (5.0, 9.0, 5.0)
    # Resonant write driver: fraction of writeback energy recycled (refs
    # [51][52]; exposed so the tool can report non-resonant baselines).
    writeback_fj_nonresonant: float = 80.0
    resonance_recycle_eta: float = 0.65
    # Physical-mode per-cycle terms (fit: see tests/test_explorer.py).
    p_ctrl_mw: float = 3.6          # design-constant control/clock power
    e_macro_cycle_fj: float = 90.0  # per active macro per cycle (decode/WL)
    e_col_cycle_fj: float = 0.45    # per column per active macro-cycle (PRE)
    # Paper-mode constant: P = alpha * levels  (reverse-engineered Table I).
    alpha_mw_per_level: float = 1.157
    # Area model
    bitcell_um2: float = 1.66
    periphery_overhead: float = 0.30
    # Throughput derating (writeback/pipeline bubbles) to match Table II GOPS.
    pipeline_utilization: float = 0.80

    def resonant_saving_fj(self) -> float:
        """Energy recycled per written bit vs a conventional driver."""
        return self.writeback_fj_nonresonant * self.resonance_recycle_eta


def area_mm2_arrays(total_bits, bitcell_um2, periphery_overhead):
    """Area model, array-agnostic (scalars, (T,) arrays, or (V, T) grids).

    `SramTopology.area_mm2` and the batched `TopologyTable.area_mm2` both
    call this, so the scalar and vectorized paths are the same float ops.
    """
    cell = total_bits * bitcell_um2 * 1e-6  # mm^2
    return cell * (1.0 + periphery_overhead)


# ---------------------------------------------------------------------------
# Model variation: stacked EnergyModel variants (the yield/variation axis)
# ---------------------------------------------------------------------------

# EnergyModel fields whose variation shifts the reported figures:
# everything the evaluate kernels, the area model, and the Table II
# arithmetic read.  The clock is included: corner silicon runs at a
# different achievable f_clk.  (writeback_fj_nonresonant /
# resonance_recycle_eta feed no metric path yet, so sweeping them would
# only emit inert variants that skew the yield fractions.)
SWEEPABLE_FIELDS = (
    "f_clk_hz",
    "e_op_fj",
    "e_op_marginal_fj",
    "p_ctrl_mw",
    "e_macro_cycle_fj",
    "e_col_cycle_fj",
    "alpha_mw_per_level",
    "bitcell_um2",
    "periphery_overhead",
    "pipeline_utilization",
)

# Fields scaled together by the process-corner generator: the switched
# (CV^2-like) energy/power constants.  Geometry/utilization constants are
# corner-independent.
_CORNER_ENERGY_FIELDS = (
    "e_op_fj",
    "e_op_marginal_fj",
    "writeback_fj_nonresonant",
    "p_ctrl_mw",
    "e_macro_cycle_fj",
    "e_col_cycle_fj",
    "alpha_mw_per_level",
)


def _scale_field(model: "EnergyModel", field: str, factor: float):
    v = getattr(model, field)
    if isinstance(v, tuple):
        return tuple(x * factor for x in v)
    return v * factor


_PER_OP_FIELDS = ("e_op_fj", "e_op_marginal_fj")


@dataclasses.dataclass(frozen=True, eq=False)
class ModelTable:
    """A stack of `EnergyModel` variants, one row per variant — the
    dynamic model axis of the batched engine.

    Every `EnergyModel` float field becomes a float64 array with a
    leading variant axis: ``(V,)`` for scalars, ``(V, 3)`` for the per-op
    tuples.  Fields may additionally carry a **per-topology axis** for
    *correlated* (topology-dependent) variation — ``(V, T)`` for scalars
    and ``(V, T, 3)`` for the per-op tuples (e.g. per-macro-geometry NOR
    discharge energy), as in `bitcell_sigma_per_macro`'s per-macro-
    geometry mismatch: the batched kernels broadcast such fields along
    the grid's topology axis, so variant ``v`` applies a different
    constant to each topology.  A ``(V, 1)`` / ``(V, 1, 3)`` field
    broadcasts uniformly and is bit-identical to the same values as a
    ``(V,)`` / ``(V, 3)`` field.

    The batched kernels (`batch.evaluate_batch` /
    `batch.evaluate_suite`) take these arrays as fp64 tensors with a
    leading variant axis, so one pass sweeps every variant — which is
    what makes corner / sensitivity / Monte-Carlo studies (the paper's
    yield FoM) cheap.

    Convention: **row 0 is the nominal model** — the generators below all
    put it first, and the yield summaries in `explorer` measure variants
    against it.
    """

    names: tuple[str, ...]
    f_clk_hz: np.ndarray                  # (V,) or (V, T)
    e_op_fj: np.ndarray                   # (V, 3) or (V, T, 3)
    e_op_marginal_fj: np.ndarray          # (V, 3) or (V, T, 3)
    writeback_fj_nonresonant: np.ndarray  # (V,) or (V, T)
    resonance_recycle_eta: np.ndarray     # (V,) or (V, T)
    p_ctrl_mw: np.ndarray                 # (V,) or (V, T)
    e_macro_cycle_fj: np.ndarray          # (V,) or (V, T)
    e_col_cycle_fj: np.ndarray            # (V,) or (V, T)
    alpha_mw_per_level: np.ndarray        # (V,) or (V, T)
    bitcell_um2: np.ndarray               # (V,) or (V, T)
    periphery_overhead: np.ndarray        # (V,) or (V, T)
    pipeline_utilization: np.ndarray      # (V,) or (V, T)
    # Identity of the per-topology columns (SramTopology.name per column,
    # set by the correlated generators): the batched paths refuse to
    # sweep such a table against a *different* topology list of the same
    # length, where each column's variation would silently land on the
    # wrong macro geometry.  None for uniform / hand-built tables.
    topology_names: "tuple[str, ...] | None" = None

    def __post_init__(self):
        v = len(self.names)
        if v == 0:
            raise ValueError("empty ModelTable")
        t = None
        for f in dataclasses.fields(EnergyModel):
            arr = getattr(self, f.name)
            if arr.shape[0] != v:
                raise ValueError(
                    f"field {f.name} has {arr.shape[0]} rows, expected {v}"
                )
            if f.name in _PER_OP_FIELDS:
                if arr.ndim not in (2, 3) or arr.shape[-1] != len(OP_TYPES):
                    raise ValueError(
                        f"per-op field {f.name} must be (V, {len(OP_TYPES)})"
                        f" or (V, T, {len(OP_TYPES)}), got {arr.shape}"
                    )
                if arr.ndim == 3 and arr.shape[1] > 1:
                    width = arr.shape[1]
                    if t is not None and width != t:
                        raise ValueError(
                            f"field {f.name} has per-topology width {width},"
                            f" but another field has {t}"
                        )
                    t = width
            elif arr.ndim == 2:
                width = arr.shape[1]
                if width > 1:
                    if t is not None and width != t:
                        raise ValueError(
                            f"field {f.name} has per-topology width {width},"
                            f" but another field has {t}"
                        )
                    t = width
            elif arr.ndim != 1:
                raise ValueError(
                    f"field {f.name} must be (V,) or (V, T), got {arr.shape}"
                )
        if (
            self.topology_names is not None
            and t is not None
            and len(self.topology_names) != t
        ):
            raise ValueError(
                f"topology_names has {len(self.topology_names)} entries "
                f"but the per-topology fields have width {t}"
            )

    @property
    def n_topologies(self) -> "int | None":
        """Width of the per-topology axis when any field carries one with
        T > 1 — ``(V, T)`` scalars or ``(V, T, 3)`` per-op tuples;
        ``None`` for uniform tables (including ``(V, 1)`` / ``(V, 1, 3)``
        broadcast fields)."""
        t = None
        for f in dataclasses.fields(EnergyModel):
            arr = getattr(self, f.name)
            per_op = f.name in _PER_OP_FIELDS
            if per_op and arr.ndim == 3 and arr.shape[1] > 1:
                t = arr.shape[1]
            elif not per_op and arr.ndim == 2 and arr.shape[1] > 1:
                t = arr.shape[1]
        return t

    def content_key(self) -> str:
        """Content hash over every field's bytes + shape, plus the name
        tuples — stable across processes (unlike ``id``/pickling), so it
        keys the service's grid cache and the sweep journal's config
        fingerprint: two tables with the same key produce bit-identical
        sweep results."""
        h = hashlib.sha1()
        for f in dataclasses.fields(EnergyModel):
            arr = np.ascontiguousarray(getattr(self, f.name))
            h.update(f.name.encode())
            h.update(str(arr.shape).encode())
            h.update(arr.tobytes())
        h.update(repr(self.names).encode())
        h.update(repr(self.topology_names).encode())
        return h.hexdigest()[:16]

    @classmethod
    def from_models(
        cls,
        models: "Sequence[EnergyModel]",
        names: Sequence[str] | None = None,
    ) -> "ModelTable":
        """Stack explicit `EnergyModel` variants (nominal first)."""
        models = list(models)
        if not models:
            raise ValueError("empty model list")
        if names is None:
            names = tuple(f"v{i}" for i in range(len(models)))
        arrays = {
            f.name: np.asarray(
                [getattr(m, f.name) for m in models], dtype=np.float64
            )
            for f in dataclasses.fields(EnergyModel)
        }
        return cls(names=tuple(names), **arrays)

    @classmethod
    def corners(
        cls, base: "EnergyModel | None" = None, spread: float = 0.10
    ) -> "ModelTable":
        """TT/FF/SS-style process corners: the switched energy/power
        constants scale by ``1 -+ spread`` while the achievable clock
        scales the opposite way (fast silicon: less energy per op, higher
        f_clk).  Row 0 is the typical (nominal) model."""
        # `is None`, not falsiness: a ModelTable passed by mistake defines
        # __len__, and an otherwise-falsy base must error loudly, not be
        # silently swapped for the nominal model.
        if base is None:
            base = EnergyModel()

        def corner(k_energy: float, k_clk: float) -> EnergyModel:
            kw = {f: _scale_field(base, f, k_energy)
                  for f in _CORNER_ENERGY_FIELDS}
            kw["f_clk_hz"] = base.f_clk_hz * k_clk
            return dataclasses.replace(base, **kw)

        return cls.from_models(
            [base, corner(1.0 - spread, 1.0 + spread),
             corner(1.0 + spread, 1.0 - spread)],
            names=("tt", "ff", "ss"),
        )

    @classmethod
    def sensitivity(
        cls,
        base: "EnergyModel | None" = None,
        fields: Sequence[str] | None = None,
        rel: float = 0.05,
    ) -> "ModelTable":
        """One-at-a-time ±``rel`` perturbation grid: the nominal model
        plus, for each swept field, a +rel and a -rel variant."""
        if base is None:
            base = EnergyModel()
        fields = tuple(fields) if fields is not None else SWEEPABLE_FIELDS
        unknown = [f for f in fields if f not in SWEEPABLE_FIELDS]
        if unknown:
            raise ValueError(f"not sweepable: {unknown}")
        models, names = [base], ["nominal"]
        for f in fields:
            for sign in (+1.0, -1.0):
                factor = 1.0 + sign * rel
                models.append(
                    dataclasses.replace(base, **{f: _scale_field(base, f, factor)})
                )
                names.append(f"{f}{'+' if sign > 0 else '-'}{rel:g}")
        return cls.from_models(models, names=names)

    @classmethod
    def monte_carlo(
        cls,
        base: "EnergyModel | None" = None,
        n: int = 16,
        sigma: float = 0.05,
        seed: int = 0,
        fields: Sequence[str] | None = None,
    ) -> "ModelTable":
        """``n`` seeded Monte-Carlo samples (row 0 is the nominal model,
        rows 1..n-1 scale each swept field by an independent
        ``N(1, sigma)`` factor, floored at 0.05 to keep the model in its
        physical regime; ``pipeline_utilization`` is additionally capped
        at 1.0 — more than one op per cycle slot is unphysical)."""
        if n < 1:
            raise ValueError("n must be >= 1")
        if base is None:
            base = EnergyModel()
        fields = tuple(fields) if fields is not None else SWEEPABLE_FIELDS
        unknown = [f for f in fields if f not in SWEEPABLE_FIELDS]
        if unknown:
            raise ValueError(f"not sweepable: {unknown}")
        rng = np.random.default_rng(seed)
        models, names = [base], ["nominal"]
        for i in range(1, n):
            kw = {}
            for f in fields:
                v = getattr(base, f)
                if isinstance(v, tuple):
                    factors = np.maximum(rng.normal(1.0, sigma, len(v)), 0.05)
                    kw[f] = tuple(float(x * k) for x, k in zip(v, factors))
                else:
                    kw[f] = v * float(
                        max(rng.normal(1.0, sigma), 0.05)
                    )
                    if f == "pipeline_utilization":
                        kw[f] = min(kw[f], 1.0)
            models.append(dataclasses.replace(base, **kw))
            names.append(f"mc{i}")
        return cls.from_models(models, names=names)

    @classmethod
    def bitcell_sigma_per_macro(
        cls,
        topologies: "Sequence[SramTopology]",
        base: "EnergyModel | None" = None,
        n: int = 16,
        sigma: float = 0.05,
        seed: int = 0,
        fields: Sequence[str] = (
            "bitcell_um2", "e_macro_cycle_fj", "e_col_cycle_fj"
        ),
        ref_cells: int = 128 * 128,
    ) -> "ModelTable":
        """Correlated (topology-dependent) Monte-Carlo: per-macro-geometry
        mismatch keyed on each topology's rows x cols.

        Local (bitcell-level) variation averages out over a macro
        Pelgrom-style, so the per-macro sigma shrinks with array size:
        ``sigma_t = sigma * sqrt(ref_cells / (rows_t * cols_t))`` with
        ``ref_cells`` the paper's 128x128 bank.  Each swept scalar field
        becomes a ``(V, T)`` array and each swept per-op field (e.g.
        ``e_op_fj`` — per-geometry NAND/NOR/INV discharge energy) a
        ``(V, T, 3)`` array — variant ``v`` scales topology ``t`` (and,
        for per-op fields, each op type independently) by an independent
        ``N(1, sigma_t)`` factor (floored at 0.05;
        ``pipeline_utilization`` capped at 1.0) — which the batched
        kernels broadcast along the grid's topology axis.  Row 0 is the
        nominal model.  ``topologies`` accepts a `SramTopology` sequence
        or a `batch.TopologyTable` and must match the topology table the
        sweep is evaluated against.
        """
        if n < 1:
            raise ValueError("n must be >= 1")
        if base is None:
            base = EnergyModel()
        topos = tuple(getattr(topologies, "topologies", topologies))
        if not topos:
            raise ValueError("empty topology list")
        fields = tuple(fields)
        bad = [f for f in fields if f not in SWEEPABLE_FIELDS]
        if bad:
            raise ValueError(f"not sweepable per topology: {bad}")
        cells = np.array([t.rows * t.cols for t in topos], dtype=np.float64)
        sigma_t = sigma * np.sqrt(ref_cells / cells)           # (T,)
        rng = np.random.default_rng(seed)
        names = ("nominal",) + tuple(f"corr{i}" for i in range(1, n))
        table = cls.from_models([base] * n, names=names)
        kw = {}
        n_t = len(topos)
        for f in fields:
            if f in _PER_OP_FIELDS:
                factors = np.ones((n, n_t, len(OP_TYPES)), dtype=np.float64)
                if n > 1:
                    factors[1:] = np.maximum(
                        rng.normal(
                            1.0, sigma_t[None, :, None],
                            (n - 1, n_t, len(OP_TYPES)),
                        ),
                        0.05,
                    )
                vals = np.asarray(getattr(base, f))[None, None, :] * factors
            else:
                factors = np.ones((n, n_t), dtype=np.float64)
                if n > 1:
                    factors[1:] = np.maximum(
                        rng.normal(1.0, sigma_t[None, :], (n - 1, n_t)),
                        0.05,
                    )
                vals = getattr(base, f) * factors
                if f == "pipeline_utilization":
                    vals = np.minimum(vals, 1.0)
            kw[f] = vals
        return dataclasses.replace(
            table, topology_names=tuple(t.name for t in topos), **kw
        )

    def uniform_row(self, i: int) -> bool:
        """True when variant ``i`` applies the same constants to every
        topology (always true for 1-D / ``(V, 1)`` fields), i.e. when
        ``model(i)`` can materialize it as a single `EnergyModel`."""
        for f in dataclasses.fields(EnergyModel):
            v = getattr(self, f.name)[i]
            if f.name in _PER_OP_FIELDS:
                # (T, 3): uniform iff every topology row is identical
                if v.ndim == 2 and not np.all(v == v[:1]):
                    return False
            elif np.ndim(v) and not np.all(v == v.flat[0]):
                return False
        return True

    def model(self, i: int, topology: "int | None" = None) -> "EnergyModel":
        """Row ``i`` re-materialized as a plain `EnergyModel` (exact:
        float64 -> python float round-trips bit-for-bit).

        For correlated tables, ``topology`` selects the column of each
        ``(V, T)`` field; without it, a row whose per-topology values
        differ has no single-`EnergyModel` representation and raises.
        """
        kw = {}
        for f in dataclasses.fields(EnergyModel):
            v = getattr(self, f.name)[i]
            if f.name in _PER_OP_FIELDS:
                if v.ndim == 2:  # (T, 3) per-topology row
                    if topology is not None:
                        v = v[topology if v.shape[0] > 1 else 0]
                    elif np.all(v == v[:1]):
                        v = v[0]
                    else:
                        raise ValueError(
                            f"variant {i} ({self.names[i]!r}) is topology-"
                            f"dependent in field {f.name}; pass topology= "
                            f"to materialize one column"
                        )
                kw[f.name] = tuple(float(x) for x in v)
            elif np.ndim(v):  # (T,) per-topology row
                if topology is not None:
                    kw[f.name] = float(v[topology if v.shape[0] > 1 else 0])
                elif np.all(v == v.flat[0]):
                    kw[f.name] = float(v.flat[0])
                else:
                    raise ValueError(
                        f"variant {i} ({self.names[i]!r}) is topology-"
                        f"dependent in field {f.name}; pass topology= to "
                        f"materialize one column"
                    )
            else:
                kw[f.name] = float(v)
        return EnergyModel(**kw)

    def models(self) -> "list[EnergyModel]":
        return [self.model(i) for i in range(len(self))]

    def __len__(self) -> int:
        return len(self.names)


@dataclasses.dataclass
class Metrics:
    power_mw: float
    latency_ns: float
    energy_nj: float
    cycles: int
    throughput_gops: float
    tops_per_watt: float
    gops_per_mm2: float
    area_mm2: float

    def as_row(self) -> dict:
        return dataclasses.asdict(self)


# --- mode arithmetic, shared with the batched engine (core/batch.py) -------
#
# These helpers are written against plain arithmetic operators so they accept
# python floats, numpy arrays, and torch tensors alike.  ``evaluate`` (scalar)
# and ``evaluate_batch`` (grid) call the *same* expressions, so the two paths
# agree to floating-point round-off by construction.


def paper_power_mw(n_levels, model: EnergyModel):
    """Paper-mode power: P = alpha x level count (reverse-engineered Table I)."""
    return model.alpha_mw_per_level * n_levels


def paper_energy_nj(power_mw, latency_ns):
    return power_mw * latency_ns * 1e-3  # mW * ns = pJ; /1e3 -> nJ


def physical_energy_nj(latency_ns, active_macro_cycles, e_ops_fj, cols,
                       model: EnergyModel):
    """Physical-mode decomposition: control + active-macro + per-op terms."""
    e_ctrl_fj = model.p_ctrl_mw * 1e-3 * (latency_ns * 1e-9) * 1e15
    e_macro_fj = active_macro_cycles * (
        model.e_macro_cycle_fj + model.e_col_cycle_fj * cols
    )
    return (e_ctrl_fj + e_macro_fj + e_ops_fj) * 1e-6


def evaluate(
    schedule: "MappingResult",
    topo: SramTopology,
    model: EnergyModel | None = None,
    mode: str = "physical",
) -> Metrics:
    """Power/latency/energy for a scheduled workload on a topology.

    ``schedule`` comes from mapping.schedule_netlist (cycles + op counts).
    """
    from .mapping import MappingResult  # circular-import guard

    assert isinstance(schedule, MappingResult)
    if model is None:
        model = EnergyModel()
    cycles = schedule.total_cycles
    t_ns = cycles / model.f_clk_hz * 1e9
    n_ops = schedule.op_counts
    e_ops_fj = sum(n_ops[t] * e for t, e in zip(OP_TYPES, model.e_op_marginal_fj))

    if mode == "paper":
        p_mw = paper_power_mw(schedule.n_levels, model)
        e_nj = paper_energy_nj(p_mw, t_ns)
    elif mode == "physical":
        e_nj = physical_energy_nj(
            t_ns, schedule.active_macro_cycles, e_ops_fj, topo.cols, model
        )
        p_mw = e_nj / t_ns * 1e3 if t_ns > 0 else 0.0
    else:
        raise ValueError(f"unknown mode {mode!r}")

    total_ops = sum(n_ops.values())
    thr_gops = (
        total_ops / (t_ns * 1e-9) / 1e9 * model.pipeline_utilization
        if t_ns > 0
        else 0.0
    )
    area = topo.area_mm2(model)
    tops_w = (thr_gops / 1e3) / (p_mw * 1e-3) if p_mw > 0 else 0.0
    return Metrics(
        power_mw=p_mw,
        latency_ns=t_ns,
        energy_nj=e_nj,
        cycles=cycles,
        throughput_gops=thr_gops,
        tops_per_watt=tops_w,
        gops_per_mm2=thr_gops / area if area > 0 else 0.0,
        area_mm2=area,
    )


def table2_arrays(ops_per_cycle, area_mm2, model: EnergyModel,
                  nor_fraction: float = 0.5) -> dict:
    """Table II arithmetic over total sense-amp width + area.

    Array-agnostic like the mode helpers above: ``table2_metrics`` feeds
    it scalars, ``batch.table2_batch`` feeds it (T,) arrays — one set of
    expressions, no drift between the scalar and batched paths.
    """
    # NOR discharge (350 ps) utilizes the 1 ns cycle worse than NAND (150 ps)
    util = model.pipeline_utilization * (1.0 - 0.14 * nor_fraction)
    gops = ops_per_cycle * model.f_clk_hz / 1e9 * util
    e_mix_fj = (1 - nor_fraction) * model.e_op_fj[0] + nor_fraction * model.e_op_fj[1]
    p_mw = gops * e_mix_fj * 1e-3 + model.p_ctrl_mw * 0.4
    return dict(
        throughput_gops=gops,
        power_mw=p_mw,
        tops_per_watt=(gops / 1e3) / (p_mw * 1e-3),
        gops_per_mm2=gops / area_mm2,
        area_mm2=area_mm2,
    )


def table2_metrics(
    topo: SramTopology,
    model: EnergyModel | None = None,
    nor_fraction: float = 0.5,
) -> dict:
    """Table II-style standalone metrics (throughput, TOPS/W, GOPS/mm^2).

    Uses the *standalone* per-op energies (65/116 fJ) plus a control-power
    share — this is the accounting that reproduces the paper's published
    8 KB single-macro range (88.2-106.6 GOPS, 8.64-10.45 TOPS/W,
    551-666 GOPS/mm^2); the NAND/NOR mix sets where in the range we land.
    """
    if model is None:
        model = EnergyModel()
    w = topo.ops_per_cycle_per_macro * topo.n_macros
    return table2_arrays(w, topo.area_mm2(model), model, nor_fraction)


def peak_throughput_gops(topo: SramTopology, model: EnergyModel | None = None) -> float:
    if model is None:
        model = EnergyModel()
    return (
        topo.ops_per_cycle_per_macro
        * topo.n_macros
        * model.f_clk_hz
        / 1e9
        * model.pipeline_utilization
    )


def inductor_size_nh(
    topo: SramTopology,
    model: EnergyModel | None = None,
    c_bl_per_cell_ff: float = 0.08,
    f_res_hz: float | None = None,
) -> float:
    """Resonant inductor sizing (Alg. I line 15).

    Series LC: L = 1 / ((2 pi f_res)^2 * C_total).  One inductor is shared
    by all write drivers of a macro ("utilizing a shared inductor ... the
    bitline capacitance increases N times for N write drivers"), so
    C_total = cols x rows x C_cell.
    """
    if model is None:
        model = EnergyModel()
    f_res = f_res_hz or model.f_clk_hz
    c_total_f = topo.cols * topo.rows * c_bl_per_cell_ff * 1e-15
    l_h = 1.0 / ((2 * math.pi * f_res) ** 2 * c_total_f)
    return l_h * 1e9
