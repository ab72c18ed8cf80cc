"""Algorithm I — mapping combinational logic workloads to the optimal
resonant cache architecture.

Faithful implementation of the paper's Algorithm I / Fig. 8 flow:

    1.  CreateAIG(RTL, AIGsyn_opt)          -> 64 recipe AIGs (prefix-cached)
    2.  ChaAIG(aig) per AIG                 -> levels + per-level op counts
    3.  IdentifyOptOpeAIG                   -> min total gate count
    4.  IdentifyOptLogAIG                   -> min level count
    5.  IdentifySRAM                        -> capacity-feasible topologies
    6.  Evaluate(aig, sram) for both AIGs   -> power/latency/energy metrics
    7.  FilterEnergy                        -> min-energy (AIG, topology)
    8.  CalculateInductor                   -> resonant L for chosen topology

The "RTL netlist" input is an `Aig` (our circuits.py generators play the
role of YOSYS elaboration).  ``explore`` additionally returns every
(recipe x topology) evaluation so the Fig 9 / Table I benchmarks can sweep
all 64 x 12 = 768 implementations per circuit (6912 over the 9-circuit
suite, matching the paper's 6900+ claim).

Two backends drive the back half (ChaAIG -> Evaluate -> FilterEnergy):

  * ``backend="python"`` — the original per-pair scalar loop over
    `mapping.schedule_stats` + `sram.evaluate`; kept as the parity
    reference.  The sweep lands in ``ExplorationResult.evaluations``.
  * ``backend="torch"``  — the tensorized engine (`core/batch.py`, the
    default): the full recipe x topology grid is scheduled, evaluated,
    and filtered in one fp64 tensor pass on ``device``.  The sweep lands
    in ``ExplorationResult.grid``
    and ``best`` is re-materialized through the scalar model for an
    exactly-comparable `Evaluation`.

Suite-level entry point: `explore_suite` runs Algorithm I over a whole
benchmark suite at once — the front half through
`transforms.characterize_suite` (shared-prefix DAG, on-disk cache,
process pool) and the back half through one `batch.evaluate_select_suite`
call over circuits x recipes x topologies.

Every entry point takes ``device=`` (default ``"cuda"``, raising without
a card); ``device="cpu"`` runs the plain torch versions on the host.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Mapping, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .aig import Aig, AigStats
from .batch import (
    ExplorationGrid,
    SelectionResult,
    SuiteTable,
    TopologyTable,
    VariationGrid,
    WorkloadTable,
    evaluate_batch,
    evaluate_select_batch,
    evaluate_select_suite,
    evaluate_suite,
    winner_summary,
)
from .mapping import BITS_PER_GATE, MappingResult, schedule_stats
from .sram import (
    TOPOLOGY_LIBRARY,
    EnergyModel,
    Metrics,
    ModelTable,
    SramTopology,
    evaluate,
    inductor_size_nh,
)
from .transforms import (
    CharacterizationCache,
    enumerate_recipes,
    characterize_suite,
)


@dataclasses.dataclass
class Evaluation:
    recipe: tuple[str, ...]
    topo: SramTopology
    stats: AigStats
    schedule: MappingResult
    metrics: Metrics


#: Quantiles reported by `VariationResult.energy_quantiles` — median plus
#: the quartiles and the 5%/95% tails of the per-variant winner energy.
ENERGY_QUANTILES = (0.05, 0.25, 0.5, 0.75, 0.95)


@dataclasses.dataclass
class VariationResult:
    """Yield-style summary of a model-variant sweep for one circuit.

    Variant 0 of ``models`` is the nominal model (the `ModelTable`
    generators' convention); the yield figures measure how robust the
    nominal pick is across the other variants — the paper's fourth FoM.
    For large-N Monte-Carlo sweeps the winner shares alone hide the
    distribution tails, so the per-variant winner energy is summarized
    as quantiles (``energy_quantiles``) and as conditional
    value-at-risk (`cvar`).
    """

    models: ModelTable
    grid: VariationGrid              # the (V, T, R) sweep itself
    winners: list[tuple[tuple[str, ...], SramTopology]]  # per variant
    winner_share: dict[str, float]   # "topo/recipe" -> fraction of variants won
    best_yield: float    # fraction of variants where the nominal winner stays best
    latency_yield: float  # fraction where the nominal winner fits + meets
    #                       the latency constraint under that variant's clock
    winner_energy_nj: np.ndarray     # (V,) each variant's winning energy
    energy_quantiles: dict[float, float]  # ENERGY_QUANTILES of the above

    @property
    def n_variants(self) -> int:
        return len(self.models)

    def cvar(self, alpha: float = 0.9) -> float:
        """Conditional value-at-risk (expected shortfall) of the
        per-variant winner energy: the mean over the worst
        (highest-energy) ``1 - alpha`` tail of variants.  ``cvar(0.9)``
        answers "when silicon lands in the bad 10% of the model
        distribution, what energy do we expect?" — a tail figure winner
        shares cannot express."""
        if not 0.0 <= alpha < 1.0:
            raise ValueError(f"alpha must be in [0, 1), got {alpha}")
        e = np.sort(self.winner_energy_nj)
        k = max(1, int(np.ceil((1.0 - alpha) * e.size)))
        return float(e[-k:].mean())


@dataclasses.dataclass
class ExplorationResult:
    """Output of Algorithm I (+ the full sweep for the benchmarks)."""

    circuit: str
    best: Evaluation                 # min-energy feasible implementation
    inductor_nh: float
    opt_gate_recipe: tuple[str, ...]  # IdentifyOptOpeAIG
    opt_level_recipe: tuple[str, ...]  # IdentifyOptLogAIG
    evaluations: list[Evaluation]    # scalar sweep (backend="python")
    n_recipes: int
    wall_s: float
    backend: str = "python"
    grid: ExplorationGrid | None = None  # batched sweep (backend="torch")
    cha: dict[tuple[str, ...], AigStats] | None = None
    variation: VariationResult | None = None  # model_sweep summary

    @property
    def n_evaluations(self) -> int:
        return self.grid.size if self.grid is not None else len(self.evaluations)

    def sweep_energies(self, fits_only: bool = True) -> np.ndarray:
        """Energy of every swept implementation, from whichever sweep
        representation this result carries."""
        if self.grid is not None:
            return (
                self.grid.fit_energies()
                if fits_only
                else self.grid.energy_nj.ravel()
            )
        pool = [
            e.metrics.energy_nj
            for e in self.evaluations
            if e.schedule.fits or not fits_only
        ]
        return np.asarray(pool)

    def table_row(self) -> dict:
        m = self.best.metrics
        s = self.best.stats
        return dict(
            benchmark=self.circuit,
            sram_macro_kb=self.best.topo.macro_kb,
            macro_count=self.best.topo.n_macros,
            recipe=",".join(self.best.recipe) or "(none)",
            levels=s.n_levels,
            nand=s.nand_count,
            nor=s.nor_count,
            inv=s.inv_count,
            power_mw=round(m.power_mw, 3),
            latency_ns=round(m.latency_ns, 3),
            energy_nj=round(m.energy_nj, 6),
            inductor_nh=round(self.inductor_nh, 3),
        )


def characterize_recipes(
    rtl: Aig,
    recipes: Sequence[tuple[str, ...]] | None = None,
    cache: "CharacterizationCache | str | os.PathLike | None" = None,
    n_jobs: int | None = 1,
    cha_backend: str = "auto",
    device: "str | torch.device | None" = None,
) -> dict[tuple[str, ...], AigStats]:
    """Alg. I lines 3-6: create + characterize every recipe AIG, including
    the un-transformed baseline recipe ``()`` first.

    Thin single-circuit wrapper over `transforms.characterize_suite`:
    ``cache`` (a `CharacterizationCache` or a directory path) makes the
    result persistent across runs, ``n_jobs`` > 1 characterizes
    independent prefix branches on a process pool (default serial — one
    circuit rarely amortizes worker startup).  ``cha_backend`` picks the
    transform engine: ``"device"`` (batched `kernels.aig_sim` truth
    tables on ``device``), ``"python"`` (the bigint parity reference), or
    ``"auto"`` (device).
    """
    return characterize_suite(
        {rtl.name: rtl},
        recipes,
        cache=cache,
        n_jobs=n_jobs,
        backend=cha_backend,
        device=device,
    )[rtl.name]


def _materialize(
    recipe: tuple[str, ...],
    topo: SramTopology,
    stats: AigStats,
    model: EnergyModel,
    mode: str,
    discipline: str,
) -> Evaluation:
    """Scalar-path Evaluation for one grid cell (used to surface the argmin
    of a batched sweep as a full dataclass, bit-identical to the python
    backend's pick)."""
    sched = schedule_stats(stats, topo, discipline=discipline)
    met = evaluate(sched, topo, model, mode=mode)
    return Evaluation(recipe, topo, stats, sched, met)


def _restrict_cha(
    cha: Mapping[tuple[str, ...], AigStats],
    recipes: Sequence[tuple[str, ...]] | None,
) -> dict[tuple[str, ...], AigStats]:
    """Validate a characterization map and honor a recipes restriction."""
    cha = dict(cha)
    if recipes is not None:
        wanted = list(dict.fromkeys([()] + [tuple(r) for r in recipes]))
        missing = [r for r in wanted if r not in cha]
        if missing:
            raise ValueError(f"cha is missing requested recipes {missing}")
        cha = {r: cha[r] for r in wanted}
    if () not in cha:
        raise ValueError("cha must include the baseline recipe ()")
    return cha


def _opt_and_feasible(
    cha: Mapping[tuple[str, ...], AigStats],
    sram_list: Sequence[SramTopology],
) -> tuple[tuple[str, ...], tuple[str, ...], list[SramTopology]]:
    """Alg. I lines 7-9: optimal-ops / optimal-levels recipes and the
    capacity-feasible topology subset for those candidates."""
    opt_gate = min(cha, key=lambda r: (cha[r].total_gates, cha[r].n_levels))
    opt_level = min(cha, key=lambda r: (cha[r].n_levels, cha[r].total_gates))
    min_gates = min(cha[opt_gate].total_gates, cha[opt_level].total_gates)
    feasible = [
        t for t in sram_list if t.total_bits >= BITS_PER_GATE * min_gates
    ]
    if not feasible:
        feasible = [max(sram_list, key=lambda t: t.total_bits)]
    return opt_gate, opt_level, feasible


def explore(
    rtl: Aig,
    sram_list: Sequence[SramTopology] = TOPOLOGY_LIBRARY,
    recipes: Sequence[tuple[str, ...]] | None = None,
    model: EnergyModel | None = None,
    mode: str = "physical",
    full_sweep: bool = True,
    max_latency_ns: float | None = None,
    backend: str = "torch",
    discipline: str = "list",
    cha: Mapping[tuple[str, ...], AigStats] | None = None,
    cache: "CharacterizationCache | str | os.PathLike | None" = None,
    n_jobs: int | None = 1,
    fused: bool = True,
    cha_backend: str = "auto",
    device: "str | torch.device | None" = None,
) -> ExplorationResult:
    """Algorithm I for one circuit.

    Args:
        rtl: the input AIG (circuits.py generators play YOSYS elaboration).
        sram_list: candidate topologies — the paper's 12-entry
            `TOPOLOGY_LIBRARY` or a programmatic `sram.topology_grid`.
        recipes: synthesis recipes to sweep (default: all 64 ordered
            permutations; the baseline ``()`` is always included).
        model: `EnergyModel` constants (default: paper-calibrated).
        mode: energy accounting — ``"physical"`` decomposition or the
            paper's Table-I ``"paper"`` arithmetic.
        full_sweep: ``True`` evaluates every recipe x topology (what Fig 9
            reports); ``False`` restricts lines 10-13 to the two optimal
            AIGs exactly as the pseudocode does.
        max_latency_ns: optional latency admissibility bound (ns).
        backend: ``"torch"`` batched grid (`core/batch.py`, default) or
            the ``"python"`` scalar reference loop.
        discipline: cycle schedule — ``"list"`` (ASAP, default) or the
            paper's lock-step ``"levels"``.
        cha: precomputed characterizations (`characterize_recipes` output,
            must include ``()``) so repeated sweeps skip the transforms.
        cache: persistent characterization cache (path or
            `CharacterizationCache`) consulted when ``cha`` is None.
        n_jobs: process-pool width for characterization (1 = serial).
        fused: with ``backend="torch"``, run FilterEnergy on the device
            in the same pass (`batch.evaluate_select_batch`) so only the
            winner crosses the host boundary and the grid stays lazy;
            ``False`` keeps the host-side `select_best` path.
        cha_backend: transform engine for the *front* half —
            ``"device"`` (batched `kernels.aig_sim` truth tables),
            ``"python"`` (bigint parity reference), or ``"auto"``
            (device).  Independent of ``backend``, which picks the
            back-half sweep engine.
        device: where the kernels and tensors run — ``"cuda"`` (default;
            raises without a card) or ``"cpu"`` (plain torch versions).

    Returns:
        `ExplorationResult`: the min-energy admissible implementation
        (``best``, energies in nJ, latencies in ns, cycle counts exact
        ints), the chosen inductor size (nH), and the full sweep
        (``evaluations`` list or batched ``grid``).
    """
    if backend not in ("python", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    dev = resolve_device(device)
    t0 = time.time()
    if model is None:
        model = EnergyModel()

    # Lines 3-6: create + characterize (or reuse the caller's cache).
    if cha is None:
        cha = characterize_recipes(
            rtl, recipes, cache=cache, n_jobs=n_jobs, cha_backend=cha_backend,
            device=dev,
        )
    cha = _restrict_cha(cha, recipes)
    all_recipes = list(cha)

    # Lines 7-9: optimal AIGs + capacity-feasible topologies.
    opt_gate, opt_level, feasible = _opt_and_feasible(cha, sram_list)

    # Lines 10-13 (+ optional full sweep for Fig 9).
    sweep_recipes = all_recipes if full_sweep else [opt_gate, opt_level]
    sweep_topos = list(sram_list) if full_sweep else list(feasible)

    evaluations: list[Evaluation] = []
    grid: ExplorationGrid | None = None
    if backend == "python":
        for topo in sweep_topos:
            for r in sweep_recipes:
                sched = schedule_stats(cha[r], topo, discipline=discipline)
                met = evaluate(sched, topo, model, mode=mode)
                evaluations.append(Evaluation(r, topo, cha[r], sched, met))

        # Line 14: lowest-energy among *feasible* implementations honoring
        # the caller's latency constraint (the tool's stated contract:
        # "tailored to the specified input memory and latency constraints").
        def admissible(e: Evaluation) -> bool:
            if not e.schedule.fits or e.topo not in feasible:
                return False
            if max_latency_ns is not None and e.metrics.latency_ns > max_latency_ns:
                return False
            return True

        pool = [e for e in evaluations if admissible(e)]
        if not pool:
            pool = [e for e in evaluations if e.schedule.fits] or evaluations
        best = min(pool, key=lambda e: e.metrics.energy_nj)
    else:
        work = WorkloadTable.from_stats([(r, cha[r]) for r in sweep_recipes])
        topo_table = TopologyTable.from_topologies(sweep_topos)
        feas = np.array([t in feasible for t in sweep_topos], dtype=bool)
        if fused:
            # Device-resident back half: evaluate + FilterEnergy in one
            # pass; only the winner index leaves the device and the grid
            # materializes lazily if anyone reads it.
            grid, sel = evaluate_select_batch(
                work, topo_table, model, mode=mode, discipline=discipline,
                feasible=feas, max_latency_ns=max_latency_ns, lazy=True,
                device=dev,
            )
            best_flat = int(sel.winner_idx[0])  # V=1: one winner
        else:
            grid = evaluate_batch(
                work, topo_table, model, mode=mode, discipline=discipline,
                feasible=feas, device=dev,
            )
            best_flat = grid.best_index(max_latency_ns)
        # Line 14 on the grid; re-materialize the winner through the scalar
        # model so `best` is exactly the object the python backend returns.
        ti, ri = grid.unravel(best_flat)
        best = _materialize(
            sweep_recipes[ri], sweep_topos[ti], cha[sweep_recipes[ri]],
            model, mode, discipline,
        )

    # Line 15: inductor sizing for the chosen topology.
    l_nh = inductor_size_nh(best.topo, model)

    return ExplorationResult(
        circuit=rtl.name,
        best=best,
        inductor_nh=l_nh,
        opt_gate_recipe=opt_gate,
        opt_level_recipe=opt_level,
        evaluations=evaluations,
        n_recipes=len(all_recipes),
        wall_s=time.time() - t0,
        backend=backend,
        grid=grid,
        cha=cha,
    )


def _variation_result(
    vgrid: VariationGrid,
    max_latency_ns: float | None,
    idx: np.ndarray | None = None,
    winner_energy: np.ndarray | None = None,
    nominal_latency: np.ndarray | None = None,
    nominal_fits: "bool | None" = None,
) -> VariationResult:
    """Per-variant winners + yield summary for one circuit's sweep.

    ``idx``: precomputed ``(V,)`` winner indices.  The fused pipeline
    passes one row of the on-device `SelectionResult` — together with
    its per-winner energies (``winner_energy``) and the nominal-winner
    latencies/fits (``nominal_latency``/``nominal_fits``) the whole
    summary is computed without touching the full (V, T, R) tensors,
    which then stay device-resident.  Callers without a fused result
    (host fallback) omit them and the summary is derived from the grid.
    """
    if idx is None:
        idx = vgrid.best_indices(max_latency_ns)
    pairs = [vgrid.unravel(int(i)) for i in idx]
    winners = [(vgrid.recipes[ri], vgrid.topologies[ti]) for ti, ri in pairs]
    share, best_yield = winner_summary(
        [f"{topo.name}/{','.join(recipe) or '-'}" for recipe, topo in winners]
    )
    # Does the nominal (variant-0) winner stay admissible under each
    # variant?  Capacity is model-free; latency shifts with each
    # variant's achievable clock.
    ti0, ri0 = pairs[0]
    if nominal_fits is None:
        nominal_fits = bool(vgrid.fits[ti0, ri0])
    ok = np.full(len(idx), bool(nominal_fits))
    if max_latency_ns is not None:
        if nominal_latency is None:
            nominal_latency = vgrid.latency_ns[:, ti0, ri0]
        ok &= np.asarray(nominal_latency) <= max_latency_ns
    if winner_energy is None:
        flat = vgrid.energy_nj.reshape(len(idx), -1)
        winner_energy = flat[np.arange(len(idx)), np.asarray(idx)]
    winner_energy = np.asarray(winner_energy, dtype=float)
    quantiles = {
        q: float(np.quantile(winner_energy, q)) for q in ENERGY_QUANTILES
    }
    return VariationResult(
        models=vgrid.models,
        grid=vgrid,
        winners=winners,
        winner_share=share,
        best_yield=best_yield,
        latency_yield=float(np.mean(ok)),
        winner_energy_nj=winner_energy,
        energy_quantiles=quantiles,
    )


def explore_suite(
    circuits: Mapping[str, Aig],
    sram_list: Sequence[SramTopology] = TOPOLOGY_LIBRARY,
    recipes: Sequence[tuple[str, ...]] | None = None,
    model: EnergyModel | None = None,
    mode: str = "physical",
    max_latency_ns: float | None = None,
    backend: str = "torch",
    discipline: str = "list",
    cha: Mapping[str, Mapping[tuple[str, ...], AigStats]] | None = None,
    cache: "CharacterizationCache | str | os.PathLike | None" = None,
    n_jobs: int | None = None,
    model_sweep: ModelTable | None = None,
    fused: bool = True,
    shard: "bool | None" = None,
    cha_backend: str = "auto",
    device: "str | torch.device | None" = None,
) -> dict[str, ExplorationResult]:
    """Algorithm I over a whole benchmark suite in two device-sized steps.

    Front half: one `transforms.characterize_suite` call — the 64-recipe
    prefix DAG per circuit with structural dedup, optional persistent
    ``cache``, and a process pool over independent branches and circuits
    (``n_jobs``, default ``min(4, cpu_count)``).  ``cha_backend`` picks
    its transform engine: ``"device"`` (batched `kernels.aig_sim` truth
    tables on ``device``), ``"python"`` (bigint parity reference), or
    ``"auto"`` (device).

    Back half (``backend="torch"``, the default): the characterizations
    are stacked into a `batch.SuiteTable` and ONE
    `batch.evaluate_select_suite` call sweeps circuits x recipes x
    topologies on ``device``; each circuit's `ExplorationGrid` is then a
    view into the stacked result.  ``backend="python"`` falls back to the
    scalar per-circuit loop (still sharing the suite front half).

    ``model_sweep``: a `sram.ModelTable` of energy-model variants
    (process corners, sensitivity grids, Monte-Carlo samples — variant 0
    is the nominal model).  Correlated (topology-dependent) tables —
    e.g. `ModelTable.bitcell_sigma_per_macro` keyed on ``sram_list``'s
    macro geometries — flow through the same kernels via their
    ``(V, T)`` fields.  The same single device pass then covers
    circuits x variants x topologies x recipes; the selection stage is
    one batched `select_best_batch` pass over every (circuit, variant)
    cell, and every result's ``variation`` field carries the
    per-variant winners and the yield summary (`VariationResult`).  The
    headline ``best``/``grid`` stay the nominal variant's, so downstream
    consumers are unchanged.  Mutually exclusive with ``model``;
    requires ``backend="torch"``.

    ``fused`` (default): the whole back half is device-resident — the
    three-tier FilterEnergy runs inside the same device pass
    (`batch.evaluate_select_suite`), only the (C, V) winner indices +
    per-winner metrics cross the host boundary, and each result's
    ``grid`` is a lazy view whose tensors materialize on first access.
    ``fused=False`` keeps the host-side `select_best_batch` path (the
    parity reference).  ``shard`` is accepted for compatibility; the
    port runs the variant axis on one device (`batch._shard_variants`).

    ``device``: ``"cuda"`` (default; raises without a card) or ``"cpu"``
    (the plain torch versions of the kernels and the back half).

    Returns ``{circuit: ExplorationResult}`` in the input's order; each
    result's ``wall_s`` is the suite wall time divided evenly across
    circuits (the work is genuinely shared).
    """
    if backend not in ("python", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    dev = resolve_device(device)
    if model_sweep is not None:
        if model is not None:
            raise ValueError("pass either model or model_sweep, not both")
        if backend != "torch":
            raise ValueError("model_sweep requires backend='torch'")
        model = model_sweep.model(0)  # nominal, for best materialization
    t0 = time.time()
    if model is None:
        model = EnergyModel()

    if cha is None:
        cha = characterize_suite(
            circuits, recipes, cache=cache, n_jobs=n_jobs, backend=cha_backend,
            device=dev,
        )
    cha = {name: _restrict_cha(cha[name], recipes) for name in circuits}

    if backend == "python":
        out = {
            name: explore(
                rtl, sram_list, recipes, model, mode,
                max_latency_ns=max_latency_ns, backend="python",
                discipline=discipline, cha=cha[name], device=dev,
            )
            for name, rtl in circuits.items()
        }
        wall = (time.time() - t0) / max(1, len(out))
        for res in out.values():
            res.wall_s = wall
        return out

    names = list(circuits)
    opt, feas_mask = {}, np.zeros((len(names), len(sram_list)), dtype=bool)
    sram_list = list(sram_list)
    for i, name in enumerate(names):
        opt_gate, opt_level, feasible = _opt_and_feasible(cha[name], sram_list)
        opt[name] = (opt_gate, opt_level)
        feas_mask[i] = [t in feasible for t in sram_list]

    suite = SuiteTable.from_cha(cha)
    topo_table = TopologyTable.from_topologies(sram_list)
    swept = model_sweep if model_sweep is not None else model
    sel: SelectionResult | None = None
    if fused:
        # Device-resident back half: evaluate + FilterEnergy fused into
        # one pass — only (C, V) winner indices + per-winner metrics are
        # transferred, and the grids below are lazy device views.
        sg, sel = evaluate_select_suite(
            suite, topo_table, swept, mode=mode, discipline=discipline,
            feasible=feas_mask, max_latency_ns=max_latency_ns, lazy=True,
            shard=shard, device=dev,
        )
    else:
        sg = evaluate_suite(
            suite, topo_table, swept,
            mode=mode, discipline=discipline, feasible=feas_mask, device=dev,
        )

    out = {}
    wall = (time.time() - t0) / max(1, len(names))
    if sel is not None:
        suite_winners = sel.winner_idx  # (C, V) — computed on device
    elif model_sweep is not None:
        # Host selection stage for the whole hypercube: every (circuit,
        # variant) winner from ONE batched masked-argmin pass.
        suite_winners = sg.best_indices(max_latency_ns)  # (C, V)
    for i, name in enumerate(names):
        variation = None
        if model_sweep is not None:
            vgrid = sg.variation(name)
            variation = _variation_result(
                vgrid, max_latency_ns, idx=suite_winners[i],
                winner_energy=(
                    None if sel is None else sel.winner_energy_nj[i]
                ),
                nominal_latency=(
                    None if sel is None else sel.nominal_latency_ns[i]
                ),
                nominal_fits=(
                    None if sel is None else bool(sel.nominal_fits[i])
                ),
            )
            grid = vgrid.grid(0)  # nominal variant, the headline result
            # the batched pass already holds variant 0's winner under
            # the same tiers — no per-circuit re-selection needed
            best_flat = int(suite_winners[i, 0])
        elif sel is not None:
            grid = sg.grid(name)
            best_flat = int(sel.winner_idx[i, 0])  # V=1 hypercube
        else:
            grid = sg.grid(name)
            best_flat = grid.best_index(max_latency_ns)
        ti, ri = grid.unravel(best_flat)
        recipe, topo = grid.recipes[ri], sram_list[ti]
        best = _materialize(
            recipe, topo, cha[name][recipe], model, mode, discipline
        )
        out[name] = ExplorationResult(
            circuit=circuits[name].name,
            best=best,
            inductor_nh=inductor_size_nh(topo, model),
            opt_gate_recipe=opt[name][0],
            opt_level_recipe=opt[name][1],
            evaluations=[],
            n_recipes=len(cha[name]),
            wall_s=wall,
            backend=backend,
            grid=grid,
            cha=cha[name],
            variation=variation,
        )
    return out


def explore_request(
    rtl: Aig,
    sram_list: Sequence[SramTopology] = TOPOLOGY_LIBRARY,
    recipes: Sequence[tuple[str, ...]] | None = None,
    *,
    model: EnergyModel | None = None,
    model_sweep: ModelTable | None = None,
    max_memory_kb: float | None = None,
    max_latency_ns: float | None = None,
    mode: str = "physical",
    discipline: str = "list",
    cha: Mapping[tuple[str, ...], AigStats] | None = None,
    cache: "CharacterizationCache | str | os.PathLike | None" = None,
    n_jobs: int | None = 1,
    fused: bool = True,
    shard: "bool | None" = None,
    cha_backend: str = "auto",
    device: "str | torch.device | None" = None,
) -> ExplorationResult:
    """Algorithm I for ONE production-style query: (circuit, memory
    budget, latency bound, variation spec) -> winner.

    This is the request-sized entry point an exploration service answers
    at scale; calling it directly is the offline reference for any
    padded/bucketed fast path.

    ``max_memory_kb`` is a *hard* memory budget: the candidate topology
    list is restricted to designs whose total capacity fits it before
    Algorithm I runs (capacity feasibility, tie-breaking, and the
    fallback tiers then all operate inside the budget).  An empty
    in-budget pool raises ``ValueError`` — the service surfaces that as
    a structured ``infeasible-memory`` error.  Everything else is
    `explore_suite` on the single-circuit suite.
    """
    pool = list(sram_list)
    if not pool:
        raise ValueError("empty sram_list")
    if max_memory_kb is not None:
        pool = [t for t in pool if t.total_kb <= max_memory_kb]
        if not pool:
            smallest = min(t.total_kb for t in sram_list)
            raise ValueError(
                f"no candidate topology fits the {max_memory_kb} KB memory "
                f"budget (smallest candidate is {smallest} KB)"
            )
    out = explore_suite(
        {rtl.name: rtl},
        pool,
        recipes,
        model=model,
        mode=mode,
        max_latency_ns=max_latency_ns,
        backend="torch",
        discipline=discipline,
        cha=None if cha is None else {rtl.name: cha},
        cache=cache,
        n_jobs=n_jobs,
        model_sweep=model_sweep,
        fused=fused,
        shard=shard,
        cha_backend=cha_backend,
        device=device,
    )
    return out[rtl.name]


def best_worst(result: ExplorationResult) -> tuple[Evaluation, Evaluation]:
    """Table I companion: best- and worst-case feasible implementations."""
    if result.grid is not None:
        if result.cha is None:
            raise ValueError(
                "grid-backed ExplorationResult needs .cha to materialize "
                "Evaluations (explore() always sets it)"
            )
        g = result.grid
        if g.model is None:
            raise ValueError(
                "this grid is a correlated-variant slice with no single "
                "scalar model; materialize cells via "
                "ModelTable.model(v, topology=...) instead"
            )
        i_best, i_worst = g.best_worst_indices()
        out = []
        for i in (i_best, i_worst):
            ti, ri = g.unravel(i)
            recipe, topo = g.recipes[ri], g.topologies[ti]
            out.append(
                _materialize(recipe, topo, result.cha[recipe],
                             g.model, g.mode, g.discipline)
            )
        return out[0], out[1]
    pool = [e for e in result.evaluations if e.schedule.fits]
    pool = pool or result.evaluations
    best = min(pool, key=lambda e: e.metrics.energy_nj)
    worst = max(pool, key=lambda e: e.metrics.energy_nj)
    return best, worst
