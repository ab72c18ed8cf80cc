"""The paper's exploration CLI on the port -- Algorithm I over the
EPFL-like suite, on the card.

When given a combinational circuit, it searches the synthesis recipes and
the resonant-SRAM topologies for the lowest-energy implementation that
fits the memory and latency budget, and prints the Table-I-style row of
each circuit plus its best-vs-worst energy saving.  The front half runs
K1 (`kernels.aig_sim`) and the back half the fused fp64 torch sweep, both
on ``--device`` (default ``cuda``; without a card it raises unless
``--device cpu`` is given)::

    python -m repro_torch.launch.cim_explore --circuit adder --scale tiny
    python -m repro_torch.launch.cim_explore --all --scale default

    # persistent characterization cache: the first run is cold, reruns
    # read the front half from disk
    python -m repro_torch.launch.cim_explore --all --cache runs/cha_cache

    # energy-model variation: sweep process corners / Monte-Carlo samples
    # through the same back-half pass and report a yield summary
    python -m repro_torch.launch.cim_explore --all --model-sweep mc \\
        --model-variants 32

    # on the host, with the kernels' plain torch versions
    python -m repro_torch.launch.cim_explore --circuit sqrt --scale tiny --device cpu
"""

from __future__ import annotations

import argparse
from typing import Sequence

from ..core import circuits as C
from ..core.explorer import ExplorationResult, VariationResult, best_worst, explore_suite
from ..core.sram import TOPOLOGY_LIBRARY, EnergyModel, ModelTable
from ..device import resolve_device


def model_table(kind: "str | None", variants: int, sigma: float) -> "ModelTable | None":
    """The ``--model-sweep`` table: process corners, one-at-a-time
    sensitivity, Monte-Carlo, or correlated per-macro-geometry
    Monte-Carlo keyed on `TOPOLOGY_LIBRARY` (the swept topology list)."""
    if kind is None:
        return None
    if kind == "corners":
        return ModelTable.corners(EnergyModel(), spread=sigma)
    if kind == "sensitivity":
        return ModelTable.sensitivity(EnergyModel(), rel=sigma)
    if kind == "mc":
        return ModelTable.monte_carlo(EnergyModel(), n=variants, sigma=sigma, seed=0)
    if kind == "correlated":
        # topology-dependent (V, T) variation keyed on the library's
        # macro geometries -- must match the swept topology list
        return ModelTable.bitcell_sigma_per_macro(
            TOPOLOGY_LIBRARY, n=variants, sigma=sigma, seed=0
        )
    raise ValueError(f"unknown model sweep {kind!r}")


def yield_summary(var: VariationResult) -> list[str]:
    """The printed lines of a model sweep's yield summary."""
    q = var.energy_quantiles
    lines = [
        f"  model sweep ({var.n_variants} variants): best_yield={var.best_yield:.2f} "
        f"latency_yield={var.latency_yield:.2f}",
        f"  winner energy [nJ]: p5={q[0.05]:.4g} median={q[0.5]:.4g} p95={q[0.95]:.4g} "
        f"cvar(0.9)={var.cvar(0.9):.4g}",
    ]
    for impl, share in sorted(var.winner_share.items(), key=lambda kv: -kv[1]):
        lines.append(f"    {impl:32s} wins {share:.0%} of variants")
    return lines


def report(name: str, rtl, res: ExplorationResult) -> None:
    """Print one circuit's Table-I row, its best-vs-worst saving and, for
    a model sweep, the yield summary."""
    b, w = best_worst(res)
    print(f"\n=== {name} ({rtl.n_ands} AIG nodes, {res.n_recipes} recipes, "
          f"{res.n_evaluations} implementations, {res.wall_s:.1f}s) ===")
    for k, v in res.table_row().items():
        print(f"  {k:14s} {v}")
    saving = 100 * (1 - b.metrics.energy_nj / w.metrics.energy_nj)
    print(f"  best-vs-worst energy saving: {saving:.1f}% (paper avg 89.12%)")
    if res.variation is not None:
        print("\n".join(yield_summary(res.variation)))


def main(argv: "Sequence[str] | None" = None) -> dict[str, ExplorationResult]:
    """Run the CLI; returns ``{circuit: ExplorationResult}``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--circuit", default="adder", choices=list(C._GENERATORS) + ["all"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--scale", choices=["tiny", "default", "paper"], default="tiny")
    ap.add_argument("--max-latency-ns", type=float, default=None)
    ap.add_argument("--backend", choices=["torch", "python"], default="torch",
                    help="sweep backend: the fused torch grid or the scalar reference")
    ap.add_argument("--cache", default=None, metavar="DIR",
                    help="persistent characterization cache directory")
    ap.add_argument("--jobs", type=int, default=None,
                    help="characterization workers (default: serial on the "
                         "device backend)")
    ap.add_argument("--model-sweep", choices=["corners", "sensitivity", "mc", "correlated"],
                    default=None,
                    help="sweep EnergyModel variants (process corners, "
                         "one-at-a-time sensitivity, Monte-Carlo, or "
                         "correlated per-macro-geometry Monte-Carlo) through "
                         "the same back-half pass and report a yield summary")
    ap.add_argument("--model-variants", type=int, default=16,
                    help="Monte-Carlo sample count (--model-sweep mc/correlated)")
    ap.add_argument("--model-sigma", type=float, default=0.05,
                    help="relative sigma/spread for the model sweep")
    ap.add_argument("--device", default="cuda",
                    help="torch device of both halves (default cuda; 'cpu' "
                         "runs the kernels' plain torch versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    names = list(C._GENERATORS) if (args.all or args.circuit == "all") else [args.circuit]
    suite = C.benchmark_suite(scale=args.scale, only=names)
    results = explore_suite(
        suite, max_latency_ns=args.max_latency_ns, backend=args.backend,
        cache=args.cache, n_jobs=args.jobs,
        model_sweep=model_table(args.model_sweep, args.model_variants, args.model_sigma),
        device=device,
    )
    for name, res in results.items():
        report(name, suite[name], res)
    return results


if __name__ == "__main__":
    main()
