"""Beyond-paper: Algorithm I re-targeted at the TPU mesh/sharding space.

The counterpart of the reference's ``core/mesh_explorer.py``.  The paper's
tool maps a *workload* (an AIG characterized per level) onto a
*memory-compute topology* (SRAM macro library) by sweeping an analytical
energy/latency model and returning the argmin.  This instantiation maps
one (arch x shape) workload onto a topology library of mesh shapes and a
recipe library of step-lowering options, with the three-term roofline of
the dry-run (`launch.dryrun`: the step traced on meta DTensors over a fake
512-rank mesh) as the latency model and a bytes-moved energy proxy:

    paper                      | here
    ---------------------------+---------------------------------------
    AIG synthesis recipe (64)  | step recipe (remat, accum, chunking)
    SRAM topology library (12) | mesh library ((16,16), (32,8), ...)
    analytical power/latency   | roofline terms of the traced step
    capacity check (4b/gate)   | per-device bytes fit 16 GB HBM
    FilterEnergy -> argmin     | argmin(energy proxy) s.t. latency, HBM
    inductor sizing            | collective schedule report

Energy proxy constants (order-of-magnitude, vendor-typical for 5nm-class
accelerators): 0.6 pJ/flop (bf16), 10 pJ/byte HBM, 25 pJ/byte ICI.  They
and ``HBM_GB`` model the reference's TPU v5e pod, not the card the
selection runs on.

The selection (`select_best`, and the variant sweep's one batched pass
through `select_best_batch_device`) runs on ``device``, ``cuda`` unless
the caller asks for the CPU.

Usage:
    PYTHONPATH=src python -m repro_torch.core.mesh_explorer --arch gemma3-27b \\
        --shape train_4k [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from ..device import resolve_device
from .batch import select_best, select_best_batch_device, winner_summary

PJ_PER_FLOP = 0.6e-12
PJ_PER_HBM_BYTE = 10e-12
PJ_PER_LINK_BYTE = 25e-12
HBM_GB = 16.0

# The energy-proxy constants as a named variant (J/flop, J/byte) -- the
# mesh analogue of `sram.ModelTable`'s nominal row.
NOMINAL_CONSTANTS = dict(
    pj_per_flop=PJ_PER_FLOP,
    pj_per_hbm_byte=PJ_PER_HBM_BYTE,
    pj_per_link_byte=PJ_PER_LINK_BYTE,
)


def constant_corners(spread: float = 0.25) -> list[dict]:
    """Nominal + low/high corners of the energy-proxy constants (vendor
    figures are order-of-magnitude; the corners bound how sensitive the
    argmin is to them).  Variant 0 is nominal, like `sram.ModelTable`."""

    def scaled(k: float) -> dict:
        return {n: v * k for n, v in NOMINAL_CONSTANTS.items()}

    return [dict(NOMINAL_CONSTANTS), scaled(1.0 - spread), scaled(1.0 + spread)]


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """One entry of the 'SRAM topology library' analogue."""

    name: str
    multi_pod: bool = False
    mesh_shape: tuple | None = None  # e.g. (32, 8) single-pod DPxTP


@dataclasses.dataclass(frozen=True)
class StepRecipe:
    """One entry of the 'synthesis recipe' analogue."""

    name: str
    remat: str = "full"
    grad_accum: int = 1
    q_chunk: int = 1024
    kv_chunk: int = 1024
    cast_bf16: bool = False
    shard_grads: bool = False

    def overrides(self) -> dict:
        return dict(remat=self.remat, grad_accum=self.grad_accum,
                    q_chunk=self.q_chunk, kv_chunk=self.kv_chunk,
                    cast_bf16=self.cast_bf16, shard_grads=self.shard_grads)


DEFAULT_RECIPES = (
    StepRecipe("base"),
    StepRecipe("bf16cast", cast_bf16=True),
    StepRecipe("bf16+rs", cast_bf16=True, shard_grads=True),
    StepRecipe("accum4", grad_accum=4),
    StepRecipe("chunk2048", q_chunk=2048, kv_chunk=2048),
    StepRecipe("remat-block", remat="block"),
)

DEFAULT_TOPOLOGIES = (
    MeshTopology("single-16x16"),
    MeshTopology("single-32x8", mesh_shape=(32, 8)),
    MeshTopology("single-64x4", mesh_shape=(64, 4)),
    MeshTopology("multi-2x16x16", multi_pod=True),
)


@dataclasses.dataclass
class MeshEvaluation:
    topo: str
    recipe: str
    latency_s: float
    energy_j: float
    hbm_gb: float
    fits: bool
    bottleneck: str
    record: dict


def energy_proxy(rec: dict) -> float:
    r = rec["roofline"]
    chips = rec["n_chips"]
    return chips * (
        r["flops"] * PJ_PER_FLOP
        + r["hbm_bytes"] * PJ_PER_HBM_BYTE
        + r["link_bytes"] * PJ_PER_LINK_BYTE
    )


def evaluation(topo: str, recipe: str, record: dict) -> MeshEvaluation:
    """One dry-run record as a point of the sweep."""
    r = record["roofline"]
    hbm = record["hbm_per_device_gb"]
    return MeshEvaluation(
        topo=topo, recipe=recipe,
        latency_s=max(r["compute_s"], r["memory_s"], r["collective_s"]),
        energy_j=energy_proxy(record), hbm_gb=hbm, fits=hbm <= HBM_GB,
        bottleneck=r["bottleneck"], record=record,
    )


def _sweep_workload(
    arch: str,
    shape: str,
    topologies,
    recipes,
    out_dir: str,
    workers: int = 1,
) -> list[MeshEvaluation]:
    """Evaluate the full topology x recipe grid for one (arch, shape).
    ``workers > 1`` traces the cells in that many spawned processes (the
    trace is single-threaded host work; each process holds its own fake
    group); the records and their order are the serial loop's."""
    from ..launch.dryrun import run_cell

    grid = [(topo, rec) for topo in topologies for rec in recipes]
    calls = [dict(arch=arch, shape_name=shape, multi_pod=topo.multi_pod, out_dir=out_dir,
                  overrides=rec.overrides(), tag=f"{topo.name}__{rec.name}",
                  mesh_shape=topo.mesh_shape) for topo, rec in grid]
    if workers > 1 and len(calls) > 1:
        import concurrent.futures
        import multiprocessing

        with concurrent.futures.ProcessPoolExecutor(
                min(workers, len(calls)), mp_context=multiprocessing.get_context("spawn")) as ex:
            records = list(ex.map(_run_cell_kw, calls))
    else:
        records = [run_cell(**kw) for kw in calls]
    return [evaluation(topo.name, rec.name, record)
            for (topo, rec), record in zip(grid, records) if "skipped" not in record]


def _run_cell_kw(kw: dict) -> dict:
    from ..launch.dryrun import run_cell

    return run_cell(**kw)


def variation_summary(
    evals: list[MeshEvaluation],
    variants: "list[dict]",
    max_latency_s: float | None = None,
    device=None,
) -> dict:
    """Per-variant winners + yield over an energy-constant sweep -- the
    mesh analogue of `explorer.VariationResult`.  One vectorized ``(V,
    N)`` energy matrix, then ONE shared selection pass for every variant's
    winner through `select_best_batch_device` on ``device``.  Variant 0 is
    the nominal constants."""
    comp = np.array(
        [
            [
                e.record["roofline"]["flops"],
                e.record["roofline"]["hbm_bytes"],
                e.record["roofline"]["link_bytes"],
            ]
            for e in evals
        ]
    )  # (N, 3)
    chips = np.array([e.record["n_chips"] for e in evals], dtype=float)
    k = np.array(
        [
            [v["pj_per_flop"], v["pj_per_hbm_byte"], v["pj_per_link_byte"]]
            for v in variants
        ]
    )  # (V, 3)
    # Same operation order as `energy_proxy` -- chips * (f*kf + h*kh + l*kl)
    # -- so a nominal-constants variant ranks identically to the headline
    # `best` pick, last-ulp ties included.
    energy = chips[None, :] * (
        k[:, 0:1] * comp[None, :, 0]
        + k[:, 1:2] * comp[None, :, 1]
        + k[:, 2:3] * comp[None, :, 2]
    )  # (V, N)
    fits = np.array([e.fits for e in evals])
    lat = np.array([e.latency_s for e in evals])
    idx = select_best_batch_device(
        energy, fits[None, :], latency=lat[None, :],
        max_latency=max_latency_s, device=resolve_device(device),
    )
    winners = [
        dict(topo=evals[int(i)].topo, recipe=evals[int(i)].recipe)
        for i in idx
    ]
    share, best_yield = winner_summary(
        [f"{w['topo']}/{w['recipe']}" for w in winners]
    )
    return dict(
        n_variants=len(variants),
        winners=winners,
        winner_share=share,
        best_yield=best_yield,
    )


def _pick(evals: list[MeshEvaluation], max_latency_s: float | None) -> int:
    """FilterEnergy: the same admissibility-filter + argmin the SRAM
    explorer uses (core/batch.py), over the stacked evaluation arrays."""
    return select_best(
        np.array([e.energy_j for e in evals]),
        np.array([e.fits for e in evals]),
        latency=np.array([e.latency_s for e in evals]),
        max_latency=max_latency_s,
    )


def _pick_best(
    evals: list[MeshEvaluation], max_latency_s: float | None
) -> MeshEvaluation:
    return evals[_pick(evals, max_latency_s)]


def explore_mesh(
    arch: str,
    shape: str,
    topologies=DEFAULT_TOPOLOGIES,
    recipes=DEFAULT_RECIPES,
    out_dir: str = "runs/mesh_explorer",
    max_latency_s: float | None = None,
    constant_sweep: "list[dict] | None" = None,
    device=None,
    workers: int = 1,
) -> dict:
    """Algorithm I over the mesh/recipe space.  Returns the full sweep plus
    the min-energy admissible pick.  ``constant_sweep`` (a list of
    energy-constant dicts, e.g. `constant_corners()`) additionally
    reports per-variant winners + yield under a ``"variation"`` key,
    selected on ``device``.  ``workers``: processes tracing the cells."""
    device = resolve_device(device)
    evals = _sweep_workload(arch, shape, topologies, recipes, out_dir, workers)
    best = _pick_best(evals, max_latency_s)
    out = dict(
        arch=arch, shape=shape,
        best=dict(topo=best.topo, recipe=best.recipe,
                  latency_s=best.latency_s, energy_j=best.energy_j,
                  bottleneck=best.bottleneck, hbm_gb=best.hbm_gb),
        sweep=[dataclasses.asdict(e) | {"record": None} for e in evals],
    )
    if constant_sweep:
        out["variation"] = variation_summary(
            evals, list(constant_sweep), max_latency_s, device=device
        )
    return out


def explore_mesh_suite(
    workloads: "list[tuple[str, str]]",
    topologies=DEFAULT_TOPOLOGIES,
    recipes=DEFAULT_RECIPES,
    out_dir: str = "runs/mesh_explorer",
    max_latency_s: float | None = None,
    constant_sweep: "list[dict] | None" = None,
    device=None,
    workers: int = 1,
) -> dict:
    """The suite path: sweep several (arch, shape) workloads over one
    topology x recipe grid -- the mesh analogue of
    `explorer.explore_suite`'s circuits axis.

    Dry-run records are shared through `run_cell`'s on-disk run directory
    (the dry-run layer's own persistent cache), so overlapping workloads
    across calls do not trace again.  Returns ``{"workloads":
    {"arch/shape": {best, sweep}}, "best": ...}`` with the global
    min-energy admissible pick across the whole suite.
    """
    device = resolve_device(device)
    out: dict = {"workloads": {}}
    tagged: list[tuple[str, MeshEvaluation]] = []
    for arch, shape in workloads:
        evals = _sweep_workload(arch, shape, topologies, recipes, out_dir, workers)
        key = f"{arch}/{shape}"
        out["workloads"][key] = dict(
            best=dataclasses.asdict(_pick_best(evals, max_latency_s))
            | {"record": None},
            sweep=[dataclasses.asdict(e) | {"record": None} for e in evals],
        )
        if constant_sweep:
            out["workloads"][key]["variation"] = variation_summary(
                evals, list(constant_sweep), max_latency_s, device=device
            )
        tagged.extend((key, e) for e in evals)
    best_key, best = tagged[_pick([e for _, e in tagged], max_latency_s)]
    out["best"] = dataclasses.asdict(best) | {
        "record": None, "workload": best_key
    }
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="architecture, or comma list for a suite sweep")
    ap.add_argument("--shape", default="train_4k",
                    help="shape, or comma list; a suite sweep covers the "
                         "full arch x shape product")
    ap.add_argument("--max-latency-s", type=float, default=None)
    ap.add_argument("--corner-spread", type=float, default=None,
                    help="sweep the energy-proxy constants over +-x "
                         "corners and report per-variant winners + yield")
    ap.add_argument("--out", default="runs/mesh_explorer")
    ap.add_argument("--device", default=None,
                    help="where the selection runs (default cuda)")
    ap.add_argument("--workers", type=int, default=1,
                    help="processes tracing the dry-run cells")
    args = ap.parse_args(argv)
    sweep = (
        constant_corners(args.corner_spread)
        if args.corner_spread is not None else None
    )
    archs = args.arch.split(",")
    shapes = args.shape.split(",")
    kw = dict(max_latency_s=args.max_latency_s, constant_sweep=sweep,
              out_dir=args.out, device=args.device, workers=args.workers)
    if len(archs) > 1 or len(shapes) > 1:
        workloads = [(a, s) for a in archs for s in shapes]
        res = explore_mesh_suite(workloads, **kw)
        print(json.dumps(res["best"], indent=1))
        for key, wl in res["workloads"].items():
            b = wl["best"]
            print(f"  {key:28s} -> {b['topo']:16s} {b['recipe']:12s} "
                  f"lat={b['latency_s']:.4f}s E={b['energy_j']:.1f}J")
            if "variation" in wl:
                v = wl["variation"]
                print(f"    constants sweep: best_yield={v['best_yield']:.2f} "
                      f"share={v['winner_share']}")
        return
    res = explore_mesh(args.arch, args.shape, **kw)
    print(json.dumps(res["best"], indent=1))
    for e in res["sweep"]:
        print(f"  {e['topo']:16s} {e['recipe']:12s} lat={e['latency_s']:.4f}s "
              f"E={e['energy_j']:.1f}J hbm={e['hbm_gb']:.1f}GB {e['bottleneck']}")
    if "variation" in res:
        v = res["variation"]
        print(f"  constants sweep: best_yield={v['best_yield']:.2f} "
              f"share={v['winner_share']}")


if __name__ == "__main__":
    main()
