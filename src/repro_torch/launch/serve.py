"""Serving launcher of the port: the rCiM exploration service.

``explore`` spins up `serve.explore_service.ExplorationService` (a warm
persistent query engine on ``--device``, default ``cuda``), streams
design queries at it, and prints per-request winners and service-time
percentiles.

Examples::

    python -m repro_torch.launch.serve explore --scale tiny --requests 16
    python -m repro_torch.launch.serve explore --circuits adder,max \\
        --max-memory-kb 96 --max-latency-ns 400 --sweep mc --variants 8
    python -m repro_torch.launch.serve explore --device cpu --scale tiny
"""

from __future__ import annotations

import argparse
import sys
import time


def _main_explore(args: argparse.Namespace) -> None:
    import numpy as np

    from ..core.circuits import benchmark_suite
    from ..core.sram import TOPOLOGY_LIBRARY, ModelTable
    from ..core.transforms import enumerate_recipes
    from ..serve.explore_service import ExplorationService, ExploreRequest

    only = args.circuits.split(",") if args.circuits else None
    circuits = list(benchmark_suite(scale=args.scale, only=only).values())
    recipes = enumerate_recipes()[: args.recipes]
    sweep = None
    if args.sweep == "corners":
        sweep = ModelTable.corners()
    elif args.sweep == "mc":
        sweep = ModelTable.monte_carlo(n=args.variants, seed=0)

    svc = ExplorationService(
        sram_list=TOPOLOGY_LIBRARY,
        recipes=recipes,
        cache=args.cache,
        max_batch=args.max_batch,
        device=args.device,
    )
    try:
        t0 = time.perf_counter()
        reqs = [
            ExploreRequest(
                circuit=circuits[i % len(circuits)],
                max_memory_kb=args.max_memory_kb,
                max_latency_ns=args.max_latency_ns,
                model_sweep=sweep,
                tag=f"q{i}",
            )
            for i in range(args.requests)
        ]
        futs = svc.submit_batch(reqs)
        resps = [f.result() for f in futs]
        wall = time.perf_counter() - t0
        lat = []
        for r in resps:
            if not r.ok:
                print(f"{r.request.tag:>6}  ERROR {r.error.code}: "
                      f"{r.error.message}")
                continue
            lat.append(r.service_ms)
            w = r.winner
            mark = "warm" if r.grid_cache_hit else "cold"
            line = (f"{r.request.tag:>6}  {r.request.circuit.name:<8} "
                    f"-> {w.topology.name:<12} recipe={','.join(w.recipe) or '-'} "
                    f"E={w.energy_nj:.4f} nJ  lat={w.latency_ns:.1f} ns "
                    f"[{mark} {r.service_ms:.1f} ms]")
            if r.variation is not None:
                line += (f"  yield={r.variation.best_yield:.2f} "
                         f"cvar90={r.variation.cvar():.4f}")
            print(line)
        ok = [r for r in resps if r.ok]
        print(f"\nserved {len(ok)}/{len(resps)} requests in {wall:.2f}s "
              f"({len(resps) / wall:.1f} rps) on {svc.device}")
        if lat:
            print(f"service ms: p50={np.percentile(lat, 50):.1f} "
                  f"p99={np.percentile(lat, 99):.1f} "
                  f"max={max(lat):.1f}")
        st = svc.stats()
        print(f"cache: cha {st.get('cha_hits', 0)}/{st.get('cha_misses', 0)} "
              f"hit/miss, grid {st.get('grid_hits', 0)}/"
              f"{st.get('grid_misses', 0)} hit/miss, "
              f"{st['distinct_buckets']} bucket(s)")
    finally:
        svc.close()


def main(argv: "list[str] | None" = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    ex = sub.add_parser(
        "explore", help="warm persistent rCiM exploration service"
    )
    ex.add_argument("--circuits", default=None,
                    help="comma-separated benchmark names (default: all)")
    ex.add_argument("--scale", choices=["tiny", "default", "paper"],
                    default="tiny")
    ex.add_argument("--recipes", type=int, default=8,
                    help="number of synthesis recipes to sweep")
    ex.add_argument("--requests", type=int, default=8)
    ex.add_argument("--max-memory-kb", type=float, default=None)
    ex.add_argument("--max-latency-ns", type=float, default=None)
    ex.add_argument("--sweep", choices=["none", "corners", "mc"],
                    default="none")
    ex.add_argument("--variants", type=int, default=8,
                    help="Monte-Carlo variants for --sweep mc")
    ex.add_argument("--cache", default=None,
                    help="characterization cache directory")
    ex.add_argument("--max-batch", type=int, default=8)
    ex.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")

    args = ap.parse_args(argv)
    _main_explore(args)


if __name__ == "__main__":
    main()
