"""Serving launchers of the port.

Two subcommands share this entry point, both on ``--device`` (default
``cuda``; raises without a card unless ``--device cpu``):

  * ``llm`` -- batched generation with the slot-based `serve.engine`
    (also the default when no subcommand is given, as in the reference);
  * ``explore`` -- the rCiM exploration service.

``llm`` builds the model from random weights (seed 0) in bf16 (the
recurrent blocks' fp32 leaves stay fp32, `models.model.FP32_PARAMS`)
and serves ``--requests`` random prompts.  whisper-tiny and internvl2-2b
read encoder frames or image patches besides the prompts, which
``llm`` (as the reference's) does not pass: `ServeEngine.serve` refuses
them with a `ValueError` naming the input; serve them through
``ServeEngine.generate(..., extra_batch=)``.  ``llm --trace-out PATH``
switches the port's tracer (`runtime.trace`) on for the run and writes one
Chrome-trace JSON there at exit: the engine's, the model's and the MoE's
spans on the host and (on a card) their device intervals, and the
counters, with ``ts`` in microseconds of CLOCK_REALTIME, the clock of a
``torch.profiler`` trace, so Perfetto shows both on one time axis (the
first `trace.LIMIT` spans; it prints how many it dropped past them).
``explore`` spins up `serve.explore_service.ExplorationService` (a warm
persistent query engine on ``--device``, default ``cuda``), streams
design queries at it, and prints per-request winners and service-time
percentiles.

Examples::

    python -m repro_torch.launch.serve llm --preset 100m
    python -m repro_torch.launch.serve llm --device cpu --preset smoke
    python -m repro_torch.launch.serve llm --arch deepseek-moe-16b --preset full
    python -m repro_torch.launch.serve llm --device cpu --arch mamba2-780m
    python -m repro_torch.launch.serve llm --device cpu --trace-out /tmp/serve_trace.json
    python -m repro_torch.launch.serve explore --scale tiny --requests 16
    python -m repro_torch.launch.serve explore --circuits adder,max \\
        --max-memory-kb 96 --max-latency-ns 400 --sweep mc --variants 8
    python -m repro_torch.launch.serve explore --device cpu --scale tiny
"""

from __future__ import annotations

import argparse
import sys
import time


def _main_llm(args: argparse.Namespace) -> None:
    import numpy as np
    import torch

    from ..device import resolve_device
    from ..models.config import ParallelConfig
    from ..models.model import Model
    from ..runtime import trace
    from ..serve.engine import Request, ServeEngine
    from .train import build_model_config

    dev = resolve_device(args.device)
    if args.trace_out:
        trace.enable()
    cfg = build_model_config(args.arch, args.preset)
    model = Model(cfg, ParallelConfig(), q_chunk=64, kv_chunk=64, device=dev,
                  param_dtype=torch.bfloat16)
    model.init(torch.Generator(device=dev).manual_seed(0))

    engine = ServeEngine(model, batch=args.batch,
                         max_seq=args.prompt_len + args.max_new,
                         temperature=args.temperature, device=dev)
    rng = np.random.default_rng(0)
    reqs = [
        Request(uid=i,
                prompt=rng.integers(0, cfg.vocab_size, size=(args.prompt_len,)).astype(np.int32),
                max_new=args.max_new)
        for i in range(args.requests)
    ]
    t0 = time.time()
    done = engine.serve(reqs, prompt_pad=args.prompt_len)
    dt = time.time() - t0
    n_tok = sum(len(r.out_tokens) for r in done)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"served {len(done)} requests, {n_tok} tokens in {dt:.1f}s "
          f"({n_tok/dt:.1f} tok/s on {where})")
    for r in done[:3]:
        print(f"  req {r.uid}: {[int(t) for t in r.out_tokens[:8]]}...")
    if args.trace_out:
        trace.disable()
        record = trace.export_chrome(args.trace_out)
        print(f"trace: {len(record['spans'])} spans to {args.trace_out}"
              + (f", {record['dropped']} dropped" if record["dropped"] else ""))


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
    # As in the reference: a bare `python -m repro_torch.launch.serve
    # --batch 4` routes to the LLM launcher.
    if not argv or argv[0] not in {"llm", "explore"} and argv[0] not in {"-h", "--help"}:
        argv = ["llm"] + argv

    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    llm = sub.add_parser("llm", help="batched LLM generation engine")
    llm.add_argument("--arch", default="minicpm-2b")
    llm.add_argument("--preset", choices=["smoke", "100m", "full"], default="smoke",
                     help="smoke (CPU size), 100m, or full (the published config)")
    llm.add_argument("--batch", type=int, default=4)
    llm.add_argument("--prompt-len", type=int, default=32)
    llm.add_argument("--max-new", type=int, default=16)
    llm.add_argument("--requests", type=int, default=8)
    llm.add_argument("--temperature", type=float, default=0.0)
    llm.add_argument("--device", default="cuda",
                     help="cuda (default; raises without a card) or cpu")
    llm.add_argument("--trace-out", default=None,
                     help="trace the run (runtime.trace) and write its Chrome-trace JSON here")

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
    if args.cmd == "explore":
        _main_explore(args)
    else:
        _main_llm(args)


if __name__ == "__main__":
    main()
