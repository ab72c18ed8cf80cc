"""Run one cell of the port's benchmark on the card and print its result.

    python3 portbench/run.py --workload minicpm-2b.serve --seed 7 --seconds 45 --trace 0

From the root of a checkout (one that holds ``src/`` and ``BENCHMARK.json``).
Without a CUDA card, or with fewer cards than the cell asks for, it exits
with code 2 and prints no result.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each number compared beside its limit); the checks are also the last lines
of standard error.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer ones.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _env() -> None:
    """Caches inside the checkout at fixed paths; the process's own import
    path.  Nothing of this run writes outside the checkout, HOME and TMPDIR."""
    build = ROOT / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")
    here = str(pathlib.Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p and pathlib.Path(p).resolve() != pathlib.Path(here)]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _say(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args()
    _env()

    from portbench import harness

    workload = harness.load_workload(args.workload)
    import torch

    chips = int(workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _say(f"portbench: {args.workload} needs {chips} CUDA card(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    torch.set_num_threads(4)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(dev)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi: {e}"
    _say(f"portbench: {args.workload} seed {args.seed} on {kind}; {smi}; torch {torch.__version__}")

    from portbench import arch

    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    config = arch.load_dict(workload["config"])
    rec, checks = harness.run_cell(workload, config, args.seed, args.seconds, bool(args.trace),
                                   dev, T_START)
    found = harness.forbidden_modules()
    if found:
        _say(f"portbench: the run's process loaded {', '.join(found)}")
        return 3

    correct, compared, other = harness.judge(workload, checks)
    metrics = harness.read_metrics(harness.cell_metrics(bench, args.workload, bool(args.trace)),
                                   rec)
    device = dict(platform="gpu", kind=kind, count=chips,
                  memory_peak_bytes=int(rec["memory_peak_bytes"]))
    out = dict(correct=correct, attempted=int(rec["attempted"]), failed=int(rec["failed"]),
               metrics=metrics, device=device)
    prof = rec.get("profile")
    if args.trace and prof and prof.get("n_device_ops"):
        device.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        out["breakdown"] = dict(device_ops=prof["device_ops"], idle_gaps=prof["idle_gaps"])
    out["checks"] = compared
    _say(f"portbench: window {rec['window_s']:.3f} s, set-up {rec['setup_s']:.3f} s, "
         f"check {rec['check_s']:.3f} s; " + ", ".join(f"{k} {v}" for k, v in other.items()))
    for k, c in compared.items():
        _say(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
