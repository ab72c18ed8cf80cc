"""Readings that set a cell's limits, on the card at the cell's own size.

    python3 portbench/calibrate.py --workload minicpm-2b.serve --seeds 11,12,13 \\
        --control 11,12,13 --seconds 1 [--faults]

One process builds the cell anew for every seed and drives a short window
of the timed path (at least one whole wave, or one step past the three the
check follows), then prints one JSON line a seed: the program's readings
(the lower end of each limit), and for the ``--control`` seeds the
control's: the plain reference in float8 put in the program's place (a
serving cell: the gap of the token the float8 reference puts first at each
judged position; a training cell: the float8 reference's three steps read
against the float32 one's).  ``--faults`` (a training cell) also reads the
program with half of each batch left out, the mean taken over the rest.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def half_batch(objs):
    step_fn = objs["step_fn"]

    def step(params, opt_state, batch):
        return step_fn(params, opt_state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})

    return step


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import arch, harness
    from portbench.drivers import train

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    workload = harness.load_workload(args.workload)
    config = arch.load_dict(workload["config"])
    controls = {int(s) for s in args.control.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        is_train = workload["driver"] == "train"
        rec, checks = harness.run_cell(workload, config, seed, args.seconds, False, dev, t,
                                       control=seed in controls and not is_train)
        line = dict(workload=args.workload, seed=seed, program=checks,
                    setup_s=rec["setup_s"], window_s=rec["window_s"], check_s=rec["check_s"],
                    attempted=rec["attempted"], memory_peak_bytes=rec["memory_peak_bytes"])
        ctx = dict(arch=arch.from_dict(config), cell=workload, seed=seed, device=dev)
        if is_train and seed in controls:
            line["control"] = train.check(ctx, train.follow(ctx, lowp=True))
        if is_train and args.faults:
            _, line["half_batch"] = harness.run_cell(workload, config, seed, 0.0, False, dev,
                                                     time.perf_counter(), fault=half_batch)
        line["seconds"] = time.perf_counter() - t
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
