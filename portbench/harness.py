"""One run of one cell, found by name: its workload file, its configuration
file, its driver and its metrics' readers, each a file of its own.

``workloads/<cell>.json`` names the configuration, the driver, the
traffic parameters, the program's settings and the check's limits;
``configs/<config>.json`` the model, and through its ``arch`` key the
architecture (``archs/<arch>.py``, `arch`); ``drivers/<driver>.py`` the
path it drives (``run(ctx) -> (record, checks)``, and ``TRAFFIC``, the
traffic kinds it takes); ``metrics/<metric>.py`` one metric
(``read(record) -> number or None``).  `BENCHMARK.json` says which
metrics a cell reports: its ``end_to_end`` ones in a plain run, its
``per_layer`` ones in a traced run.
"""

from __future__ import annotations

import json
import math
import pathlib
import sys

from . import arch as arch_mod
from . import found

HERE = pathlib.Path(__file__).resolve().parent

#: top-level modules that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_workload(name: str) -> dict:
    with open(HERE / "workloads" / f"{name}.json") as f:
        return json.load(f)


def driver(name: str):
    return found.load("drivers", name)


def metric(name: str):
    return found.load("metrics", name)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[tuple[str, str]]:
    """``(name, unit)`` of the metrics a run of ``cell`` reports."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [(m["name"], m["unit"]) for m in group
            if "workloads" not in m or cell in m["workloads"]]


def read_metrics(wanted: list[tuple[str, str]], rec: dict) -> dict:
    """Each metric's reader over the run's record; one that finds nothing to
    read (None) is left out."""
    out = {}
    for name, unit in wanted:
        v = metric(name).read(rec)
        if v is not None:
            out[name] = dict(value=float(v), unit=unit)
    return out


def run_cell(workload: dict, config: dict, seed: int, seconds: float, trace: bool,
             device, t_start: float, **extra) -> tuple[dict, dict]:
    """Drive one run: ``(record, checks)``.  ``ctx["arch"]`` is the
    configuration as numbers, read by the architecture it names.  ``extra``
    reaches the driver's context (``fault``: a hook the tests break the
    timed path with; ``control``)."""
    ctx = dict(arch=arch_mod.from_dict(config), cell=workload, seed=seed, seconds=seconds,
               trace=trace, device=device, t_start=t_start, **extra)
    return driver(workload["driver"]).run(ctx)


def judge(workload: dict, checks: dict) -> tuple[bool, dict, dict]:
    """``(correct, compared, other)``: every number that has a limit in the
    workload file is compared (at most its limit); the others are shown."""
    limits = workload["check"]["limits"]
    compared = {}
    for k, lim in limits.items():
        v = float(checks.get(k, math.nan))
        compared[k] = dict(value=v if math.isfinite(v) else 1e300, limit=lim)
    ok = all(lim is not None and math.isfinite(float(checks.get(k, math.nan)))
             and float(checks[k]) <= lim for k, lim in limits.items())
    other = {k: v for k, v in checks.items() if k not in limits}
    return ok, compared, other


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
