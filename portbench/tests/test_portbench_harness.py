"""The harness's data on the CPU: every cell and configuration file parses
and names a driver, a configuration and metrics that exist; the names,
units and texts of `BENCHMARK.json` keep to the allowed characters; the
traffic repeats for a seed and differs across seeds; and `run.py` refuses
to run without a card."""

import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from portbench import arch, harness, traffic

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = sorted(p.stem for p in (BENCH / "workloads").glob("*.json"))
CONFIGS = sorted(p.stem for p in (BENCH / "configs").glob("*.json"))


def _text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


@pytest.mark.parametrize("name", WORKLOADS)
def test_workload_file_names_what_exists(name):
    w = harness.load_workload(name)
    assert w["name"] == name
    assert (BENCH / "configs" / f"{w['config']}.json").is_file()
    assert hasattr(harness.driver(w["driver"]), "run")
    assert w["chips"] in (1, 4) and _text_ok(w["why"])
    assert set(w["check"]["limits"])
    assert w["traffic"]["kind"] in harness.driver(w["driver"]).TRAFFIC


@pytest.mark.parametrize("name", CONFIGS)
def test_config_file_parses(name):
    c = arch.load_dict(name)
    a = arch.from_dict(c)
    assert a.name == name and a.n_heads * a.head_dim > 0
    assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    assert all(k in c for k in c["reduced"]), "a reduced key holds the value as run"


def test_benchmark_entries_match_their_files():
    assert SPEC["paths"] == ["portbench"] and SPEC["command"] == ["python3", "portbench/run.py"]
    cfg_names = {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert arch.load_dict(c["name"])["reduced"] == c["reduced"]
        assert arch.load_dict(c["name"])["source"] == c["source"]
    for w in SPEC["workloads"]:
        f = harness.load_workload(w["name"])
        assert w["config"] in cfg_names and w["config"] == f["config"]
        assert (w["chips"], w["why"]) == (f["chips"], f["why"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    cells = {w["name"] for w in SPEC["workloads"]}
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == cfg_names
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert hasattr(harness.metric(m["name"]), "read"), m["name"]
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["per_layer"]:
        mover = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(mover.get("workloads", cells)), m["name"]
    for cell in cells:
        names = [n for n, _ in harness.cell_metrics(SPEC, cell, False)]
        assert "setup_s" in names and len(names) >= 2
        assert harness.cell_metrics(SPEC, cell, True)


def test_benchmark_names_units_and_texts():
    keys = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert set(SPEC) == keys
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _text_ok(c["source"]) and _text_ok(c["why"])
        names.append(("config", c["name"]))
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _text_ok(w["why"])
        names.append(("cell", w["name"]))
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _text_ok(m["layer"]) and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(("metric", m["name"]))
    for _, n in names:
        assert NAME.match(n), n
    assert len(set(names)) == len(names)
    assert len(json.dumps(SPEC)) <= 64 * 1024
    for p in BENCH.rglob("*"):
        if "__pycache__" not in p.parts:
            assert re.match(r"^[A-Za-z0-9_./-]+$", str(p.relative_to(ROOT))), p


@pytest.mark.parametrize("name", [w for w in WORKLOADS if w.endswith(".serve")])
def test_serving_traffic_repeats_for_a_seed_and_differs_across_seeds(name):
    w = harness.load_workload(name)
    tr, v = w["traffic"], arch.load(w["config"]).vocab_size
    a1, a2 = traffic.wave(tr, v, 2**40 + 3, 1), traffic.wave(tr, v, 2**40 + 3, 1)
    b = traffic.wave(tr, v, 2**40 + 4, 1)
    assert [(r.max_new, r.prompt.tolist()) for r in a1] == [(r.max_new, r.prompt.tolist())
                                                            for r in a2]
    assert [r.prompt.tolist() for r in a1] != [r.prompt.tolist() for r in b]
    # the same sizes for every seed and wave, in another order
    sizes = lambda reqs: sorted((len(r.prompt), r.max_new) for r in reqs)  # noqa: E731
    assert sorted(len(r.prompt) for r in a1) == sorted(len(r.prompt) for r in b)
    assert sorted(r.max_new for r in a1) == sorted(r.max_new for r in traffic.wave(tr, v, 9, 0))
    assert sizes(a1) != sizes(b) or [r.max_new for r in a1] != [r.max_new for r in b]
    lo, hi = tr["prompt_len"]["lo"], tr["prompt_len"]["hi"]
    assert all(lo <= len(r.prompt) <= min(hi, tr["prompt_pad"]) for r in a1)
    assert all(r.max_new <= tr["max_seq"] - tr["prompt_pad"] for r in a1)
    assert all(0 < t < v for r in a1 for t in r.prompt)
    assert len(a1) == tr["clients"]


def test_training_traffic_repeats_for_a_seed_and_differs_across_seeds():
    w = harness.load_workload("minicpm-2b.train")
    tr, v = w["traffic"], arch.load(w["config"]).vocab_size
    a = traffic.train_batch(tr, v, 5, 0)
    assert a.shape == (tr["batch"], tr["seq"] + 1)
    assert np.array_equal(a, traffic.train_batch(tr, v, 5, 0))
    assert not np.array_equal(a, traffic.train_batch(tr, v, 6, 0))
    assert not np.array_equal(a, traffic.train_batch(tr, v, 5, 1))
    assert a.min() >= 0 and a.max() < v


def _run(args, cwd, env_extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **env_extra)
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("name", WORKLOADS)
def test_run_refuses_without_a_card(name):
    out = _run(["--workload", name, "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
               ROOT, {})
    assert out.returncode == 2, out.stderr[-2000:]
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


@pytest.mark.parametrize("cell,config", [("SERVE", "MOE"), ("TRAIN", "DENSE")])
def test_traced_run_reads_its_per_layer_metrics(cell, config):
    """A traced run on the CPU: the spans' and counts' metrics are read; the
    device trace's find no device work there and are left out."""
    import time

    import torch

    from portbench.tests import tiny

    rec, _ = harness.run_cell(getattr(tiny, cell), getattr(tiny, config), 3, 0.0, True,
                              torch.device("cpu"), time.perf_counter())
    got = harness.read_metrics([(m["name"], m["unit"]) for m in SPEC["per_layer"]], rec)
    if cell == "SERVE":
        for kind in ("serve", "moe"):
            assert {f"prefill_ms.{kind}", f"slot_waste_pct.{kind}", f"decode_roofline_pct.{kind}",
                    f"mfu.{kind}"} <= set(got)
            assert 0 < got[f"decode_roofline_pct.{kind}"]["value"] < 100
        assert "itl_p95_ms.moe" in got and len(rec["prefill_ms"]) == 1
        # every step of the extra wave outside the profiled 8-15 is a span
        spans = rec["decode_spans"]
        assert len(spans) == 16 - 8 and all(0 < s["live"] <= 4 for s in spans)
        assert all(0 < s["experts_hit"] <= 8 for s in spans)
    else:
        assert set(got) == {"mfu.train"}
    assert not {"decode_device_ms.serve", "device_idle_pct.serve", "decode_device_ms.moe",
                "device_idle_pct.moe", "step_device_ms.train", "device_idle_pct.train"} & set(got)
    assert rec["profile"]["n_device_ops"] == 0 and rec["profile"]["steps"] >= 1
