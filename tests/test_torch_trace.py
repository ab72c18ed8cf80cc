"""The port's tracer (``repro_torch.runtime.trace``) on the CPU.

Off, a span site is the shared no-op and nothing is recorded or entered;
on (switched on, or under ``torch.profiler``), the engine's, the model's,
the MoE's and the train step's spans nest as the program calls them, the
counters equal what the routing and the waves hold, the host stamps
bracket the profiler's own events, the tracer dispatches no op of its own
and holds a bounded number of records.  The launchers' ``--trace-out`` writes a Chrome trace.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as L
from repro_torch.models.config import ParallelConfig
from repro_torch.models.model import Model
from repro_torch.optim import adamw as A
from repro_torch.runtime import trace
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train.steps import make_train_step


@pytest.fixture(autouse=True)
def _clean_tracer():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def tiny(arch="deepseek-moe-16b", remat="block", **changes):
    cfg = dataclasses.replace(smoke_config(arch), **changes)
    m = Model(cfg, ParallelConfig(remat=remat), compute_dtype=torch.float32, q_chunk=8,
              kv_chunk=8, device="cpu")
    return m.init(torch.Generator().manual_seed(0))


def requests(vocab, max_new=(3, 5), n=2, plen=6, uid0=0):
    rng = np.random.default_rng(uid0)
    return [Request(uid=uid0 + i, prompt=rng.integers(1, vocab, plen).astype(np.int32),
                    max_new=max_new[i % len(max_new)]) for i in range(n)]


def by_name(rec):
    out = {}
    for s in rec["spans"]:
        out.setdefault(s["name"], []).append(s)
    return out


def test_off_records_nothing_and_enters_no_profiler_range(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name, *a):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    m = tiny()
    ServeEngine(m, batch=2, max_seq=24, device="cpu").serve(requests(m.cfg.vocab_size), 6)
    assert not trace.active()
    assert trace.span("block.attn", {"layer": 0}) is trace.NULL
    assert trace.span("engine.decode", t=3) is trace.NULL
    rec = trace.collect()
    assert rec == dict(spans=[], counters={}, counts=[], dropped=0) and entered == []


def test_spans_nest_with_parents_and_wave_ids_over_serve():
    m = tiny()
    eng = ServeEngine(m, batch=2, max_seq=24, device="cpu")
    trace.enable()
    eng.serve(requests(m.cfg.vocab_size, max_new=(3, 5), n=4), 6)  # two waves
    rec = trace.collect()
    ids = {s["id"]: s for s in rec["spans"]}
    parent = lambda s: ids[s["parent"]]["name"] if s["parent"] is not None else None
    want = {"engine.prefill": "engine.wave", "model.prefill": "engine.prefill",
            "engine.readback": "engine.wave", "engine.decode": "engine.wave",
            "model.decode_step": "engine.decode", "moe.route": "block.ffn",
            "moe.experts": "block.ffn", "moe.combine": "block.ffn", "engine.wave": None}
    for s in rec["spans"]:
        if s["name"] in want:
            assert parent(s) == want[s["name"]], s
        elif s["name"] in ("block.attn", "block.ffn", "model.unembed"):
            assert parent(s) in ("model.prefill", "model.decode_step"), s
    names = by_name(rec)
    # a decoder opens no latent attention's spans (tests/test_torch_mla.py reads those)
    assert set(names) == set(trace.SPANS) - {n for n in trace.SPANS
                                             if n.startswith(("train.", "mla."))}
    # every counter but the decode kernel's launches, which the CPU makes none of
    assert set(rec["counters"]) == set(trace.COUNTERS) - {"attn.decode_kernel"}
    waves = names["engine.wave"]
    assert [w["attrs"]["uids"] for w in waves] == [[0, 1], [2, 3]]
    assert [w["attrs"]["max_new"] for w in waves] == [[3, 5], [3, 5]]
    for w in waves:  # every span of a wave carries its id
        mine = [s for s in rec["spans"] if s["wave"] == w["wave"]]
        assert all(w["host_start_ns"] <= s["host_start_ns"] <= s["host_end_ns"]
                   <= w["host_end_ns"] for s in mine)
        steps = sorted(s["t"] for s in mine if s["name"] == "engine.decode")
        assert steps == [0, 1, 2, 3]
        assert sorted(s["t"] for s in mine if s["name"] == "engine.readback") == list(range(5))
    assert len({w["wave"] for w in waves}) == 2
    # one block.attn and one block.ffn a layer a call, with its layer and kind
    calls = len(names["model.prefill"]) + len(names["model.decode_step"])
    for kind in ("block.attn", "block.ffn"):
        assert len(names[kind]) == calls * len(m.kinds)
        assert {(s["attrs"]["layer"], s["attrs"]["kind"]) for s in names[kind]} == \
            set(enumerate(m.kinds))
    assert len(names["moe.route"]) == calls * (len(m.kinds) - m.cfg.first_dense_layers)


def test_moe_counters_equal_the_routing_keep_mask():
    """Capacity 8 (the floor) for 2 x 16 tokens top-2 over 8 experts
    (factor 0.5): some assignments drop, and the counters equal the counts
    worked from ``Routing.keep``."""
    m = tiny(capacity_factor=0.5)
    cfg, p = m.cfg, m.layers[1]["moe"]
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        r = L.moe_route(p, x.reshape(1, -1, cfg.d_model), cfg)
        trace.enable()
        L.moe_ffn(p, x, cfg)
    c = trace.collect()["counters"]
    kept = int(r.keep.sum())
    assert r.cap == 8 and kept < r.keep.numel()
    assert c == {"moe.assignments": 2 * 16 * 2, "moe.slots": 8 * 8,
                 "moe.slots_filled": kept, "moe.dropped": r.keep.numel() - kept}


@pytest.mark.parametrize("remat", ["none", "block", "full"])
def test_moe_train_step_counts_each_assignment_once(remat):
    """A train step counts each routed assignment once: under remat the
    MoE's forward runs again inside the backward (its spans nest there),
    and that recompute counts nothing."""
    m = tiny(remat=remat, n_layers=3, capacity_factor=0.5)
    step = make_train_step(m, A.constant_schedule(1e-3), A.AdamWConfig())
    toks = torch.randint(0, m.cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(0))
    trace.enable()
    step(m.train_params(), A.adamw_init(m.train_params(), A.AdamWConfig()),
         dict(tokens=toks, labels=toks))
    rec = trace.collect()
    ids = {s["id"]: s for s in rec["spans"]}

    def home(s):
        while ids[s["parent"]]["name"] not in ("train.forward", "train.backward"):
            s = ids[s["parent"]]
        return ids[s["parent"]]["name"]

    n_moe = len(m.kinds) - m.cfg.first_dense_layers
    homes = sorted(home(s) for s in by_name(rec)["moe.route"])
    assert homes == (["train.backward"] * n_moe if remat != "none" else []) + \
        ["train.forward"] * n_moe
    c = rec["counters"]
    assert c["moe.assignments"] == n_moe * toks.numel() * m.cfg.top_k
    assert c["moe.slots_filled"] + c["moe.dropped"] == c["moe.assignments"]
    assert 0 < c["moe.dropped"] and c["moe.slots_filled"] <= c["moe.slots"]


def test_the_tracer_holds_at_most_limit_spans_and_counts(monkeypatch):
    """Past `LIMIT` spans (pending and collected alike) and `LIMIT` counts,
    what closes is dropped and counted, until `reset`."""
    monkeypatch.setattr(trace, "LIMIT", 5)
    trace.enable()
    for _ in range(3):
        with trace.span("a"):
            pass
        trace.count("moe.slots", 1)
    assert len(trace.collect()["spans"]) == 3
    for _ in range(4):
        with trace.span("b"):
            pass
        trace.count("moe.slots", 1)
    rec = trace.collect()
    assert [s["name"] for s in rec["spans"]] == ["a"] * 3 + ["b"] * 2
    assert rec["counters"] == {"moe.slots": 5} and rec["dropped"] == 2 + 2
    trace.reset()
    with trace.span("c"):
        pass
    rec = trace.collect()
    assert [s["name"] for s in rec["spans"]] == ["c"] and rec["dropped"] == 0


def test_moe_ffn_calls_a_patched_moe_route(monkeypatch):
    seen = []
    route = L.moe_route

    def recording(*args):
        r = route(*args)
        seen.append(r.expert_idx.shape)
        return r

    monkeypatch.setattr(L, "moe_route", recording)
    m = tiny()
    trace.enable()
    with torch.no_grad():
        m.forward(dict(tokens=torch.ones((2, 8), dtype=torch.int64)))
    assert len(seen) == len(m.kinds) - m.cfg.first_dense_layers
    assert len(by_name(trace.collect())["moe.route"]) == len(seen)


def test_engine_calls_the_models_entry_points_by_attribute():
    """A wrapper set on the model (as portbench's serving harness sets one) is
    what the engine calls, inside its own spans."""
    m = tiny("minicpm-2b")
    calls = []
    decode = m.decode_step

    def wrapped(caches, tok, pos):
        calls.append(pos)
        with trace.span("outside"):
            return decode(caches, tok, pos)

    m.decode_step = wrapped
    trace.enable()
    ServeEngine(m, batch=2, max_seq=24, device="cpu").serve(
        requests(m.cfg.vocab_size, max_new=(4,)), 6)
    names = by_name(trace.collect())
    assert calls == [6, 7, 8]
    ids = {s["id"]: s["name"] for v in names.values() for s in v}
    assert [ids[s["parent"]] for s in names["outside"]] == ["engine.decode"] * 3
    assert [ids[s["parent"]] for s in names["model.decode_step"]] == ["outside"] * 3


def test_train_step_spans_and_remat_under_backward():
    m = tiny("minicpm-2b", n_layers=4)
    step = make_train_step(m, A.constant_schedule(1e-3), A.AdamWConfig())
    toks = torch.randint(0, m.cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(0))
    trace.enable()
    step(m.train_params(), A.adamw_init(m.train_params(), A.AdamWConfig()),
         dict(tokens=toks, labels=toks))
    rec = trace.collect()
    ids = {s["id"]: s for s in rec["spans"]}
    names = by_name(rec)
    assert {n for n in names if n.startswith("train.")} == \
        {n for n in trace.SPANS if n.startswith("train.")}
    (top,) = names["train.step"]
    for part in ("train.forward", "train.backward", "train.optimizer"):
        (s,) = names[part]
        assert s["parent"] == top["id"]
    order = [names[p][0]["host_start_ns"] for p in ("train.forward", "train.backward",
                                                    "train.optimizer")]
    assert order == sorted(order)
    homes = {ids[s["parent"]]["name"] for s in names["block.attn"]}
    # the scanned blocks run once in the forward and again in the backward
    assert homes == {"train.forward", "train.backward"}
    assert len(names["block.attn"]) == 2 * len(m.kinds)


def test_a_span_counts_only_if_open_and_closed_while_on():
    with trace.span("opened-off"):
        trace.enable()
    with trace.span("closed-off"):
        with trace.span("inner"):
            pass
        trace.disable()
    trace.count("moe.assignments", 3)  # off: not counted
    rec = trace.collect()
    # the parent closed while off is dropped; its child comes back without it
    assert [(d["name"], d["parent"]) for d in rec["spans"]] == [("inner", None)]
    assert rec["counters"] == {}
    trace.enable()
    with trace.span("across-a-reset"):
        trace.reset()
    assert trace.collect()["spans"] == []


def test_host_stamps_bracket_the_profilers_events():
    """Under a CPU ``torch.profiler``, each span's host start and end
    bracket the profiler's event of the same name, within 200 us: one
    clock (CLOCK_REALTIME) for both."""
    m = tiny("minicpm-2b")
    eng = ServeEngine(m, batch=2, max_seq=24, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("warm-up"):  # a profiled session's first range is slow to open
            pass
        eng.generate(np.ones((2, 6), np.int32), 3)
    rec = trace.collect()
    rec["spans"] = [s for s in rec["spans"] if s["name"] != "warm-up"]
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    assert rec["spans"]
    for name, spans in by_name(rec).items():
        got = sorted(events[name])
        assert len(got) == len(spans), name
        for s, (e0, e1) in zip(sorted(spans, key=lambda s: s["host_start_ns"]), got):
            assert 0 <= e0 - s["host_start_ns"] < 200_000, name
            assert 0 <= s["host_end_ns"] - e1 < 200_000, name


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["minicpm-2b", "deepseek-moe-16b"])
def test_the_tracer_dispatches_no_op_of_its_own(arch):
    """A decode step dispatches the same ops with the tracer on as off (the
    counters hold the ``keep`` mask; `collect` reduces it later)."""
    from repro_torch.serve.engine import align_prefill_caches

    m = tiny(arch)
    with torch.no_grad():
        _, caches = m.prefill(dict(tokens=torch.ones((2, 6), dtype=torch.int64)))
        caches = align_prefill_caches(m, caches, 6, 24, 2)
        tok = torch.ones(2, dtype=torch.int64)
        seen = []
        for on in (False, True):
            (trace.enable if on else trace.disable)()
            with _Ops() as mode:
                m.decode_step(caches, tok, 6)
            seen.append(mode.ops)
    assert seen[0] == seen[1]
    assert trace.collect()["spans"]


def test_export_chrome_writes_spans_and_counters(tmp_path):
    m = tiny()
    trace.enable()
    ServeEngine(m, batch=2, max_seq=24, device="cpu").serve(requests(m.cfg.vocab_size), 6)
    rec = trace.export_chrome(str(tmp_path / "t.json"))
    ev = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    spans = [e for e in ev if e["ph"] == "X"]
    assert len(spans) == len(rec["spans"]) and all(e["cat"] == "host" for e in spans)
    assert {e["ts"] for e in spans} == {d["host_start_ns"] / 1e3 for d in rec["spans"]}
    counters = {e["name"]: e["args"][e["name"]] for e in ev if e["ph"] == "C"}
    assert counters == rec["counters"] and counters["moe.assignments"] > 0


@pytest.mark.parametrize("which", ["serve", "train"])
def test_launchers_trace_out(which, tmp_path, capsys):
    path = tmp_path / f"{which}.json"
    if which == "serve":
        serve_cli.main(["llm", "--device", "cpu", "--preset", "smoke", "--requests", "2",
                        "--batch", "2", "--max-new", "3", "--trace-out", str(path)])
        want = {"engine.wave", "engine.decode", "model.decode_step", "block.attn"}
    else:
        train_cli.main(["--device", "cpu", "--preset", "smoke", "--steps", "2", "--batch", "2",
                        "--seq", "16", "--trace-out", str(path)])
        want = {"train.step", "train.forward", "train.backward", "train.optimizer"}
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"] if e["ph"] == "X"}
    assert want <= names
    assert f"spans to {path}" in capsys.readouterr().out
    assert not trace.active()
