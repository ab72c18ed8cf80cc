"""The per-layer metrics that read the program's own spans and counters
(`spans`, over ``repro_torch.runtime.trace``), on the CPU: each returns None
where nothing was traced or the program has no tracer, and its number from
a synthetic reading; a run's reading is taken once and scoped to that run."""

import sys

import pytest
import torch

from portbench import harness, spans
from repro_torch.runtime import trace

METRICS = {  # name -> its value over `_synthetic`
    "decode_attn_ms.serve": 3.5, "decode_attn_ms.moe": 3.5,
    "decode_ffn_ms.serve": 0.75, "decode_ffn_ms.moe": 0.75,
    "readback_wait_ms.serve": 3.0, "readback_wait_ms.moe": 3.0,
    "moe_slot_fill_pct.moe": 75.0, "moe_drop_pct.moe": 6.25,
    "train_forward_ms.train": 10.0, "train_backward_ms.train": 20.0,
    "train_optimizer_ms.train": 5.0,
}


@pytest.fixture(autouse=True)
def _clean_tracer():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _span(i, name, parent, device_ms=0.0, host_ms=0.0):
    return dict(id=i, name=name, parent=parent, wave=0, t=None, attrs={}, host_start_ns=0,
                host_end_ns=int(host_ms * 1e6), host_ms=host_ms, device_start_ns=0,
                device_end_ns=int(device_ms * 1e6), device_ms=device_ms)


def _synthetic():
    """Two decode steps (attn 3 + 4 ms, ffn 1 + 0.5 ms; a prefill's block
    outside them), two read-backs (2 and 4 ms on the host), one train step
    (forward 10, backward 20 with a recomputed block in it, optimizer 5),
    and the MoE's counters."""
    s = [_span(0, "model.prefill", None, 50), _span(1, "block.attn", 0, 40),
         _span(2, "engine.decode", None, 9), _span(3, "model.decode_step", 2, 8),
         _span(4, "block.attn", 3, 3), _span(5, "block.ffn", 3, 1),
         _span(6, "moe.route", 5, 0.2), _span(7, "model.unembed", 3, 0.3),
         _span(8, "engine.readback", None, host_ms=2), _span(9, "model.decode_step", None, 5),
         _span(10, "block.attn", 9, 4), _span(11, "block.ffn", 9, 0.5),
         _span(12, "engine.readback", None, host_ms=4),
         _span(13, "train.step", None, 40), _span(14, "train.forward", 13, 10),
         _span(15, "block.attn", 14, 2), _span(16, "train.backward", 13, 20),
         _span(17, "block.attn", 16, 2), _span(18, "train.optimizer", 13, 5)]
    counters = {"moe.slots": 100, "moe.slots_filled": 75, "moe.assignments": 80,
                "moe.dropped": 5}
    return dict(spans=s, counters=counters, counts=[])


@pytest.mark.parametrize("name", sorted(METRICS))
def test_reader_returns_none_with_nothing_traced(name):
    assert harness.metric(name).read({}) is None


@pytest.mark.parametrize("name", sorted(METRICS))
def test_reader_reads_a_synthetic_collect(name, monkeypatch):
    monkeypatch.setattr(trace, "collect", _synthetic)
    assert harness.metric(name).read({}) == pytest.approx(METRICS[name])


def test_readers_return_none_without_the_programs_tracer(monkeypatch):
    """A checkout older than the tracer: the import fails, nothing is read."""
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.trace", None)
    assert all(harness.metric(n).read({}) is None for n in METRICS)


def test_a_runs_reading_is_taken_once_and_scoped_to_that_run():
    first, second = {}, {}
    trace.enable()
    with trace.span("engine.readback"):
        pass
    assert spans.host_ms(first, "engine.readback") is not None
    with trace.span("model.decode_step"):  # after the first run's reading
        pass
    got = spans.reading(first)
    assert [s["name"] for s in got["spans"]] == ["engine.readback"]
    assert spans.host_ms(second, "engine.readback") is None
    assert [s["name"] for s in spans.reading(second)["spans"]] == ["model.decode_step"]


def test_device_metrics_need_device_intervals():
    """On the CPU the spans have no device interval: the device metrics
    read nothing, the host's and the counters' do."""
    trace.enable()
    with trace.span("model.decode_step"):
        with trace.span("block.attn"):
            pass
    trace.count("moe.slots", 10)
    trace.count("moe.slots_filled", torch.tensor([True, False, True]))
    rec = {}
    assert harness.metric("decode_attn_ms.serve").read(rec) is None
    assert harness.metric("moe_slot_fill_pct.moe").read(rec) == pytest.approx(20.0)
