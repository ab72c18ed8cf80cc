"""Spans and counters inside the port, on the profiler's clock.

The LM path (`serve.engine`, `models.model`, `models.layers.moe_ffn` and
the latent attention, `train.steps`) opens named spans at its layer boundaries and bumps named
counters where the work happens.  Like `runtime.faults`, the module is
strictly a no-op unless it is on, and it is on exactly while

  * a `torch.profiler` session records (``torch.autograd.profiler.
    _is_profiler_enabled``, one module attribute read), or
  * the operator switched it on with `enable` (the launchers'
    ``--trace-out``).

Off, a span site costs one bool test and returns the shared `NULL`
context manager: it allocates nothing, stamps no clock, enters no profiler
range and records no CUDA event (``record_function`` alone costs about
13 us with no profiler running, so it is never entered then).  Sites that
carry attributes pass a dict built once (a layer's ``{layer, kind}``) or
build it only when `active`.

On, a span records its name, its host start and end (``time.time_ns``:
CLOCK_REALTIME, the clock Kineto stamps its CPU events with), its parent
(the innermost span open when it opened), the engine's wave id, its step
``t`` and its attributes.  It counts only if it opened and closed while
the tracer was on: a profiler that starts or stops in the middle of a
span drops it.  Spans are kept in memory and reduced at `collect`.

Beside the host clock, a span is

  * a profiler range of its own name while a profiler records
    (``_RecordFunctionFast``, a function-scope range: it lands in the
    Kineto trace around the launches it made, and, unlike a
    ``record_function`` user scope, adds no ``gpu_user_annotation``
    interval to the device timeline, so the device reductions that read
    that timeline count the same kernels with the tracer as without);
  * on a CUDA process, a pair of timing events on the current stream.
    `collect` synchronizes once, records an anchor event, reads
    ``time.time_ns()`` there, and puts every span's device interval on the
    host clock.  Nothing synchronizes inside the traced stretch.  A device
    interval is the stream time between the span's two events: for a
    card-paced span its device time, for a host-paced one also the card's
    wait for the host.

Counters (`count`) add host ints, or hold a device tensor (the MoE's
``keep`` mask) and reduce it at `collect`, so the tracer launches no
kernel inside the stretch.  A counter counts a forward's work once: a
forward that remat recomputes inside a backward counts nothing.

The tracer holds at most `LIMIT` spans and `LIMIT` counts until `reset`,
pending and collected alike; past that it drops what closes and counts
it in `collect`'s ``dropped``.  So a tracer left on with nobody to
`collect` (a process that runs ``torch.profiler`` for its own ends, a long
``--trace-out`` run) holds a bounded number of CUDA events and tensors.

The spans are those of one thread of Python at a time (the engine's or
the train loop's; autograd's device thread runs while the caller waits in
``autograd.grad``, so a recomputed block nests under ``train.backward``).

`export_chrome` writes what `collect` returns as one Chrome-trace JSON:
host spans, device intervals and counters, with ``ts`` in microseconds of
CLOCK_REALTIME, loadable in Perfetto beside a ``torch.profiler`` trace.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable

import torch
from torch.autograd import profiler as _profiler

#: The span names the program opens (the contract `PERF.md` and the
#: benchmark's per-layer metrics read).
SPANS: dict[str, str] = {
    "engine.wave": "ServeEngine.serve, one wave (attrs: uids, max_new)",
    "engine.prefill": "ServeEngine.generate: Model.prefill and align_prefill_caches",
    "engine.decode": "ServeEngine.generate, one step: Model.decode_step and the sampling",
    "engine.readback": "ServeEngine.generate, one step: the host's wait for its tokens",
    "model.prefill": "Model.prefill",
    "model.decode_step": "Model.decode_step",
    "block.attn": "one layer's norm, mixer and residual add (attrs: layer, kind)",
    "block.ffn": "one layer's norm, MLP or MoE and residual add (attrs: layer, kind)",
    "model.unembed": "the final norm and the unembedding",
    "mla.project": "mla_train / mla_decode: q, the latent and its norm, RoPE, the cache append",
    "mla.attend": ("mla_train: the keys and values expanded, attention; mla_decode: absorbed "
                   "attention over the latent cache (attrs: rows, slots)"),
    "mla.out": "mla_train / mla_decode: W_UV where absorbed, and wo",
    "moe.route": "moe_ffn: the router, top-k and capacity slots",
    "moe.experts": "moe_ffn: the dispatch buffer and the experts",
    "moe.combine": "moe_ffn: the weighted combine and the shared experts",
    "train.step": "make_train_step's step",
    "train.forward": "Model.loss_fn",
    "train.backward": "torch.autograd.grad (remat's recomputed blocks nest here)",
    "train.optimizer": "adamw_update and global_norm",
}

#: The Chrome-trace tracks of `export_chrome` (small ints, apart from the
#: thread ids of a Kineto trace's CPU tracks)
HOST_TID, DEVICE_TID = 1, 2

#: The counter names the program bumps.
COUNTERS: dict[str, str] = {
    "attn.decode_kernel": "launches of the decode attention kernel (CUDA, off a mesh)",
    "moe.assignments": "routed (token, expert) assignments",
    "moe.dropped": "assignments beyond their expert's capacity",
    "moe.slots": "expert buffer slots (groups x experts x capacity)",
    "moe.slots_filled": "slots holding a kept assignment",
}

#: The most spans, and the most counts, held until `reset`.
LIMIT = 1 << 16


class _Null:
    """The shared no-op span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL = _Null()


class _State:
    def __init__(self):
        self.enabled = False
        self.next_id = 0
        self.wave = None
        self.stack: list[_Span] = []
        self.pending: list[_Span] = []
        self.pending_counts: list[tuple] = []
        self.spans: list[dict] = []
        self.counts: list[tuple] = []
        self.totals: dict[str, int] = {}
        self.dropped = 0  # spans and counts past `LIMIT`
        self.events: list = []  # timing events free for reuse
        self.stream = None  # the current CUDA stream, as last seen


def _event():
    """A timing event recorded now on the current stream: one of the pool
    (created once, reused after `collect`), recorded on the stream object
    last seen unless the current stream moved (a raw query, cheaper than
    building a `torch.cuda.Stream` a record)."""
    s = _S
    ev = s.events.pop() if s.events else torch.cuda.Event(enable_timing=True)
    sid, dev, kind = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
    st = s.stream
    if st is None or st.stream_id != sid or st.device_index != dev:
        st = s.stream = torch.cuda.Stream(stream_id=sid, device_index=dev, device_type=kind)
    ev.record(st)
    return ev


_S = _State()


def active() -> bool:
    """Whether a span opened now would count."""
    return _S.enabled or _profiler._is_profiler_enabled


def enable() -> None:
    """Switch the tracer on until `disable` (with or without a profiler)."""
    _S.enabled = True


def disable() -> None:
    _S.enabled = False


def reset() -> None:
    """Drop everything recorded (open spans stay open, and are dropped at
    their close)."""
    global _S
    enabled = _S.enabled
    _S = _State()
    _S.enabled = enabled


def next_wave() -> int:
    """Start a new wave id: the spans that close after this call carry it."""
    _S.wave = 0 if _S.wave is None else _S.wave + 1
    return _S.wave


class _Span:
    __slots__ = ("name", "attrs", "t", "st", "id", "parent", "wave", "t0", "t1", "ev0", "ev1",
                 "rf")

    def __init__(self, name: str, attrs, t):
        self.name, self.attrs, self.t = name, attrs, t

    def __enter__(self):
        s = self.st = _S
        self.id = s.next_id
        s.next_id += 1
        self.parent = s.stack[-1].id if s.stack else None
        s.stack.append(self)
        self.t0 = time.time_ns()
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = torch._C._profiler._RecordFunctionFast(self.name)
            self.rf.__enter__()
        self.ev0 = self.ev1 = None
        if torch.cuda.is_initialized():
            self.ev0 = _event()
        return self

    def __exit__(self, *exc) -> bool:
        if self.ev0 is not None:
            self.ev1 = _event()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None
        self.t1 = time.time_ns()
        s = self.st
        if s.stack and s.stack[-1] is self:
            s.stack.pop()
        elif self in s.stack:
            s.stack.remove(self)
        if s is _S and active():
            if len(s.pending) + len(s.spans) < LIMIT:
                self.wave = s.wave
                s.pending.append(self)
                return False
            s.dropped += 1
        if self.ev0 is not None:
            s.events += (self.ev0, self.ev1)
        return False


def span(name: str, attrs: "dict | None" = None, t: "int | None" = None):
    """A context manager timing ``name`` (``attrs``: small attributes;
    ``t``: the step), or `NULL` when the tracer is off."""
    if not (_S.enabled or _profiler._is_profiler_enabled):
        return NULL
    return _Span(name, attrs, t)


def _local(x):
    """A DTensor's local shard (on a mesh a counter counts this rank's share)."""
    return x.to_local() if hasattr(x, "to_local") else x


def _sum(x) -> int:
    return int(_local(x).sum())


def falses(x) -> int:
    """`count`'s reduction for the entries of a bool mask that are False."""
    x = _local(x)
    return x.numel() - int(x.sum())


def count(name: str, value, reduce: "Callable | None" = None) -> None:
    """Add ``value`` to counter ``name`` while the tracer is on: a host int,
    or a device tensor held and reduced at `collect` (by ``reduce``,
    default its sum).  Inside a backward (remat's recomputed forward) it
    counts nothing."""
    if not (_S.enabled or _profiler._is_profiler_enabled):
        return
    s = _S
    if torch._C._current_graph_task_id() != -1:
        return
    if len(s.pending_counts) + len(s.counts) >= LIMIT:
        s.dropped += 1
        return
    s.pending_counts.append((name, time.time_ns(), value, reduce))


def collect() -> dict:
    """Everything recorded since the last `reset`, reduced: ``spans`` (each
    a dict of ``id, name, parent, wave, t, attrs, host_start_ns,
    host_end_ns, host_ms`` and, on CUDA, ``device_start_ns, device_end_ns,
    device_ms``), ``counters`` (totals by name) and ``counts`` (``(name,
    time_ns, value)`` per increment) and ``dropped`` (spans and counts
    past `LIMIT`).  Synchronizes once where spans hold
    CUDA events; safe to call repeatedly."""
    s = _S
    pending, s.pending = s.pending, []
    anchor = t_anchor = None
    if any(p.ev0 is not None for p in pending):
        torch.cuda.synchronize()
        anchor = _event()
        t_anchor = time.time_ns()
        anchor.synchronize()
    for p in pending:
        d = dict(id=p.id, name=p.name, parent=p.parent, wave=p.wave, t=p.t,
                 attrs=dict(p.attrs) if p.attrs else {}, host_start_ns=p.t0, host_end_ns=p.t1,
                 host_ms=(p.t1 - p.t0) / 1e6)
        if anchor is not None and p.ev0 is not None:
            d["device_start_ns"] = t_anchor - round(p.ev0.elapsed_time(anchor) * 1e6)
            d["device_end_ns"] = t_anchor - round(p.ev1.elapsed_time(anchor) * 1e6)
            d["device_ms"] = p.ev0.elapsed_time(p.ev1)
            s.events += (p.ev0, p.ev1)
        s.spans.append(d)
    if anchor is not None:
        s.events.append(anchor)
    counts, s.pending_counts = s.pending_counts, []
    for name, ts, value, reduce in counts:
        v = value if isinstance(value, int) else (reduce or _sum)(value)
        s.counts.append((name, ts, v))
        s.totals[name] = s.totals.get(name, 0) + v
    ids = {d["id"] for d in s.spans}
    spans = [d if d["parent"] is None or d["parent"] in ids else {**d, "parent": None}
             for d in s.spans]
    return dict(spans=spans, counters=dict(s.totals), counts=list(s.counts), dropped=s.dropped)


def _chrome_events(record: dict) -> list[dict]:
    """`collect`'s record as Chrome-trace events (``ts`` and ``dur`` in
    microseconds of CLOCK_REALTIME) in this process: host spans on one
    track, device intervals on another, each counter's running total."""
    pid = os.getpid()
    ev = [dict(ph="M", name="thread_name", pid=pid, tid=tid, args=dict(name=name))
          for tid, name in ((HOST_TID, "repro_torch spans (host)"),
                            (DEVICE_TID, "repro_torch spans (device)"))]
    for d in record["spans"]:
        args = dict(d["attrs"], id=d["id"], parent=d["parent"], wave=d["wave"], t=d["t"])
        ev.append(dict(ph="X", name=d["name"], cat="host", pid=pid, tid=HOST_TID,
                       ts=d["host_start_ns"] / 1e3,
                       dur=(d["host_end_ns"] - d["host_start_ns"]) / 1e3, args=args))
        if "device_start_ns" in d:
            ev.append(dict(ph="X", name=d["name"], cat="device", pid=pid, tid=DEVICE_TID,
                           ts=d["device_start_ns"] / 1e3, dur=d["device_ms"] * 1e3, args=args))
    run: dict[str, int] = {}
    for name, ts, v in record["counts"]:
        run[name] = run.get(name, 0) + v
        ev.append(dict(ph="C", name=name, pid=pid, ts=ts / 1e3, args={name: run[name]}))
    return ev


def export_chrome(path: str) -> dict:
    """`collect`, then write the Chrome-trace JSON to ``path``; returns the
    record."""
    record = collect()
    with open(path, "w") as f:
        json.dump(dict(traceEvents=_chrome_events(record), displayTimeUnit="ms"), f)
    return record
