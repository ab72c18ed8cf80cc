"""The program's own spans and counters (`repro_torch.runtime.trace`), as the
per-layer metrics that read them see them.

The program's tracer is on while `torch.profiler` records, so in a traced
run it sees the profiled stretch: decode steps 8-15 of a serving cell's
extra wave, a training cell's extra step.  The first reader of a run's
record collects what the tracer saw and resets it, so that each run reads
its own stretch; every reader of that record gets the same reading.  Where
the program has no tracer (a checkout older than it) or the tracer saw
nothing, the readers return None.

A span's device interval is the stream time between its two CUDA events:
for a card-paced span its device time, for a host-paced one also the
card's wait for the host.  A run on the CPU has none.  The profiler slows
the host until it often paces the step (a decode step's `block.attn` read
126-164 ms under it against 110 without, on an H100), so the device
intervals and the host waits read here place time in the program but are
no evidence of a faster layer; the counters are unaffected.
"""

from __future__ import annotations

_last: list = [None, None]  # the record last read, and its reading


def reading(rec: dict):
    """``trace.collect()``'s result for this run's record, or None."""
    if _last[0] is rec:
        return _last[1]
    try:
        from repro_torch.runtime import trace
    except ImportError:
        got = None
    else:
        got = trace.collect()
        trace.reset()
        if not got["spans"] and not got["counters"]:
            got = None
    _last[:] = [rec, got]
    return got


def _under(spans: list[dict], names: str) -> dict:
    """Each span's id -> the id of its nearest ancestor named ``names``
    (or None)."""
    by_id = {s["id"]: s for s in spans}
    out = {}
    for s in spans:
        p = s["parent"]
        while p is not None and by_id[p]["name"] != names:
            p = by_id[p]["parent"]
        out[s["id"]] = p
    return out


def device_ms_per(rec: dict, name: str, per: str):
    """Device ms of the ``name`` spans inside ``per`` spans, summed, over the
    number of ``per`` spans (a mean a step)."""
    got = reading(rec)
    if got is None:
        return None
    spans = got["spans"]
    steps = [s for s in spans if s["name"] == per]
    inner = [s for s, a in zip(spans, _under(spans, per).values())
             if s["name"] == name and a is not None]
    if not steps or not inner or any("device_ms" not in s for s in inner):
        return None
    return sum(s["device_ms"] for s in inner) / len(steps)


def host_ms(rec: dict, name: str):
    """Mean host ms of the ``name`` spans."""
    got = reading(rec)
    if got is None:
        return None
    ms = [s["host_ms"] for s in got["spans"] if s["name"] == name]
    return sum(ms) / len(ms) if ms else None


def counter_pct(rec: dict, part: str, whole: str):
    """100 x counter ``part`` over counter ``whole``."""
    got = reading(rec)
    if got is None:
        return None
    c = got["counters"]
    if part not in c or not c.get(whole):
        return None
    return 100.0 * c[part] / c[whole]
