"""Device traces of a short steady stretch of a traced run, reduced to
what the per-layer metrics and the result's ``device`` and ``breakdown``
read.

`Window` wraps `torch.profiler` (CPU and CUDA activity) around a stretch
that starts and ends with the device idle (synchronized), then reads the
raw Kineto events: every device activity (kernels, copies, sets) as an
interval, and the host's ATen ops.  ``busy_s`` is the union of the device
intervals; ``window_s`` runs from the first host event of the stretch to
the end of its last event, host or device.  An idle gap between device
intervals is put down to the ATen op the host began last before the gap
closed: the op whose launch the device was waiting for.
"""

from __future__ import annotations

import bisect
import collections


def _cuda() -> bool:
    import torch

    return torch.cuda.is_available()


def _sync() -> None:
    import torch

    if _cuda():
        torch.cuda.synchronize()


class Window:
    def __init__(self):
        self.prof = None
        self.running = False
        self.steps = 0
        self.result = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        _sync()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if _cuda() else [])
        self.prof = profile(activities=acts)
        self.prof.start()
        self.running = True

    def stop(self) -> None:
        """End the stretch (a no-op when it is not running)."""
        if self.running:
            _sync()
            self.prof.stop()
            self.running = False

    def reduce(self) -> dict:
        """Read the trace once (after the measured window has closed)."""
        if self.result is None and self.prof is not None:
            self.stop()
            self.result = reduce_events(self.prof.profiler.kineto_results.events(), self.steps)
            self.prof = None
        return self.result or dict(n_device_ops=0, steps=0)


def reduce_events(events, steps: int) -> dict:
    dev, host = [], []
    for e in events:
        kind = str(e.device_type())
        start, dur = e.start_ns(), e.duration_ns()
        if kind.endswith("CUDA"):
            dev.append((start, start + dur, e.name()))
        elif kind.endswith("CPU"):
            host.append((start, start + dur, e.name()))
    if not dev:
        return dict(n_device_ops=0, steps=steps)
    dev.sort()
    lo = min(min(s for s, _, _ in host) if host else dev[0][0], dev[0][0])
    hi = max(max(e for _, e, _ in host) if host else 0, max(e for _, e, _ in dev))
    by_name = collections.Counter()
    for s, e, n in dev:
        by_name[n] += (e - s) * 1e-9
    # the union of device intervals and the gaps between its runs
    busy, gaps = 0, []
    cur_s, cur_e = dev[0][0], dev[0][1]
    for s, e, _ in dev[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    aten = sorted((s, n) for s, _, n in host if n.startswith("aten::"))
    starts = [s for s, _ in aten]
    by_host = collections.Counter()
    for g0, g1 in gaps:
        i = bisect.bisect_right(starts, g1) - 1
        by_host[aten[i][1] if i >= 0 else "host"] += (g1 - g0) * 1e-9
    return dict(
        n_device_ops=len(dev),
        n_kernels=sum(not n.startswith(("Memcpy", "Memset")) for _, _, n in dev),
        device_s=sum(e - s for s, e, _ in dev) * 1e-9,
        busy_s=busy * 1e-9,
        window_s=(hi - lo) * 1e-9,
        steps=steps,
        device_ops=[[n[:160], s] for n, s in by_name.most_common(10)],
        idle_gaps=[[n[:160], s] for n, s in by_host.most_common(10)],
    )
