"""device_idle_pct.serve: 1 - the union of device intervals over the
profiled stretch of decode steps (torch.profiler), in %."""

from portbench import readers


def read(rec):
    return readers.idle_pct(rec)
