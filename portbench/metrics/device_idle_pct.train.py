"""device_idle_pct.train: 1 - the union of device intervals over the
profiled train step (torch.profiler), in %."""

from portbench import readers


def read(rec):
    return readers.idle_pct(rec)
