"""step_device_ms.train: device time (kernels, copies, sets) summed over the
profiled train step (torch.profiler)."""

from portbench import readers


def read(rec):
    return readers.device_ms_per_step(rec)
