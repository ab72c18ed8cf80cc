"""decode_device_ms.serve: device time (kernels, copies, sets) summed over a
profiled decode step, mean over the profiled steps (torch.profiler)."""

from portbench import readers


def read(rec):
    return readers.device_ms_per_step(rec)
