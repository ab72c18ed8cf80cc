"""kernels_per_step.train: CUDA kernels the profiled train step launches
(copies and sets apart)."""

from portbench import readers


def read(rec):
    return readers.kernels_per_step(rec)
