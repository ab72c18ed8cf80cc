"""kernels_per_decode.serve: CUDA kernels a profiled decode step launches
(copies and sets apart), mean over the profiled steps."""

from portbench import readers


def read(rec):
    return readers.kernels_per_step(rec)
