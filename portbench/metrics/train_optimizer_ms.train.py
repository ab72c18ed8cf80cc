"""train_optimizer_ms.train: the device interval of `train.optimizer`
(the eager AdamW and the gradients' global norm) in the profiled train
step.

Read under the profiler, which slows the host until it paces the step:
the interval then takes in the card's wait for the host (`spans`), so
it places time in the program but is no evidence of a faster layer
until the stretch it reads runs without the profiler."""

from portbench import spans


def read(rec):
    return spans.device_ms_per(rec, "train.optimizer", "train.step")
