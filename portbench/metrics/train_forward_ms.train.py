"""train_forward_ms.train: the device interval of the program's
`train.forward` span (`Model.loss_fn`) in the profiled train step; the
step is host-paced in part, so it holds the card's wait for the host.

Read under the profiler, which slows the host until it paces the step:
the interval then takes in the card's wait for the host (`spans`), so
it places time in the program but is no evidence of a faster layer
until the stretch it reads runs without the profiler."""

from portbench import spans


def read(rec):
    return spans.device_ms_per(rec, "train.forward", "train.step")
