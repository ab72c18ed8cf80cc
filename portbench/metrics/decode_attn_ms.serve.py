"""decode_attn_ms.serve: device ms a decode step spends inside the program's
`block.attn` spans (each layer's norm, attention and residual add), summed
over the layers, mean over the profiled decode steps (`model.decode_step`
spans): device intervals (`spans`).

Read under the profiler, which slows the host until it paces the step:
the interval then takes in the card's wait for the host (`spans`), so
it places time in the program but is no evidence of a faster layer
until the stretch it reads runs without the profiler."""

from portbench import spans


def read(rec):
    return spans.device_ms_per(rec, "block.attn", "model.decode_step")
