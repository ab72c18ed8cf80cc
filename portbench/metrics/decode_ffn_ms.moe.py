"""decode_ffn_ms.moe: `decode_ffn_ms.serve` in the MoE serving cell: the
MoE layers' routing, experts and combine, and the first layer's dense MLP.

Read under the profiler, which slows the host until it paces the step:
the interval then takes in the card's wait for the host (`spans`), so
it places time in the program but is no evidence of a faster layer
until the stretch it reads runs without the profiler."""

from portbench import spans


def read(rec):
    return spans.device_ms_per(rec, "block.ffn", "model.decode_step")
