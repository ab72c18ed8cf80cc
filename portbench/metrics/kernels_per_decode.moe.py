"""kernels_per_decode.moe: `kernels_per_decode.serve` in the MoE serving cell
(it moves `output_tokens_per_s.moe`)."""

from portbench import readers


def read(rec):
    return readers.kernels_per_step(rec)
