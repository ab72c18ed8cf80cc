"""decode_device_ms.moe: `decode_device_ms.serve` in the MoE serving cell
(it moves `output_tokens_per_s.moe`)."""

from portbench import readers


def read(rec):
    return readers.device_ms_per_step(rec)
