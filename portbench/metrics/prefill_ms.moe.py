"""prefill_ms.moe: `prefill_ms.serve` in the MoE serving cell
(it moves `output_tokens_per_s.moe`)."""

from portbench import readers


def read(rec):
    return readers.prefill_ms(rec)
