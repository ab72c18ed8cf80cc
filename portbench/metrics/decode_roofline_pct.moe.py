"""decode_roofline_pct.moe: `decode_roofline_pct.serve` in the MoE serving cell
(it moves `output_tokens_per_s.moe`)."""

from portbench import readers


def read(rec):
    return readers.decode_roofline_pct(rec)
