"""mfu.moe: `mfu.serve` in the MoE serving cell
(it moves `output_tokens_per_s.moe`)."""

from portbench import readers


def read(rec):
    return readers.serve_mfu_pct(rec)
