"""device_idle_pct.moe: `device_idle_pct.serve` in the MoE serving cell
(it moves `output_tokens_per_s.moe`)."""

from portbench import readers


def read(rec):
    return readers.idle_pct(rec)
