"""slot_waste_pct.moe: `slot_waste_pct.serve` in the MoE serving cell
(it moves `output_tokens_per_s.moe`)."""

from portbench import readers


def read(rec):
    return readers.slot_waste_pct(rec)
