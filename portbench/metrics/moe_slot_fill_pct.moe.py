"""moe_slot_fill_pct.moe: expert buffer slots that hold a kept assignment
(`moe.slots_filled`) over all slots (`moe.slots`: groups x experts x
capacity), over the MoE layers of the profiled decode steps, in %."""

from portbench import spans


def read(rec):
    return spans.counter_pct(rec, "moe.slots_filled", "moe.slots")
