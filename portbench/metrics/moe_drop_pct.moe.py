"""moe_drop_pct.moe: routed assignments beyond their expert's capacity
(`moe.dropped`) over all assignments (`moe.assignments`), over the MoE
layers of the profiled decode steps, in %."""

from portbench import spans


def read(rec):
    return spans.counter_pct(rec, "moe.dropped", "moe.assignments")
