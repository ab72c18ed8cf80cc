"""readback_wait_ms.moe: `readback_wait_ms.serve` in the MoE serving cell
(near 0 where the host paces the step).

Read under the profiler, which slows the host: it places the host's
wait but is no evidence of a changed one until the stretch it reads
runs without the profiler."""

from portbench import spans


def read(rec):
    return spans.host_ms(rec, "engine.readback")
