"""readback_wait_ms.serve: host ms the engine waits in a decode step for
the card's tokens (`engine.readback` spans, mean over the profiled
stretch).  Under the profiler the host dispatches more slowly, so it reads
lower there than in a plain run.

Read under the profiler, which slows the host: it places the host's
wait but is no evidence of a changed one until the stretch it reads
runs without the profiler."""

from portbench import spans


def read(rec):
    return spans.host_ms(rec, "engine.readback")
