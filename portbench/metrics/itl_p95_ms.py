"""itl_p95_ms: the 95th percentile of the gaps between consecutive output
tokens of a request, over every token of every request in the window
(host clock: when the engine has read each token back).  Read in a traced
run's window (which runs as a plain run's does), as a per-layer metric:
the decode step is paced by the host's dispatch, whose pace over a few
seconds sways this tail by more than half of any bound the check allows."""

from portbench import readers


def read(rec):
    return readers.p95(rec.get("token_gaps_ms"))
