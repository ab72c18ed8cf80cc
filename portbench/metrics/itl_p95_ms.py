"""itl_p95_ms: the 95th percentile of the gaps between consecutive output
tokens of a request, over every token of every request in the window
(host clock: when the engine has read each token back)."""

from portbench import readers


def read(rec):
    return readers.p95(rec.get("token_gaps_ms"))
