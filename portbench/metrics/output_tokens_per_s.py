"""output_tokens_per_s: every output token read back on the host in the
window (each request's first, from prefill, included; none past its
max_new), over the window's seconds (host clock)."""

from portbench import readers


def read(rec):
    return readers.per_second(rec, "tokens_out")
