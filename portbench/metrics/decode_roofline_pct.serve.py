"""decode_roofline_pct.serve: the least time of the traced run's
synchronized decode steps (`counts`: the larger of bytes over 3.35 TB/s and
operations over 989 TFLOP/s, for the requests still live in each step, at
the positions they attend, unpadded; an MoE layer reads the experts their
tokens reach, as recorded) over the steps' spans (host clock)."""

from portbench import readers


def read(rec):
    return readers.decode_roofline_pct(rec)
