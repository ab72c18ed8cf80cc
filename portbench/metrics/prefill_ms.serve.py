"""prefill_ms.serve: the synchronized span around `Model.prefill` in
the traced run's extra wave, after the window (host clock)."""

from portbench import readers


def read(rec):
    return readers.prefill_ms(rec)
