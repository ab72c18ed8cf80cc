"""train_tokens_per_s: tokens trained in the window over its seconds; each
step ends with the read-back of its loss (host clock)."""

from portbench import readers


def read(rec):
    return readers.per_second(rec, "tokens_trained")
