"""output_tokens_per_s.moe: `output_tokens_per_s` in the MoE serving cell,
whose host dispatches a step about as fast as the card runs it, so that its
runs spread too widely to share that metric's bound."""

from portbench import readers


def read(rec):
    return readers.per_second(rec, "tokens_out")
