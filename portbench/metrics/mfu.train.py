"""mfu.train: the architecture's ``train_flops`` (the decoder's
`counts.train_flops`: 6 x the matmul weights, the unembedding and causal
attention, recomputation not counted) of every step in the window over its
seconds times 989 TFLOP/s (`readers.train_mfu_pct`)."""

from portbench import readers


def read(rec):
    return readers.train_mfu_pct(rec)
