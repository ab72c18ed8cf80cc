"""mfu.train: `counts.train_flops` (6 x the matmul weights, the
unembedding and causal attention, recomputation not counted) of every step
in the window over its seconds times 989 TFLOP/s."""

from portbench import counts


def read(rec):
    if not rec.get("steps"):
        return None
    flops = rec["steps"] * counts.train_flops(rec["arch"], rec["batch"], rec["seq"])
    return 100.0 * flops / (rec["window_s"] * counts.BF16_FLOPS)
