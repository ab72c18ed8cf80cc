"""mfu.serve: the operations the window's requests asked for
(`readers.serve_window_flops`: prompts unpadded, decode tokens of live
requests only) over the window's seconds times 989 TFLOP/s."""

from portbench import readers


def read(rec):
    return readers.serve_mfu_pct(rec)
