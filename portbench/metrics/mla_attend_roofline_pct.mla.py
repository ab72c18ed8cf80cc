"""mla_attend_roofline_pct.mla: the latent attention's share of its
roofline in the profiled decode steps.  The least time is the latent
slots each `mla.attend` span reads (its ``rows`` times its ``slots``,
every slot up to the step's, the left pads included, as the program
attends them), each read once at 3.35 TB/s (`archs/mla.py`'s
``latent_bytes``: the 512-wide latent and the 64-wide rotary key in
bfloat16), summed over the layers and steps; over the spans' device ms
inside `model.decode_step` (`mla_attend_ms.mla`'s intervals).  The
yardstick of a decode kernel for latent attention; it moves
`output_tokens_per_s.moe`.

Like the other span metrics it reads the profiled host's pace: an
interval takes in the card's wait for the host (`spans`), so the share
is a floor of the kernels' own.  Where the program has no such span, or
the architecture no ``latent_bytes``, the reader finds nothing."""

from portbench import arch, counts, spans


def read(rec):
    got = spans.reading(rec)
    if got is None or "arch" not in rec:
        return None
    a = rec["arch"]
    latent_bytes = getattr(arch.module(a), "latent_bytes", None)
    sp = got["spans"]
    inner = [s for s, step in zip(sp, spans._under(sp, "model.decode_step").values())
             if s["name"] == "mla.attend" and step is not None]
    if latent_bytes is None or not inner or any("device_ms" not in s for s in inner):
        return None
    least = sum(latent_bytes(a, s["attrs"]["rows"], s["attrs"]["slots"], layers=1)
                for s in inner) / counts.HBM_BYTES_PER_S
    return 100.0 * least / (sum(s["device_ms"] for s in inner) / 1e3)
