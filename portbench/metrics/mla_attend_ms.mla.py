"""mla_attend_ms.mla: device ms a decode step spends inside the program's
`mla.attend` spans (the absorbed attention over the latent cache: the
query taken into the latent space, the scores over every slot up to the
step's, the softmax and the weighted sum of latents), summed over the
layers, mean over the profiled decode steps (`model.decode_step` spans):
device intervals (`spans`).  It moves `output_tokens_per_s.moe` in the
latent-attention serving cell.

Read under the profiler, which slows the host until it paces the step:
the interval then takes in the card's wait for the host (`spans`), so
it places time in the program but is no evidence of a faster layer
until the stretch it reads runs without the profiler.  A program
without latent attention has no such span, and the reader finds
nothing."""

from portbench import spans


def read(rec):
    return spans.device_ms_per(rec, "mla.attend", "model.decode_step")
