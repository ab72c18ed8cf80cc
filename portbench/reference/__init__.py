"""Plain float32 reference of the benchmark: `decoder` (forward, served
logits) and `train` (loss, gradients, AdamW).  It imports no part of the
program."""
