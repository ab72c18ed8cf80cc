"""Plain float32 reference of the benchmark: one module an architecture,
named as the architecture is (`decoder`: forward, served logits), and
`train` (loss, gradients, AdamW).  It imports no part of the program and
loads no architecture module."""
