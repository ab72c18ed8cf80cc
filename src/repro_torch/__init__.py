"""PyTorch/CUDA port of the rCiM exploration system (the JAX package
`repro` is the reference)."""
