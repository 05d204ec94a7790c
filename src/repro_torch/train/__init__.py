"""Training: AdamW, the microbatched train step, checkpoints and fault
handling, as the JAX package's ``repro.train``."""
