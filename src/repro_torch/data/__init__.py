"""The synthetic token pipeline, as the JAX package's ``repro.data``."""
