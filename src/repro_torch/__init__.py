"""repro_torch: the COPIFT system ported to PyTorch and hand-written CUDA
kernels for an NVIDIA H100.

The JAX package ``repro`` beside it is the reference the port is held
against; ``repro_torch`` imports neither JAX nor ``repro``.  This slice
serves dense decoder models (``serve.engine``, ``launch.serve``) through the
COPIFT softmax, exp and PRNG kernels (``kernels``).
"""
