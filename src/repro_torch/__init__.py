"""repro_torch: the COPIFT system ported to PyTorch and hand-written CUDA
kernels for an NVIDIA H100.

The JAX package ``repro`` beside it is the reference the port is held
against; ``repro_torch`` imports neither JAX nor ``repro``.  It trains
(``train``, ``data``, ``launch.train``) and serves (``serve.engine``,
``launch.serve``) dense decoder models through the COPIFT softmax, exp and
PRNG kernels (``kernels``), and runs the paper's kernels through the facade
(``api``).
"""
