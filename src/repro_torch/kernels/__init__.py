"""Hand-written CUDA kernels for the COPIFT exp, log, softmax, PRNG and
Monte-Carlo integration.

Layout (per kernel): ``csrc/<name>.cu`` holds the kernel and its C
launcher, ``<name>.py`` the wrapper that launches it and the plain PyTorch
version beside it, ``ops.py`` the public entry points with impl dispatch,
``ref.py`` the shared constants and oracles, ``_build.py`` the nvcc build
and the ctypes binding.  The entry points are reached as ``kernels.ops.*``:
re-exporting ``ops.softmax`` here would hide the ``kernels.softmax`` module.
"""
