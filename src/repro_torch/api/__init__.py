"""``repro_torch.api`` — the port's public front door, as ``repro.api``.

This slice ports the kernel half of the facade: :class:`KernelSpec` and
its registry (``kernel``, ``kernels``, ``specs``, ``register_kernel``)
and the scoped :func:`config`.  ``kernel(name).run(...)`` reaches the
port's entry points in ``kernels.ops``, which launch the CUDA kernels on
the card.  ``evaluate``, ``Target``, ``Tuner`` and ``Report`` come with the
analytic model (ROADMAP §1 item 3).
"""

from repro_torch.api.registry import (KernelSpec, kernel, kernels,
                                      register_kernel, specs)
from repro_torch.api.runtime import config

__all__ = ["KernelSpec", "kernel", "kernels", "register_kernel", "specs",
           "config"]
