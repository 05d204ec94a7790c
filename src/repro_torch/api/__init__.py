"""``repro_torch.api`` — the port's public front door, as ``repro.api``.

* :class:`KernelSpec` — *what* runs: one registry object per kernel binding
  its ISA schedule, tunable workload, entry point and plain oracle
  (``kernel("softmax")``; ``register_kernel`` for user kernels).
  ``kernel(name).run(...)`` reaches the port's entry points in
  ``kernels.ops``, which launch the CUDA kernels on the card.
* :class:`Target` — *where* it runs in the analytic model: cluster shape x
  DVFS point(s) x scheduling strategy x power cap; ``Target.system(...)``
  attaches a :class:`SystemConfig` (N clusters behind an interconnect and
  a shared HBM, ``repro_torch.system``).
* :class:`Report` — *what happened*: the one result dataclass
  :func:`evaluate` returns.

Plus the verbs :func:`evaluate`, :func:`sweep`, :func:`compare_strategies`,
:func:`headline`, :class:`Tuner` (plan, block, operating-point and
cluster-count searches sharing one cache and one batched cost oracle, and
the attribution of a tuned plan's speedup), :func:`default_tuner` and
:func:`config`.  Every ``Report`` and every tuner result equals the JAX
package's bit for bit.  The fault model (ROADMAP §1 item 3e) is not ported
yet.
"""

from repro_torch.api.evaluate import (compare_strategies, evaluate, headline,
                                      sweep)
from repro_torch.api.registry import (KernelSpec, kernel, kernels,
                                      register_kernel, specs)
from repro_torch.api.report import Report, ReportMetrics
from repro_torch.api.runtime import config
from repro_torch.api.target import Target
from repro_torch.api.tuner import Tuner

# Re-exported building blocks: the static cluster/system vocabulary a
# Target is built from.
from repro_torch.cluster.topology import (NOMINAL_POINT, OPERATING_POINTS,
                                          SNITCH_CLUSTER, ClusterConfig,
                                          DvfsIsland, OperatingPoint,
                                          parse_islands)
from repro_torch.system.topology import SystemConfig, parse_system

_DEFAULT_TUNER: "Tuner | None" = None


def default_tuner() -> Tuner:
    """The shared process-wide :class:`Tuner` (default target, persistent
    cache) — what the ``kernels.ops`` tiling defaults and
    ``copift.make_plan(tune=True)`` consult, so every consumer hits one
    cache and one cost oracle."""
    global _DEFAULT_TUNER
    if _DEFAULT_TUNER is None:
        _DEFAULT_TUNER = Tuner()
    return _DEFAULT_TUNER

__all__ = [
    "KernelSpec", "kernel", "kernels", "register_kernel", "specs",
    "Target", "Report", "ReportMetrics",
    "evaluate", "sweep", "compare_strategies", "headline",
    "Tuner", "default_tuner", "config",
    "NOMINAL_POINT", "OPERATING_POINTS", "SNITCH_CLUSTER", "ClusterConfig",
    "DvfsIsland", "OperatingPoint", "parse_islands",
    "SystemConfig", "parse_system",
]
