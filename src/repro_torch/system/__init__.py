"""repro_torch.system — the manycore part: clusters x interconnect x HBM;
the port's copy of the JAX package's ``repro.system``.

Composes N :class:`~repro_torch.cluster.topology.ClusterConfig`\\ s behind a
shared HBM interface (the Occamy shape of the Snitch lineage, Zaruba et
al. 2020):

* ``topology``  — :class:`SystemConfig` + the ``"4x8c,hbm=256"`` spec
  grammar (:func:`parse_system`);
* ``noc``       — inter-cluster DMA contention: concurrent streams
  water-fill the HBM bandwidth, saturating once aggregate demand exceeds
  it;
* ``scheduler`` — hierarchical blocks → clusters → cores assignment,
  reusing ``cluster.scheduler`` strategies at both levels;
* ``analytics`` — :func:`evaluate_system` returning the standard
  :class:`~repro_torch.api.Report` (a 1-cluster unconstrained system reduces
  bit-for-bit to ``api.evaluate``), plus the tuner's cluster-count knob
  (:func:`select_system_point`).

The front door is the facade: ``api.Target.system(...)`` +
``api.evaluate`` route here automatically, and
``api.Tuner.operating_point(n_clusters=...)`` searches the cluster count.
Plain Python on the host, like the rest of the analytic model.
"""

from repro_torch.system.analytics import (SystemPoint, evaluate_system,
                                          select_system_point, system_cost)
from repro_torch.system.noc import (fair_shares, hbm_roofline_cycles,
                                    is_saturated, system_transfer_cycles)
from repro_torch.system.scheduler import SystemAssignment, assign_system
from repro_torch.system.topology import (DEFAULT_SYSTEM, SystemConfig,
                                         parse_system)

__all__ = [
    "DEFAULT_SYSTEM", "SystemAssignment", "SystemConfig", "SystemPoint",
    "assign_system", "evaluate_system", "fair_shares",
    "hbm_roofline_cycles", "is_saturated", "parse_system",
    "select_system_point", "system_cost", "system_transfer_cycles",
]
