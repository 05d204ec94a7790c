"""Cluster-scale COPIFT — the paper's single-PE models composed into a
multi-core Snitch cluster (shared banked TCDM, one DMA engine, DVFS); the
port's copy of the JAX package's ``repro.cluster``.

Layer map (mirrors ``repro_torch.core``'s):

* ``topology``    — ``ClusterConfig`` / ``OperatingPoint``: cores, TCDM
  banks, DMA width, the DVFS ladder (Snitch cluster defaults)
* ``contention``  — inter-core TCDM bank-conflict surcharge, fed through
  ``core.timing``'s ``extra_contention`` hook
* ``dma``         — double-buffered cluster L1 refill overlapped against
  compute (``max(compute, transfer)``, never the sum)
* ``scheduler``   — static work partitioning: homogeneous block-cyclic plus
  the weighted ``assign`` strategies (static-proportional, LPT) for
  heterogeneous cores
* ``dvfs``        — operating-point power scaling (dyn ∝ f·V², leak ∝ V²)
  and the energy-optimal-point search under a cluster power cap
* ``report``      — the unified ``Report`` result object (public name
  ``repro_torch.api.Report``) with every derived metric defined once

The scaling curves and the cluster roofline (``repro.cluster.analytics``)
wait for ROADMAP.md §1 item 3.  At one core, nominal DVFS and zero
contention the cluster results equal the single-PE
``core.timing.evaluate_kernel`` / ``core.energy`` numbers bit for bit.
"""

from repro_torch.cluster.report import Report, ReportMetrics, headline
from repro_torch.cluster.contention import (AccessProfile, baseline_profile,
                                            baseline_extra_contention,
                                            baseline_extra_contention_het,
                                            copift_extra_contention,
                                            copift_extra_contention_het,
                                            copift_profile)
from repro_torch.cluster.dma import (BYTES_PER_ELEM, DmaTiming,
                                     cluster_dma_timing, kernel_bytes,
                                     transfer_cycles)
from repro_torch.cluster.dvfs import (DvfsPointResult, cluster_power_mw,
                                      core_power_mw, het_cluster_power_mw,
                                      optimal_point, scale_breakdown,
                                      sweep_points)
from repro_torch.cluster.scheduler import (STRATEGIES, WorkAssignment,
                                           assign, block_cyclic,
                                           cluster_compute_cycles)
from repro_torch.cluster.topology import (NOMINAL_POINT, OPERATING_POINTS,
                                          SNITCH_CLUSTER, ClusterConfig,
                                          DvfsIsland, OperatingPoint,
                                          parse_islands)

__all__ = [
    "Report", "ReportMetrics", "headline", "AccessProfile",
    "baseline_profile", "baseline_extra_contention",
    "baseline_extra_contention_het", "copift_extra_contention",
    "copift_extra_contention_het", "copift_profile", "BYTES_PER_ELEM",
    "DmaTiming", "cluster_dma_timing", "kernel_bytes", "transfer_cycles",
    "DvfsPointResult", "cluster_power_mw", "core_power_mw",
    "het_cluster_power_mw", "optimal_point", "scale_breakdown",
    "sweep_points", "STRATEGIES", "WorkAssignment", "assign",
    "block_cyclic", "cluster_compute_cycles", "NOMINAL_POINT",
    "OPERATING_POINTS", "SNITCH_CLUSTER", "ClusterConfig", "DvfsIsland",
    "OperatingPoint", "parse_islands",
]
