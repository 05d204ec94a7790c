"""The one result object every evaluation returns (public name:
``repro_torch.api.Report``; this module is its import-cycle-free home, below
both ``repro_torch.cluster`` and ``repro_torch.api``).

The port's copy of the JAX package's ``repro.cluster.report``, plain Python,
so that its numbers equal the JAX package's bit for bit.

Before the facade, ``repro_torch.cluster`` carried two near-duplicate result
classes — ``ClusterKernelResult`` (homogeneous) and ``HetClusterResult``
(DVFS islands) — whose metric properties (``speedup``, ``ipc_*``,
``power_ratio``, ``energy_saving``, ...) were copy-pasted and could drift
apart silently.  ``ReportMetrics`` is the single definition of those
derived metrics; ``Report`` is the single dataclass ``repro_torch.api.evaluate``
returns, in which a homogeneous cluster is literally the degenerate case
where every per-core operating point coincides (and cycle counts stay
exact integers).

Cycle counts are expressed in *reference-clock cycles* — cycles of the
fastest core's domain.  When every core shares one point the scale factor
is exactly 1 and the counts are plain ``int``s, bit-for-bit equal to the
pre-facade homogeneous results (pinned by ``tests/test_api.py`` against
``tests/test_cluster.py``'s numbers).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.cluster.topology import OperatingPoint
from repro_torch.core.analytics import geomean


class ReportMetrics:
    """Derived metrics shared by every evaluation result.

    Expects the host object to provide: ``cycles_base``, ``cycles_copift``,
    ``instrs_base``, ``instrs_copift``, ``power_base_mw``,
    ``power_copift_mw``, ``ref_freq_ghz`` and ``total_elems``.
    """

    @property
    def speedup(self) -> float:
        """COPIFT cluster vs RV32G cluster, same cores and points."""
        return self.cycles_base / self.cycles_copift

    @property
    def ipc_base(self) -> float:
        return self.instrs_base / self.cycles_base

    @property
    def ipc_copift(self) -> float:
        """Cluster-aggregate IPC (can exceed n_cores on dual-issue PEs)."""
        return self.instrs_copift / self.cycles_copift

    @property
    def power_ratio(self) -> float:
        return self.power_copift_mw / self.power_base_mw

    @property
    def energy_saving(self) -> float:
        """E_base / E_copift = speedup / power ratio (same points)."""
        return self.speedup / self.power_ratio

    @property
    def time_us(self) -> float:
        return self.cycles_copift / self.ref_freq_ghz * 1e-3

    @property
    def cycles_per_elem(self) -> float:
        return self.cycles_copift / self.total_elems

    @property
    def energy_pj_per_elem(self) -> float:
        """Cluster COPIFT energy per element at the operating point(s)."""
        t_ns = self.cycles_per_elem / self.ref_freq_ghz
        return self.power_copift_mw * t_ns


@dataclass(frozen=True)
class Report(ReportMetrics):
    """One kernel evaluated on one :class:`~repro_torch.api.Target`.

    The unified replacement for ``ClusterKernelResult`` and
    ``HetClusterResult`` (both now deprecated aliases of this class).
    """
    name: str
    strategy: str
    core_points: tuple[OperatingPoint, ...]
    block: int
    total_blocks: int
    total_elems: int
    blocks_per_core: tuple[int, ...]
    ref_freq_ghz: float           # the fastest domain (uncore/DMA clock)
    # reference-clock cycle counts: exact ints on a homogeneous target,
    # floats (slower cores scaled by f_ref/f_i) on a heterogeneous one
    cycles_base: float
    cycles_copift: float
    instrs_base: int
    instrs_copift: int
    # model diagnostics
    extra_contention: float       # worst per-core stalls/access surcharge
    imbalance: float              # max/mean load (weighted on het targets)
    dma_bound: bool
    dma_utilization: float
    # power of the active cores at their own points (mW, whole cluster)
    power_base_mw: float
    power_copift_mw: float

    @property
    def n_cores(self) -> int:
        return len(self.core_points)

    @property
    def is_heterogeneous(self) -> bool:
        return len(set(self.core_points)) > 1

    @property
    def point(self) -> OperatingPoint:
        """The single operating point of a homogeneous target."""
        pts = set(self.core_points)
        if len(pts) != 1:
            raise ValueError(
                f"heterogeneous report ({len(pts)} distinct points) has no "
                f"single operating point; inspect .core_points instead")
        return self.core_points[0]


def headline(results: "list[Report]") -> dict:
    """fig2-style aggregates over a set of per-kernel reports."""
    return dict(
        geomean_speedup=geomean([r.speedup for r in results]),
        peak_speedup=max(r.speedup for r in results),
        peak_ipc=max(r.ipc_copift for r in results),
        geomean_ipc_gain=geomean([r.ipc_copift / r.ipc_base
                                  for r in results]),
        geomean_power_ratio=geomean([r.power_ratio for r in results]),
        max_power_ratio=max(r.power_ratio for r in results),
        geomean_energy_saving=geomean([r.energy_saving for r in results]),
        peak_energy_saving=max(r.energy_saving for r in results))
