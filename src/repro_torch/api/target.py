"""``Target`` — *where* a kernel runs, as one value object.

The port's copy of the JAX package's ``repro.api.target``, plain Python, so
that its numbers equal the JAX package's bit for bit.

Pre-facade, the execution context was scattered across call signatures:
``ClusterConfig`` + a separate ``n_cores`` argument + an ``OperatingPoint``
+ an island layout + a scheduling strategy + a power cap.  A ``Target``
bundles all of it, and makes the heterogeneous (DVFS-island) cluster the
general case: a homogeneous cluster is literally a one-island target, and
a single PE is the 1-core cluster — exactly how Snitch (Zaruba et al.,
2020) treats a lone core as the degenerate cluster.  One level further up,
:meth:`Target.system` attaches a :class:`~repro_torch.system.SystemConfig` —
the manycore part — and the lone cluster becomes *its* degenerate case.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.cluster.scheduler import STRATEGIES
from repro_torch.cluster.topology import (NOMINAL_POINT, SNITCH_CLUSTER,
                                          ClusterConfig, DvfsIsland, OperatingPoint,
                                          parse_islands)
from repro_torch.system.topology import SystemConfig, parse_system


@dataclass(frozen=True)
class Target:
    """One execution context: cluster shape x operating point(s) x schedule.

    ``cluster``       static shared resources (cores, TCDM banks, DMA width,
                      DVFS ladder) plus any island layout;
    ``point``         the operating point of every core *not* covered by an
                      island layout (i.e. the homogeneous point);
    ``strategy``      how blocks are shared across cores
                      (``cluster.scheduler.assign``; on uniform cores every
                      strategy reduces exactly to block-cyclic);
    ``power_cap_mw``  cluster-level power budget, honored by the tuner and
                      reported as feasibility by the cost oracle (a
                      *system*-level budget when ``system_config`` is set);
    ``system_config`` a :class:`~repro_torch.system.SystemConfig` for manycore
                      targets (``None`` = a single cluster; built by
                      :meth:`Target.system`) — ``api.evaluate`` then routes
                      through ``repro_torch.system.evaluate_system``.
    """
    cluster: ClusterConfig = SNITCH_CLUSTER
    point: OperatingPoint = NOMINAL_POINT
    strategy: str = "block_cyclic"
    power_cap_mw: float | None = None
    system_config: SystemConfig | None = None

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}; "
                             f"expected one of {STRATEGIES}")
        if self.power_cap_mw is not None and self.power_cap_mw <= 0:
            raise ValueError(f"power_cap_mw must be positive, got "
                             f"{self.power_cap_mw}")
        if self.system_config is not None \
                and self.cluster is not self.system_config.clusters[0] \
                and self.cluster != self.system_config.clusters[0]:
            raise ValueError(
                "Target.cluster must be the system's first cluster; "
                "construct manycore targets with Target.system(...)")

    # -- constructors -------------------------------------------------------

    @classmethod
    def single_pe(cls, point: OperatingPoint = NOMINAL_POINT,
                  cluster: ClusterConfig = SNITCH_CLUSTER) -> "Target":
        """The paper's setting: one core, nominal DVFS — the 1-PE cluster."""
        return cls.homogeneous(n_cores=1, point=point, cluster=cluster)

    @classmethod
    def homogeneous(cls, n_cores: int | None = None,
                    point: OperatingPoint = NOMINAL_POINT,
                    cluster: ClusterConfig = SNITCH_CLUSTER,
                    power_cap_mw: float | None = None) -> "Target":
        """Every core at one operating point (any island layout dropped)."""
        n = cluster.n_cores if n_cores is None else n_cores
        cfg = cluster if (n == cluster.n_cores and cluster.islands is None) \
            else replace(cluster, n_cores=n, islands=None)
        return cls(cluster=cfg, point=point, power_cap_mw=power_cap_mw)

    @classmethod
    def heterogeneous(cls, islands: "str | tuple[DvfsIsland, ...]",
                      strategy: str = "lpt",
                      cluster: ClusterConfig = SNITCH_CLUSTER,
                      power_cap_mw: float | None = None) -> "Target":
        """DVFS-island cluster from an island tuple or a CLI-style spec
        string (``"2@1.45GHz@1.00V,6@0.50GHz@0.60V"``, parsed against the
        cluster's ladder)."""
        if isinstance(islands, str):
            islands = parse_islands(islands, cluster)
        return cls(cluster=cluster.with_islands(*islands), strategy=strategy,
                   power_cap_mw=power_cap_mw)

    @classmethod
    def system(cls, system: "SystemConfig | int | str",
               point: OperatingPoint = NOMINAL_POINT,
               strategy: str = "block_cyclic",
               cluster: ClusterConfig = SNITCH_CLUSTER,
               hbm_bytes_per_cycle: float | None = None,
               noc_latency_cycles: int = 0,
               cluster_strategy: str = "block_cyclic",
               power_cap_mw: float | None = None) -> "Target":
        """A manycore target: a :class:`~repro_torch.system.SystemConfig`, a
        cluster count (``Target.system(4)`` — four copies of ``cluster``),
        or a spec string (``Target.system("4x8c,hbm=256")``).

        ``strategy`` schedules blocks → cores inside each cluster;
        ``cluster_strategy`` (or the config's own) schedules blocks →
        clusters.  ``power_cap_mw`` is the *system* budget.  The HBM/NoC
        keywords apply when building the config here; an explicit
        ``SystemConfig`` carries its own."""
        if isinstance(system, int):
            system = SystemConfig.homogeneous(
                system, cluster, hbm_bytes_per_cycle=hbm_bytes_per_cycle,
                noc_latency_cycles=noc_latency_cycles,
                cluster_strategy=cluster_strategy)
        elif isinstance(system, str):
            system = parse_system(system, cluster)
        return cls(cluster=system.clusters[0], point=point,
                   strategy=strategy, power_cap_mw=power_cap_mw,
                   system_config=system)

    # -- derived views ------------------------------------------------------

    @property
    def n_cores(self) -> int:
        """Total cores — across every cluster for a manycore target."""
        if self.system_config is not None:
            return self.system_config.n_cores
        return self.cluster.n_cores

    @property
    def n_clusters(self) -> int:
        return 1 if self.system_config is None \
            else self.system_config.n_clusters

    @property
    def core_points(self) -> tuple[OperatingPoint, ...]:
        """One operating point per core: the island layout expanded, or
        ``point`` replicated when homogeneous (flattened cluster-major on
        a manycore target)."""
        if self.system_config is not None:
            return self.system_config.core_points(self.point)
        return self.cluster.core_points(self.point)

    @property
    def is_heterogeneous(self) -> bool:
        """True iff the cores mix distinct operating points."""
        return len(set(self.core_points)) > 1

    @property
    def islands(self) -> tuple[DvfsIsland, ...] | None:
        return self.cluster.islands

    def with_strategy(self, strategy: str) -> "Target":
        return replace(self, strategy=strategy)

    def with_power_cap(self, power_cap_mw: float | None) -> "Target":
        return replace(self, power_cap_mw=power_cap_mw)
