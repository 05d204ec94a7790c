"""``SystemConfig`` — N clusters behind an interconnect + shared HBM.

The port's copy of the JAX package's ``repro.system.topology``, plain
Python, so that its numbers equal the JAX package's bit for bit.

The Snitch lineage (Zaruba et al., arXiv 2002.10143) scales the 8-core
cluster this repo models to Occamy-class manycore parts: dozens of
clusters, each with its own TCDM and DMA engine, all draining into one
HBM interface over a network-on-chip.  ``SystemConfig`` composes the
existing :class:`~repro_torch.cluster.topology.ClusterConfig` the same way
``ClusterConfig`` composed the single PE:

``clusters``             one ``ClusterConfig`` per cluster (islands and
                         per-cluster core counts travel with each entry);
``hbm_bytes_per_cycle``  aggregate HBM bandwidth shared by every cluster's
                         DMA stream; ``None`` = unconstrained (each cluster
                         keeps its private ``dma_bytes_per_cycle``, which
                         makes the 1-cluster system *definitionally* the
                         single-cluster model);
``noc_latency_cycles``   per-stream interconnect latency added to any
                         HBM-arbitrated transfer (0 for the degenerate
                         case — a lone cluster sits on the HBM port);
``cluster_strategy``     how work blocks are shared *across clusters*
                         (same strategy names as the per-core level,
                         ``cluster.scheduler.STRATEGIES``).

The degenerate-case rule of the cluster model applies one level up: a 1-cluster
``SystemConfig`` with unconstrained HBM reduces bit-for-bit to today's
single-cluster ``Report`` (pinned in ``tests/test_system_model.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.cluster.scheduler import STRATEGIES
from repro_torch.cluster.topology import (NOMINAL_POINT, SNITCH_CLUSTER,
                                          ClusterConfig, OperatingPoint)

_SYSTEM_GRAMMAR = ("'<n_clusters>x<n_cores>c[,hbm=<bytes/cycle>]"
                   "[,noc=<cycles>][,strategy=<name>]', "
                   "e.g. '4x8c,hbm=256,noc=8'")


@dataclass(frozen=True)
class SystemConfig:
    """A manycore part: clusters x interconnect x HBM bandwidth."""

    clusters: tuple[ClusterConfig, ...] = (SNITCH_CLUSTER,)
    hbm_bytes_per_cycle: float | None = None
    noc_latency_cycles: int = 0
    cluster_strategy: str = "block_cyclic"

    def __post_init__(self):
        if not self.clusters:
            raise ValueError("a SystemConfig needs at least one cluster")
        for i, c in enumerate(self.clusters):
            if not isinstance(c, ClusterConfig):
                raise TypeError(f"clusters[{i}] is {type(c).__name__}, "
                                f"expected ClusterConfig")
        if self.hbm_bytes_per_cycle is not None \
                and self.hbm_bytes_per_cycle <= 0:
            raise ValueError(f"hbm_bytes_per_cycle must be positive (or None "
                             f"for unconstrained), got "
                             f"{self.hbm_bytes_per_cycle}")
        if self.noc_latency_cycles < 0:
            raise ValueError(f"noc_latency_cycles must be >= 0, got "
                             f"{self.noc_latency_cycles}")
        if self.cluster_strategy not in STRATEGIES:
            raise ValueError(f"unknown cluster_strategy "
                             f"{self.cluster_strategy!r}; expected one of "
                             f"{STRATEGIES}")

    # -- constructors -------------------------------------------------------

    @classmethod
    def homogeneous(cls, n_clusters: int,
                    cluster: ClusterConfig = SNITCH_CLUSTER,
                    hbm_bytes_per_cycle: float | None = None,
                    noc_latency_cycles: int = 0,
                    cluster_strategy: str = "block_cyclic") -> "SystemConfig":
        """``n_clusters`` identical copies of ``cluster`` — the common case
        (Occamy replicates one cluster design)."""
        if n_clusters < 1:
            raise ValueError(f"n_clusters must be >= 1, got {n_clusters}")
        return cls(clusters=(cluster,) * n_clusters,
                   hbm_bytes_per_cycle=hbm_bytes_per_cycle,
                   noc_latency_cycles=noc_latency_cycles,
                   cluster_strategy=cluster_strategy)

    # -- derived views ------------------------------------------------------

    @property
    def n_clusters(self) -> int:
        return len(self.clusters)

    @property
    def n_cores(self) -> int:
        return sum(c.n_cores for c in self.clusters)

    @property
    def is_uniform(self) -> bool:
        """True iff every cluster is the same config (shape + islands)."""
        return len(set(self.clusters)) == 1

    @property
    def aggregate_dma_bytes_per_cycle(self) -> float:
        """Peak demand every cluster DMA engine can put on the HBM port at
        once — when this exceeds ``hbm_bytes_per_cycle`` the interconnect
        saturates and transfers stretch (``repro_torch.system.noc``)."""
        return sum(c.dma_bytes_per_cycle for c in self.clusters)

    def cluster_core_points(self, default: OperatingPoint = NOMINAL_POINT
                            ) -> tuple[tuple[OperatingPoint, ...], ...]:
        """Per-cluster per-core operating points (each cluster's island
        layout expanded against ``default``)."""
        return tuple(c.core_points(default) for c in self.clusters)

    def core_points(self, default: OperatingPoint = NOMINAL_POINT
                    ) -> tuple[OperatingPoint, ...]:
        """All cores' points, flattened cluster-major — the system-level
        analogue of ``ClusterConfig.core_points``."""
        return tuple(p for pts in self.cluster_core_points(default)
                     for p in pts)

    def with_hbm(self, hbm_bytes_per_cycle: float | None) -> "SystemConfig":
        return replace(self, hbm_bytes_per_cycle=hbm_bytes_per_cycle)

    def with_clusters(self, n_clusters: int) -> "SystemConfig":
        """Resize to ``n_clusters`` copies of the first cluster."""
        if n_clusters < 1:
            raise ValueError(f"n_clusters must be >= 1, got {n_clusters}")
        return replace(self, clusters=(self.clusters[0],) * n_clusters)


def parse_system(spec: str,
                 cluster: ClusterConfig = SNITCH_CLUSTER) -> SystemConfig:
    """Parse a CLI-style system spec, e.g. ``"4x8c,hbm=256,noc=8"``.

    The leading token is ``<n_clusters>x<n_cores>c``; optional ``hbm=``
    (bytes/cycle, or ``none`` for unconstrained), ``noc=`` (cycles) and
    ``strategy=`` (a ``cluster.scheduler`` name) follow in any order.
    Core count applies to every cluster (replicated ``cluster`` template,
    islands dropped when the core count changes).  Errors name the
    offending token and its position, like ``parse_islands``.
    """
    tokens = [t.strip() for t in spec.split(",")]
    if not tokens or not tokens[0]:
        raise ValueError(f"empty system spec {spec!r}; expected "
                         f"{_SYSTEM_GRAMMAR}")
    head = tokens[0]
    try:
        counts, cores = head.split("x", 1)
        if not cores.endswith("c"):
            raise ValueError
        n_clusters = int(counts)
        n_cores = int(cores[:-1])
    except ValueError:
        raise ValueError(
            f"bad shape token {head!r} (token 1 of {spec!r}); expected "
            f"{_SYSTEM_GRAMMAR}") from None
    if n_clusters < 1 or n_cores < 1:
        raise ValueError(f"shape token {head!r} (token 1 of {spec!r}) needs "
                         f"n_clusters >= 1 and n_cores >= 1")
    hbm: float | None = None
    noc = 0
    strategy = "block_cyclic"
    for i, tok in enumerate(tokens[1:], start=2):
        key, sep, val = tok.partition("=")
        if not sep or not val:
            raise ValueError(f"bad option {tok!r} (token {i} of {spec!r}); "
                             f"expected {_SYSTEM_GRAMMAR}")
        if key == "hbm":
            if val.lower() == "none":
                hbm = None
                continue
            try:
                hbm = float(val)
            except ValueError:
                raise ValueError(f"bad hbm value {val!r} (token {i} of "
                                 f"{spec!r}); expected a number or 'none'"
                                 ) from None
        elif key == "noc":
            try:
                noc = int(val)
            except ValueError:
                raise ValueError(f"bad noc value {val!r} (token {i} of "
                                 f"{spec!r}); expected an integer cycle "
                                 f"count") from None
        elif key == "strategy":
            strategy = val
        else:
            raise ValueError(f"unknown option {key!r} (token {i} of "
                             f"{spec!r}); expected one of hbm, noc, strategy")
    tmpl = cluster if n_cores == cluster.n_cores else cluster.with_cores(
        n_cores)
    return SystemConfig.homogeneous(n_clusters, tmpl,
                                    hbm_bytes_per_cycle=hbm,
                                    noc_latency_cycles=noc,
                                    cluster_strategy=strategy)


DEFAULT_SYSTEM = SystemConfig()
