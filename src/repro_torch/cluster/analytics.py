"""Cluster-level analytics over the facade's one evaluation path; a
self-standing copy of the JAX package's ``repro.cluster.analytics``.

The composition itself (per-PE COPIFT x contention x DMA x DVFS) lives in
``repro_torch.api.evaluate`` as ONE code path in which a homogeneous
cluster is the degenerate (uniform-points) case of the heterogeneous one.
This module holds the derived curves on top of it:

* scaling curves (weak/strong/efficiency), the cluster roofline and the
  ``headline`` aggregates — all delegating to the facade internally;
* ``ClusterKernelResult`` / ``HetClusterResult`` — historical aliases of
  the unified :class:`repro_torch.api.Report`, kept because the JAX
  package exports them; call ``repro_torch.api.evaluate`` with a
  ``Target`` for a single evaluation.

Like the single-PE model this is steady-state: fill/drain and the
end-of-kernel barrier are excluded (they vanish against any production
problem size, cf. Fig. 3's convergence).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.cluster.report import Report, headline  # noqa: F401  (re-export)
from repro_torch.cluster.scheduler import STRATEGIES
from repro_torch.cluster.topology import (NOMINAL_POINT, SNITCH_CLUSTER,
                                          ClusterConfig, OperatingPoint)
from repro_torch.core.kernels_isa import KERNELS, copift_schedule

#: Historical aliases: both pre-facade result classes are the one Report.
ClusterKernelResult = Report
HetClusterResult = Report


def _facade():
    """``(evaluate, Target)`` resolved lazily: importing ``repro_torch.api`` at
    module level would recurse — this module is itself imported by the
    ``repro_torch.cluster`` package init the facade's imports trigger."""
    from repro_torch.api.evaluate import evaluate
    from repro_torch.api.target import Target
    return evaluate, Target


def _homogeneous_target(cfg: ClusterConfig, n_cores: int | None,
                        point: OperatingPoint):
    """The target ``evaluate_cluster`` historically meant: ``n_cores``
    cores of ``cfg``'s shared resources, every core at ``point`` (any
    island layout ignored, exactly as the old code path did)."""
    _, Target = _facade()
    n = cfg.n_cores if n_cores is None else n_cores
    if n != cfg.n_cores or cfg.islands is not None:
        cfg = replace(cfg, n_cores=n, islands=None)
    return Target(cluster=cfg, point=point)


def compare_strategies(name: str, cfg: ClusterConfig,
                       strategies: tuple[str, ...] = STRATEGIES,
                       blocks_per_core: int = 1,
                       total_blocks: int | None = None
                       ) -> dict[str, Report]:
    """Evaluate every scheduling strategy on the same heterogeneous cluster
    — how much of the speed-blind block-cyclic tail each one recovers."""
    from repro_torch.api.evaluate import compare_strategies as api_compare
    _, Target = _facade()
    return api_compare(name, Target(cluster=cfg), strategies=strategies,
                       blocks_per_core=blocks_per_core,
                       total_blocks=total_blocks)


# ---------------------------------------------------------------------------
# Scaling curves
# ---------------------------------------------------------------------------

def weak_scaling(name: str, cfg: ClusterConfig = SNITCH_CLUSTER,
                 cores: tuple[int, ...] = (1, 2, 4, 8, 16),
                 blocks_per_core: int = 1,
                 point: OperatingPoint = NOMINAL_POINT) -> list[Report]:
    """Work grows with the cluster (throughput scaling)."""
    ev, _ = _facade()
    return [ev(name, _homogeneous_target(cfg, n, point),
               blocks_per_core=blocks_per_core)
            for n in cores]


def strong_scaling(name: str, cfg: ClusterConfig = SNITCH_CLUSTER,
                   cores: tuple[int, ...] = (1, 2, 4, 8, 16),
                   total_blocks: int = 48,
                   point: OperatingPoint = NOMINAL_POINT) -> list[Report]:
    """Fixed work split ever thinner (latency scaling + imbalance tail)."""
    ev, _ = _facade()
    return [ev(name, _homogeneous_target(cfg, n, point),
               total_blocks=total_blocks)
            for n in cores]


def scaling_efficiency(results: list[Report]) -> list[float]:
    """Per-entry parallel efficiency vs the first (1-core) entry.

    Weak scaling: time(1)/time(n) with work ∝ n → ideal 1.0.
    Strong scaling: handled by the same throughput form — efficiency is
    (elems/cycle at n) / (n × elems/cycle at 1).
    """
    base = results[0]
    base_tput = base.total_elems / base.cycles_copift
    out = []
    for r in results:
        tput = r.total_elems / r.cycles_copift
        scale = r.n_cores / base.n_cores
        out.append(tput / (base_tput * scale))
    return out


# ---------------------------------------------------------------------------
# Cluster roofline
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RooflinePoint:
    """One kernel against the cluster's compute/DMA rooflines."""
    name: str
    oi_flops_per_byte: float      # inf for the in-core Monte-Carlo kernels
    peak_gflops: float            # n_cores × FMA × freq
    attainable_gflops: float      # min(peak, OI × DMA bandwidth)
    achieved_gflops: float
    bound: str                    # "compute" | "memory"


def cluster_roofline(cfg: ClusterConfig = SNITCH_CLUSTER,
                     point: OperatingPoint = NOMINAL_POINT,
                     blocks_per_core: int = 1) -> list[RooflinePoint]:
    """FP64 roofline of the cluster: compute roof = n_cores FMA lanes, memory
    roof = the shared DMA engine.  FLOPs are counted as FP instructions per
    element (FMA=1 issue slot — consistent with the IPC accounting)."""
    from repro_torch.cluster.dma import BYTES_PER_ELEM
    peak = cfg.n_cores * 2.0 * point.freq_ghz          # GFLOP/s, FMA = 2
    bw_gbs = cfg.dma_bytes_per_cycle * point.freq_ghz  # GB/s
    out = []
    for name in KERNELS:
        sched = copift_schedule(name)
        flops_per_elem = 2.0 * sched.n_fp              # count FMAs generously
        bytes_per_elem = BYTES_PER_ELEM[name]
        oi = (flops_per_elem / bytes_per_elem if bytes_per_elem
              else float("inf"))
        attainable = min(peak, oi * bw_gbs) if bytes_per_elem else peak
        r = _facade()[0](name,
                         _homogeneous_target(cfg, cfg.n_cores, point),
                         blocks_per_core=blocks_per_core)
        achieved = (flops_per_elem * r.total_elems
                    / (r.cycles_copift / point.freq_ghz))  # GFLOP/s
        out.append(RooflinePoint(
            name=name, oi_flops_per_byte=oi, peak_gflops=peak,
            attainable_gflops=attainable, achieved_gflops=achieved,
            bound="memory" if attainable < peak else "compute"))
    return out
