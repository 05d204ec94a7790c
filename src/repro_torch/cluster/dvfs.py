"""DVFS power/energy scaling and the energy-optimal operating point.

The port's copy of the JAX package's ``repro.cluster.dvfs``, plain Python,
so that its numbers equal the JAX package's bit for bit.

``core/energy.py``'s coefficients are calibrated at one (f, V) point —
1 GHz / 0.8 V.  Moving along the cluster's DVFS ladder scales each
component: dynamic power ∝ f·V², leakage ∝ V² (lumos-style first-order
scaling).  Energy per element then trades two terms against each other —
dynamic energy ∝ V² (frequency cancels), static energy ∝ V²/f (slower
clocks leak longer) — so the energy optimum sits at the lowest voltage
whose frequency still amortizes leakage, and a cluster *power cap*
(n_cores × per-core power ≤ budget) can push the feasible optimum lower
still.  That shift of the optimal point with core count is the effect
motivating the cluster model (cf. Fu et al., arXiv:2505.24363).

Exactness note: when asked for the nominal point this module returns the
calibrated breakdown object unchanged (no ×1.0 float round-trips), which is
part of the single-core bit-for-bit reduction guarantee.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.cluster.topology import (NOMINAL_POINT, ClusterConfig,
                                          OperatingPoint)
from repro_torch.core.energy import PowerBreakdown, baseline_power, copift_power

#: Share of the constant term that is leakage/always-on (scales V² only);
#: the rest of every component is dynamic switching power (scales f·V²).
STATIC_FRAC_CONST = 0.30


def scale_breakdown(pb: PowerBreakdown, point: OperatingPoint,
                    nominal: OperatingPoint = NOMINAL_POINT) -> PowerBreakdown:
    """Re-express a calibrated power breakdown at another operating point."""
    if point == nominal:
        return pb
    dyn = point.dynamic_scale(nominal)
    stat = point.static_scale(nominal)
    const = pb.const * (STATIC_FRAC_CONST * stat
                        + (1.0 - STATIC_FRAC_CONST) * dyn)
    return replace(pb, const=const, int_dp=pb.int_dp * dyn,
                   fpu=pb.fpu * dyn, lsu=pb.lsu * dyn, fetch=pb.fetch * dyn,
                   dma=pb.dma * dyn, ssr=pb.ssr * dyn)


def core_power_mw(name: str, point: OperatingPoint = NOMINAL_POINT,
                  copift: bool = True,
                  nominal: OperatingPoint = NOMINAL_POINT) -> float:
    """One PE's power (mW) for kernel ``name`` at an operating point."""
    pb = copift_power(name) if copift else baseline_power(name)
    return scale_breakdown(pb, point, nominal).total


def cluster_power_mw(cfg: ClusterConfig, name: str, n_cores: int,
                     point: OperatingPoint = NOMINAL_POINT,
                     copift: bool = True) -> float:
    """Cluster power: every active core runs the same kernel.  (Per-core
    calibration already amortizes the shared uncore — see energy.py.)
    Scaling is relative to ``cfg.nominal``, the cluster's declared
    calibration point."""
    return n_cores * core_power_mw(name, point, copift=copift,
                                   nominal=cfg.nominal)


def het_cluster_power_mw(cfg: ClusterConfig, name: str,
                         core_points: tuple[OperatingPoint, ...],
                         copift: bool = True) -> float:
    """Cluster power when active cores sit at per-core operating points.

    Cores are grouped by *distinct point* and each group is charged
    ``count x per-core power`` — so a heterogeneous call where every core
    shares one point computes the exact same ``n x p`` product as
    ``cluster_power_mw`` (the bit-for-bit homogeneous reduction), rather
    than a re-associated float sum."""
    counts: dict[OperatingPoint, int] = {}
    for p in core_points:
        counts[p] = counts.get(p, 0) + 1
    return sum(n * core_power_mw(name, p, copift=copift, nominal=cfg.nominal)
               for p, n in counts.items())


@dataclass(frozen=True)
class DvfsPointResult:
    """One operating point evaluated for one (kernel, n_cores) workload."""
    point: OperatingPoint
    cluster_power_mw: float
    time_per_elem_ns: float
    energy_pj_per_elem: float
    feasible: bool               # within the cluster power cap


def sweep_points(cfg: ClusterConfig, name: str, n_cores: int,
                 cluster_cycles_per_elem: float,
                 power_cap_mw: float | None = None,
                 copift: bool = True) -> list[DvfsPointResult]:
    """Evaluate every ladder point.  ``cluster_cycles_per_elem`` is the
    cluster-level cost from ``analytics`` (cycles are frequency-independent:
    cores, TCDM and DMA share the cluster clock domain)."""
    cap = power_cap_mw if power_cap_mw is not None else cfg.power_cap_mw
    out = []
    for pt in cfg.operating_points:
        p_mw = cluster_power_mw(cfg, name, n_cores, pt, copift=copift)
        t_ns = cluster_cycles_per_elem / pt.freq_ghz
        out.append(DvfsPointResult(
            point=pt, cluster_power_mw=p_mw, time_per_elem_ns=t_ns,
            energy_pj_per_elem=p_mw * t_ns,
            feasible=(cap is None or p_mw <= cap)))
    return out


def optimal_point(cfg: ClusterConfig, name: str, n_cores: int,
                  cluster_cycles_per_elem: float,
                  power_cap_mw: float | None = None,
                  copift: bool = True) -> tuple[DvfsPointResult,
                                                list[DvfsPointResult]]:
    """Energy-optimal feasible point (and the full sweep, for reporting).

    Among points under the power cap, minimize energy/element; break ties
    toward lower voltage.  If the cap excludes every point, fall back to
    the lowest-power point — the cluster must throttle there anyway.
    """
    sweep = sweep_points(cfg, name, n_cores, cluster_cycles_per_elem,
                         power_cap_mw, copift=copift)
    feasible = [r for r in sweep if r.feasible]
    pool = feasible or [min(sweep, key=lambda r: r.cluster_power_mw)]
    best = min(pool, key=lambda r: (r.energy_pj_per_elem, r.point.vdd))
    return best, sweep
