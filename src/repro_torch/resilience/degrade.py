"""Graceful degradation — mapping a :class:`FaultState` onto the machine;
a copy of the JAX package's ``repro.resilience.degrade``.

The rule is *re-plan, don't re-model*: a fault never adds a new pricing
formula.  Dead cores drop out of the work assignment (speed 0 → zero
blocks → excluded from contention, compute and power exactly as an idle
core always was), throttled islands are re-pointed to the fastest DVFS
ladder rung at or below the cap (the existing power/clock scaling then
prices them), and a degraded HBM link is a narrower port into the same
``noc.fair_shares`` water-filling.  The fault-free state is the identity
on every one of these, which is what makes the empty-trace reduction a
bit-for-bit equality rather than an approximation.
"""

from __future__ import annotations

from repro_torch.cluster.topology import ClusterConfig, OperatingPoint
from repro_torch.resilience.faults import AllCoresDeadError, FaultState
from repro_torch.system.topology import SystemConfig

__all__ = ["throttled_point", "degrade_cluster", "masked_speeds",
           "degrade_system_hbm", "resolve_state", "require_survivors"]


def resolve_state(faults, t_ms: float = 0.0) -> FaultState:
    """Normalize the ``faults=`` argument of the evaluation entry points:
    ``None`` → the trivial state, a ``FaultTrace`` → its state at ``t_ms``,
    a ``FaultState`` → itself."""
    if faults is None:
        return FaultState()
    if isinstance(faults, FaultState):
        return faults
    state_at = getattr(faults, "state_at", None)
    if state_at is None:
        raise TypeError(f"faults must be a FaultTrace or FaultState, got "
                        f"{type(faults).__name__}")
    return state_at(t_ms)


def throttled_point(point: OperatingPoint, cap_ghz: float,
                    ladder: tuple[OperatingPoint, ...]) -> OperatingPoint:
    """The operating point a thermal cap forces: the fastest ladder rung at
    or below ``cap_ghz``, or the slowest rung when the cap undercuts the
    whole ladder (hardware can't clock below its floor).  A point already
    within the cap is returned unchanged — throttling never *raises* a
    frequency."""
    if point.freq_ghz <= cap_ghz:
        return point
    under = [p for p in ladder if p.freq_ghz <= cap_ghz]
    if under:
        return max(under, key=lambda p: p.freq_ghz)
    return min(ladder, key=lambda p: p.freq_ghz)


def degrade_cluster(cfg: ClusterConfig,
                    core_points: tuple[OperatingPoint, ...],
                    state: FaultState, cluster: int = 0
                    ) -> tuple[tuple[OperatingPoint, ...], tuple[bool, ...]]:
    """One cluster's ``(core_points, alive_mask)`` under ``state``.

    Throttle caps re-point every core of the cluster's island(s) down the
    ladder; fail-stops flip the alive mask (a whole-cluster death kills
    every core).  The points of dead cores are left as-is — the mask is
    what removes them from scheduling, contention and power.
    """
    cap = state.freq_cap(cluster)
    if cap is not None:
        points = tuple(throttled_point(p, cap, cfg.operating_points)
                       for p in core_points)
    else:
        points = tuple(core_points)
    alive = tuple(not state.core_dead(cluster, i)
                  for i in range(len(core_points)))
    return points, alive


def masked_speeds(core_points: tuple[OperatingPoint, ...],
                  alive: tuple[bool, ...]) -> tuple[float, ...]:
    """Per-core relative speeds with dead cores at 0.0 — the survival mask
    in the form ``cluster.scheduler.assign`` consumes (zero-speed cores
    receive zero blocks under every strategy)."""
    return tuple(p.freq_ghz if a else 0.0
                 for p, a in zip(core_points, alive))


def degrade_system_hbm(system: SystemConfig,
                       state: FaultState) -> SystemConfig:
    """The system with its HBM port narrowed by the state's active
    bandwidth-degradation multiplier.  An unconstrained port (``None``)
    becomes a constrained one at the scaled aggregate DMA width — a
    degraded link is a real bottleneck even if the healthy part never
    saturated."""
    if state.hbm_scale == 1.0:
        return system
    base = system.hbm_bytes_per_cycle
    if base is None:
        base = system.aggregate_dma_bytes_per_cycle
    return system.with_hbm(base * state.hbm_scale)


def require_survivors(speeds, what: str) -> None:
    """Raise :class:`AllCoresDeadError` unless some speed is positive —
    the evaluation entry points call this so an all-dead state fails with
    the fault context, not a downstream max()-of-empty traceback."""
    if not any(s > 0 for s in speeds):
        raise AllCoresDeadError(
            f"fault state leaves no core alive on {what}; nothing can be "
            f"priced (degradation needs at least one survivor)")
