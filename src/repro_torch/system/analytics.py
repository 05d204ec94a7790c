"""``evaluate_system`` — the manycore part priced into the existing
``Report``; a self-standing copy of the JAX package's
``repro.system.analytics``, so every system ``Report`` and ``SystemPoint``
equals the JAX package's with ``==``.

Composition, not duplication: every cluster is priced by
``repro_torch.api.evaluate._price_cluster`` — the exact per-cluster body of
``api.evaluate`` — against the *system-wide* reference clock, DMA streams
are arbitrated by ``repro_torch.system.noc``, and the per-cluster figures
reduce with the same operators the single-cluster path uses (``max`` of
finish times, ``sum`` of powers, ``max`` of contention).  Because
``max``/``sum`` over a singleton are the identity, a 1-cluster system with
unconstrained HBM is *bit-for-bit* ``api.evaluate`` on the equivalent
cluster ``Target``.

The memoized timing engine underneath (``repro_torch.perf`` + the lru tier
in ``api.evaluate``) means identical clusters price their block timings
once: evaluating a 32-cluster homogeneous part simulates exactly the same
(kernel, block, contention) triples as the 1-cluster part.

All ``repro_torch.api`` imports in this module are function-local —
``api.evaluate`` routes system targets here, so the module boundary must
stay lazy in one direction.  Like the rest of the analytic model this runs
on the host; it launches no kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.cluster.dma import kernel_bytes
from repro_torch.cluster.report import Report
from repro_torch.core.analytics import TABLE_I
from repro_torch.obs import metrics as _metrics
from repro_torch.obs.spans import span as _obs_span
from repro_torch.system.noc import is_saturated, system_transfer_cycles
from repro_torch.system.scheduler import assign_system
from repro_torch.system.topology import SystemConfig


def evaluate_system(spec, target=None, *, blocks_per_core: int = 1,
                    total_blocks: int | None = None, plan=None,
                    faults=None, fault_t_ms: float = 0.0) -> Report:
    """Evaluate one kernel on a multi-cluster system target.

    Same contract as ``api.evaluate`` (weak scaling by default,
    ``total_blocks`` for strong scaling), hierarchically scheduled: blocks
    → clusters by the system's ``cluster_strategy`` (weighted by aggregate
    cluster speed), then → cores by the target's per-core strategy.
    ``api.evaluate`` delegates here for any target with a
    ``system_config``; calling either is the same code path.

    ``faults``/``fault_t_ms`` degrade the part before pricing (see
    ``api.evaluate``): dead clusters take zero blocks (aggregate speed 0
    at the top scheduling level), dead cores mask out inside their
    cluster, throttle caps re-point whole islands, and the HBM
    degradation multiplier narrows the arbitrated port feeding
    ``noc.fair_shares``.  A trivial state is the historical path
    verbatim; a part with no surviving core raises ``AllCoresDeadError``.
    """
    from repro_torch.api.evaluate import (_price_cluster, _resolve_faults,
                                          _simulatable)
    from repro_torch.api.registry import kernel
    from repro_torch.api.target import Target
    spec = kernel(spec)
    if not spec.simulatable:
        raise ValueError(
            f"kernel {spec.name!r} has no ISA schedule/baseline trace — it "
            f"is tuner-only; evaluate_system() needs one of "
            f"{[s.name for s in _simulatable()]}")
    if target is None:
        target = Target.system(SystemConfig())
    system = target.system_config
    if system is None:
        raise ValueError("target carries no SystemConfig; construct one "
                         "with Target.system(...) (api.evaluate handles "
                         "plain cluster targets)")
    if plan is not None:
        raise ValueError(
            "plan-transformed evaluation is single-cluster only — price "
            "the plan on a cluster Target; SystemConfig targets take "
            "plan=None (the registry default)")
    name = spec.isa_name
    block = TABLE_I[name].max_block
    cluster_points = system.cluster_core_points(target.point)
    fstate = _resolve_faults(faults, fault_t_ms)
    if fstate is None:
        alive_masks = None
        cluster_speeds = tuple(tuple(p.freq_ghz for p in pts)
                               for pts in cluster_points)
    else:
        from repro_torch.resilience.degrade import (degrade_cluster,
                                                    degrade_system_hbm,
                                                    masked_speeds,
                                                    require_survivors)
        degraded = [degrade_cluster(cfg, pts, fstate, cluster=i)
                    for i, (cfg, pts) in enumerate(zip(system.clusters,
                                                       cluster_points))]
        cluster_points = tuple(pts for pts, _ in degraded)
        alive_masks = tuple(mask for _, mask in degraded)
        cluster_speeds = tuple(masked_speeds(pts, mask)
                               for pts, mask in degraded)
        require_survivors([s for sp in cluster_speeds for s in sp],
                          f"the {system.n_clusters}-cluster system target")
        system = degrade_system_hbm(system, fstate)
    speeds_all = tuple(s for sp in cluster_speeds for s in sp)
    f_ref = max(s for s in speeds_all if s > 0)
    if total_blocks is None:
        total_blocks = blocks_per_core * system.n_cores
    if total_blocks < 1:
        raise ValueError(f"need at least one block of work, got "
                         f"{total_blocks} (blocks_per_core="
                         f"{blocks_per_core})")
    with _obs_span("system.evaluate", kernel=name,
                   n_clusters=system.n_clusters, n_cores=system.n_cores,
                   total_blocks=total_blocks, strategy=target.strategy):
        sys_assign = assign_system(
            total_blocks, cluster_speeds,
            system.cluster_strategy, target.strategy)
        shares = sys_assign.cluster_blocks
        passes = [
            _price_cluster(cfg, name, pts, block, share, target.strategy,
                           f_ref,
                           None if alive_masks is None else alive_masks[i])
            if share else None
            for i, (cfg, pts, share) in enumerate(zip(system.clusters,
                                                      cluster_points,
                                                      shares))]
        cluster_bytes = tuple(kernel_bytes(name, block * share)
                              for share in shares)
        transfers = system_transfer_cycles(system, cluster_bytes)

        # Per-cluster latency, then the same outer reduction the cluster
        # path applies per core: the part finishes with its slowest
        # cluster.  max()/sum() over one active cluster are the identity —
        # that IS the 1-cluster bit-for-bit reduction.
        act = [(cp, tr) for cp, tr in zip(passes, transfers)
               if cp is not None]
        cycles_c = max(max(cp.compute_c, tr) for cp, tr in act)
        cycles_b = max(max(cp.compute_b, tr) for cp, tr in act)
        power_c = sum(cp.power_c for cp, _ in act)
        power_b = sum(cp.power_b for cp, _ in act)
        instrs_c = act[0][0].instrs_c
        instrs_b = act[0][0].instrs_b
        extra_contention = max(max(cp.extras_c) for cp, _ in act)
        dma_bound = any(tr > cp.compute_c for cp, tr in act)
        dma_utilization = max(
            (tr / max(cp.compute_c, tr) if max(cp.compute_c, tr) else 0.0)
            for cp, tr in act)
        saturated = is_saturated(system, cluster_bytes)
        _metrics.set_gauge("system.evaluate.saturated", int(saturated))
        _metrics.set_gauge("system.evaluate.n_clusters", system.n_clusters)

        flat = sys_assign.flat
        uniform = len(set(speeds_all)) == 1
        total_elems = block * total_blocks

    return Report(
        name=name, strategy=target.strategy,
        core_points=tuple(p for pts in cluster_points for p in pts),
        block=block, total_blocks=total_blocks, total_elems=total_elems,
        blocks_per_core=flat.blocks_per_core, ref_freq_ghz=f_ref,
        cycles_base=cycles_b, cycles_copift=cycles_c,
        instrs_base=instrs_b * total_blocks,
        instrs_copift=instrs_c * total_blocks,
        extra_contention=extra_contention,
        imbalance=(flat.imbalance if uniform else flat.weighted_imbalance),
        dma_bound=dma_bound,
        dma_utilization=dma_utilization,
        power_base_mw=power_b,
        power_copift_mw=power_c)


# -- tuner surface ----------------------------------------------------------


def system_cost(spec, system: SystemConfig, point_name: str, *,
                problem: int | None = None, power_cap_mw: float | None = None):
    """One ``CostEstimate`` for a workload on a whole system at one
    operating point — the pricing unit of :func:`select_system_point`.

    Simulatable kernels go through :func:`evaluate_system` (full HBM
    arbitration); tuner-only workloads (no ISA schedule) are priced per
    cluster through ``tune.cost.evaluate`` on a ceil-shared problem and
    composed (max of cluster times, sum of powers) — no DMA byte model
    exists for them, so HBM contention is not applied on that path.
    """
    from repro_torch.tune.cost import CostEstimate, evaluate as cost_evaluate
    from repro_torch.tune.space import Candidate
    from repro_torch.tune.workloads import get_workload
    k = system.n_clusters
    cluster = system.clusters[0]
    point = cluster.point(point_name)
    try:
        from repro_torch.api.registry import kernel
        spec_r = kernel(spec)
        simulatable = spec_r.simulatable
    except KeyError:
        spec_r, simulatable = None, False
    if simulatable:
        from repro_torch.api.target import Target
        w = spec_r.get_workload()
        blk = w.max_block
        elems = problem or w.default_problem
        tb = max(1, -(-elems // blk))
        rep = evaluate_system(spec_r,
                              Target.system(system, point=point),
                              total_blocks=tb)
        time_ns = rep.cycles_copift / rep.ref_freq_ghz
        power = rep.power_copift_mw
        return CostEstimate(cycles=rep.cycles_copift, time_ns=time_ns,
                            energy_pj=power * time_ns,
                            ipc=rep.ipc_copift,
                            power_mw=power,
                            feasible=(power_cap_mw is None
                                      or power <= power_cap_mw),
                            dma_bound=rep.dma_bound)
    w = get_workload(spec) if isinstance(spec, str) else spec
    elems = problem or w.default_problem
    share = -(-elems // k)
    est = cost_evaluate(w, Candidate(block=w.max_block,
                                     n_cores=cluster.n_cores,
                                     point=point_name),
                        problem=share, cfg=cluster)
    power = est.power_mw * k
    return CostEstimate(cycles=est.cycles, time_ns=est.time_ns,
                        energy_pj=est.energy_pj * k,
                        ipc=est.ipc * k, power_mw=power,
                        feasible=(power_cap_mw is None
                                  or power <= power_cap_mw),
                        dma_bound=est.dma_bound)


@dataclass(frozen=True)
class SystemPoint:
    """The winning (cluster count, operating point) of a system search.

    ``best_cost`` mirrors ``TuneResult.best_cost`` so serve-engine gauge
    code treats system and cluster plans uniformly; ``evaluated`` keeps
    every (n_clusters, point, CostEstimate) row for inspection."""
    workload: str
    objective: str
    n_clusters: int
    point: str
    best_cost: object
    evaluated: tuple
    power_cap_mw: float | None = None

    @property
    def feasible(self) -> bool:
        return bool(self.best_cost.feasible)


def select_system_point(spec, counts, *,
                        cluster=None,
                        hbm_bytes_per_cycle: float | None = None,
                        noc_latency_cycles: int = 0,
                        power_cap_mw: float | None = None,
                        objective: str = "energy",
                        problem: int | None = None) -> SystemPoint:
    """Search cluster count x DVFS point under a *system* power cap.

    ``counts`` is an int (search ``1..counts``) or an iterable of counts.
    Every candidate is priced by :func:`system_cost`; feasible candidates
    (system power within the cap) rank by the objective, infeasible ones
    rank after every feasible one by speed — the same ordering rule as
    ``tune.cost.parse_objective``.
    """
    from repro_torch.cluster.topology import SNITCH_CLUSTER
    from repro_torch.tune.cost import objective_value, parse_objective
    cluster = cluster or SNITCH_CLUSTER
    if isinstance(counts, int):
        if counts < 1:
            raise ValueError(f"counts must be >= 1, got {counts}")
        counts = range(1, counts + 1)
    counts = tuple(counts)
    if not counts:
        raise ValueError("no cluster counts to search")
    parse_objective(objective)       # fail fast on a bad objective string
    rows = []
    wname = spec if isinstance(spec, str) else getattr(
        spec, "name", str(spec))
    with _obs_span("system.select_point", workload=wname,
                   n_candidates=len(counts) * len(cluster.operating_points)):
        for k in counts:
            system = SystemConfig.homogeneous(
                k, cluster, hbm_bytes_per_cycle=hbm_bytes_per_cycle,
                noc_latency_cycles=noc_latency_cycles)
            for pt in cluster.operating_points:
                est = system_cost(spec, system, pt.name, problem=problem,
                                  power_cap_mw=power_cap_mw)
                rows.append((k, pt.name, est))
    best = min(rows, key=lambda r: (not r[2].feasible,
                                    objective_value(r[2], objective)))
    return SystemPoint(workload=wname, objective=objective,
                       n_clusters=best[0], point=best[1], best_cost=best[2],
                       evaluated=tuple(rows), power_cap_mw=power_cap_mw)
