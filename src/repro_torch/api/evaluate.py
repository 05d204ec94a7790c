"""``evaluate(spec, target)`` — THE cluster evaluation code path; the
port's copy of the JAX package's ``repro.api.evaluate``, plain Python and
numpy in the same order, so every ``Report`` equals the JAX package's bit
for bit.

This is the composition the paper's pipeline ends in (per-PE COPIFT x
contention x DMA x DVFS), written once for the general case: a cluster of
cores at per-core operating points, blocks shared by a weighted scheduling
strategy.  A homogeneous cluster is the degenerate case where every
per-core point coincides — the per-core clock-scale factor is then exactly
1 and is *skipped*, so cycle counts stay exact integers and every figure
reduces bit-for-bit to the pre-facade homogeneous results, which in turn
reduce to the paper-calibrated single-PE numbers at one core (the
invariant chain the JAX package pins and ``tests/test_torch_evaluate.py``
holds the port to).

``repro_torch.system.evaluate_system`` composes this same path one level
up: each cluster of a ``SystemConfig`` is priced by :func:`_price_cluster`
(the exact per-cluster body of :func:`evaluate`), so the manycore model
and the single-cluster model are one code path by construction — a
1-cluster system is bit-for-bit this function.  ``faults=`` prices the
target degraded through ``repro_torch.resilience``, as in the JAX
package.

Like the single-PE model, this is a steady-state view: fill/drain and the
end-of-kernel barrier are excluded (they vanish against any production
problem size, cf. Fig. 3's convergence).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from repro_torch.api.registry import KernelSpec, kernel
from repro_torch.api.target import Target
from repro_torch.cluster.contention import (baseline_extra_contention_het,
                                            copift_extra_contention_het)
from repro_torch.cluster.dma import kernel_bytes, transfer_cycles
from repro_torch.cluster.dvfs import het_cluster_power_mw
from repro_torch.cluster.report import Report, headline  # noqa: F401  (re-export)
from repro_torch.cluster.scheduler import assign
from repro_torch.core.analytics import TABLE_I
from repro_torch.core.kernels_isa import baseline_trace, copift_schedule
from repro_torch.core.timing import (baseline_timing, copift_block_timing,
                                     copift_serial_block_timing)
from repro_torch.obs import record as _obs_record
from repro_torch.obs.spans import span as _obs_span


@lru_cache(maxsize=None)
def _copift_timing(name: str, block: int, extra_contention: float):
    """Memoized discrete-event run — the simulator dominates sweep time and
    (kernel, block, contention) triples repeat across points/core counts."""
    return copift_block_timing(copift_schedule(name), block,
                               extra_contention=extra_contention)


@lru_cache(maxsize=None)
def _baseline_timing(name: str, block: int, extra_contention: float):
    return baseline_timing(baseline_trace(name), block,
                           extra_contention=extra_contention)


@lru_cache(maxsize=None)
def _cluster_powers(cfg, name: str, act_points) -> tuple[float, float]:
    """Memoized (baseline, COPIFT) cluster power for one active-point
    multiset — the power model re-simulates block timings per call, so
    sweeps over many targets repay this cache heavily."""
    return (het_cluster_power_mw(cfg, name, act_points, copift=False),
            het_cluster_power_mw(cfg, name, act_points, copift=True))


# repro_torch.perf.clear_all() resets this lru tier along with the memo tables.
from repro_torch.perf.memo import register_cache as _register_cache  # noqa: E402

for _c in (_copift_timing, _baseline_timing, _cluster_powers):
    _register_cache(_c.cache_clear)
del _c


def _compute_cycles(timing_fn, extras: tuple[float, ...],
                    blocks: tuple[int, ...], speeds: tuple[float, ...],
                    f_ref: float):
    """Reference-clock compute latency over the active cores, plus one
    block's instruction count.  ``timing_fn(extra_contention)`` returns the
    per-block ``BlockTiming``; ``extras``/``blocks``/``speeds`` are
    parallel over the *active* cores only.

    The per-core finish times are reduced vectorized: cores at the
    reference clock stay in exact int64 (cycles x blocks with no x1.0
    float round-trip — the homogeneous bit-for-bit reduction), slower
    cores scale by ``f_ref/f`` in float64 exactly as the scalar
    expression did."""
    bts = [timing_fn(e) for e in extras]
    instrs = bts[-1].instrs
    finish = np.asarray([bt.cycles for bt in bts], dtype=np.int64) \
        * np.asarray(blocks, dtype=np.int64)
    speeds_a = np.asarray(speeds)
    at_ref = speeds_a == f_ref
    latest = int(finish[at_ref].max()) if at_ref.any() else 0
    if not at_ref.all():
        scaled = finish[~at_ref] * (f_ref / speeds_a[~at_ref])
        top = float(scaled.max())
        if top > latest:
            latest = top
    return latest, instrs


@dataclass(frozen=True)
class _ClusterPass:
    """Everything one cluster contributes to a report: the assignment plus
    the compute/instr/power figures of the registry-default plan path.
    ``evaluate`` consumes one of these; ``system.evaluate_system`` reduces
    over several — same numbers either way."""
    assignment: object
    active: tuple
    act_speeds: tuple
    act_blocks: tuple
    act_points: tuple
    extras_c: tuple
    extras_b: tuple
    compute_c: "int | float"
    compute_b: "int | float"
    instrs_c: int
    instrs_b: int
    power_b: float
    power_c: float


def _price_cluster(cfg, name: str, core_points, block: int,
                   total_blocks: int, strategy: str,
                   f_ref: float, alive=None) -> _ClusterPass:
    """Price ``total_blocks`` blocks of ``name`` on one cluster — the exact
    per-cluster body of :func:`evaluate`'s default-plan path, factored out
    so the system layer reduces over the *same expression tree* (the
    bit-for-bit 1-cluster invariant).  ``f_ref`` is the caller's reference
    clock: the cluster's own fastest core for a lone cluster, the
    system-wide fastest for a manycore part.

    ``alive`` (``repro_torch.resilience``) is an optional per-core
    survival mask: dead cores enter the assignment at speed 0, take zero
    blocks, and thereby drop out of contention, compute and power the same
    way an idle core always has.  ``None`` — the fault-free case — is the
    historical expression, untouched."""
    speeds = tuple(p.freq_ghz if alive is None or alive[i] else 0.0
                   for i, p in enumerate(core_points))
    assignment = assign(total_blocks, speeds, strategy)
    active = tuple(i for i, b in enumerate(assignment.blocks_per_core) if b)
    act_speeds = tuple(speeds[i] for i in active)
    act_blocks = tuple(assignment.blocks_per_core[i] for i in active)
    act_points = tuple(core_points[i] for i in active)
    extras_c = copift_extra_contention_het(cfg, name, act_speeds)
    extras_b = baseline_extra_contention_het(cfg, name, act_speeds)
    compute_c, instrs_c = _compute_cycles(
        lambda e: _copift_timing(name, block, e), extras_c, act_blocks,
        act_speeds, f_ref)
    compute_b, instrs_b = _compute_cycles(
        lambda e: _baseline_timing(name, block, e), extras_b, act_blocks,
        act_speeds, f_ref)
    power_b, power_c = _cluster_powers(cfg, name, act_points)
    return _ClusterPass(assignment=assignment, active=active,
                        act_speeds=act_speeds, act_blocks=act_blocks,
                        act_points=act_points, extras_c=extras_c,
                        extras_b=extras_b, compute_c=compute_c,
                        compute_b=compute_b, instrs_c=instrs_c,
                        instrs_b=instrs_b, power_b=power_b, power_c=power_c)


def _resolve_faults(faults, t_ms: float):
    """``faults=`` → a non-trivial ``FaultState``, or ``None`` when there
    is nothing to degrade.  ``None`` is the contract with the callers: it
    means *take the historical code path verbatim* (the empty-trace
    bit-for-bit pin), not merely "an empty mask"."""
    if faults is None:
        return None
    from repro_torch.resilience.degrade import resolve_state
    state = resolve_state(faults, t_ms)
    return None if state.is_trivial else state


def _resolve_plan(spec, plan):
    """Canonicalize a tuner candidate for the cluster path.

    Only the *plan* knobs (block, FP fusion, mover demotion, pipelining)
    travel with the candidate — the cluster itself (cores, operating
    points, strategy) is the ``Target``'s job, so island layouts are
    rejected and ``n_cores``/``point`` are ignored."""
    from repro_torch.tune.cost import (_access_profile, _canonicalize,
                                       tuned_schedule)
    w = spec.get_workload()
    plan = _canonicalize(w, plan)
    if plan.islands or plan.island_blocks:
        raise ValueError(
            "plan carries DVFS-island knobs (islands/island_blocks); "
            "express the cluster through the Target's core points instead")
    sched = tuned_schedule(w, plan)
    return plan, sched, _access_profile(w, sched, plan.block)


def _plan_cluster_power(cfg, spec, sched, block, act_points) -> float:
    """COPIFT cluster power for a rewritten plan schedule: the cost
    oracle's component model per PE, re-expressed at each active core's
    operating point (mirrors ``tune.cost._evaluate_het``'s grouping)."""
    from repro_torch.cluster.dvfs import scale_breakdown
    from repro_torch.tune.cost import _core_power
    pb = _core_power(spec.get_workload(), sched, block)
    counts: dict = {}
    for p in act_points:
        counts[p] = counts.get(p, 0) + 1
    return sum(n * scale_breakdown(pb, p, cfg.nominal).total
               for p, n in counts.items())


def evaluate(spec: "KernelSpec | str", target: Target | None = None, *,
             blocks_per_core: int = 1,
             total_blocks: int | None = None,
             plan=None, faults=None, fault_t_ms: float = 0.0) -> Report:
    """Evaluate one kernel on one target; the facade's front door.

    Weak scaling by default (``blocks_per_core`` blocks per core); pass
    ``total_blocks`` for strong scaling (fixed work, split by the target's
    strategy).  Every block is the kernel's Table-I max block, as in the
    single-PE ``evaluate_kernel``.

    ``plan`` routes a tuner candidate (:class:`repro_torch.tune.Candidate`)
    through this same cluster path: the schedule is rewritten by
    ``tune.cost.tuned_schedule``, the block size is the plan's, inter-core
    TCDM contention comes from the rewritten schedule's own access
    profile, and COPIFT power from the oracle's component model at each
    core's point — so a tuned and a default plan produce directly
    comparable ``Report``\\ s (the input to ``obs.attrib``).  ``plan=None``
    is the registry default.  The RV32G baseline side is never
    plan-transformed.

    A target with a ``system_config`` (``Target.system``) is priced by
    ``system.evaluate_system``, before anything else, as in the JAX
    package.

    ``faults`` (``repro_torch.resilience``) prices the target *degraded*:
    a :class:`~repro_torch.resilience.faults.FaultTrace` is sampled at
    ``fault_t_ms`` (or pass a ``FaultState`` directly), dead cores drop
    out of scheduling/contention/power via the survival mask, throttled
    islands are re-pointed down the DVFS ladder, and on system targets a
    degraded HBM link narrows the arbitrated port.  A trivial state (the
    empty trace) takes the historical expression verbatim, and an
    all-cores-dead state raises
    :class:`~repro_torch.resilience.faults.AllCoresDeadError`.
    """
    spec = kernel(spec)
    if not spec.simulatable:
        raise ValueError(
            f"kernel {spec.name!r} has no ISA schedule/baseline trace — it "
            f"is tuner-only; evaluate() needs one of "
            f"{[s.name for s in _simulatable()]}")
    target = target or Target()
    if target.system_config is not None:
        # Manycore part: the system layer reduces _price_cluster over the
        # clusters (lazy import — repro_torch.system imports api internals).
        from repro_torch.system.analytics import evaluate_system
        return evaluate_system(spec, target, blocks_per_core=blocks_per_core,
                               total_blocks=total_blocks, plan=plan,
                               faults=faults, fault_t_ms=fault_t_ms)
    name = spec.isa_name
    cfg = target.cluster

    core_points = target.core_points
    fstate = _resolve_faults(faults, fault_t_ms)
    if fstate is None:
        alive = None
        speeds = tuple(p.freq_ghz for p in core_points)
        f_ref = max(speeds)
    else:
        from repro_torch.resilience.degrade import (degrade_cluster,
                                                    masked_speeds,
                                                    require_survivors)
        core_points, alive = degrade_cluster(cfg, core_points, fstate)
        speeds = masked_speeds(core_points, alive)
        require_survivors(speeds, f"the {cfg.n_cores}-core cluster target")
        f_ref = max(speeds)
    if plan is None:
        plan_sched = plan_profile = None
        pipelined = True
        block = TABLE_I[name].max_block
    else:
        plan, plan_sched, plan_profile = _resolve_plan(spec, plan)
        pipelined = plan.pipelined
        block = plan.block
    if total_blocks is None:
        total_blocks = blocks_per_core * cfg.n_cores
    if total_blocks < 1:
        raise ValueError(f"need at least one block of work, got "
                         f"{total_blocks} (blocks_per_core={blocks_per_core})")
    with _obs_span("api.evaluate", kernel=name, n_cores=cfg.n_cores,
                   total_blocks=total_blocks, strategy=target.strategy):
        if plan is None:
            cp = _price_cluster(cfg, name, core_points, block, total_blocks,
                                target.strategy, f_ref, alive)
            assignment, active = cp.assignment, cp.active
            act_speeds, act_blocks = cp.act_speeds, cp.act_blocks
            extras_c, extras_b = cp.extras_c, cp.extras_b
            compute_c, instrs_c = cp.compute_c, cp.instrs_c
            compute_b, instrs_b = cp.compute_b, cp.instrs_b
            power_b, power_c = cp.power_b, cp.power_c
        else:
            assignment = assign(total_blocks, speeds, target.strategy)
            active = tuple(i for i, b
                           in enumerate(assignment.blocks_per_core) if b)
            act_speeds = tuple(speeds[i] for i in active)
            act_blocks = tuple(assignment.blocks_per_core[i] for i in active)
            act_points = tuple(core_points[i] for i in active)
            extras_c = tuple(
                plan_profile.extra_stalls_het(cfg, act_speeds, pos)
                for pos in range(len(act_speeds)))
            timing = (copift_block_timing if pipelined
                      else copift_serial_block_timing)
            copift_fn = lambda e: timing(  # noqa: E731
                plan_sched, block, extra_contention=e)
            extras_b = baseline_extra_contention_het(cfg, name, act_speeds)
            compute_c, instrs_c = _compute_cycles(
                copift_fn, extras_c, act_blocks, act_speeds, f_ref)
            compute_b, instrs_b = _compute_cycles(
                lambda e: _baseline_timing(name, block, e), extras_b,
                act_blocks, act_speeds, f_ref)
            power_b = het_cluster_power_mw(cfg, name, act_points,
                                           copift=False)
            power_c = _plan_cluster_power(cfg, spec, plan_sched, block,
                                          act_points)
        total_elems = block * total_blocks
        transfer = transfer_cycles(cfg, kernel_bytes(name, total_elems))
        cycles_c = max(compute_c, transfer)
        cycles_b = max(compute_b, transfer)
        uniform = len(set(speeds)) == 1

        rec = _obs_record.active_recorder()
        if rec is not None:
            _trace_evaluate(rec, name, plan_sched, block, pipelined, active,
                            act_speeds, act_blocks, extras_c, extras_b,
                            f_ref, transfer, total_blocks, cycles_c,
                            cycles_b)

    return Report(
        name=name, strategy=target.strategy, core_points=core_points,
        block=block, total_blocks=total_blocks, total_elems=total_elems,
        blocks_per_core=assignment.blocks_per_core, ref_freq_ghz=f_ref,
        cycles_base=cycles_b, cycles_copift=cycles_c,
        instrs_base=instrs_b * total_blocks,
        instrs_copift=instrs_c * total_blocks,
        extra_contention=max(extras_c),
        # unweighted max/mean on uniform cores (the historical homogeneous
        # figure), makespan over the fluid optimum on mixed islands
        imbalance=(assignment.imbalance if uniform
                   else assignment.weighted_imbalance),
        dma_bound=transfer > compute_c,
        dma_utilization=(transfer / cycles_c if cycles_c else 0.0),
        power_base_mw=power_b,
        power_copift_mw=power_c)


def _trace_evaluate(rec, name, sched, block, pipelined, active, act_speeds,
                    act_blocks, extras_c, extras_b, f_ref, transfer,
                    total_blocks, cycles_c, cycles_b) -> None:
    """Record the per-core cycle accounting of one traced evaluate.

    Re-runs the COPIFT/baseline block timings with lanes scoped per core so
    the trace carries ``eval<N>.core<i>/{int,fpss,rv32g}`` lanes, then emits
    an ``evaluate`` summary with every exact intermediate the cluster
    reduction consumed — what ``obs.export.reconcile`` replays against the
    ``Report``.  The re-runs are bit-identical to the values the lru tier
    served ``_compute_cycles`` (pure functions of kernel/block/contention),
    and the memo tables are consulted for provenance only, never bypassed.
    Lane names are sequence-numbered so back-to-back evaluates in one
    session never mix aggregates.

    ``sched`` is the (possibly plan-rewritten) COPIFT schedule, or ``None``
    for the registry default; ``pipelined`` picks the Step-5 combinator and
    is stamped per core as ``combine`` ("max" | "sum")."""
    seq = len(rec.summaries)
    if sched is None:
        sched = copift_schedule(name)
    timing = copift_block_timing if pipelined else copift_serial_block_timing
    btrace = baseline_trace(name)
    cores = []
    for pos, i in enumerate(active):
        scope = f"eval{seq}.core{i}"
        with rec.lane(scope):
            bt = timing(sched, block, extra_contention=extras_c[pos])
            bb = baseline_timing(btrace, block,
                                 extra_contention=extras_b[pos])
        prefix = f"{scope}/"
        lanes = {ln[len(prefix):]: dict(tot)
                 for ln, tot in rec.lane_micro.items()
                 if ln.startswith(prefix)}
        cores.append(dict(core=i, freq_ghz=act_speeds[pos],
                          blocks=act_blocks[pos],
                          extra_contention_copift=extras_c[pos],
                          extra_contention_base=extras_b[pos],
                          block_cycles=bt.cycles, int_cycles=bt.int_cycles,
                          fp_cycles=bt.fp_cycles, base_cycles=bb.cycles,
                          combine="max" if pipelined else "sum",
                          lanes=lanes))
    rec.summary(dict(kind="evaluate", name=name, block=block,
                     total_blocks=total_blocks, ref_freq_ghz=f_ref,
                     transfer_cycles=transfer, cycles_copift=cycles_c,
                     cycles_base=cycles_b, cores=cores))


def sweep(spec: "KernelSpec | str", targets, *,
          blocks_per_core: int = 1,
          total_blocks: int | None = None) -> "list[Report]":
    """Evaluate one kernel on many :class:`Target`\\ s — the sweep entry
    point (DVFS ladders, core-count scans, island layouts).

    This is deliberately a thin ordered loop over :func:`evaluate`: all
    the cross-target sharing lives in the layers underneath — the
    ``(kernel, block, contention)`` timing lrus backed by the
    ``repro_torch.perf`` memo, the :func:`_cluster_powers` cache, and the
    vectorized per-core reduction inside :func:`_compute_cycles` — so a
    sweep's repeated sub-simulations run once however the targets are
    ordered, and each entry is *definitionally* bit-for-bit equal to
    ``evaluate(spec, target, ...)``.
    """
    spec = kernel(spec)
    targets = list(targets)
    with _obs_span("api.sweep", kernel=spec.name, n_targets=len(targets)):
        return [evaluate(spec, t, blocks_per_core=blocks_per_core,
                         total_blocks=total_blocks) for t in targets]


def _simulatable():
    from repro_torch.api.registry import specs
    return [s for s in specs() if s.simulatable]


def compare_strategies(spec: "KernelSpec | str", target: Target,
                       strategies: tuple[str, ...] | None = None,
                       blocks_per_core: int = 1,
                       total_blocks: int | None = None
                       ) -> dict[str, Report]:
    """Evaluate every scheduling strategy on the same target — how much of
    the speed-blind block-cyclic tail each one recovers."""
    from repro_torch.cluster.scheduler import STRATEGIES
    return {s: evaluate(spec, target.with_strategy(s),
                        blocks_per_core=blocks_per_core,
                        total_blocks=total_blocks)
            for s in (strategies or STRATEGIES)}
