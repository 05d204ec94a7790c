"""The unified analytic cost oracle: ``evaluate(workload, candidate)``; the
port's copy of the JAX package's ``repro.tune.cost``.

One candidate is priced end-to-end through the calibrated machinery:

1. *Schedule rewrite* — the knobs are applied to the workload's
   ``CopiftSchedule``: FP phases concatenated when fused (one FREP loop,
   fewer setups, shallower pipeline), demoted streams turned into explicit
   integer-LSU accesses (one load + pointer bump per element per demoted
   mover), and the replica set shrunk to the Step-4 distinct buffers when
   pipelining is off.
2. *Per-core cycles* — ``core.timing.copift_problem_timing`` for pipelined
   candidates (fill/steady/drain, the Fig. 3 machinery); for unpipelined
   ones the serial sum of the integer and FP phase costs per block.
3. *Cluster composition* — block-cyclic split across ``n_cores``, the
   inter-core TCDM bank surcharge from the candidate's own access profile
   (zero at one core — the single-PE reduction), and double-buffered DMA
   refill (``max(compute, transfer)``).
4. *Operating point* — time from the point's frequency; power from the
   component model re-expressed at the point (dyn ∝ f·V², leak ∝ V²); a
   cluster power cap marks candidates infeasible rather than silently
   clipping them.
5. *DVFS islands* — a candidate with a non-empty ``islands`` layout is
   priced through the heterogeneous path instead: cores expand to
   per-core operating points, blocks are shared by the candidate's
   ``strategy`` (``cluster.scheduler.assign``), each core pays its own
   clock-rate-scaled contention surcharge, and power groups active cores
   by distinct point.  A uniform layout reproduces the homogeneous path
   bit-for-bit, so the heterogeneous space strictly contains this one.

At the space's default candidate (Table-I block, no fusion, natural
movers, pipelined, one core, nominal point) every term reduces to the
paper-calibrated single-PE numbers — the oracle strictly extends the
ground truth, as ``repro_torch.cluster`` does.
"""

from __future__ import annotations

import math
import time as _time
from dataclasses import dataclass, replace
from functools import lru_cache

import numpy as np

from repro_torch.cluster.contention import (PATTERN_AFFINE, PATTERN_RANDOM,
                                            AccessProfile)
from repro_torch.cluster.dma import transfer_cycles
from repro_torch.cluster.dvfs import scale_breakdown
from repro_torch.cluster.scheduler import assign, block_cyclic
from repro_torch.cluster.topology import (SNITCH_CLUSTER, ClusterConfig,
                                          OperatingPoint)
from repro_torch.core.energy import (L0_CAPACITY, P_CONST, P_DMA, P_FETCH_FREP,
                                     P_FETCH_L0, P_FETCH_L1, P_FPU, P_INT,
                                     P_LSU, P_SSR, PowerBreakdown)
from repro_torch.core.isa import Instr, count_mem_accesses
from repro_torch.core.timing import (PROGRAM_PROLOGUE_CYCLES, CopiftSchedule,
                                     copift_block_timing,
                                     copift_problem_timing,
                                     copift_serial_block_timing)
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs.spans import span as _obs_span
from repro_torch.perf.memo import register_cache as _register_cache
from repro_torch.tune.space import Candidate
from repro_torch.tune.workloads import Workload, get_workload

#: Base objectives the searches can minimize.
OBJECTIVES = ("cycles", "time", "energy", "edp")

#: Latency-bound suffix units (longest-match first so "us"/"ns" win
#: over the bare-seconds suffix).
_LATENCY_UNITS = (("ns", 1.0), ("us", 1e3), ("ms", 1e6), ("s", 1e9))

#: Rank scale for candidates violating a latency bound: any violator
#: sorts after every bound-meeting candidate, and violators rank among
#: themselves by how fast they are (closest-to-the-bound first), so a
#: search over an infeasible space still returns the least-bad plan.
#: Applied *multiplicatively* (``PENALTY * (1 + time_ns)``) — an additive
#: offset this large would absorb any realistic ``time_ns`` into the same
#: float64 value and collapse the within-tier ordering.  Finite (not
#: ``inf``) so estimates stay JSON-clean.
_LATENCY_PENALTY = 1e30


@dataclass(frozen=True)
class CostEstimate:
    """What one candidate costs for one whole problem on the cluster."""
    cycles: int              # cluster cycles (frequency-independent)
    time_ns: float           # cycles at the candidate's operating point
    energy_pj: float         # cluster energy for the whole problem
    ipc: float               # cluster-aggregate instructions per cycle
    power_mw: float          # cluster power at the operating point
    feasible: bool           # within the cluster power cap
    dma_bound: bool

    @property
    def edp(self) -> float:
        return self.energy_pj * self.time_ns


@lru_cache(maxsize=256)
def parse_objective(objective: str) -> tuple[str, float | None]:
    """Split an objective string into ``(base, latency_bound_ns)``.

    Grammar: ``<base>`` or ``<base>@time<=<bound><unit>`` where ``base``
    is one of :data:`OBJECTIVES` and ``unit`` is ``ns``/``us``/``ms``/
    ``s`` (bare numbers are nanoseconds).  ``"energy@time<=2.5ms"`` is
    the serving question — *minimum energy among the plans finishing
    within 2.5 ms* — with the bound a hard constraint, not a weight:
    bound-meeting candidates always outrank violators, and violators
    rank by speed so an over-constrained search degrades to the fastest
    plan (the cluster must miss the SLO as narrowly as it can).
    """
    base, sep, bound = objective.partition("@")
    if base not in OBJECTIVES:
        raise ValueError(f"unknown objective {base!r}; expected one of "
                         f"{OBJECTIVES}, optionally with a latency bound "
                         f"('energy@time<=2.5ms')")
    if not sep:
        return base, None
    if not bound.startswith("time<="):
        raise ValueError(
            f"bad latency bound {bound!r} in objective {objective!r}; "
            f"expected 'time<=<number><ns|us|ms|s>' "
            f"(e.g. 'energy@time<=2.5ms')")
    spec = bound[len("time<="):]
    scale = 1.0
    for unit, s in _LATENCY_UNITS:
        if spec.endswith(unit):
            spec, scale = spec[:-len(unit)], s
            break
    try:
        bound_ns = float(spec) * scale
    except ValueError:
        raise ValueError(
            f"bad latency bound number {spec!r} in objective "
            f"{objective!r}; expected 'time<=<number><ns|us|ms|s>'") \
            from None
    if not bound_ns > 0:
        raise ValueError(f"latency bound must be positive, got {bound_ns} "
                         f"ns in objective {objective!r}")
    return base, bound_ns


def constrain_latency(base: str, bound_ns: float) -> str:
    """The objective string for *minimum ``base`` within ``bound_ns``*
    (``repr`` round-trips the float exactly, so equal bounds always
    produce equal cache keys)."""
    objective = f"{base}@time<={bound_ns!r}ns"
    parse_objective(objective)   # validate eagerly, error names the input
    return objective


def objective_value(est: CostEstimate, objective: str) -> float:
    """Scalar to minimize.  ``cycles`` and ``time`` differ only when the
    space sweeps operating points (cycles are frequency-independent).
    A latency-bounded objective (``"energy@time<=2.5ms"``) returns the
    base metric for bound-meeting estimates and a penalty tier ordered
    by ``time_ns`` for violators — see :func:`parse_objective`."""
    base, bound_ns = parse_objective(objective)
    if bound_ns is not None and est.time_ns > bound_ns:
        return _LATENCY_PENALTY * (1.0 + est.time_ns)
    return {"cycles": est.cycles, "time": est.time_ns,
            "energy": est.energy_pj, "edp": est.edp}[base]


def meets_latency(est: CostEstimate, objective: str) -> bool:
    """Whether the estimate satisfies the objective's latency bound
    (vacuously true for unbounded objectives)."""
    bound_ns = parse_objective(objective)[1]
    return bound_ns is None or est.time_ns <= bound_ns


def tuned_schedule(workload: Workload, cand: Candidate) -> CopiftSchedule:
    """Apply the plan-level knobs to the workload's schedule."""
    sched = workload.schedule()
    fp_bodies = [list(b) for b in sched.fp_bodies]
    fused = cand.fuse_fp and len(fp_bodies) > 1
    if fused:
        fp_bodies = [[ins for body in fp_bodies for ins in body]]
    int_body = list(sched.int_body)
    movers = min(max(1, cand.movers), sched.n_ssrs)
    for i in range(sched.n_ssrs - movers):
        # A demoted stream loses its data mover: its traffic goes through
        # the integer LSU instead, one load + pointer bump per element.
        int_body += [
            Instr("lw", f"dm{i}", (f"loop:pdm{i}", f"mem:dm{i}")),
            Instr("addi", f"loop:pdm{i}", (f"loop:pdm{i}",)),
        ]
    replicas = (sched.n_buffer_replicas if cand.pipelined
                else workload.n_buffers_serial)
    return CopiftSchedule(
        sched.name, int_body=int_body, fp_bodies=fp_bodies, n_ssrs=movers,
        n_buffer_replicas=replicas,
        phase_order=() if fused else sched.phase_order)


def _per_core_cycles(sched: CopiftSchedule, blocks_per_core: int, block: int,
                     pipelined: bool, extra_contention: float) -> int:
    """Cycles the slowest core spends on its ``blocks_per_core`` blocks."""
    if pipelined:
        bt = copift_problem_timing(sched, blocks_per_core * block, block,
                                   extra_contention=extra_contention)
        return bt.cycles
    # Serial (Fig. 1f): every phase runs to completion on each block; no
    # int/FP overlap, but also no first-FREP-iteration handoff and the
    # smaller Step-4 buffer set.  The per-block cost lives in the timing
    # model (shared memo, traced lanes) — same arithmetic as before.
    bt = copift_serial_block_timing(sched, block,
                                    extra_contention=extra_contention)
    return PROGRAM_PROLOGUE_CYCLES + blocks_per_core * bt.cycles


def _access_profile(workload: Workload, sched: CopiftSchedule,
                    block: int) -> AccessProfile:
    """The candidate's own TCDM request rate (mirrors
    ``cluster.contention.copift_profile``, but for the rewritten
    schedule rather than the registry one)."""
    bt = copift_block_timing(sched, block)
    int_mem = count_mem_accesses(sched.int_body) * block
    stream_beats = 2 * sched.n_ssrs * block
    pattern = PATTERN_RANDOM if workload.uses_issr else PATTERN_AFFINE
    return AccessProfile(name=workload.name,
                         requests_per_cycle=(int_mem + stream_beats)
                         / bt.cycles,
                         pattern=pattern)


def _core_power(workload: Workload, sched: CopiftSchedule,
                block: int) -> PowerBreakdown:
    """One PE's power for the rewritten schedule (mirrors
    ``energy.copift_power`` with the candidate's own utilizations)."""
    bt = copift_block_timing(sched, block)
    cyc = bt.cycles
    u_int = (sched.n_int * block + sched.block_overhead_instrs()) / cyc
    u_fp = sched.n_fp * block / cyc
    int_mem = count_mem_accesses(sched.int_body) * block
    stream_beats = 2 * sched.n_ssrs * block
    u_mem = (int_mem + stream_beats) / cyc
    int_fetch = (P_FETCH_L0 if len(sched.int_body) <= L0_CAPACITY
                 else P_FETCH_L1) * u_int
    return PowerBreakdown(
        const=P_CONST, int_dp=P_INT * u_int, fpu=P_FPU * u_fp,
        lsu=P_LSU * u_mem, fetch=int_fetch + P_FETCH_FREP * u_fp,
        dma=P_DMA if workload.bytes_per_elem else 0.0,
        ssr=P_SSR * sched.n_ssrs)


def _resolve_point(cfg: ClusterConfig, name: str) -> OperatingPoint:
    return cfg.point(name)   # the one ladder lookup (topology owns it)


def _island_core_points(cfg: ClusterConfig,
                        cand: Candidate) -> tuple[OperatingPoint, ...]:
    """Expand the candidate's island layout to one point per core, cores
    split as evenly as possible across the islands (earlier islands take
    the remainder; with more islands than cores, the surplus islands get
    no cores and drop out — the cross-product search may legally pair a
    small ``n_cores`` with a wide layout)."""
    pts = [_resolve_point(cfg, n) for n in cand.islands]
    sizes = block_cyclic(cand.n_cores, len(pts)).blocks_per_core
    out: list[OperatingPoint] = []
    for p, n in zip(pts, sizes):
        out.extend([p] * n)
    return tuple(out)


def _island_blocks_per_core(cfg: ClusterConfig,
                            cand: Candidate) -> tuple[int, ...]:
    """Expand the candidate's per-island block sizes to one block size per
    core, mirroring ``_island_core_points``'s even split."""
    sizes = block_cyclic(cand.n_cores, len(cand.islands)).blocks_per_core
    out: list[int] = []
    for blk, n in zip(cand.island_blocks, sizes):
        out.extend([blk] * n)
    return tuple(out)


def _evaluate_het_island_blocks(workload: Workload, cand: Candidate,
                                problem: int, cfg: ClusterConfig,
                                power_cap_mw: float | None) -> CostEstimate:
    """Pricing path for per-island block sizes (``cand.island_blocks``).

    With blocks of different sizes per island the "identical blocks"
    premise of ``scheduler.assign`` no longer holds, so work is
    apportioned in *elements*: speed-proportional shares for the weighted
    strategies (largest-remainder, deterministic), even shares for the
    speed-blind block-cyclic rule.  Each core then runs its share in its
    own island's block size — larger blocks amortize per-block overheads,
    smaller ones can dodge remainder waste on the slow islands, which is
    exactly the headroom the shared-block knob could not express.

    A *uniform* ``island_blocks`` tuple never reaches this path:
    ``evaluate`` canonicalizes it onto the shared ``block`` knob, so the
    per-island space strictly contains the shared-block space and the
    tuner's refined pick can never score worse than the shared plan.
    """
    from repro_torch.cluster.scheduler import _static_proportional

    sched = tuned_schedule(workload, cand)
    core_points = _island_core_points(cfg, cand)
    core_blocks = _island_blocks_per_core(cfg, cand)
    speeds = tuple(p.freq_ghz for p in core_points)
    f_ref = max(speeds)
    weights = speeds if cand.strategy != "block_cyclic" \
        else (1.0,) * len(speeds)
    shares = _static_proportional(problem, weights)

    compute = 0.0
    total_blocks = 0
    active: list[int] = [i for i, s in enumerate(shares) if s]
    act_speeds = tuple(speeds[i] for i in active)
    for pos, i in enumerate(active):
        blk = core_blocks[i]
        n_blocks = math.ceil(shares[i] / blk)
        total_blocks += n_blocks
        profile = _access_profile(workload, sched, blk)
        extra = profile.extra_stalls_het(cfg, act_speeds, pos)
        c = _per_core_cycles(sched, n_blocks, blk, cand.pipelined, extra)
        compute = max(compute, c * (f_ref / speeds[i]))
    transfer = (transfer_cycles(cfg, workload.bytes_per_elem * problem)
                if workload.bytes_per_elem else 0)
    cycles = max(compute, transfer)

    time_ns = cycles / f_ref
    counts: dict[tuple[OperatingPoint, int], int] = {}
    for i in active:
        key = (core_points[i], core_blocks[i])
        counts[key] = counts.get(key, 0) + 1
    power_mw = sum(n * scale_breakdown(_core_power(workload, sched, blk),
                                       p, cfg.nominal).total
                   for (p, blk), n in counts.items())
    instrs = ((sched.n_int + sched.n_fp) * problem
              + sched.block_overhead_instrs() * total_blocks)
    return CostEstimate(
        cycles=cycles, time_ns=time_ns, energy_pj=power_mw * time_ns,
        ipc=instrs / cycles, power_mw=power_mw,
        feasible=(power_cap_mw is None or power_mw <= power_cap_mw),
        dma_bound=transfer > compute)


def _evaluate_het(workload: Workload, cand: Candidate, problem: int,
                  cfg: ClusterConfig,
                  power_cap_mw: float | None) -> CostEstimate:
    """The heterogeneous (DVFS-island) pricing path: per-core rates,
    weighted block assignment, per-point power grouping.  Cycles are
    reference-clock cycles of the fastest island; with a uniform island
    layout every figure equals the homogeneous path's bit-for-bit."""
    sched = tuned_schedule(workload, cand)
    block = cand.block
    total_blocks = max(1, math.ceil(problem / block))
    core_points = _island_core_points(cfg, cand)
    speeds = tuple(p.freq_ghz for p in core_points)
    f_ref = max(speeds)
    assignment = assign(total_blocks, speeds, cand.strategy)
    profile = _access_profile(workload, sched, block)

    active = [i for i, b in enumerate(assignment.blocks_per_core) if b]
    act_speeds = tuple(speeds[i] for i in active)
    compute = 0.0
    for pos, i in enumerate(active):
        extra = profile.extra_stalls_het(cfg, act_speeds, pos)
        c = _per_core_cycles(sched, assignment.blocks_per_core[i], block,
                             cand.pipelined, extra)
        compute = max(compute, c * (f_ref / speeds[i]))
    transfer = (transfer_cycles(cfg, workload.bytes_per_elem * problem)
                if workload.bytes_per_elem else 0)
    cycles = max(compute, transfer)

    time_ns = cycles / f_ref
    pb = _core_power(workload, sched, block)
    counts: dict[OperatingPoint, int] = {}
    for i in active:
        counts[core_points[i]] = counts.get(core_points[i], 0) + 1
    power_mw = sum(n * scale_breakdown(pb, p, cfg.nominal).total
                   for p, n in counts.items())
    instrs = ((sched.n_int + sched.n_fp) * problem
              + sched.block_overhead_instrs() * total_blocks)
    return CostEstimate(
        cycles=cycles, time_ns=time_ns, energy_pj=power_mw * time_ns,
        ipc=instrs / cycles, power_mw=power_mw,
        feasible=(power_cap_mw is None or power_mw <= power_cap_mw),
        dma_bound=transfer > compute)


@lru_cache(maxsize=16384)
def _evaluate(workload: Workload, cand: Candidate, problem: int,
              cfg: ClusterConfig, power_cap_mw: float | None) -> CostEstimate:
    if cand.island_blocks:
        return _evaluate_het_island_blocks(workload, cand, problem, cfg,
                                           power_cap_mw)
    if cand.islands:
        return _evaluate_het(workload, cand, problem, cfg, power_cap_mw)
    # The homogeneous path IS the batch path at group size one — scalar
    # and batched pricing cannot drift apart by construction.
    sched = tuned_schedule(workload, cand)
    return _batch_hom_group(workload, sched, [cand], problem, cfg,
                            power_cap_mw)[0]


_register_cache(_evaluate.cache_clear)


def _canonicalize(w: Workload, cand: Candidate) -> Candidate:
    """Validate a candidate and put it in pricing-canonical form (the one
    rule set shared by :func:`evaluate` and :func:`evaluate_batch`)."""
    if cand.block < 1:
        raise ValueError(f"block must be >= 1, got {cand.block}")
    if cand.block > w.max_block:
        raise ValueError(f"block {cand.block} exceeds {w.name}'s L1 cap "
                         f"{w.max_block}")
    if cand.n_cores < 1:
        raise ValueError(f"n_cores must be >= 1, got {cand.n_cores}")
    if cand.island_blocks:
        if len(cand.island_blocks) != len(cand.islands):
            raise ValueError(
                f"island_blocks {cand.island_blocks} must match the island "
                f"layout {cand.islands} one-for-one ({len(cand.islands)} "
                f"islands)")
        for blk in cand.island_blocks:
            if not 1 <= blk <= w.max_block:
                raise ValueError(f"island block {blk} outside [1, "
                                 f"{w.max_block}] for {w.name}")
        if len(set(cand.island_blocks)) == 1:
            # Every island at one block size IS the shared-block plan —
            # canonicalize onto the shared knob so the per-island space
            # strictly contains the shared one (the never-worse theorem).
            cand = replace(cand, block=cand.island_blocks[0],
                           island_blocks=())
    if len(cand.islands) <= 1 and cand.strategy != "block_cyclic":
        # With zero or one island the cores are uniform and every strategy
        # reduces to block-cyclic — canonicalize so the cross-product
        # search prices the redundant variants once, not three times.
        cand = replace(cand, strategy="block_cyclic")
    return cand


def evaluate(workload: Workload | str, cand: Candidate,
             problem: int | None = None,
             cfg: ClusterConfig = SNITCH_CLUSTER,
             power_cap_mw: float | None = None) -> CostEstimate:
    """Price one candidate for ``problem`` elements of ``workload``.

    Memoized on the full argument tuple — sweeps and repeated searches
    re-price shared candidates for free within a process (the persistent
    ``tune.cache`` handles the across-process case).
    """
    w = get_workload(workload) if isinstance(workload, str) else workload
    cand = _canonicalize(w, cand)
    return _evaluate(w, cand, problem or w.default_problem, cfg, power_cap_mw)


def _batch_hom_group(w: Workload, sched: CopiftSchedule,
                     cands: list[Candidate], problem: int,
                     cfg: ClusterConfig,
                     power_cap_mw: float | None) -> list[CostEstimate]:
    """Price one homogeneous plan group (shared rewritten schedule).

    This is THE homogeneous pricing path: the scalar ``_evaluate`` calls
    it at group size one, so scalar and batched estimates agree by
    construction.  The per-candidate *compute* cycles come from the
    (memoized) simulator machinery; every candidate-axis composition
    (operating-point time, power, energy, IPC, feasibility) is done
    elementwise with numpy — elementwise float64 ops are ordinary IEEE
    operations, so batching the axis changes no value.
    """
    n = len(cands)
    transfer = (transfer_cycles(cfg, w.bytes_per_elem * problem)
                if w.bytes_per_elem else 0)
    profiles: dict[int, AccessProfile] = {}
    scaled_mw: dict[tuple[int, str], float] = {}
    compute = np.empty(n, dtype=np.int64)
    freq = np.empty(n)
    per_core_mw = np.empty(n)
    n_active = np.empty(n, dtype=np.int64)
    instrs = np.empty(n, dtype=np.int64)
    oh = sched.block_overhead_instrs()
    per_elem = sched.n_int + sched.n_fp
    for j, c in enumerate(cands):
        point = _resolve_point(cfg, c.point)
        total_blocks = max(1, math.ceil(problem / c.block))
        assignment = block_cyclic(total_blocks, c.n_cores)
        na = assignment.cores_active(0)
        prof = profiles.get(c.block)
        if prof is None:
            prof = profiles[c.block] = _access_profile(w, sched, c.block)
        extra = prof.extra_stalls(cfg, na)
        compute[j] = _per_core_cycles(sched, assignment.max_blocks, c.block,
                                      c.pipelined, extra)
        mw = scaled_mw.get((c.block, c.point))
        if mw is None:
            mw = scaled_mw[(c.block, c.point)] = scale_breakdown(
                _core_power(w, sched, c.block), point, cfg.nominal).total
        per_core_mw[j] = mw
        freq[j] = point.freq_ghz
        n_active[j] = na
        instrs[j] = per_elem * problem + oh * total_blocks
    cycles = np.maximum(compute, transfer)
    time_ns = cycles / freq
    power_mw = per_core_mw * n_active
    energy_pj = power_mw * time_ns
    ipc = instrs / cycles
    feasible = (np.ones(n, dtype=bool) if power_cap_mw is None
                else power_mw <= power_cap_mw)
    dma_bound = transfer > compute
    return [CostEstimate(
        cycles=int(cycles[j]), time_ns=float(time_ns[j]),
        energy_pj=float(energy_pj[j]), ipc=float(ipc[j]),
        power_mw=float(power_mw[j]), feasible=bool(feasible[j]),
        dma_bound=bool(dma_bound[j])) for j in range(n)]


def evaluate_batch(workload: Workload | str, candidates,
                   problem: int | None = None,
                   cfg: ClusterConfig = SNITCH_CLUSTER,
                   power_cap_mw: float | None = None) -> list[CostEstimate]:
    """Price many candidates in one pass — same numbers as :func:`evaluate`
    for each, ~10-100x the throughput.

    Homogeneous candidates are grouped by their plan knobs (``fuse_fp``,
    ``movers``, ``pipelined`` — everything :func:`tuned_schedule` reads),
    so each group rewrites the schedule once and shares one set of
    sub-simulations through the ``repro_torch.perf`` timing memo; the remaining
    cluster math is composed vectorized over the candidate axis.
    Island (heterogeneous) candidates go through the scalar per-core
    paths, which share their sub-simulations through the same memo.

    Returns one :class:`CostEstimate` per candidate, in input order, each
    bit-for-bit equal to what ``evaluate`` returns for that candidate
    (the JAX package asserts it, and ``tests/test_torch_tune.py`` holds
    the port to the JAX package's numbers).
    """
    w = get_workload(workload) if isinstance(workload, str) else workload
    problem = problem or w.default_problem
    cands = [_canonicalize(w, c) for c in candidates]
    metrics_on = _obs_metrics.enabled()
    t0 = _time.perf_counter() if metrics_on else 0.0
    with _obs_span("tune.evaluate_batch", workload=w.name,
                   candidates=len(cands)):
        out: list[CostEstimate | None] = [None] * len(cands)
        groups: dict[tuple, list[int]] = {}
        for i, c in enumerate(cands):
            if c.islands or c.island_blocks:
                out[i] = _evaluate(w, c, problem, cfg, power_cap_mw)
            else:
                groups.setdefault((c.fuse_fp, c.movers, c.pipelined),
                                  []).append(i)
        for idxs in groups.values():
            sched = tuned_schedule(w, cands[idxs[0]])
            ests = _batch_hom_group(w, sched, [cands[i] for i in idxs],
                                    problem, cfg, power_cap_mw)
            for i, est in zip(idxs, ests):
                out[i] = est
    if metrics_on:
        # Oracle throughput: how fast the batched pricing path is moving.
        dt = _time.perf_counter() - t0
        _obs_metrics.inc("tune.oracle.batches")
        _obs_metrics.inc("tune.oracle.candidates", len(cands))
        _obs_metrics.observe("tune.oracle.batch_seconds", dt)
        if dt > 0:
            _obs_metrics.set_gauge("tune.oracle.candidates_per_sec",
                                   len(cands) / dt)
    return out
