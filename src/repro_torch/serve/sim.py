"""Discrete-event serving simulator over the cluster cost models; a copy
of the JAX package's ``repro.serve.sim``, whose ``SimReport`` objects equal
the JAX package's with ``==``.  It runs on the host and launches no kernel:
its milliseconds and microjoules are the Snitch model's, not a card's.

``repro_torch.api.evaluate`` prices one kernel invocation; this module prices a
*service*: requests arrive on a :class:`~repro_torch.serve.traffic.Trace`, wait
in a bounded admission queue, get coalesced into batches, and run on slot
partitions of the cluster whose size/DVFS point an autoscaling policy
(``repro_torch.serve.policies``) re-decides every control epoch.  Out come the
serving quantities the kernel-level reports cannot express: latency
percentiles under queueing, dropped-request counts, energy under a
time-varying load, and whether a p99 SLO was met.

Model (deliberately minimal, fully deterministic):

* The cluster's ``n_cores`` cores are partitioned into
  ``plan.n_slots`` equal slots; each busy slot runs one batch to
  completion (no preemption).
* A batch of ``k`` queued requests is priced as ONE problem of
  ``k * elems`` elements on the slot's cores at the slot's DVFS point —
  simulatable registry kernels through the full ``api.evaluate`` path
  (so a 1-core, 1-request simulation reproduces the ``Report`` cycles
  bit-for-bit), tuner-only workloads through the tuner's cost oracle.
* Dispatch is work-conserving: an idle slot takes
  ``min(batch_max, queue)`` requests immediately (no wait-to-fill), as
  long as enough cores are free — after a plan switch, batches running
  under the old partition keep their cores until they finish.
* Energy is the sum of dispatched batch energies (the oracle's active
  energy) plus *idle leakage*: cores not serving a batch still leak the
  always-on share of the constant power term at the current plan's
  voltage (``dvfs.STATIC_FRAC_CONST``, V²-scaled) — the term that makes
  scaling the cluster down during a trough actually save energy.  Peak
  power is the largest concurrent busy-slot power sum.  Cross-slot
  interference is not modeled.

Determinism: the trace is frozen, pricing is the memoized analytic
oracle, the event heap breaks time-ties by a fixed (kind, sequence)
order, and percentiles are nearest-rank — the same trace, policy and
seed therefore reproduce the percentile table bit-for-bit (pinned in
``tests/test_torch_serve_sim.py``).
"""

from __future__ import annotations

import heapq
import math
from collections import deque
from dataclasses import dataclass, field

from repro_torch.cluster.topology import SNITCH_CLUSTER, ClusterConfig
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs.spans import span as _obs_span
from repro_torch.tune.cost import CostEstimate
from repro_torch.tune.cost import evaluate as _cost_evaluate
from repro_torch.tune.cost import evaluate_batch as _cost_evaluate_batch
from repro_torch.tune.space import Candidate
from repro_torch.tune.workloads import get_workload

__all__ = ["SloSpec", "SlotPlan", "PolicyContext", "ServicePricer",
           "SimReport", "simulate", "PERCENTILES"]

#: Percentile grid every report carries (keys of ``latency_ms``).
PERCENTILES = (50.0, 90.0, 95.0, 99.0)

# Event-heap priorities at equal timestamps: free slots first (capacity
# exists before anything else looks at it), then the control decision,
# then new arrivals — a fixed total order is what keeps replays exact.
_PRIO_FREE, _PRIO_CONTROL, _PRIO_ARRIVAL = 0, 1, 2


@dataclass(frozen=True)
class SloSpec:
    """A latency service-level objective: ``percentile`` of request
    latency must stay within ``latency_ms`` (and nothing may be
    dropped)."""
    latency_ms: float
    percentile: float = 99.0

    def __post_init__(self):
        if self.latency_ms <= 0:
            raise ValueError(f"latency_ms must be positive, got "
                             f"{self.latency_ms}")
        if not 0.0 < self.percentile <= 100.0:
            raise ValueError(f"percentile must be in (0, 100], got "
                             f"{self.percentile}")

    @property
    def budget_ns(self) -> float:
        return self.latency_ms * 1e6


@dataclass(frozen=True)
class SlotPlan:
    """One autoscaling decision: how the cluster serves until the next
    control epoch."""
    n_slots: int          # concurrent serving slots (partition of cores)
    point: str            # DVFS ladder point name, every slot alike
    batch_max: int = 4    # most requests coalesced into one batch

    def validate(self, n_cores: int) -> "SlotPlan":
        if not 1 <= self.n_slots <= n_cores:
            raise ValueError(f"n_slots={self.n_slots} must be in "
                             f"[1, {n_cores}] (the cluster's core count)")
        if n_cores % self.n_slots:
            raise ValueError(f"n_slots={self.n_slots} does not divide the "
                             f"cluster's {n_cores} cores evenly")
        if self.batch_max < 1:
            raise ValueError(f"batch_max={self.batch_max} must be >= 1")
        return self

    def cores_per_slot(self, n_cores: int) -> int:
        return n_cores // self.n_slots


@dataclass(frozen=True)
class PolicyContext:
    """Everything a policy may consult when deciding a :class:`SlotPlan`
    (bound once per simulation by :func:`simulate`)."""
    pricer: "ServicePricer"
    kernel: str
    elems: int
    n_cores: int
    epoch_ms: float
    slo: SloSpec | None
    power_cap_mw: float | None


class ServicePricer:
    """Deterministic service cost of one batch on one slot.

    ``price(kernel, elems, n_cores, point)`` returns the tuner's
    :class:`~repro_torch.tune.cost.CostEstimate` for running ``elems`` elements
    on ``n_cores`` cores at ladder point ``point``:

    * simulatable registry kernels go through ``api.evaluate`` on a
      homogeneous target (strong scaling, Table-I block), so the
      simulator's degenerate cases reduce bit-for-bit to ``Report``
      numbers;
    * tuner-only workloads (``softmax``, ``prng``) go through
      ``tune.cost.evaluate`` — the same oracle the autotuner ranks with.

    Every price is memoized; :meth:`price_many` additionally routes
    cold tuner-only batches through ``tune.cost.evaluate_batch`` so a
    policy pricing its whole plan grid pays one grouped pass.

    ``system=`` prices slots on a manycore part
    (:class:`~repro_torch.system.SystemConfig`, uniform clusters): slots then
    partition the *system's* cores, a slot spanning k whole clusters is
    priced through ``Target.system`` with its proportional share of the
    HBM bandwidth, and a sub-cluster slot falls back to the single-cluster
    path (it never crosses a cluster boundary).  ``system=None`` is
    bit-for-bit the historical single-cluster pricer.
    """

    def __init__(self, cluster: ClusterConfig = SNITCH_CLUSTER,
                 system=None):
        if system is not None:
            if not system.is_uniform:
                raise ValueError(
                    "ServicePricer needs uniform clusters in the "
                    "SystemConfig (slot partitioning assumes one cluster "
                    "shape)")
            cluster = system.clusters[0]
        self.cluster = cluster
        self.system = system
        self._memo: dict[tuple, CostEstimate] = {}

    @property
    def n_cores(self) -> int:
        """Cores the simulator's slot plans partition — across every
        cluster for a system pricer."""
        return self.system.n_cores if self.system is not None \
            else self.cluster.n_cores

    def _spec(self, kern: str):
        from repro_torch.api.registry import kernel as _registry_kernel
        try:
            spec = _registry_kernel(kern)
        except KeyError:
            return None
        return spec if spec.simulatable else None

    def _slot_target(self, n_cores: int, pt):
        """The Target one slot prices on: k whole clusters (with their
        proportional HBM share) on a system pricer, else a homogeneous
        ``n_cores``-core cut of the cluster."""
        from repro_torch.api.target import Target
        c = self.cluster.n_cores
        if self.system is not None and n_cores >= c and n_cores % c == 0:
            from repro_torch.system.topology import SystemConfig
            k = n_cores // c
            hbm = self.system.hbm_bytes_per_cycle
            if hbm is not None:
                hbm = hbm * k / self.system.n_clusters
            sub = SystemConfig.homogeneous(
                k, self.cluster, hbm_bytes_per_cycle=hbm,
                noc_latency_cycles=self.system.noc_latency_cycles,
                cluster_strategy=self.system.cluster_strategy)
            return Target.system(sub, point=pt)
        return Target.homogeneous(n_cores=n_cores, point=pt,
                                  cluster=self.cluster)

    def _price_evaluate(self, spec, elems: int, n_cores: int,
                        point: str) -> CostEstimate:
        from repro_torch.api.evaluate import evaluate as _api_evaluate
        pt = self.cluster.point(point)
        target = self._slot_target(n_cores, pt)
        block = spec.get_workload().max_block
        rep = _api_evaluate(spec, target,
                            total_blocks=max(1, -(-elems // block)))
        time_ns = rep.cycles_copift / rep.ref_freq_ghz
        return CostEstimate(cycles=rep.cycles_copift, time_ns=time_ns,
                            energy_pj=rep.power_copift_mw * time_ns,
                            ipc=rep.ipc_copift,
                            power_mw=rep.power_copift_mw,
                            feasible=True, dma_bound=rep.dma_bound)

    def price(self, kern: str, elems: int, n_cores: int,
              point: str) -> CostEstimate:
        key = (kern, elems, n_cores, point)
        est = self._memo.get(key)
        if est is None:
            spec = self._spec(kern)
            if spec is not None:
                est = self._price_evaluate(spec, elems, n_cores, point)
            elif self.system is not None \
                    and n_cores > self.cluster.n_cores:
                # Tuner-only workload on a multi-cluster slot: ceil-share
                # the problem across the k clusters, price one, compose
                # (max of equal times; k x energy/power) — the same rule
                # as repro_torch.system.system_cost's tuner-only path.
                w = get_workload(kern)
                k = n_cores // self.cluster.n_cores
                e0 = _cost_evaluate(
                    w, Candidate(block=w.max_block,
                                 n_cores=self.cluster.n_cores, point=point),
                    problem=-(-elems // k), cfg=self.cluster)
                est = CostEstimate(cycles=e0.cycles, time_ns=e0.time_ns,
                                   energy_pj=e0.energy_pj * k,
                                   ipc=e0.ipc * k,
                                   power_mw=e0.power_mw * k,
                                   feasible=e0.feasible,
                                   dma_bound=e0.dma_bound)
            else:
                w = get_workload(kern)
                est = _cost_evaluate(
                    w, Candidate(block=w.max_block, n_cores=n_cores,
                                 point=point),
                    problem=elems, cfg=self.cluster)
            self._memo[key] = est
        return est

    def idle_power_mw(self, kern: str, point: str) -> float:
        """Leakage of ONE idle core at a ladder point: the always-on
        share of the kernel's constant power term
        (``dvfs.STATIC_FRAC_CONST``), V²-scaled from the cluster's
        calibration point — what a clock-gated core still burns."""
        key = ("idle", kern, point)
        p = self._memo.get(key)
        if p is None:
            from repro_torch.cluster.dvfs import STATIC_FRAC_CONST
            from repro_torch.tune.cost import (_canonicalize, _core_power,
                                         tuned_schedule)
            w = get_workload(kern)
            cand = _canonicalize(w, Candidate(block=w.max_block))
            pb = _core_power(w, tuned_schedule(w, cand), cand.block)
            pt = self.cluster.point(point)
            p = pb.const * STATIC_FRAC_CONST \
                * pt.static_scale(self.cluster.nominal)
            self._memo[key] = p
        return p

    def price_many(self, kern: str,
                   shapes: "list[tuple[int, int, str]]"
                   ) -> list[CostEstimate]:
        """Price many ``(elems, n_cores, point)`` shapes of one kernel —
        cold tuner-only shapes grouped per problem size through
        ``evaluate_batch`` (the policies' grid-pricing fast path)."""
        cold = [s for s in set(shapes)
                if (kern, *s) not in self._memo]
        if cold and self.system is None and self._spec(kern) is None:
            w = get_workload(kern)
            by_problem: dict[int, list[tuple[int, int, str]]] = {}
            for s in cold:
                by_problem.setdefault(s[0], []).append(s)
            for elems, group in sorted(by_problem.items()):
                cands = [Candidate(block=w.max_block, n_cores=n, point=p)
                         for _, n, p in group]
                ests = _cost_evaluate_batch(w, cands, problem=elems,
                                            cfg=self.cluster)
                for s, est in zip(group, ests):
                    self._memo[(kern, *s)] = est
        return [self.price(kern, *s) for s in shapes]


def _nearest_rank(sorted_vals: "tuple[float, ...]", q: float) -> float:
    if not sorted_vals:
        return math.nan
    k = max(1, math.ceil(q / 100.0 * len(sorted_vals)))
    return sorted_vals[min(k, len(sorted_vals)) - 1]


@dataclass(frozen=True)
class SimReport:
    """What one simulated service run cost and delivered."""
    policy: str
    trace_spec: str
    trace_seed: int
    n_requests: int
    n_completed: int
    n_dropped: int
    latency_ms: dict          # {"p50": ..., "p90": ..., "p95": ..., "p99": ...}
    max_latency_ms: float
    makespan_ms: float        # last completion (>= trace duration)
    energy_uj: float          # active + idle energy over the run
    active_energy_uj: float   # sum of dispatched batch energies
    idle_energy_uj: float     # leakage of unoccupied cores
    peak_power_mw: float      # largest concurrent busy-slot power sum
    mean_batch: float
    n_batches: int
    slo: SloSpec | None
    plan_switches: int        # control decisions that changed the plan
    n_shed: int = 0           # rejected by SLO-aware admission (pre-queue)
    n_failed: int = 0         # in-flight batches killed by fault events
    n_retried: int = 0        # requests re-enqueued by the retry policy
    n_lost: int = 0           # requests permanently lost to faults
    failovers: int = 0        # control epochs that remapped onto survivors
    latencies_ms: tuple = field(repr=False, default=())

    def percentile(self, q: float) -> float:
        return _nearest_rank(self.latencies_ms, q)

    @property
    def completed_frac(self) -> float:
        """Fraction of offered requests that completed — the resilience
        bench's availability figure (1.0 on a healthy run)."""
        return self.n_completed / self.n_requests if self.n_requests \
            else 1.0

    @property
    def slo_met(self) -> bool:
        """SLO holds iff the bound percentile is within budget AND no
        request was turned away (a dropped, shed *or lost* request is an
        infinite-latency one)."""
        if self.slo is None:
            return True
        if self.n_dropped or self.n_shed or self.n_lost \
                or not self.n_completed:
            return False
        return self.percentile(self.slo.percentile) <= self.slo.latency_ms

    @property
    def slo_violations(self) -> int:
        """Requests that individually missed the SLO: dropped + shed +
        lost + completed past the latency bound — the apples-to-apples
        count for comparing admission/failover policies on one trace."""
        if self.slo is None:
            return self.n_dropped + self.n_shed + self.n_lost
        late = sum(1 for lat in self.latencies_ms
                   if lat > self.slo.latency_ms)
        return self.n_dropped + self.n_shed + self.n_lost + late

    @property
    def energy_uj_per_request(self) -> float:
        return self.energy_uj / self.n_completed if self.n_completed \
            else math.nan

    def format_lines(self) -> list[str]:
        slo = (f"p{self.slo.percentile:g} <= {self.slo.latency_ms:g} ms: "
               f"{'MET' if self.slo_met else 'MISSED'}"
               if self.slo else "none")
        pct = "  ".join(f"{k}={v:.3f}ms"
                        for k, v in self.latency_ms.items())
        fault = ([f"  faults: batches_killed={self.n_failed} "
                  f"retried={self.n_retried} lost={self.n_lost} "
                  f"failovers={self.failovers}  "
                  f"completed_frac={self.completed_frac:.4f}"]
                 if (self.n_failed or self.n_retried or self.n_lost
                     or self.failovers) else [])
        return [
            f"policy={self.policy}  trace={self.trace_spec!r} "
            f"seed={self.trace_seed}",
            f"  requests={self.n_requests} completed={self.n_completed} "
            f"dropped={self.n_dropped} shed={self.n_shed}  "
            f"batches={self.n_batches} "
            f"(mean {self.mean_batch:.2f})  switches={self.plan_switches}",
            f"  latency {pct}  max={self.max_latency_ms:.3f}ms",
            f"  energy={self.energy_uj:.2f}uJ "
            f"(active {self.active_energy_uj:.2f} + idle "
            f"{self.idle_energy_uj:.2f}; "
            f"{self.energy_uj_per_request:.3f}uJ/req)  "
            f"peak_power={self.peak_power_mw:.1f}mW  slo: {slo}",
        ] + fault


def _empty_report(trace, policy_name, slo) -> SimReport:
    return SimReport(policy=policy_name, trace_spec=trace.spec,
                     trace_seed=trace.seed, n_requests=0, n_completed=0,
                     n_dropped=0,
                     latency_ms={f"p{q:g}": math.nan for q in PERCENTILES},
                     max_latency_ms=math.nan, makespan_ms=0.0,
                     energy_uj=0.0, active_energy_uj=0.0, idle_energy_uj=0.0,
                     peak_power_mw=0.0, mean_batch=0.0,
                     n_batches=0, slo=slo, plan_switches=0)


def simulate(trace, policy, *, slo: SloSpec | None = None,
             epoch_ms: float = 50.0, queue_cap: int = 64,
             pricer: ServicePricer | None = None,
             power_cap_mw: float | None = None,
             admission: str = "tail_drop",
             faults=None, retry=None) -> SimReport:
    """Run ``policy`` over ``trace`` and return a :class:`SimReport`.

    ``epoch_ms`` is the control period (the policy re-decides its
    :class:`SlotPlan` at every multiple of it); ``queue_cap`` bounds the
    admission queue — arrivals beyond it are *dropped*, which any SLO
    counts as a miss.  ``power_cap_mw`` is handed to the policy (the
    planner must not pick a plan whose concurrent slot power exceeds it);
    the report's ``peak_power_mw`` shows what actually happened.

    ``admission`` picks the gate in front of the queue:

    * ``"tail_drop"`` (historical): admit until the queue is full;
    * ``"slo_aware"``: additionally *shed* an arrival whose predicted
      latency (queue depth in batch-waves x the current plan's batch
      service time) already exceeds the SLO bound — turning work away
      *before* it poisons the queue, so admitted requests keep meeting
      the bound.  Requires ``slo``; shed requests are reported as
      ``n_shed`` (they count as violations, like drops — the win is
      *fewer* total ``slo_violations`` on an overloaded trace).

    ``faults`` takes a :class:`~repro_torch.resilience.faults.FaultTrace`:
    when it carries fail-stop events the run is delegated to
    ``repro_torch.resilience.failover.simulate_failover`` — in-flight batches
    on failed cores are killed, their requests go through ``retry`` (a
    :class:`~repro_torch.resilience.failover.RetryPolicy`; ``None`` = killed
    requests are lost outright), and slot partitions remap onto the
    survivors at the next control epoch.  ``faults=None`` or a trace
    with no fail-stop events runs this healthy loop verbatim — the
    no-fault report is bit-for-bit the historical one (pinned in
    ``tests/test_torch_failover.py``).  Throttle/HBM windows are evaluate-path
    degradations and do not alter serving dispatch.
    """
    if epoch_ms <= 0:
        raise ValueError(f"epoch_ms must be positive, got {epoch_ms}")
    if queue_cap < 1:
        raise ValueError(f"queue_cap must be >= 1, got {queue_cap}")
    if admission not in ("tail_drop", "slo_aware"):
        raise ValueError(f"unknown admission policy {admission!r}; "
                         f"expected 'tail_drop' or 'slo_aware'")
    if admission == "slo_aware" and slo is None:
        raise ValueError("admission='slo_aware' needs an SloSpec — the "
                         "predicted-wait gate is the SLO's latency bound")
    pname = getattr(policy, "name", type(policy).__name__)
    if not trace.requests:
        return _empty_report(trace, pname, slo)
    pricer = pricer or ServicePricer()
    if faults is not None and faults.failstop_events():
        from repro_torch.resilience.failover import simulate_failover
        return simulate_failover(trace, policy, slo=slo, epoch_ms=epoch_ms,
                                 queue_cap=queue_cap, pricer=pricer,
                                 power_cap_mw=power_cap_mw,
                                 admission=admission, faults=faults,
                                 retry=retry)
    n_cores = pricer.n_cores
    ctx = PolicyContext(pricer=pricer, kernel=trace.requests[0].kernel,
                        elems=trace.requests[0].elems, n_cores=n_cores,
                        epoch_ms=epoch_ms, slo=slo,
                        power_cap_mw=power_cap_mw)
    policy.bind(ctx)

    events: list = []
    seq = 0
    for r in trace.requests:
        heapq.heappush(events, (r.t_arrival_ms, _PRIO_ARRIVAL, seq,
                                "arrival", r))
        seq += 1
    heapq.heappush(events, (0.0, _PRIO_CONTROL, seq, "control", None))
    seq += 1

    queue: deque = deque()
    # sid -> (power_mw, batch, cores): batches keep their cores to
    # completion even across plan switches (no preemption).
    busy: dict[int, tuple[float, int, int]] = {}
    plan: SlotPlan | None = None
    latencies: list[float] = []
    active_pj = 0.0
    idle_pj = 0.0
    peak_power = 0.0
    n_dropped = n_shed = n_batches = batch_sum = plan_switches = 0
    arrived_epoch = completed_epoch = 0
    prev_rate = 0.0
    makespan = 0.0
    t_prev = 0.0
    sid_counter = 0
    metrics_on = _obs_metrics.enabled()

    def active_cores() -> int:
        return sum(c for _, _, c in busy.values())

    def predicted_latency_ms(r) -> float:
        """Deterministic service-time forecast for one arrival under the
        current plan: immediate dispatch prices the lone request; a busy
        system prices a full batch_max batch (one 'wave') and counts the
        waves ahead of this request in the queue, plus its own."""
        cps = plan.cores_per_slot(n_cores)
        if not queue and len(busy) < plan.n_slots \
                and active_cores() + cps <= n_cores:
            return pricer.price(r.kernel, r.elems, cps,
                                plan.point).time_ns * 1e-6
        wave_ms = pricer.price(r.kernel, r.elems * plan.batch_max, cps,
                               plan.point).time_ns * 1e-6
        waves_ahead = 1 + len(queue) // (plan.n_slots * plan.batch_max)
        return (waves_ahead + 1) * wave_ms

    def dispatch(t: float) -> None:
        nonlocal active_pj, peak_power, n_batches, batch_sum, seq, \
            sid_counter, makespan
        cps = plan.cores_per_slot(n_cores)
        while queue and len(busy) < plan.n_slots \
                and active_cores() + cps <= n_cores:
            k = min(plan.batch_max, len(queue))
            reqs = [queue.popleft() for _ in range(k)]
            est = pricer.price(reqs[0].kernel,
                               sum(r.elems for r in reqs),
                               cps, plan.point)
            free_t = t + est.time_ns * 1e-6
            sid = sid_counter
            sid_counter += 1
            busy[sid] = (est.power_mw, k, cps)
            heapq.heappush(events, (free_t, _PRIO_FREE, seq,
                                    "slot_free", sid))
            seq += 1
            active_pj += est.energy_pj
            peak_power = max(peak_power,
                             sum(p for p, _, _ in busy.values()))
            n_batches += 1
            batch_sum += k
            makespan = max(makespan, free_t)
            for r in reqs:
                lat = free_t - r.t_arrival_ms
                latencies.append(lat)
                if metrics_on:
                    _obs_metrics.observe("serve.sim.latency_ms", lat)

    kern = trace.requests[0].kernel
    with _obs_span("serve.sim", policy=pname, trace=trace.spec,
                   requests=trace.n_requests):
        while events:
            t, _prio, _seq, kind, payload = heapq.heappop(events)
            if t > t_prev:
                # Idle leakage over the gap: unoccupied cores at the
                # current plan's voltage (mW x ms = 1 uJ = 1e6 pJ).
                if plan is not None:
                    n_idle = n_cores - active_cores()
                    if n_idle > 0:
                        idle_pj += (pricer.idle_power_mw(kern, plan.point)
                                    * n_idle * (t - t_prev) * 1e6)
                t_prev = t
            if kind == "slot_free":
                completed_epoch += busy.pop(payload)[1]
                if queue:
                    dispatch(t)
            elif kind == "control":
                rate = arrived_epoch / (epoch_ms * 1e-3)
                decision = policy.decide(dict(
                    t_ms=t, queue_len=len(queue), busy_slots=len(busy),
                    arrived_epoch=arrived_epoch,
                    completed_epoch=completed_epoch,
                    rate_rps=rate, prev_rate_rps=prev_rate,
                    plan=plan)).validate(n_cores)
                if plan is not None and decision != plan:
                    plan_switches += 1
                plan = decision
                prev_rate = rate
                arrived_epoch = completed_epoch = 0
                if queue:
                    dispatch(t)
                if t < trace.duration_ms or queue or busy:
                    heapq.heappush(events, (t + epoch_ms, _PRIO_CONTROL,
                                            seq, "control", None))
                    seq += 1
            else:  # arrival
                arrived_epoch += 1
                if len(queue) >= queue_cap:
                    n_dropped += 1
                    if metrics_on:
                        _obs_metrics.inc("serve.sim.dropped")
                elif admission == "slo_aware" and plan is not None \
                        and predicted_latency_ms(payload) > slo.latency_ms:
                    n_shed += 1
                    if metrics_on:
                        _obs_metrics.inc("serve.sim.shed")
                else:
                    queue.append(payload)
                    dispatch(t)

    lat_sorted = tuple(sorted(latencies))
    report = SimReport(
        policy=pname, trace_spec=trace.spec, trace_seed=trace.seed,
        n_requests=trace.n_requests, n_completed=len(latencies),
        n_dropped=n_dropped,
        latency_ms={f"p{q:g}": _nearest_rank(lat_sorted, q)
                    for q in PERCENTILES},
        max_latency_ms=lat_sorted[-1] if lat_sorted else math.nan,
        makespan_ms=makespan, energy_uj=(active_pj + idle_pj) * 1e-6,
        active_energy_uj=active_pj * 1e-6, idle_energy_uj=idle_pj * 1e-6,
        peak_power_mw=peak_power,
        mean_batch=batch_sum / n_batches if n_batches else 0.0,
        n_batches=n_batches, slo=slo, plan_switches=plan_switches,
        n_shed=n_shed, latencies_ms=lat_sorted)
    if metrics_on:
        _obs_metrics.inc("serve.sim.requests", trace.n_requests)
        _obs_metrics.set_gauge(f"serve.sim.{pname}.p99_ms",
                               report.latency_ms["p99"])
        _obs_metrics.set_gauge(f"serve.sim.{pname}.energy_uj",
                               report.energy_uj)
        _obs_metrics.set_gauge(f"serve.sim.{pname}.peak_power_mw",
                               report.peak_power_mw)
        _obs_metrics.set_gauge(f"serve.sim.{pname}.dropped",
                               float(n_dropped))
        _obs_metrics.set_gauge(f"serve.sim.{pname}.shed", float(n_shed))
    return report
